"""Motion-only PnP: pose-only Levenberg-Marquardt refinement.

Port of ``ov2slam_tpu/solvers/pnp_refine.py`` (the reference's
`ceresPnP`): pose-only BA with Huber loss, chi2 outlier rejection between
passes, and an L2 re-solve, with a fixed iteration count on a 6x6 system.
"""

from __future__ import annotations

import torch

from ..utils import lie


def _pose_residuals(T_cw, points, px_obs, fx, fy, cx, cy):
    p = lie.pose_apply(T_cw[None], points)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    depth_ok = z > 1e-3
    zs = torch.where(z.abs() < 1e-3, torch.full_like(z, 1e-3), z)
    u = fx * x / zs + cx
    v = fy * y / zs + cy
    r = torch.stack([u, v], -1) - px_obs

    iz = 1.0 / zs
    zero = torch.zeros_like(iz)
    Jproj = torch.stack([
        fx * iz, zero, -fx * x * iz * iz,
        zero, fy * iz, -fy * y * iz * iz,
    ], -1).reshape(-1, 2, 3)
    hat = lie.so3_hat(p)
    Jpose = torch.cat([Jproj, -Jproj @ hat], dim=-1)  # (N, 2, 6)
    return r, Jpose, depth_ok


def pnp_refine(
    T_wc, points, px_obs, valid,
    fx, fy, cx, cy,
    robust_th: float = 5.9915,
    iters: int = 10,
    lam0: float = 1e-4,
):
    """Refine a world-from-camera pose against 2D-3D correspondences.

    Args:
      T_wc: (7,) initial pose (e.g. motion-model prior or P3P output).
      points: (N, 3) world points; px_obs (N, 2) undistorted pixels.
      valid: (N,) bool.
      robust_th: Huber chi2 threshold (0 → pure L2).

    Returns: (T_wc_refined (7,), inlier (N,), final_cost ()).
    """
    f32 = torch.float32
    dev = T_wc.device
    T_wc = T_wc.to(f32)
    center = T_wc[4:7]
    T_cw = lie.pose_inverse(torch.cat([T_wc[:4], T_wc[4:7] - center]))
    pts = points.to(f32) - center
    px_obs = px_obs.to(f32)
    w_valid = valid.to(f32)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def cost(T):
        r_, _, dok = _pose_residuals(T, pts, px_obs, fx, fy, cx, cy)
        c2 = torch.sum(r_ * r_, -1)
        if robust_th > 0:
            rho = torch.where(
                c2 > robust_th,
                2.0 * torch.sqrt(robust_th * c2) - robust_th, c2)
        else:
            rho = c2
        return torch.sum(rho * w_valid * dok)

    lam = torch.full((), lam0, dtype=f32, device=dev)   # no host upload
    c1 = torch.zeros((), dtype=f32, device=dev)
    for _ in range(iters):
        r, J, depth_ok = _pose_residuals(T_cw, pts, px_obs, fx, fy, cx, cy)
        chi2 = torch.sum(r * r, -1)
        if robust_th > 0:
            w_rob = torch.where(
                chi2 <= robust_th, torch.ones_like(chi2),
                torch.sqrt(robust_th / torch.clamp(chi2, min=1e-12)))
        else:
            w_rob = torch.ones_like(chi2)
        w = w_valid * w_rob * depth_ok

        H = torch.einsum("oik,o,oil->kl", J, w, J)
        g = -torch.einsum("oik,o,oi->k", J, w, r)
        Hd = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-6))
        dx, _ = torch.linalg.solve_ex(Hd + 1e-8 * eye6, g[:, None])
        T_new = lie.pose_left_update(T_cw, dx[:, 0])

        c0, c1 = cost(T_cw), cost(T_new)
        accept = c1 < c0
        T_cw = torch.where(accept, T_new, T_cw)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e2))

    r, _, depth_ok = _pose_residuals(T_cw, pts, px_obs, fx, fy, cx, cy)
    chi2 = torch.sum(r * r, -1)
    gate = robust_th if robust_th > 0 else 5.9915
    inlier = valid & (chi2 <= gate) & depth_ok

    T_out = lie.pose_inverse(T_cw)
    T_out = torch.cat([T_out[:4], T_out[4:7] + center])
    return T_out, inlier, c1


def pnp_refine_two_pass(T_wc, points, px_obs, valid, fx, fy, cx, cy,
                        robust_th: float = 5.9915,
                        iters_robust: int = 5, iters_l2: int = 5):
    """Robust pass → outlier removal → L2 pass on inliers."""
    T, inlier, _ = pnp_refine(T_wc, points, px_obs, valid, fx, fy, cx, cy,
                              robust_th=robust_th, iters=iters_robust)
    T, inlier2, cost = pnp_refine(T, points, px_obs, valid & inlier,
                                  fx, fy, cx, cy, robust_th=0.0,
                                  iters=iters_l2)
    return T, inlier & inlier2, cost
