"""Batched P3P (Kneip closed form) and RANSAC absolute-pose solver.

Port of ``ov2slam_tpu/geometry/pnp.py`` (the reference's `p3pRansac` /
`p3pLMedS` around OpenGV's Kneip P3P): all minimal samples are drawn up
front, every P3P is solved in one batched closed-form pass (quartic roots
via Ferrari, `geometry/poly.py`), every candidate pose is scored against
every correspondence, and the argmax consensus wins.

P3P math follows L. Kneip, D. Scaramuzza, R. Siegwart, "A Novel
Parametrization of the Perspective-Three-Point Problem" (CVPR 2011).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import lie
from ..utils.lie import _cross
from .essential import draw_samples
from .poly import solve_quartic_real


def _nz(x, eps, fill=None):
    return torch.where(x.abs() < eps,
                       torch.full_like(x, eps if fill is None else fill), x)


def _normalize(v, axis=-1):
    return v / torch.clamp(torch.linalg.norm(v, dim=axis, keepdim=True), min=1e-12)


def p3p_kneip(bearings, points):
    """Closed-form P3P: up to 4 camera poses from 3 bearing/point pairs.

    Args:
      bearings: (..., 3, 3) unit bearing vectors (camera frame, rows).
      points:   (..., 3, 3) corresponding world points (rows).

    Returns:
      poses: (..., 4, 7) world-from-camera poses T_wc (camera position C and
        orientation R_wc such that ``lambda * f_i = R_wc^T (P_i - C)``).
      valid: (..., 4) bool mask of real solutions.
    """
    dtype = bearings.dtype
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    P1, P2, P3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]

    # Orthonormal intermediate camera frame τ = [t1 t2 t3] (rows).
    # Kneip requires f3 to lie in the half-space z_τ < 0; instead of a data
    # swap (branchy) we detect the sign and swap (f1,P1)<->(f2,P2) with where.
    def make_T(f1_, f2_):
        t1 = f1_
        t3 = _normalize(_cross(f1_, f2_))
        t2 = _cross(t3, t1)
        return torch.stack([t1, t2, t3], dim=-2)

    T0 = make_T(f1, f2)
    f3_t0 = (T0 @ f3[..., None])[..., 0]
    swap = (f3_t0[..., 2] > 0)[..., None]

    f1s = torch.where(swap, f2, f1)
    f2s = torch.where(swap, f1, f2)
    P1s = torch.where(swap, P2, P1)
    P2s = torch.where(swap, P1, P2)
    T = make_T(f1s, f2s)
    f3_t = (T @ f3[..., None])[..., 0]

    # Intermediate world frame η = [n1 n2 n3] (rows).
    n1 = _normalize(P2s - P1s)
    n3 = _normalize(_cross(n1, P3 - P1s))
    n2 = _cross(n3, n1)
    N = torch.stack([n1, n2, n3], dim=-2)

    P3_eta = (N @ (P3 - P1s)[..., None])[..., 0]
    p1 = P3_eta[..., 0]
    p2 = P3_eta[..., 1]
    d12 = torch.linalg.norm(P2s - P1s, dim=-1)

    cos_beta = torch.sum(f1s * f2s, dim=-1)
    # b = cot(beta), beta = angle(f1, f2)
    b = torch.sign(cos_beta) * torch.sqrt(torch.clamp(
        1.0 / torch.clamp(1.0 - cos_beta**2, min=1e-12) - 1.0, min=0.0))

    z3 = _nz(f3_t[..., 2], 1e-12, -1e-12)
    phi1 = f3_t[..., 0] / z3
    phi2 = f3_t[..., 1] / z3

    p1_2, p1_3, p1_4 = p1 * p1, p1**3, p1**4
    p2_2, p2_3, p2_4 = p2 * p2, p2**3, p2**4
    d12_2 = d12 * d12
    b2 = b * b
    phi1_2 = phi1 * phi1
    phi2_2 = phi2 * phi2

    # Kneip 2011 eq. (11) quartic coefficients in cosθ.
    a4 = -phi2_2 * p2_4 - phi1_2 * p2_4 - p2_4
    a3 = (2.0 * p2_3 * d12 * b
          + 2.0 * phi2_2 * p2_3 * d12 * b
          - 2.0 * phi1 * phi2 * p2_3 * d12)
    a2 = (-phi2_2 * p1_2 * p2_2 - phi2_2 * p2_2 * d12_2 * b2
          - phi2_2 * p2_2 * d12_2 + phi2_2 * p2_4 + phi1_2 * p2_4
          + 2.0 * p1 * p2_2 * d12
          + 2.0 * phi1 * phi2 * p1 * p2_2 * d12 * b
          - phi1_2 * p1_2 * p2_2
          + 2.0 * phi2_2 * p1 * p2_2 * d12
          - p2_2 * d12_2 * b2 - 2.0 * p1_2 * p2_2)
    a1 = (2.0 * p1_2 * p2 * d12 * b
          + 2.0 * phi1 * phi2 * p2_3 * d12
          - 2.0 * phi2_2 * p2_3 * d12 * b
          - 2.0 * p1 * p2 * d12_2 * b)
    a0 = (-2.0 * phi1 * phi2 * p1 * p2_2 * d12 * b
          + phi2_2 * p2_2 * d12_2
          + 2.0 * p1_3 * d12 - p1_2 * d12_2
          + phi2_2 * p1_2 * p2_2 - p1_4
          - 2.0 * phi2_2 * p1 * p2_2 * d12
          + phi1_2 * p1_2 * p2_2
          + phi2_2 * p2_2 * d12_2 * b2)

    a4_safe = _nz(a4, 1e-14)
    cos_theta, valid = solve_quartic_real(
        a3 / a4_safe, a2 / a4_safe, a1 / a4_safe, a0 / a4_safe)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta**2, min=0.0))  # θ ∈ [0, π]

    # expand per-root (..., 4) against per-sample scalars.
    def ex(x):
        return x[..., None]

    cot_alpha_num = (phi1 / _nz(phi2, 1e-12)
                     )[..., None] * ex(p1) + cos_theta * ex(p2) - ex(d12 * b)
    cot_alpha_den = (phi1 / _nz(phi2, 1e-12)
                     )[..., None] * cos_theta * ex(p2) - ex(p1) + ex(d12)
    cot_alpha = cot_alpha_num / _nz(cot_alpha_den, 1e-12)

    sin_alpha = torch.sqrt(1.0 / (cot_alpha**2 + 1.0))
    cos_alpha = torch.sqrt(torch.clamp(1.0 - sin_alpha**2, min=0.0))
    cos_alpha = torch.where(cot_alpha < 0, -cos_alpha, cos_alpha)

    # Camera center in η frame (Kneip eq. 5) and orientation Q (eq. 6).
    k = ex(d12) * (sin_alpha * ex(b) + cos_alpha)
    C_eta = torch.stack(
        [cos_alpha * k, sin_alpha * cos_theta * k, sin_alpha * sin_theta * k],
        dim=-1,
    )  # (..., 4, 3)

    # Q: rotation from η to τ (rows as in the paper).
    zr = torch.zeros_like(cos_theta)
    Q = torch.stack(
        [
            -cos_alpha, -sin_alpha * cos_theta, -sin_alpha * sin_theta,
            sin_alpha, -cos_alpha * cos_theta, -cos_alpha * sin_theta,
            zr, -sin_theta, cos_theta,
        ],
        dim=-1,
    ).reshape(cos_theta.shape + (3, 3))

    # World camera center: C = P1 + N^T C_η ; orientation R_wc = N^T Q^T T.
    Nt = N.transpose(-1, -2)[..., None, :, :]
    C = P1s[..., None, :] + (Nt @ C_eta[..., None])[..., 0]
    # Orientation: R_wc = N^T Q^T T (maps camera coords to world coords).
    R_wc = Nt @ Q.transpose(-1, -2) @ T[..., None, :, :]

    q = lie.matrix_to_quat(R_wc)
    poses = lie.make_pose(q, C)

    # guard NaNs from degenerate samples
    finite = torch.isfinite(poses).all(dim=-1)
    poses = torch.where(finite[..., None], poses,
                        lie.pose_identity(dtype, poses.device).expand(
                            poses.shape))
    return poses, valid & finite


# --------------------------------------------------------------------------
# Batched RANSAC / LMedS
# --------------------------------------------------------------------------

def reproj_errors_px(T_wc, points, px_obs, fx, fy, cx, cy):
    """Pixel reprojection errors of world ``points`` (N,3) observed at
    ``px_obs`` (N,2) under poses ``T_wc`` (..., 7). Returns (..., N)."""
    T_cw = lie.pose_inverse(T_wc)
    pc = lie.pose_apply(T_cw[..., None, :], points)
    z = pc[..., 2]
    behind = z <= 1e-6
    zs = _nz(z, 1e-6)
    u = pc[..., 0] / zs * fx + cx
    v = pc[..., 1] / zs * fy + cy
    err = torch.sqrt((u - px_obs[..., 0]) ** 2 + (v - px_obs[..., 1]) ** 2)
    return torch.where(behind, torch.full_like(err, 1e9), err)


def _p3p_candidates(gen, bearings, points, valid_mask, n_iters, idx):
    if idx is None:
        idx = draw_samples(gen, valid_mask, n_iters, 3)
    sample_ok = valid_mask[idx].all(dim=-1) & (
        (idx[:, 0] != idx[:, 1]) & (idx[:, 0] != idx[:, 2])
        & (idx[:, 1] != idx[:, 2]))
    poses, pvalid = p3p_kneip(bearings[idx], points[idx])
    pvalid = pvalid & sample_ok[:, None]
    return poses.reshape(-1, 7), pvalid.reshape(-1)


def p3p_ransac(gen: Optional[torch.Generator], bearings, points, px_obs,
               valid_mask, fx, fy, cx, cy, err_th, n_iters: int = 100,
               idx=None):
    """Batched P3P RANSAC.

    Args:
      gen: generator for the samples (unused where ``idx`` (n_iters, 3) row
        indices are given).
      bearings: (N, 3) unit bearings; points: (N, 3) world points;
      px_obs: (N, 2) observed (undistorted) pixels; valid_mask: (N,) bool.
      err_th: inlier threshold in px.

    Returns:
      (best_T_wc (7,), inlier_mask (N,), n_inliers ())
    """
    flat_poses, flat_valid = _p3p_candidates(gen, bearings, points,
                                             valid_mask, n_iters, idx)
    errs = reproj_errors_px(flat_poses, points, px_obs, fx, fy, cx, cy)
    inl = (errs < err_th) & valid_mask[None, :]
    scores = torch.where(flat_valid, inl.sum(dim=-1),
                         torch.full_like(flat_valid, -1, dtype=torch.int64))
    best = torch.argmax(scores)
    return flat_poses[best], inl[best], scores[best]


def p3p_lmeds(gen: Optional[torch.Generator], bearings, points, px_obs,
              valid_mask, fx, fy, cx, cy, err_th, n_iters: int = 100,
              idx=None):
    """Batched P3P LMedS: minimize the median squared reprojection error,
    then report inliers under err_th."""
    N = points.shape[0]
    flat_poses, flat_valid = _p3p_candidates(gen, bearings, points,
                                             valid_mask, n_iters, idx)
    errs = reproj_errors_px(flat_poses, points, px_obs, fx, fy, cx, cy)
    big = torch.where(valid_mask[None, :], errs ** 2,
                      torch.full_like(errs, float("inf")))
    srt = torch.sort(big, dim=-1).values
    n_valid = int(valid_mask.sum())
    med = srt[:, min(max(n_valid // 2, 0), N - 1)]
    med = torch.where(flat_valid, med, torch.full_like(med, float("inf")))
    best = torch.argmin(med)
    inl = (errs[best] < err_th) & valid_mask
    return flat_poses[best], inl, inl.sum()
