"""Motion-only PnP: pose-only Levenberg-Marquardt refinement.

Port of ``ov2slam_tpu/solvers/pnp_refine.py`` (the reference's
`ceresPnP`): pose-only BA with Huber loss, chi2 outlier rejection between
passes, and an L2 re-solve, with a fixed iteration count on a 6x6 system.

:func:`pnp_refine` takes CPU tensors to its plain version
(:func:`pnp_refine_plain`); on CUDA tensors it is one launch of
``csrc/pnp_refine.cu`` (every LM iteration and the chi2 gate) on the
current stream, or raises. :func:`pnp_refine_two_pass` is two calls.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .. import kernels
from ..ops import launch as _chk
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


def pnp_refine_plain(
    T_wc, points, px_obs, valid,
    fx, fy, cx, cy,
    robust_th: float = 5.9915,
    iters: int = 10,
    lam0: float = 1e-4,
):
    """Refine a world-from-camera pose against 2D-3D correspondences, in
    plain PyTorch.

    Args:
      T_wc: (7,) initial pose (e.g. motion-model prior or P3P output).
      points: (N, 3) world points; px_obs (N, 2) undistorted pixels.
      valid: (N,) bool.
      robust_th: Huber chi2 threshold (0 → pure L2).

    Returns: (T_wc_refined (7,), inlier (N,), final_cost ()).
    """
    if T_wc.is_cuda:
        pnp_refine_plain.cuda_runs += 1
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


# calls on CUDA tensors (the main path must make none)
pnp_refine_plain.cuda_runs = 0

# the rows csrc/pnp_refine.cu takes (one CTA strides over them)
MAX_ROWS = 1 << 16


class PnpLaunch:
    """The inputs of one ``pnp_refine_launch`` call in the C function's
    order (:meth:`c_args`): the pose, the points and pixels with their row
    strides (floats), the mask, the row count, the intrinsics (a table of
    device pointers, 0 where the value is a number, and one of values),
    the Huber threshold, the iterations and the initial damping."""

    def __init__(self, T_wc, pts, pts_stride, px, px_stride, valid, n,
                 cal_ptrs, cal_vals, robust_th, iters, lam0):
        self.T_wc, self.pts, self.pts_stride = T_wc, pts, pts_stride
        self.px, self.px_stride, self.valid, self.n = (px, px_stride, valid,
                                                       n)
        self.cal_ptrs, self.cal_vals = cal_ptrs, cal_vals
        self.robust_th, self.iters, self.lam0 = robust_th, iters, lam0

    def c_args(self):
        return (self.T_wc, self.pts, self.pts_stride, self.px,
                self.px_stride, self.valid, self.n,
                ctypes.addressof(self.cal_ptrs),
                ctypes.addressof(self.cal_vals), self.robust_th, self.iters,
                self.lam0)


def pack_launch(T_wc, points, px_obs, valid, fx, fy, cx, cy,
                robust_th: float, iters: int, lam0: float) -> PnpLaunch:
    """Check the inputs of one kernel launch and pack its arguments.

    Raises TypeError on a dtype the kernel does not take (f32 pose, points,
    pixels and intrinsics tensors, a bool mask, numbers for the
    thresholds) and ValueError on a tensor on another device than
    ``points``, on a pose or mask that is not contiguous, on points or
    pixels whose rows are not adjacent floats (rows may be strided: the
    front end passes a column view of its packed state, read in place), on
    shapes that do not match, on negative ``iters``, and on more than
    :data:`MAX_ROWS` rows."""
    fn = "pnp_refine"
    dev = points.device
    n = points.shape[0] if points.dim() == 2 else -1
    _chk.check(fn, "T_wc", T_wc, torch.float32, dev, (7,))
    s_pts = _chk.check(fn, "points", points, torch.float32, dev, (n, 3),
                       rows=True)
    s_px = _chk.check(fn, "px_obs", px_obs, torch.float32, dev, (n, 2),
                      rows=True)
    _chk.check(fn, "valid", valid, torch.bool, dev, (n,))
    if n > MAX_ROWS:
        raise ValueError(f"{fn}: {n} rows; the kernel takes at most "
                         f"{MAX_ROWS}")
    if iters < 0:
        raise ValueError(f"{fn}: iters {iters}")
    cal = [_chk.scalar(fn, name, x, dev) for name, x in (
        ("fx", fx), ("fy", fy), ("cx", cx), ("cy", cy))]
    ptrs = (ctypes.c_int64 * 4)(*[p or 0 for p, _ in cal])
    vals = (ctypes.c_float * 4)(*[v for _, v in cal])
    return PnpLaunch(T_wc.data_ptr(), points.data_ptr(), s_pts,
                     px_obs.data_ptr(), s_px, valid.data_ptr(), n, ptrs,
                     vals, _chk.number(fn, "robust_th", robust_th),
                     int(iters), _chk.number(fn, "lam0", lam0))


def launch(T_wc, points, px_obs, valid, fx, fy, cx, cy,
           robust_th: float = 5.9915, iters: int = 10, lam0: float = 1e-4):
    """One launch of ``csrc/pnp_refine.cu`` on CUDA tensors, on the current
    stream of their device: what :func:`pnp_refine_plain` computes.
    Returns (T_wc refined (7,), inlier (N,), final cost ()). N = 0
    launches nothing (the pose as given, cost 0)."""
    a = pack_launch(T_wc, points, px_obs, valid, fx, fy, cx, cy, robust_th,
                    iters, lam0)
    dev = points.device
    f32 = torch.float32
    if a.n == 0:
        return (T_wc.clone(), torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=f32, device=dev))
    T_out = torch.empty(7, dtype=f32, device=dev)
    inlier = torch.empty(a.n, dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    lib = kernels.load("pnp_refine")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pnp_refine_launch(*a.c_args(), T_out.data_ptr(),
                                   inlier.data_ptr(), cost.data_ptr(),
                                   stream)
    if rc != 0:
        raise RuntimeError(f"pnp_refine launch failed: code {rc}")
    pnp_refine.launches += 1
    pnp_refine.shapes[(a.n, a.iters, a.robust_th > 0)] += 1
    return T_out, inlier, cost


def pnp_refine(
    T_wc, points, px_obs, valid,
    fx, fy, cx, cy,
    robust_th: float = 5.9915,
    iters: int = 10,
    lam0: float = 1e-4,
):
    """Refine a world-from-camera pose against 2D-3D correspondences (see
    :func:`pnp_refine_plain`). CPU tensors take the plain version; CUDA
    tensors one kernel launch. ``fx`` .. ``cy``: numbers or one-element
    f32 tensors.

    Returns: (T_wc_refined (7,), inlier (N,), final_cost ())."""
    if _chk.device_of(points, "pnp_refine").type == "cpu":
        return pnp_refine_plain(T_wc, points, px_obs, valid, fx, fy, cx,
                                cy, robust_th=robust_th, iters=iters,
                                lam0=lam0)
    return launch(T_wc, points, px_obs, valid, fx, fy, cx, cy,
                  robust_th=robust_th, iters=iters, lam0=lam0)


# launches of the kernel, and how many at each (N, iters, robust)
pnp_refine.launches = 0
pnp_refine.shapes = collections.Counter()


def pnp_refine_two_pass(T_wc, points, px_obs, valid, fx, fy, cx, cy,
                        robust_th: float = 5.9915,
                        iters_robust: int = 5, iters_l2: int = 5):
    """Robust pass → outlier removal → L2 pass on inliers (two launches
    on CUDA tensors)."""
    T, inlier, _ = pnp_refine(T_wc, points, px_obs, valid, fx, fy, cx, cy,
                              robust_th=robust_th, iters=iters_robust)
    T, inlier2, cost = pnp_refine(T, points, px_obs, valid & inlier,
                                  fx, fy, cx, cy, robust_th=0.0,
                                  iters=iters_l2)
    return T, inlier & inlier2, cost
