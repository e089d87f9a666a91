"""Schur-complement Levenberg-Marquardt bundle adjustment over xyz points.

Port of ``ov2slam_tpu/solvers/ba.py`` (the reference's Ceres SPARSE_SCHUR
problem, `optimizer.cpp:436-479`: landmarks eliminated first, LM trust
region, Huber loss, 5 iterations), also home of the solver calibration and
helpers that the inverse-depth solver (`solvers/ba_invdepth.py`) shares:

- residuals and analytic Jacobians of every observation in one batched
  pass (pose Jacobian ``[I | -hat(p_cam)]`` for left-multiplicative
  updates on T_cw, `ceres_parametrization.cpp:107-195`);
- Huber IRLS weights;
- per-landmark 3x3 blocks eliminated in closed form; the reduced camera
  system is dense up to ``DENSE_SCHUR_MAX_KFS`` poses and solved by
  block-Jacobi preconditioned CG above it (full BA), matrix-free: every
  S·x product is O(observations) gather and segmented-sum work;
- fixed iteration counts with accept/reject damping updates;
- a chi2 + positive-depth outlier sweep between the robust and L2 passes
  (`optimizer.cpp:492-627`).

Every pose- or landmark-indexed sum is a segmented sum sorted by bin once
per solve (``segment.SegmentSum``: the same order on every run); the JAX
package accumulates them as scatters and one-hot GEMMs on the TPU. Fixed
keyframes get zeroed pose Jacobians and identity-padded Schur blocks
(`optimizer.cpp:396-407`). f32 throughout, recentred on the first pose.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import lie
from .segment import SegmentSum


class BAParams(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    T_rl: torch.Tensor        # (7,) left-cam pose in right-cam frame (cam 1)
    intr: Tuple[float, float, float, float]   # (fx, fy, cx, cy) on the host


def make_ba_params(cam_l, cam_r=None) -> BAParams:
    """Build solver calibration from Camera objects (undistorted model)."""
    f32 = torch.float32
    T_rl = (lie.pose_inverse(cam_r.T_c0_ci) if cam_r is not None
            else lie.pose_identity(device=cam_l.device))
    return BAParams(
        fx=cam_l.fx.to(f32), fy=cam_l.fy.to(f32),
        cx=cam_l.cx.to(f32), cy=cam_l.cy.to(f32),
        T_rl=T_rl.to(f32), intr=cam_l.intrinsics_f)


def _huber_weight(chi2, th):
    """IRLS weight for Huber loss with threshold th (on chi2)."""
    return torch.where(chi2 <= th, torch.ones_like(chi2),
                       torch.sqrt(th / torch.clamp(chi2, min=1e-12)))


def _robust_cost(chi2, robust_th: float):
    """Huber rho on chi2 (plain chi2 when ``robust_th`` is 0)."""
    if robust_th > 0:
        return torch.where(
            chi2 <= robust_th, chi2,
            2.0 * torch.sqrt(robust_th * torch.clamp(chi2, min=0.0))
            - robust_th)
    return chi2


# dense reduced camera system up to this many poses; above it the
# matrix-free PCG path engages
DENSE_SCHUR_MAX_KFS = 64
_CG_ITERS = 100


def _residuals_jacobians(T_cw, points, obs_kf, obs_lm, obs_px, obs_cam,
                         params: BAParams):
    """All observation residuals + Jacobians in one pass.

    Returns r (O, 2), Jp (O, 2, 6), Jl (O, 2, 3), depth_ok (O,).
    """
    Tk = T_cw[obs_kf]
    X = points[obs_lm]
    p_left = lie.pose_apply(Tk, X)

    is_right = (obs_cam == 1)[:, None]
    p_cam = torch.where(is_right,
                        lie.pose_apply(params.T_rl[None], p_left), p_left)

    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    depth_ok = z > 1e-3
    zs = torch.where(z.abs() < 1e-3, torch.full_like(z, 1e-3), z)
    u = params.fx * x / zs + params.cx
    v = params.fy * y / zs + params.cy
    r = torch.stack([u, v], -1) - obs_px

    iz = 1.0 / zs
    zero = torch.zeros_like(iz)
    Jproj = torch.stack([
        params.fx * iz, zero, -params.fx * x * iz * iz,
        zero, params.fy * iz, -params.fy * y * iz * iz,
    ], -1).reshape(-1, 2, 3)
    # dp_cam/d(left-cam point): I for left obs, R_rl for right obs
    R_rl = lie.quat_to_matrix(lie.pose_q(params.T_rl))
    eye3 = torch.eye(3, dtype=p_left.dtype, device=p_left.device)
    Jp_cam = torch.where(is_right[..., None], R_rl[None], eye3[None])
    Jpi = Jproj @ Jp_cam                       # (O, 2, 3) d r / d p_left

    # d p_left / d δξ (left-mult on T_cw) = [I | -hat(p_left)]
    Jpose = torch.cat([Jpi, -Jpi @ lie.so3_hat(p_left)], dim=-1)
    # d p_left / d X = R_cw
    Jpoint = Jpi @ lie.quat_to_matrix(lie.pose_q(Tk))
    return r, Jpose, Jpoint, depth_ok


def _bins(Kw, Lw, obs_kf, obs_lm):
    """The problem's sums, each index sorted once: ``pose`` and ``lm`` bin
    the observation rows by pose and by landmark, and for windows on the
    dense branch ``lp`` by (landmark, pose)."""
    bins = dict(pose=SegmentSum(obs_kf, Kw), lm=SegmentSum(obs_lm, Lw))
    if Kw <= DENSE_SCHUR_MAX_KFS:
        bins["lp"] = SegmentSum(obs_lm * Kw + obs_kf, Lw * Kw)
    return bins


def _schur_pcg(Hpp_d, bp, Hll_inv, bl, Wo, obs_kf, obs_lm, free_pose,
               bins, n_iters: int = _CG_ITERS):
    """Matrix-free block-Jacobi-preconditioned CG on the Schur complement
    S x = (Hpp_d − Σ_l W_l Hll⁻¹ W_lᵀ) x (the reference's full-BA scale,
    `optimizer.cpp:1674-2332`). Returns the pose steps (Kw, 6)."""
    free = free_pose[:, None] > 0

    def schur_corr(v_lm):              # Σ_o W_o Hll⁻¹ v_lm[obs_lm]
        t = torch.einsum("lab,lb->la", Hll_inv, v_lm)
        return bins["pose"](torch.einsum("oab,ob->oa", Wo, t[obs_lm]))

    def matvec(x):                     # x (Kw, 6)
        x = torch.where(free, x, torch.zeros_like(x))
        y = bins["lm"](torch.einsum("oab,oa->ob", Wo, x[obs_kf]))
        out = torch.einsum("kab,kb->ka", Hpp_d, x) - schur_corr(y)
        return torch.where(free, out, x)

    b = bp - schur_corr(bl)
    b = torch.where(free, b, torch.zeros_like(b))

    # block-Jacobi preconditioner from the (damped) pose Hessian diagonal
    eyeK = torch.eye(6, dtype=bp.dtype, device=bp.device)
    M_inv, _ = torch.linalg.inv_ex(Hpp_d + 1e-6 * eyeK[None])
    M_inv = torch.where(free[..., None], M_inv, eyeK[None])

    def precond(v):
        return torch.einsum("kab,kb->ka", M_inv, v)

    x = torch.zeros_like(b)
    res = b
    z = precond(res)
    p = z
    rz = torch.sum(res * z)
    zero = torch.zeros((), dtype=bp.dtype, device=bp.device)
    for _ in range(n_iters):
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(denom.abs() > 1e-20, rz / denom, zero)
        x = x + alpha * p
        res = res - alpha * Ap
        z = precond(res)
        rz_new = torch.sum(res * z)
        beta = torch.where(rz.abs() > 1e-20, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return torch.where(free, x, torch.zeros_like(x))


def _solve_normal_iteration(T_cw, points, lam, obs_kf, obs_lm, obs_px,
                            obs_cam, w_obs, free_pose, params, bins=None):
    """One damped Schur-LM step. Returns (new_T_cw, new_points); ``bins``
    (from :func:`_bins`) are built here when the caller has none."""
    Kw = T_cw.shape[0]
    Lw = points.shape[0]
    if bins is None:
        bins = _bins(Kw, Lw, obs_kf, obs_lm)

    r, Jp, Jl, depth_ok = _residuals_jacobians(
        T_cw, points, obs_kf, obs_lm, obs_px, obs_cam, params)
    w = w_obs * depth_ok
    # zero out Jacobians of gauge-fixed poses
    Jp = Jp * free_pose[obs_kf][:, None, None]
    wJp = Jp * w[:, None, None]
    wJl = Jl * w[:, None, None]

    # block accumulations (each observation touches one pose)
    Hpp = bins["pose"](torch.einsum("oik,oil->okl", wJp, Jp))
    Hll = bins["lm"](torch.einsum("oik,oil->okl", wJl, Jl))
    bp = bins["pose"](-torch.einsum("oik,oi->ok", wJp, r))
    bl = bins["lm"](-torch.einsum("oik,oi->ok", wJl, r))

    # LM damping (multiplicative on the diagonal)
    eyeK = torch.eye(6, dtype=r.dtype, device=r.device)
    eyeL = torch.eye(3, dtype=r.dtype, device=r.device)
    Hll_d = Hll + (lam * torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1),
                                     min=1e-6))[..., None] * eyeL[None]
    Hpp_d = Hpp + (lam * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1),
                                     min=1e-6))[..., None] * eyeK[None]
    Hll_inv, _ = torch.linalg.inv_ex(Hll_d + 1e-8 * eyeL[None])

    # per-observation cross blocks W_o = Jpᵀ w Jl
    Wo = torch.einsum("oik,oil->okl", wJp, Jl)          # (O, 6, 3)

    if Kw > DENSE_SCHUR_MAX_KFS:
        # matrix-free PCG at full-BA scale; inner iterations scale with
        # the pose count (a chain-like covisibility graph passes
        # information O(1) poses per iteration)
        dx_pose = _schur_pcg(Hpp_d, bp, Hll_inv, bl, Wo, obs_kf, obs_lm,
                             free_pose, bins,
                             n_iters=min(max(100, 2 * Kw), 600))
        corr = bins["lm"](torch.einsum("oab,oa->ob", Wo, dx_pose[obs_kf]))
        dx_lm = torch.einsum("lab,lb->la", Hll_inv, bl - corr)
        new_T_cw = lie.pose_left_update(T_cw, dx_pose * free_pose[:, None])
        return new_T_cw, points + dx_lm

    Z = bins["lp"](Wo).reshape(Lw, Kw, 6, 3)
    # Schur complement S = Hpp_d - Σ_l Z_l Hll_inv_l Z_lᵀ
    ZH = torch.einsum("lkab,lbc->lkac", Z, Hll_inv)
    S = -torch.einsum("lkac,lqdc->kqad", ZH, Z)          # (Kw, Kw, 6, 6)
    ar = torch.arange(Kw, device=r.device)
    S[ar, ar] += Hpp_d
    # identity-pad rows/cols of fixed or unobserved poses
    fp = free_pose > 0
    S = torch.where((fp[:, None] & fp[None, :])[..., None, None], S,
                    torch.zeros_like(S))
    S[ar, ar] += (~fp).to(r.dtype)[:, None, None] * eyeK[None]
    b_schur = (bp - torch.einsum("lkac,lc->ka", ZH, bl)) * free_pose[:, None]

    Sd = S.permute(0, 2, 1, 3).reshape(Kw * 6, Kw * 6)
    dx_pose, _ = torch.linalg.solve_ex(
        Sd + 1e-6 * torch.eye(Kw * 6, dtype=r.dtype, device=r.device),
        b_schur.reshape(Kw * 6, 1))
    dx_pose = dx_pose.reshape(Kw, 6)

    # back-substitute landmarks: dX = Hll_inv (bl - Σ_k Zᵀ dx_k)
    corr = torch.einsum("lkab,ka->lb", Z, dx_pose)
    dx_lm = torch.einsum("lab,lb->la", Hll_inv, bl - corr)
    new_T_cw = lie.pose_left_update(T_cw, dx_pose * free_pose[:, None])
    return new_T_cw, points + dx_lm


def _total_cost(T_cw, points, obs_kf, obs_lm, obs_px, obs_cam, w_obs,
                params, robust_th):
    r, _, _, depth_ok = _residuals_jacobians(
        T_cw, points, obs_kf, obs_lm, obs_px, obs_cam, params)
    return torch.sum(_robust_cost(torch.sum(r * r, -1), robust_th)
                     * w_obs * depth_ok)


def ba_solve(
    kf_poses_wc, kf_fixed, lm_pos,
    obs_kf, obs_lm, obs_px, obs_cam, obs_valid,
    params: BAParams,
    robust_th: float = 5.9915,
    iters: int = 5,
    lam0: float = 1e-3,
    between_iters=None,
):
    """Windowed bundle adjustment (local, loose and full BA).

    Args (tensors on one device):
      kf_poses_wc: (Kw, 7) world-from-camera poses.
      kf_fixed: (Kw,) bool — gauge-fixed.
      lm_pos: (Lw, 3) world landmarks.
      obs_*: padded observation table (indices into the window arrays;
        obs_kf < 0 for padding).
      robust_th: Huber threshold on chi2 (5.9915 = 95% 2-DoF,
        `optimizer.cpp:47-49`); 0 disables (pure L2 pass).
      iters: LM iterations (reference budget: 5, `optimizer.cpp:460`).
      between_iters: called with no arguments after each LM iteration
        (the asynchronous worker hands the map lock to a waiting frame
        there).

    Returns (new_kf_poses_wc (Kw, 7), new_lm_pos (Lw, 3),
    obs_inlier (O,) bool — chi2 <= robust gate & positive depth,
    final_cost ()).
    """
    f32 = torch.float32
    dev = kf_poses_wc.device
    obs_kf_c = torch.clamp(obs_kf.long(), min=0)
    obs_lm_c = torch.clamp(obs_lm.long(), min=0)
    obs_px = obs_px.to(f32)

    # recenter on the first pose to keep f32 well-conditioned
    poses = kf_poses_wc.to(f32)
    center = poses[0, 4:7].clone()
    T_cw = lie.pose_inverse(torch.cat([poses[:, :4], poses[:, 4:7] - center],
                                      dim=-1))
    points = lm_pos.to(f32) - center
    free = (~kf_fixed).to(f32)
    w_valid = obs_valid.to(f32)

    bins = _bins(T_cw.shape[0], points.shape[0], obs_kf_c, obs_lm_c)
    lam = torch.tensor(lam0, dtype=f32, device=dev)
    cost1 = torch.zeros((), dtype=f32, device=dev)
    for _ in range(iters):
        # Huber IRLS weights at the current state; cost0 reuses this pass
        r, _, _, depth_ok = _residuals_jacobians(
            T_cw, points, obs_kf_c, obs_lm_c, obs_px, obs_cam, params)
        chi2 = torch.sum(r * r, -1)
        w_rob = (_huber_weight(chi2, robust_th) if robust_th > 0
                 else torch.ones_like(chi2))
        w = w_valid * w_rob * depth_ok
        cost0 = torch.sum(_robust_cost(chi2, robust_th) * w_valid * depth_ok)
        T_new, p_new = _solve_normal_iteration(
            T_cw, points, lam, obs_kf_c, obs_lm_c, obs_px, obs_cam, w,
            free, params, bins)
        cost1 = _total_cost(T_new, p_new, obs_kf_c, obs_lm_c, obs_px,
                            obs_cam, w_valid, params, robust_th)
        accept = cost1 < cost0
        T_cw = torch.where(accept, T_new, T_cw)
        points = torch.where(accept, p_new, points)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 4.0, max=1e2))
        if between_iters is not None:
            between_iters()

    # final outlier classification (chi2 gate + positive depth,
    # `optimizer.cpp:492-592`)
    r, _, _, depth_ok = _residuals_jacobians(
        T_cw, points, obs_kf_c, obs_lm_c, obs_px, obs_cam, params)
    chi2 = torch.sum(r * r, -1)
    gate = robust_th if robust_th > 0 else 5.9915
    inlier = obs_valid & (chi2 <= gate) & depth_ok

    out = lie.pose_inverse(T_cw)
    out_poses = torch.cat([out[:, :4], out[:, 4:7] + center], dim=-1)
    return out_poses, points + center, inlier, cost1


def ba_solve_two_pass(
    kf_poses_wc, kf_fixed, lm_pos,
    obs_kf, obs_lm, obs_px, obs_cam, obs_valid,
    params: BAParams,
    robust_th: float = 5.9915,
    iters_robust: int = 5,
    iters_l2: int = 3,
    between_iters=None,
):
    """Robust pass → chi2 outlier removal → L2 refinement on inliers
    (`apply_l2_after_robust`, `optimizer.cpp:600-627`)."""
    poses, points, inlier, _ = ba_solve(
        kf_poses_wc, kf_fixed, lm_pos, obs_kf, obs_lm, obs_px, obs_cam,
        obs_valid, params, robust_th=robust_th, iters=iters_robust,
        between_iters=between_iters)
    poses, points, inlier2, cost = ba_solve(
        poses, kf_fixed, points, obs_kf, obs_lm, obs_px, obs_cam,
        obs_valid & inlier, params, robust_th=0.0, iters=iters_l2,
        between_iters=between_iters)
    return poses, points, inlier & inlier2, cost
