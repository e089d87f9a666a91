"""Anchored inverse-depth Schur-LM bundle adjustment.

Port of ``ov2slam_tpu/solvers/ba_invdepth.py`` (the reference's
``buse_inv_depth`` mode: `KSE3AnchInvDepth` / `RightCamKSE3AnchInvDepth`
costs, `se3left_parametrization.hpp:171-274`, problem assembly
`optimizer.cpp:207-290`).

World point of landmark l anchored to KF a with measured normalized ray
``m = ((u-cx)/fx, (v-cy)/fy, 1)``:

    X_w = T_wc[a] @ (m / rho)

Each observation depends on two poses (observer and anchor) plus the
scalar rho. The Schur trick keeps a scalar landmark Hessian and a dense
pose-pose Hessian (Kw, Kw, 6, 6) for local windows; windows above
``DENSE_SCHUR_MAX_KFS`` poses take the matrix-free PCG path. Every
pose- or landmark-indexed sum is a segmented sum over the observation rows,
sorted by bin once per solve (``segment.SegmentSum``: the same order on
every run, unlike ``index_add_``'s CUDA atomics); the JAX package
accumulates them as one-hot GEMMs on the TPU.

Analytic Jacobians for both pose charts (left-multiplicative update on
T_cw):
    d p_obs / d dxi_obs  =  [I | -hat(p_obs)]
    d X_w  / d dxi_anch  = -R_wc_a [I | -hat(p_anch)]
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import lie, lie_np
from .ba import DENSE_SCHUR_MAX_KFS, BAParams, _huber_weight, _robust_cost
from .segment import SegmentSum


def invdepth_state(prob, params: BAParams):
    """Host-side derivation of the inverse-depth state for a BAProblem.

    rho = 1 / depth of the current landmark estimate in its anchor camera;
    the anchor ray comes from the *measured* anchor pixel. Landmarks
    without a usable in-window anchor have their observations masked out.

    Returns (rho (Lw,), ray (Lw, 2), masked obs_valid (O,)) as numpy.
    """
    anchor = np.maximum(prob.lm_anchor, 0)
    T_cw_a = lie_np.pose_inverse(prob.kf_poses[anchor].astype(np.float64))
    p_anch = lie_np.pose_apply(T_cw_a, prob.lm_pos.astype(np.float64))
    z = np.maximum(p_anch[:, 2], 1e-3)
    rho = (1.0 / z).astype(np.float32)
    fx, fy, cx, cy = params.intr
    ray = np.stack([(prob.lm_anchor_px[:, 0] - cx) / fx,
                    (prob.lm_anchor_px[:, 1] - cy) / fy],
                   -1).astype(np.float32)
    lm_ok = (prob.lm_anchor >= 0) & (prob.lm_ids >= 0)
    obs_valid = prob.obs_valid & lm_ok[np.maximum(prob.obs_lm, 0)]
    return rho, ray, obs_valid


def _landmark_points(T_cw, lm_rho, lm_anchor, lm_ray):
    """World positions from inverse-depth state.

    Returns (X_w (Lw, 3), p_anch (Lw, 3) anchor-cam points, R_wc_a (Lw,3,3)).
    """
    rho = torch.clamp(lm_rho, min=1e-6)
    m = torch.cat([lm_ray, torch.ones_like(lm_ray[..., :1])], -1)
    p_anch = m / rho[:, None]
    T_wc_a = lie.pose_inverse(T_cw[lm_anchor])
    X_w = lie.pose_apply(T_wc_a, p_anch)
    R_wc_a = lie.quat_to_matrix(lie.pose_q(T_wc_a))
    return X_w, p_anch, R_wc_a


def _residuals_jacobians_inv(T_cw, lm_rho, lm_anchor, lm_ray,
                             obs_kf, obs_lm, obs_px, obs_cam,
                             params: BAParams):
    """Residuals + analytic Jacobians for every observation.

    Returns r (O,2), J_obs (O,2,6), J_anch (O,2,6), J_rho (O,2), depth_ok.
    """
    X_w, p_anch_all, R_wc_a_all = _landmark_points(
        T_cw, lm_rho, lm_anchor, lm_ray)

    Tk = T_cw[obs_kf]
    X = X_w[obs_lm]
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
    R_rl = lie.quat_to_matrix(lie.pose_q(params.T_rl))
    eye3 = torch.eye(3, dtype=p_left.dtype, device=p_left.device)
    Jp_cam = torch.where(is_right[..., None], R_rl[None], eye3[None])
    Jpi = Jproj @ Jp_cam                       # (O, 2, 3) d r / d p_left

    hat_pl = lie.so3_hat(p_left)
    J_obs = torch.cat([Jpi, -Jpi @ hat_pl], dim=-1)            # (O, 2, 6)

    R_cw = lie.quat_to_matrix(lie.pose_q(Tk))
    J_Xw = Jpi @ R_cw                           # (O, 2, 3)

    p_anch = p_anch_all[obs_lm]
    R_wc_a = R_wc_a_all[obs_lm]
    hat_pa = lie.so3_hat(p_anch)
    J_anch_local = torch.cat([eye3.expand(hat_pa.shape), -hat_pa], dim=-1)
    J_anch = -J_Xw @ (R_wc_a @ J_anch_local)    # (O, 2, 6)

    rho = torch.clamp(lm_rho, min=1e-6)[obs_lm]
    dXw_drho = -torch.einsum("oab,ob->oa", R_wc_a, p_anch) / rho[:, None]
    J_rho = torch.einsum("oab,ob->oa", J_Xw, dXw_drho)          # (O, 2)

    return r, J_obs, J_anch, J_rho, depth_ok


def _total_cost_inv(T_cw, lm_rho, lm_anchor, lm_ray, obs_kf, obs_lm,
                    obs_px, obs_cam, w_obs, params, robust_th):
    r, _, _, _, depth_ok = _residuals_jacobians_inv(
        T_cw, lm_rho, lm_anchor, lm_ray, obs_kf, obs_lm, obs_px, obs_cam,
        params)
    return torch.sum(_robust_cost(torch.sum(r * r, -1), robust_th)
                     * w_obs * depth_ok)


def _bins(Kw, Lw, obs_kf, anch_kf, obs_lm):
    """The problem's sums, each index sorted once: ``pose`` bins the
    observer rows followed by the anchor rows, ``lm`` the landmark rows,
    and for windows on the dense branch ``pp`` and ``lp`` the (pose, pose)
    and (landmark, pose) blocks."""
    bins = dict(pose=SegmentSum(torch.cat([obs_kf, anch_kf]), Kw),
                lm=SegmentSum(obs_lm, Lw))
    if Kw <= DENSE_SCHUR_MAX_KFS:
        bins["pp"] = SegmentSum(torch.cat([
            obs_kf * Kw + obs_kf, obs_kf * Kw + anch_kf,
            anch_kf * Kw + obs_kf, anch_kf * Kw + anch_kf]), Kw * Kw)
        bins["lp"] = SegmentSum(torch.cat([
            obs_lm * Kw + obs_kf, obs_lm * Kw + anch_kf]), Lw * Kw)
    return bins


def _solve_iteration_inv_cg(T_cw, lm_rho, lam, anch_kf, obs_kf, obs_lm,
                            w, free_pose, r, J_obs, J_anch, J_rho,
                            wJ_obs, wJ_anch, wJ_rho, Hrr, brho, bins,
                            n_iters: int = 100):
    """Matrix-free PCG step for windows above DENSE_SCHUR_MAX_KFS poses
    (poses + scalar inverse depths): every S·x product is O(obs)
    gather/segmented-sum work, and neither the (Kw, Kw, 6, 6) pose
    Hessian nor a landmark-pose cross tensor is materialized."""
    free = free_pose[:, None] > 0
    eyeK = torch.eye(6, dtype=r.dtype, device=r.device)

    def pose_sum(v_obs, v_anch):        # Σ by observer plus Σ by anchor
        return bins["pose"](torch.cat([v_obs, v_anch]))

    # per-observation cross vectors g = Jposeᵀ w J_rho (6,)
    g_obs = torch.einsum("oik,oi->ok", wJ_obs, J_rho)
    g_anch = torch.einsum("oik,oi->ok", wJ_anch, J_rho)
    same = (obs_kf == anch_kf)[:, None].to(r.dtype)

    bp = pose_sum(-torch.einsum("oik,oi->ok", wJ_obs, r),
                  -torch.einsum("oik,oi->ok", wJ_anch, r))
    diag = pose_sum(torch.einsum("oik,oik->ok", wJ_obs, J_obs)
                    + 2.0 * same * torch.einsum("oik,oik->ok", wJ_obs, J_anch),
                    torch.einsum("oik,oik->ok", wJ_anch, J_anch))

    Hrr_d = Hrr + lam * torch.clamp(Hrr, min=1e-6) + 1e-8
    damp = lam * torch.clamp(diag, min=1e-6)

    def matvec(x):                                    # S·x, x (Kw, 6)
        x = torch.where(free, x, torch.zeros_like(x))
        a = (torch.einsum("oik,ok->oi", J_obs, x[obs_kf])
             + torch.einsum("oik,ok->oi", J_anch, x[anch_kf]))  # (O, 2)
        out = pose_sum(torch.einsum("oik,oi->ok", wJ_obs, a),
                       torch.einsum("oik,oi->ok", wJ_anch, a))
        out = out + damp * x
        # Schur correction: − Z Hrr⁻¹ Zᵀ x
        y = bins["lm"](torch.einsum("ok,ok->o", g_obs, x[obs_kf])
                       + torch.einsum("ok,ok->o", g_anch, x[anch_kf]))
        t = (y / Hrr_d)[obs_lm][:, None]
        out = out - pose_sum(g_obs * t, g_anch * t)
        return torch.where(free, out, x)

    tb = (brho / Hrr_d)[obs_lm][:, None]
    b = bp - pose_sum(g_obs * tb, g_anch * tb)
    b = torch.where(free, b, torch.zeros_like(b))

    # block-Jacobi preconditioner from the damped pose-Hessian diagonal
    # blocks (cross obs/anchor terms included where the two coincide)
    cross = torch.einsum("oik,oil->okl", wJ_obs, J_anch) * same[..., None]
    Dp = pose_sum(torch.einsum("oik,oil->okl", wJ_obs, J_obs)
                  + cross + cross.transpose(1, 2),
                  torch.einsum("oik,oil->okl", wJ_anch, J_anch))
    Dp = Dp + damp[..., None] * eyeK[None] + 1e-6 * eyeK[None]
    M_inv, _ = torch.linalg.inv_ex(Dp)
    M_inv = torch.where(free[..., None], M_inv, eyeK[None])

    def precond(v):
        return torch.einsum("kab,kb->ka", M_inv, v)

    x = torch.zeros_like(b)
    res = b
    z = precond(b)
    p = z
    rz = torch.sum(b * z)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
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
    dx_pose = torch.where(free, x, torch.zeros_like(x))

    corr = bins["lm"](torch.einsum("ok,ok->o", g_obs, dx_pose[obs_kf])
                      + torch.einsum("ok,ok->o", g_anch, dx_pose[anch_kf]))
    d_rho = (brho - corr) / Hrr_d
    new_T_cw = lie.pose_left_update(T_cw, dx_pose)
    new_rho = torch.clamp(lm_rho + d_rho, min=1e-6)
    return new_T_cw, new_rho


def _solve_iteration_inv(T_cw, lm_rho, lam, lm_anchor, lm_ray,
                         obs_kf, obs_lm, obs_px, obs_cam, w, free_pose,
                         params, bins=None):
    """One damped Schur-LM step over (poses, rho); ``bins`` (from
    :func:`_bins`) are built here when the caller has none."""
    Kw = T_cw.shape[0]
    Lw = lm_rho.shape[0]

    r, J_obs, J_anch, J_rho, depth_ok = _residuals_jacobians_inv(
        T_cw, lm_rho, lm_anchor, lm_ray, obs_kf, obs_lm, obs_px, obs_cam,
        params)
    w = w * depth_ok
    anch_kf = lm_anchor[obs_lm]
    if bins is None:
        bins = _bins(Kw, Lw, obs_kf, anch_kf, obs_lm)

    # gauge: zero Jacobians of fixed poses
    J_obs = J_obs * free_pose[obs_kf][:, None, None]
    J_anch = J_anch * free_pose[anch_kf][:, None, None]

    wJ_obs = J_obs * w[:, None, None]
    wJ_anch = J_anch * w[:, None, None]
    wJ_rho = J_rho * w[:, None]

    Hrr = bins["lm"](torch.einsum("oi,oi->o", wJ_rho, J_rho))
    brho = bins["lm"](-torch.einsum("oi,oi->o", wJ_rho, r))

    if Kw > DENSE_SCHUR_MAX_KFS:
        return _solve_iteration_inv_cg(
            T_cw, lm_rho, lam, anch_kf, obs_kf, obs_lm, w, free_pose,
            r, J_obs, J_anch, J_rho, wJ_obs, wJ_anch, wJ_rho, Hrr, brho,
            bins, n_iters=min(max(100, 2 * Kw), 600))

    # dense accumulation: (Kw*Kw, 6, 6) pose blocks, (Lw*Kw, 6) cross rows
    HH = bins["pp"](torch.cat([
        torch.einsum("oik,oil->okl", wJ_obs, J_obs),
        torch.einsum("oik,oil->okl", wJ_obs, J_anch),
        torch.einsum("oik,oil->okl", wJ_anch, J_obs),
        torch.einsum("oik,oil->okl", wJ_anch, J_anch)]))
    Hpp = HH.reshape(Kw, Kw, 6, 6)
    bp = bins["pose"](torch.cat([
        -torch.einsum("oik,oi->ok", wJ_obs, r),
        -torch.einsum("oik,oi->ok", wJ_anch, r)]))
    Z = bins["lp"](torch.cat([
        torch.einsum("oik,oi->ok", wJ_obs, J_rho),
        torch.einsum("oik,oi->ok", wJ_anch, J_rho)])).reshape(Lw, Kw, 6)

    # LM damping
    eyeK = torch.eye(6, dtype=r.dtype, device=r.device)
    ar = torch.arange(Kw, device=r.device)
    diagH = torch.diagonal(Hpp[ar, ar], dim1=-2, dim2=-1)      # (Kw, 6)
    Hpp_d = Hpp.clone()
    Hpp_d[ar, ar] += (lam * torch.clamp(diagH, min=1e-6))[..., None] \
        * eyeK[None]
    Hrr_d = Hrr + lam * torch.clamp(Hrr, min=1e-6) + 1e-8

    # Schur: S = Hpp_d - sum_l Z_l Z_l^T / Hrr_d_l
    Zn = Z / Hrr_d[:, None, None]
    S = Hpp_d - torch.einsum("lka,lqb->kqab", Zn, Z)
    b_schur = bp - torch.einsum("lka,l->ka", Zn, brho)

    # identity-pad fixed/unobserved poses
    fp = free_pose > 0
    S = torch.where((fp[:, None] & fp[None, :])[..., None, None], S,
                    torch.zeros_like(S))
    S[ar, ar] += (~fp).to(r.dtype)[:, None, None] * eyeK[None]
    b_schur = b_schur * free_pose[:, None]

    Sd = S.permute(0, 2, 1, 3).reshape(Kw * 6, Kw * 6)
    dx_pose, _ = torch.linalg.solve_ex(
        Sd + 1e-6 * torch.eye(Kw * 6, dtype=r.dtype, device=r.device),
        b_schur.reshape(Kw * 6, 1))
    dx_pose = dx_pose.reshape(Kw, 6)

    corr = torch.einsum("lka,ka->l", Z, dx_pose)
    d_rho = (brho - corr) / Hrr_d
    new_T_cw = lie.pose_left_update(T_cw, dx_pose * free_pose[:, None])
    new_rho = torch.clamp(lm_rho + d_rho, min=1e-6)
    return new_T_cw, new_rho


def ba_solve_invdepth(
    kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray,
    obs_kf, obs_lm, obs_px, obs_cam, obs_valid,
    params: BAParams,
    robust_th: float = 5.9915,
    iters: int = 5,
    lam0: float = 1e-3,
):
    """Anchored inverse-depth windowed BA.

    Args (tensors on one device):
      kf_poses_wc: (Kw, 7) world-from-camera poses.
      kf_fixed: (Kw,) bool gauge-fixed flags.
      lm_rho: (Lw,) inverse depths (in the anchor camera).
      lm_anchor: (Lw,) int window index of the anchor KF.
      lm_ray: (Lw, 2) anchor normalized ray (mx, my) with mz = 1.
      obs_*: padded observation table (index -1 = padding).

    Returns (new_kf_poses_wc, new_lm_pos (Lw,3) world positions,
             new_lm_rho (Lw,), obs_inlier (O,), final_cost).
    """
    f32 = torch.float32
    dev = kf_poses_wc.device
    obs_kf_c = torch.clamp(obs_kf.long(), min=0)
    obs_lm_c = torch.clamp(obs_lm.long(), min=0)
    anchor_c = torch.clamp(lm_anchor.long(), min=0)
    obs_px = obs_px.to(f32)
    lm_ray = lm_ray.to(f32)

    poses = kf_poses_wc.to(f32)
    center = poses[0, 4:7].clone()
    T_cw = lie.pose_inverse(torch.cat([poses[:, :4], poses[:, 4:7] - center],
                                      dim=-1))
    rho = lm_rho.to(f32)
    free = (~kf_fixed).to(f32)
    w_valid = obs_valid.to(f32)

    bins = _bins(T_cw.shape[0], rho.shape[0], obs_kf_c, anchor_c[obs_lm_c],
                 obs_lm_c)
    lam = torch.tensor(lam0, dtype=f32, device=dev)
    cost1 = torch.zeros((), dtype=f32, device=dev)
    for _ in range(iters):
        r, _, _, _, depth_ok = _residuals_jacobians_inv(
            T_cw, rho, anchor_c, lm_ray, obs_kf_c, obs_lm_c, obs_px,
            obs_cam, params)
        chi2 = torch.sum(r * r, -1)
        w_rob = (_huber_weight(chi2, robust_th) if robust_th > 0
                 else torch.ones_like(chi2))
        w = w_valid * w_rob * depth_ok
        cost0 = torch.sum(_robust_cost(chi2, robust_th) * w_valid * depth_ok)
        T_new, rho_new = _solve_iteration_inv(
            T_cw, rho, lam, anchor_c, lm_ray, obs_kf_c, obs_lm_c, obs_px,
            obs_cam, w, free, params, bins)
        cost1 = _total_cost_inv(T_new, rho_new, anchor_c, lm_ray, obs_kf_c,
                                obs_lm_c, obs_px, obs_cam, w_valid, params,
                                robust_th)
        accept = cost1 < cost0
        T_cw = torch.where(accept, T_new, T_cw)
        rho = torch.where(accept, rho_new, rho)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 4.0, max=1e2))

    r, _, _, _, depth_ok = _residuals_jacobians_inv(
        T_cw, rho, anchor_c, lm_ray, obs_kf_c, obs_lm_c, obs_px, obs_cam,
        params)
    chi2 = torch.sum(r * r, -1)
    gate = robust_th if robust_th > 0 else 5.9915
    inlier = obs_valid & (chi2 <= gate) & depth_ok

    X_w, _, _ = _landmark_points(T_cw, rho, anchor_c, lm_ray)
    out = lie.pose_inverse(T_cw)
    out_poses = torch.cat([out[:, :4], out[:, 4:7] + center], dim=-1)
    return out_poses, X_w + center, rho, inlier, cost1


def ba_solve_invdepth_two_pass(
    kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray,
    obs_kf, obs_lm, obs_px, obs_cam, obs_valid,
    params: BAParams,
    robust_th: float = 5.9915,
    iters_robust: int = 5,
    iters_l2: int = 3,
):
    """Robust pass -> chi2 cull -> L2 refinement (`optimizer.cpp:600-627`)."""
    poses, _, rho, inlier, _ = ba_solve_invdepth(
        kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray,
        obs_kf, obs_lm, obs_px, obs_cam, obs_valid, params,
        robust_th=robust_th, iters=iters_robust)
    poses, pos, rho, inlier2, cost = ba_solve_invdepth(
        poses, kf_fixed, rho, lm_anchor, lm_ray,
        obs_kf, obs_lm, obs_px, obs_cam, obs_valid & inlier, params,
        robust_th=0.0, iters=iters_l2)
    return poses, pos, rho, inlier & inlier2, cost
