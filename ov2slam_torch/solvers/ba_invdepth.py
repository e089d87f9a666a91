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

On CUDA tensors the dense branch's LM step is two hand kernels around two
library calls: ``csrc/ba_normal_eq.cu`` (:func:`normal_equations`: the
rows' residuals, Jacobians and weights and every sum, in the sorted bins'
order; :func:`lm_accept`: the candidate's cost and the accept test) and
``csrc/ba_schur_step.cu`` (:func:`schur_step`: the damping and the
landmarks' elimination, then the Schur product by ``torch.addmm`` and the
LU by ``torch.linalg.solve_ex``, then the back-substitution and the pose
update). CPU tensors take their plain versions (``*_plain``), which keep
the arithmetic the step always had.

Analytic Jacobians for both pose charts (left-multiplicative update on
T_cw):
    d p_obs / d dxi_obs  =  [I | -hat(p_obs)]
    d X_w  / d dxi_anch  = -R_wc_a [I | -hat(p_anch)]
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes

import numpy as np
import torch

from .. import graphs
from ..graphs import Capture
from ..ops import launch as _chk
from ..utils import lie, lie_np
from .ba import DENSE_SCHUR_MAX_KFS, BAParams, _huber_weight, _robust_cost
from .segment import SegmentSum

# the solve's stages as profiler ranges (chip_smoke's phase ba splits a
# solve's device time by them): the plain arrangement's, then the kernels'
STAGES = ("ba.sorts", "ba.prepare", "ba.observations", "ba.weights_cost0",
          "ba.sums", "ba.damping_schur", "ba.pad", "ba.solve",
          "ba.backsub_update", "ba.cost1", "ba.accept", "ba.finish",
          "ba.normal_eq", "ba.schur_prepare", "ba.schur_product",
          "ba.schur_update", "ba.cost_accept")
_NO_RANGE = contextlib.nullcontext()


def _stage(name):
    """A profiler range ``name`` (one of :data:`STAGES`) while a profiler
    runs on this thread; otherwise nothing, at no dispatcher call."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


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


def _landmark_points(T_cw, lm_rho, lm_anchor, lm_ray, rotations=True):
    """World positions from inverse-depth state.

    Returns (X_w (Lw, 3), p_anch (Lw, 3) anchor-cam points, R_wc_a (Lw,3,3),
    None without ``rotations``).
    """
    rho = torch.clamp(lm_rho, min=1e-6)
    m = torch.cat([lm_ray, torch.ones_like(lm_ray[..., :1])], -1)
    p_anch = m / rho[:, None]
    T_wc_a = lie.pose_inverse(T_cw[lm_anchor])
    X_w = lie.pose_apply(T_wc_a, p_anch)
    R_wc_a = (lie.quat_to_matrix(lie.pose_q(T_wc_a)) if rotations
              else None)
    return X_w, p_anch, R_wc_a


def _project_inv(T_cw, lm_rho, lm_anchor, lm_ray, obs_kf, obs_lm, obs_px,
                 obs_cam, params: BAParams, rotations=True):
    """Residuals of every observation, depth_ok, and what the Jacobians
    reuse (the anchor rotations only with ``rotations``)."""
    X_w, p_anch_all, R_wc_a_all = _landmark_points(
        T_cw, lm_rho, lm_anchor, lm_ray, rotations)

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
    return r, depth_ok, (Tk, p_left, is_right, x, y, zs, p_anch_all,
                         R_wc_a_all)


def _residuals_jacobians_inv(T_cw, lm_rho, lm_anchor, lm_ray,
                             obs_kf, obs_lm, obs_px, obs_cam,
                             params: BAParams):
    """Residuals + analytic Jacobians for every observation.

    Returns r (O,2), J_obs (O,2,6), J_anch (O,2,6), J_rho (O,2), depth_ok.
    """
    r, depth_ok, (Tk, p_left, is_right, x, y, zs, p_anch_all,
                  R_wc_a_all) = _project_inv(
        T_cw, lm_rho, lm_anchor, lm_ray, obs_kf, obs_lm, obs_px, obs_cam,
        params)

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
    r, depth_ok, _ = _project_inv(
        T_cw, lm_rho, lm_anchor, lm_ray, obs_kf, obs_lm, obs_px, obs_cam,
        params, rotations=False)
    return torch.sum(_robust_cost(torch.sum(r * r, -1), robust_th)
                     * w_obs * depth_ok)


def _bins(Kw, Lw, obs_kf, anch_kf, obs_lm, drop=None):
    """The problem's sums, each index sorted once: ``pose`` bins the
    observer rows followed by the anchor rows, ``lm`` the landmark rows,
    and for windows on the dense branch ``pp`` and ``lp`` the (pose, pose)
    and (landmark, pose) blocks, with ``off`` holding each of the four's
    first sorted entry per bin (what the normal-equation kernel reads).
    Rows where ``drop`` is true (rows not valid: weight 0, so every term
    they add is 0) go to no bin; a window's padding rows, index -1
    clamped to 0, would otherwise all sum into the first bins."""
    with _stage("ba.sorts"):
        d2 = None if drop is None else torch.cat([drop, drop])
        d4 = None if drop is None else torch.cat([d2, d2])
        bins = dict(pose=SegmentSum(torch.cat([obs_kf, anch_kf]), Kw, d2),
                    lm=SegmentSum(obs_lm, Lw, drop))
        if Kw <= DENSE_SCHUR_MAX_KFS:
            bins["pp"] = SegmentSum(torch.cat([
                obs_kf * Kw + obs_kf, obs_kf * Kw + anch_kf,
                anch_kf * Kw + obs_kf, anch_kf * Kw + anch_kf]), Kw * Kw,
                d4)
            bins["lp"] = SegmentSum(torch.cat([
                obs_lm * Kw + obs_kf, obs_lm * Kw + anch_kf]), Lw * Kw, d2)
            bins["off"] = {
                k: torch.cat([bins[k].lengths.new_zeros(1), torch.cumsum(
                    bins[k].lengths[:bins[k].n], 0)]) for k in BIN_NAMES}
        return bins


def _solve_iteration_inv_cg(T_cw, lm_rho, lam, anch_kf, obs_kf, obs_lm,
                            w, free_pose, r, J_obs, J_anch, J_rho,
                            wJ_obs, wJ_anch, wJ_rho, Hrr, brho, bins,
                            n_iters: int = 100):
    """Matrix-free PCG step for windows above DENSE_SCHUR_MAX_KFS poses
    (poses + scalar inverse depths): every S·x product is O(obs)
    gather/segmented-sum work, and neither the (Kw, Kw, 6, 6) pose
    Hessian nor a landmark-pose cross tensor is materialized. Counts its
    calls on ``_solve_iteration_inv_cg.calls`` (the bench checks that its
    200-keyframe solve took this branch)."""
    _solve_iteration_inv_cg.calls += 1
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


_solve_iteration_inv_cg.calls = 0


def _weights_cost0(r, depth_ok, w_valid, robust_th):
    """The rows' IRLS weights (Huber with ``robust_th`` > 0, else 1, times
    ``w_valid`` and the depth flags) and the state's robust cost."""
    chi2 = torch.sum(r * r, -1)
    w_rob = (_huber_weight(chi2, robust_th) if robust_th > 0
             else torch.ones_like(chi2))
    return (w_valid * w_rob * depth_ok,
            torch.sum(_robust_cost(chi2, robust_th) * w_valid * depth_ok))


def _gauge_weights(rj, w, free_pose, obs_kf, anch_kf):
    """The Jacobians with fixed poses' zeroed (the gauge), the weights
    with the depth flags, and the weighted Jacobians."""
    r, J_obs, J_anch, J_rho, depth_ok = rj
    w = w * depth_ok
    J_obs = J_obs * free_pose[obs_kf][:, None, None]
    J_anch = J_anch * free_pose[anch_kf][:, None, None]
    return (r, J_obs, J_anch, J_rho, w, J_obs * w[:, None, None],
            J_anch * w[:, None, None], J_rho * w[:, None])


def _solve_iteration_inv(T_cw, lm_rho, lam, lm_anchor, lm_ray,
                         obs_kf, obs_lm, obs_px, obs_cam, w, free_pose,
                         params, bins=None, rj=None):
    """One damped Schur-LM step over (poses, rho) for a window above
    DENSE_SCHUR_MAX_KFS poses: the PCG step, in plain torch (a dense
    window's step is :func:`normal_equations` and :func:`schur_step`).
    ``bins`` (from :func:`_bins`) are built here when the caller has none,
    and ``rj`` (:func:`_residuals_jacobians_inv` at this state) likewise."""
    Kw = T_cw.shape[0]
    Lw = lm_rho.shape[0]

    if rj is None:
        rj = _residuals_jacobians_inv(
            T_cw, lm_rho, lm_anchor, lm_ray, obs_kf, obs_lm, obs_px,
            obs_cam, params)
    anch_kf = lm_anchor[obs_lm]
    if bins is None:
        bins = _bins(Kw, Lw, obs_kf, anch_kf, obs_lm)
    r, J_obs, J_anch, J_rho, w, wJ_obs, wJ_anch, wJ_rho = _gauge_weights(
        rj, w, free_pose, obs_kf, anch_kf)

    Hrr = bins["lm"](torch.einsum("oi,oi->o", wJ_rho, J_rho))
    brho = bins["lm"](-torch.einsum("oi,oi->o", wJ_rho, r))
    return _solve_iteration_inv_cg(
        T_cw, lm_rho, lam, anch_kf, obs_kf, obs_lm, w, free_pose,
        r, J_obs, J_anch, J_rho, wJ_obs, wJ_anch, wJ_rho, Hrr, brho,
        bins, n_iters=min(max(100, 2 * Kw), 600))


# ---------------------------------------------------------------------------
# The dense branch's LM step as two hand kernels on CUDA tensors
# (csrc/ba_normal_eq.cu, csrc/ba_schur_step.cu) around the Schur product and
# the 6Kw solve; the plain versions below are the CPU's, with the arithmetic
# the step always had.
# ---------------------------------------------------------------------------

def normal_equations_plain(T_cw, rho, anchor, lm_ray, obs_kf, obs_lm,
                           obs_px, right, w_valid, free, bins, params,
                           robust_th):
    """The normal equations of one LM state, in plain torch: every
    observation row's reprojection, Jacobians (observer, anchor, inverse
    depth; the right camera through ``T_rl``), Huber IRLS weight
    (``robust_th`` > 0) or 1 and the gauge of fixed poses, summed by bin.

    ``right``: (O,) bool, the right camera's rows; ``w_valid`` (O,) f32;
    ``free`` (Kw,) f32; ``bins`` from :func:`_bins` (dense).
    Returns (Hpp (Kw, Kw, 6, 6), bp (Kw, 6), Z (Lw, Kw, 6), Hrr (Lw,),
    brho (Lw,), robust cost ())."""
    if T_cw.is_cuda:
        normal_equations_plain.cuda_runs += 1
    Kw, Lw = T_cw.shape[0], rho.shape[0]
    with _stage("ba.observations"):
        rj = _residuals_jacobians_inv(T_cw, rho, anchor, lm_ray, obs_kf,
                                      obs_lm, obs_px, right, params)
    with _stage("ba.weights_cost0"):
        w, cost0 = _weights_cost0(rj[0], rj[4], w_valid, robust_th)
        r, J_obs, J_anch, J_rho, w, wJ_obs, wJ_anch, wJ_rho = \
            _gauge_weights(rj, w, free, obs_kf, anchor[obs_lm])
    with _stage("ba.sums"):
        Hrr = bins["lm"](torch.einsum("oi,oi->o", wJ_rho, J_rho))
        brho = bins["lm"](-torch.einsum("oi,oi->o", wJ_rho, r))
        # Hpp with the observer-anchor cross blocks, bp, Z
        Hpp = bins["pp"](torch.cat([
            torch.einsum("oik,oil->okl", wJ_obs, J_obs),
            torch.einsum("oik,oil->okl", wJ_obs, J_anch),
            torch.einsum("oik,oil->okl", wJ_anch, J_obs),
            torch.einsum("oik,oil->okl", wJ_anch, J_anch)]))
        bp = bins["pose"](torch.cat([
            -torch.einsum("oik,oi->ok", wJ_obs, r),
            -torch.einsum("oik,oi->ok", wJ_anch, r)]))
        Z = bins["lp"](torch.cat([
            torch.einsum("oik,oi->ok", wJ_obs, J_rho),
            torch.einsum("oik,oi->ok", wJ_anch, J_rho)]))
    return (Hpp.reshape(Kw, Kw, 6, 6), bp, Z.reshape(Lw, Kw, 6), Hrr, brho,
            cost0)


def schur_step_plain(T_cw, rho, lam, Hpp, bp, Z, Hrr, brho, free):
    """The LM step from the normal equations, in plain torch: damping of
    Hpp's diagonal blocks and of Hrr, the landmarks eliminated (Schur
    complement), fixed poses identity-padded, the 6Kw solve, the inverse
    depths back-substituted, the left-multiplicative pose update and ρ
    clamped at 1e-6. Returns the candidate (T_cw (Kw, 7), rho (Lw,))."""
    if T_cw.is_cuda:
        schur_step_plain.cuda_runs += 1
    Kw = T_cw.shape[0]
    dt, dev = Hpp.dtype, Hpp.device
    with _stage("ba.damping_schur"):
        # LM damping
        eyeK = torch.eye(6, dtype=dt, device=dev)
        ar = torch.arange(Kw, device=dev)
        diagH = torch.diagonal(Hpp[ar, ar], dim1=-2, dim2=-1)  # (Kw, 6)
        Hpp_d = Hpp.clone()
        Hpp_d[ar, ar] += (lam * torch.clamp(diagH, min=1e-6))[..., None] \
            * eyeK[None]
        Hrr_d = Hrr + lam * torch.clamp(Hrr, min=1e-6) + 1e-8

        # Schur: S = Hpp_d - sum_l Z_l Z_l^T / Hrr_d_l
        Zn = Z / Hrr_d[:, None, None]
        S = Hpp_d - torch.einsum("lka,lqb->kqab", Zn, Z)
        b_schur = bp - torch.einsum("lka,l->ka", Zn, brho)

    with _stage("ba.pad"):
        # identity-pad fixed/unobserved poses
        fp = free > 0
        S = torch.where((fp[:, None] & fp[None, :])[..., None, None], S,
                        torch.zeros_like(S))
        S[ar, ar] += (~fp).to(dt)[:, None, None] * eyeK[None]
        b_schur = b_schur * free[:, None]

    with _stage("ba.solve"):
        Sd = S.permute(0, 2, 1, 3).reshape(Kw * 6, Kw * 6)
        dx_pose, _ = torch.linalg.solve_ex(
            Sd + 1e-6 * torch.eye(Kw * 6, dtype=dt, device=dev),
            b_schur.reshape(Kw * 6, 1))
        dx_pose = dx_pose.reshape(Kw, 6)

    with _stage("ba.backsub_update"):
        corr = torch.einsum("lka,ka->l", Z, dx_pose)
        d_rho = (brho - corr) / Hrr_d
        new_T_cw = lie.pose_left_update(T_cw, dx_pose * free[:, None])
        new_rho = torch.clamp(rho + d_rho, min=1e-6)
    return new_T_cw, new_rho


def lm_accept_plain(T_cw, rho, lam, cost0, T_new, rho_new, anchor, lm_ray,
                    obs_kf, obs_lm, obs_px, right, w_valid, params,
                    robust_th):
    """The candidate's robust cost and the LM accept test, in plain torch:
    the candidate is kept where its cost is below ``cost0`` (λ halved,
    floor 1e-6), else the state stays (λ x4, ceiling 1e2). Returns (T_cw,
    rho, λ, the candidate's cost)."""
    if T_cw.is_cuda:
        lm_accept_plain.cuda_runs += 1
    return _accept(T_cw, rho, lam, cost0, T_new, rho_new, anchor, lm_ray,
                   obs_kf, obs_lm, obs_px, right, w_valid, params, robust_th)


def _accept(T_cw, rho, lam, cost0, T_new, rho_new, anchor, lm_ray, obs_kf,
            obs_lm, obs_px, right, w_valid, params, robust_th):
    with _stage("ba.cost1"):
        cost1 = _total_cost_inv(T_new, rho_new, anchor, lm_ray, obs_kf,
                                obs_lm, obs_px, right, w_valid, params,
                                robust_th)
    with _stage("ba.accept"):
        accept = cost1 < cost0
        return (torch.where(accept, T_new, T_cw),
                torch.where(accept, rho_new, rho),
                torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                            torch.clamp(lam * 4.0, max=1e2)),
                cost1)


# calls on CUDA tensors (the main path must make none)
normal_equations_plain.cuda_runs = 0
schur_step_plain.cuda_runs = 0
lm_accept_plain.cuda_runs = 0


def normal_equations(T_cw, rho, anchor, lm_ray, obs_kf, obs_lm, obs_px,
                     right, w_valid, free, bins, params, robust_th):
    """:func:`normal_equations_plain` for CPU tensors; on CUDA tensors one
    launch of ``csrc/ba_normal_eq.cu`` (its row pass and its bin sums) on
    the current stream, or raises (:func:`pack_normal_eq`)."""
    if _chk.device_of(T_cw, "normal_equations").type == "cpu":
        return normal_equations_plain(T_cw, rho, anchor, lm_ray, obs_kf,
                                      obs_lm, obs_px, right, w_valid, free,
                                      bins, params, robust_th)
    with _stage("ba.normal_eq"):
        a, Kw, Lw, O = pack_normal_eq(T_cw, rho, anchor, lm_ray, obs_kf,
                                      obs_lm, obs_px, right, w_valid, free,
                                      params, robust_th, bins=bins)
        new = T_cw.new_empty
        out = (new((Kw, Kw, 6, 6)), new((Kw, 6)), new((Lw, Kw, 6)),
               new(Lw), new(Lw), new(()))
        rows = new((O, ROW_FLOATS))
        for name, t in zip(("rows", "Hpp", "bp", "Z", "Hrr", "brho",
                            "cost"), (rows,) + out):
            setattr(a, name, t.data_ptr())
        _chk.run("ba_normal_eq", (ctypes.addressof(a),), normal_equations,
                 ("normal", Kw, Lw, O, robust_th > 0), T_cw.device)
        return out


def schur_step(T_cw, rho, lam, Hpp, bp, Z, Hrr, brho, free):
    """:func:`schur_step_plain` for CPU tensors; on CUDA tensors two
    launches of ``csrc/ba_schur_step.cu`` around the two library calls that
    stay: the first launch damps, eliminates and pads (S before the
    product, Zn, Hrr_d, b), then the Schur product ``Σ_l Zn_l Z_lᵀ``
    (``torch.addmm``, f32 with TF32 off, into S in the 6Kw layout the solve
    reads), ``torch.linalg.solve_ex`` (LU with partial pivoting), and the
    second launch back-substitutes and updates. Raises on what the kernel
    does not take (:func:`pack_schur_step`)."""
    if _chk.device_of(T_cw, "schur_step").type == "cpu":
        return schur_step_plain(T_cw, rho, lam, Hpp, bp, Z, Hrr, brho, free)
    a = pack_schur_step(T_cw, rho, lam, Hpp, bp, Z, Hrr, brho, free)
    Kw, Lw, n = a.Kw, a.Lw, 6 * a.Kw
    new, dev = T_cw.new_empty, T_cw.device
    S, Zn, Hrr_d, b = schur_prepare(a, T_cw)
    with _stage("ba.schur_product"):
        S.addmm_(Zn.view(-1, n).t(), Z.view(-1, n), alpha=-1.0)
    with _stage("ba.solve"):
        dx, _ = torch.linalg.solve_ex(S, b)
        if not dx.is_contiguous():
            raise ValueError("schur_step: the solve returned a strided "
                             "vector")
    with _stage("ba.schur_update"):
        T_new, rho_new = new((Kw, 7)), new(Lw)
        a.T_new, a.rho_new, a.dx = (t.data_ptr() for t in (T_new, rho_new,
                                                           dx))
        a.mode = SCHUR_UPDATE
        _chk.run("ba_schur_step", (ctypes.addressof(a),), schur_step,
                 ("update", Kw, Lw), dev)
    return T_new, rho_new


def schur_prepare(a, T_cw):
    """:func:`schur_step`'s first launch on the packed ``a``
    (:func:`pack_schur_step`) on the current stream: returns S before the
    Schur product (6Kw, 6Kw), Zn (Lw, Kw, 6), Hrr_d (Lw,) and b (6Kw, 1)."""
    Kw, Lw, n = a.Kw, a.Lw, 6 * a.Kw
    new = T_cw.new_empty
    with _stage("ba.schur_prepare"):
        S, Zn, Hrr_d, b = new((n, n)), new((Lw, Kw, 6)), new(Lw), new((n, 1))
        a.S, a.Zn, a.Hrr_d, a.b = (t.data_ptr() for t in (S, Zn, Hrr_d, b))
        a.mode = SCHUR_PREPARE
        _chk.run("ba_schur_step", (ctypes.addressof(a),), schur_step,
                 ("prepare", Kw, Lw), T_cw.device)
    return S, Zn, Hrr_d, b


def lm_accept(T_cw, rho, lam, cost0, T_new, rho_new, anchor, lm_ray,
              obs_kf, obs_lm, obs_px, right, w_valid, params, robust_th):
    """:func:`lm_accept_plain` for CPU tensors; on CUDA tensors one launch
    of ``csrc/ba_normal_eq.cu``'s cost mode (the candidate's rows, their
    robust cost summed in a fixed order, and the accept test on one CTA),
    or raises."""
    if _chk.device_of(T_cw, "lm_accept").type == "cpu":
        return lm_accept_plain(T_cw, rho, lam, cost0, T_new, rho_new,
                               anchor, lm_ray, obs_kf, obs_lm, obs_px, right,
                               w_valid, params, robust_th)
    with _stage("ba.cost_accept"):
        a, Kw, Lw, O = pack_normal_eq(T_new, rho_new, anchor, lm_ray,
                                      obs_kf, obs_lm, obs_px, right, w_valid,
                                      None, params, robust_th,
                                      state=(T_cw, rho, lam, cost0))
        new = T_cw.new_empty
        out = (new((Kw, 7)), new(Lw), new(()), new(()))
        rows = new(max(O, 1))
        for name, t in zip(("rows", "T_out", "rho_out", "lam_out", "cost"),
                           (rows,) + out):
            setattr(a, name, t.data_ptr())
        _chk.run("ba_normal_eq", (ctypes.addressof(a),), lm_accept,
                 ("cost", Kw, Lw, O, robust_th > 0), T_cw.device)
        return out


for _fn in (normal_equations, schur_step, lm_accept):
    # launches of the kernel, by (mode, sizes...), and by (thread, stream)
    _fn.launches = 0
    _fn.shapes = collections.Counter()
    _fn.origins = collections.Counter()

# the wrappers that count each library's launches, and the plain versions
# (these objects, whatever a caller puts in their module attributes)
KERNEL_WRAPPERS = {"ba_normal_eq": (normal_equations, lm_accept),
                   "ba_schur_step": (schur_step,)}
PLAIN_VERSIONS = (normal_equations_plain, schur_step_plain, lm_accept_plain)

# kernels each launch call starts: csrc/ba_normal_eq.cu's row pass and its
# sums (or the cost's reduction with the accept test); csrc/ba_schur_step.cu
# one (its prepare kernel or its update kernel)
KERNELS_PER_LAUNCH = {"ba_normal_eq": 2, "ba_schur_step": 1}
# csrc/ba_schur_step.cu's kChains: the chains each output of b is summed
# in (one over every 32nd landmark, then their partial sums in order)
SCHUR_B_CHAINS = 32
# the kernels' sizes: Kw up to the dense branch's; the rows and bins of one
# launch index with 32-bit ints
MAX_KFS = DENSE_SCHUR_MAX_KFS
MAX_ROWS = 1 << 27
BIN_NAMES = ("pose", "lm", "pp", "lp")
ROW_FLOATS = 32          # csrc/ba_normal_eq.cu's per-row record
SCHUR_PREPARE, SCHUR_UPDATE = 0, 1


class NormalEqArgs(ctypes.Structure):
    """``csrc/ba_normal_eq.cu``'s ``Args``, field for field: device
    pointers, then the mode (0 the normal equations, 1 the cost and the
    accept test), the sizes and the Huber threshold."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "T_cw", "rho", "anchor", "ray", "obs_kf", "obs_lm", "obs_px",
        "right", "w_valid", "free", "fx", "fy", "cx", "cy", "T_rl",
        "perm_pose", "perm_lm", "perm_pp", "perm_lp",
        "off_pose", "off_lm", "off_pp", "off_lp",
        "T_cur", "rho_cur", "lam", "cost0",
        "rows", "Hpp", "bp", "Z", "Hrr", "brho", "cost",
        "T_out", "rho_out", "lam_out")] + [
        ("mode", ctypes.c_int), ("Kw", ctypes.c_int), ("Lw", ctypes.c_int),
        ("O", ctypes.c_int), ("robust_th", ctypes.c_float)]


class SchurArgs(ctypes.Structure):
    """``csrc/ba_schur_step.cu``'s ``Args``, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "Hpp", "bp", "Z", "Hrr", "brho", "lam", "free", "T_cw", "rho",
        "dx", "S", "Zn", "Hrr_d", "b", "T_new", "rho_new")] + [
        ("mode", ctypes.c_int), ("Kw", ctypes.c_int), ("Lw", ctypes.c_int)]


def _sizes(fn, Kw, Lw, O):
    if not 1 <= Kw <= MAX_KFS:
        raise ValueError(f"{fn}: {Kw} poses; the kernel takes 1 to "
                         f"{MAX_KFS}")
    if Lw < 1 or 4 * O > MAX_ROWS or Lw * Kw * 6 > MAX_ROWS:
        raise ValueError(f"{fn}: {Lw} landmarks and {O} observations for "
                         f"{Kw} poses: above what the kernel indexes")


def pack_normal_eq(T_cw, rho, anchor, lm_ray, obs_kf, obs_lm, obs_px,
                   right, w_valid, free, params, robust_th, bins=None,
                   state=None):
    """Check the inputs of one ``ba_normal_eq`` launch and pack them: the
    normal equations with ``bins`` (:func:`_bins`' dense bins), or, with
    ``state`` = (T_cw, rho, λ, cost0) of the current state, the cost of
    the candidate (``T_cw``, ``rho``) and the accept test. Outputs are left
    to the caller. Raises TypeError on a dtype the kernel does not take
    (f32 state and calibration, int64 indices, a bool ``right``) and
    ValueError on another device, a tensor that is not contiguous, a
    shape, or sizes above :data:`MAX_KFS` poses or what the kernel
    indexes. Returns (args, Kw, Lw, O)."""
    fn = "normal_equations" if state is None else "lm_accept"
    dev = _chk.device_of(T_cw, fn)
    f32, i64 = torch.float32, torch.int64
    Kw = T_cw.shape[0] if T_cw.dim() == 2 else -1
    Lw = rho.shape[0] if rho.dim() == 1 else -1
    O = obs_kf.shape[0] if obs_kf.dim() == 1 else -1
    _sizes(fn, Kw, Lw, O)
    a = NormalEqArgs()
    for name, t, dt, shape in (
            ("T_cw", T_cw, f32, (Kw, 7)), ("rho", rho, f32, (Lw,)),
            ("anchor", anchor, i64, (Lw,)), ("ray", lm_ray, f32, (Lw, 2)),
            ("obs_kf", obs_kf, i64, (O,)), ("obs_lm", obs_lm, i64, (O,)),
            ("obs_px", obs_px, f32, (O, 2)),
            ("right", right, torch.bool, (O,)),
            ("w_valid", w_valid, f32, (O,)),
            ("T_rl", params.T_rl, f32, (7,))):
        _chk.check(fn, name, t, dt, dev, shape)
        setattr(a, name, t.data_ptr())
    for name in ("fx", "fy", "cx", "cy"):
        t = getattr(params, name)
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{fn}: params.{name} must be a tensor")
        _chk.check(fn, name, t, f32, dev)
        if t.numel() != 1:
            raise ValueError(f"{fn}: params.{name} must have one element")
        setattr(a, name, t.data_ptr())
    if state is None:
        _chk.check(fn, "free", free, f32, dev, (Kw,))
        a.free = free.data_ptr()
        if bins is None or "off" not in bins:
            raise ValueError(f"{fn}: needs the dense branch's bins")
        n_bins = dict(pose=Kw, lm=Lw, pp=Kw * Kw, lp=Lw * Kw)
        n_rows = dict(pose=2 * O, lm=O, pp=4 * O, lp=2 * O)
        for k in BIN_NAMES:
            perm, off = bins[k].perm, bins["off"][k]
            _chk.check(fn, f"bins[{k}].perm", perm, i64, dev, (n_rows[k],))
            _chk.check(fn, f"bins[off][{k}]", off, i64, dev,
                       (n_bins[k] + 1,))
            setattr(a, f"perm_{k}", perm.data_ptr())
            setattr(a, f"off_{k}", off.data_ptr())
        a.mode = 0
    else:
        T_cur, rho_cur, lam, cost0 = state
        for name, t, shape in (("T_cur", T_cur, (Kw, 7)),
                               ("rho_cur", rho_cur, (Lw,)),
                               ("lam", lam, ()), ("cost0", cost0, ())):
            _chk.check(fn, name, t, f32, dev, shape)
            setattr(a, name, t.data_ptr())
        a.mode = 1
    a.Kw, a.Lw, a.O = Kw, Lw, O
    a.robust_th = _chk.number(fn, "robust_th", robust_th)
    return a, Kw, Lw, O


def pack_schur_step(T_cw, rho, lam, Hpp, bp, Z, Hrr, brho, free):
    """Check the inputs of ``schur_step``'s launches and pack them (f32,
    contiguous, on one device; Kw up to :data:`MAX_KFS`). Outputs, the
    mode and the solve's vector are left to :func:`schur_step`."""
    fn = "schur_step"
    dev = _chk.device_of(T_cw, fn)
    Kw = T_cw.shape[0] if T_cw.dim() == 2 else -1
    Lw = rho.shape[0] if rho.dim() == 1 else -1
    _sizes(fn, Kw, Lw, 0)
    a = SchurArgs()
    for name, t, shape in (
            ("T_cw", T_cw, (Kw, 7)), ("rho", rho, (Lw,)), ("lam", lam, ()),
            ("Hpp", Hpp, (Kw, Kw, 6, 6)), ("bp", bp, (Kw, 6)),
            ("Z", Z, (Lw, Kw, 6)), ("Hrr", Hrr, (Lw,)),
            ("brho", brho, (Lw,)), ("free", free, (Kw,))):
        _chk.check(fn, name, t, torch.float32, dev, shape)
        setattr(a, name, t.data_ptr())
    a.Kw, a.Lw = Kw, Lw
    return a


def _prepare(kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray, obs_kf,
             obs_lm, obs_px, obs_valid, lam0, obs_cam):
    """The solve's state from its inputs: the poses centred on the first
    and inverted, the clamped indices, the right camera's rows, the sorted
    bins, λ and the cost."""
    with _stage("ba.prepare"):
        f32 = torch.float32
        dev = kf_poses_wc.device
        obs_kf_c = torch.clamp(obs_kf.long(), min=0)
        obs_lm_c = torch.clamp(obs_lm.long(), min=0)
        anchor_c = torch.clamp(lm_anchor.long(), min=0)
        poses = kf_poses_wc.to(f32)
        center = poses[0, 4:7].clone()
        T_cw = lie.pose_inverse(torch.cat([poses[:, :4], poses[:, 4:7] - center],
                                          dim=-1))
        return dict(
            # a copy: a graph's iteration writes the state in place
            T_cw=T_cw, rho=lm_rho.to(f32, copy=True), center=center,
            anchor=anchor_c,
            lm_ray=lm_ray.to(f32).contiguous(), obs_kf=obs_kf_c,
            obs_lm=obs_lm_c, obs_px=obs_px.to(f32).contiguous(),
            right=obs_cam == 1,
            obs_valid=obs_valid,
            w_valid=obs_valid.to(f32), free=(~kf_fixed).to(f32),
            bins=_bins(T_cw.shape[0], lm_rho.shape[0], obs_kf_c,
                       anchor_c[obs_lm_c], obs_lm_c, drop=~obs_valid),
            lam=torch.full((), lam0, dtype=f32, device=dev),
            cost=torch.zeros((), dtype=f32, device=dev))


def _lm_step(s, params, robust_th):
    """One LM iteration from the state ``s``: returns its (T_cw, rho, λ,
    cost) after the step is accepted or rejected. A dense window takes
    :func:`normal_equations`, :func:`schur_step` and :func:`lm_accept`
    (the hand kernels on CUDA tensors); a larger one the PCG step."""
    T_cw, rho, lam = s["T_cw"], s["rho"], s["lam"]
    right = s["right"]
    st = (s["anchor"], s["lm_ray"], s["obs_kf"], s["obs_lm"], s["obs_px"],
          right)
    if T_cw.shape[0] <= DENSE_SCHUR_MAX_KFS:
        Hpp, bp, Z, Hrr, brho, cost0 = normal_equations(
            T_cw, rho, *st, s["w_valid"], s["free"], s["bins"], params,
            robust_th)
        T_new, rho_new = schur_step(T_cw, rho, lam, Hpp, bp, Z, Hrr, brho,
                                    s["free"])
        return lm_accept(T_cw, rho, lam, cost0, T_new, rho_new, *st,
                         s["w_valid"], params, robust_th)
    rj = _residuals_jacobians_inv(T_cw, rho, *st, params)
    w, cost0 = _weights_cost0(rj[0], rj[4], s["w_valid"], robust_th)
    T_new, rho_new = _solve_iteration_inv(
        T_cw, rho, lam, s["anchor"], s["lm_ray"], s["obs_kf"], s["obs_lm"],
        s["obs_px"], right, w, s["free"], params, s["bins"], rj=rj)
    return _accept(T_cw, rho, lam, cost0, T_new, rho_new, *st,
                   s["w_valid"], params, robust_th)


def _finish(s, obs_cam, params, robust_th):
    """The solve's outputs from its state: (poses_wc, world points, rho,
    inlier, cost)."""
    with _stage("ba.finish"):
        T_cw, rho = s["T_cw"], s["rho"]
        r, depth_ok, _ = _project_inv(
            T_cw, rho, s["anchor"], s["lm_ray"], s["obs_kf"], s["obs_lm"],
            s["obs_px"], obs_cam, params, rotations=False)
        chi2 = torch.sum(r * r, -1)
        gate = robust_th if robust_th > 0 else 5.9915
        inlier = s["obs_valid"] & (chi2 <= gate) & depth_ok

        X_w, _, _ = _landmark_points(T_cw, rho, s["anchor"], s["lm_ray"],
                                     rotations=False)
        out = lie.pose_inverse(T_cw)
        out_poses = torch.cat([out[:, :4], out[:, 4:7] + s["center"]], dim=-1)
        return out_poses, X_w + s["center"], rho, inlier, s["cost"]


def ba_solve_invdepth(
    kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray,
    obs_kf, obs_lm, obs_px, obs_cam, obs_valid,
    params: BAParams,
    robust_th: float = 5.9915,
    iters: int = 5,
    lam0: float = 1e-3,
    between_iters=None,
):
    """Anchored inverse-depth windowed BA.

    Args (tensors on one device):
      kf_poses_wc: (Kw, 7) world-from-camera poses.
      kf_fixed: (Kw,) bool gauge-fixed flags.
      lm_rho: (Lw,) inverse depths (in the anchor camera).
      lm_anchor: (Lw,) int window index of the anchor KF.
      lm_ray: (Lw, 2) anchor normalized ray (mx, my) with mz = 1.
      obs_*: padded observation table (index -1 = padding).
      between_iters: called with no arguments after each LM iteration.

    Returns (new_kf_poses_wc, new_lm_pos (Lw,3) world positions,
             new_lm_rho (Lw,), obs_inlier (O,), final_cost).
    """
    s = _prepare(kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray, obs_kf,
                 obs_lm, obs_px, obs_valid, lam0, obs_cam)
    for _ in range(iters):
        s["T_cw"], s["rho"], s["lam"], s["cost"] = _lm_step(
            s, params, robust_th)
        if between_iters is not None:
            between_iters()
    return _finish(s, obs_cam, params, robust_th)


def ba_solve_invdepth_two_pass(
    kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray,
    obs_kf, obs_lm, obs_px, obs_cam, obs_valid,
    params: BAParams,
    robust_th: float = 5.9915,
    iters_robust: int = 5,
    iters_l2: int = 3,
    between_iters=None,
    runners=None,
):
    """Robust pass -> chi2 cull -> L2 refinement (`optimizer.cpp:600-627`).

    A window on the dense branch on a GPU (:func:`graphed`) is solved by
    :class:`GraphedTwoPass` (the same operations, replayed as CUDA
    graphs), whose runners live in ``runners`` (a dict its owner keeps;
    default the class's cache); anything else eagerly."""
    args = (kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray, obs_kf,
            obs_lm, obs_px, obs_cam, obs_valid)
    if graphed(kf_poses_wc.device, kf_poses_wc.shape[0]):
        return GraphedTwoPass.solve(args, params, robust_th, iters_robust,
                                    iters_l2, between_iters, runners)
    return _two_pass(args, params, robust_th, iters_robust, iters_l2,
                     between_iters)


def graphed(device, n_kf: int) -> bool:
    """Whether a window of ``n_kf`` keyframes on ``device`` is solved by
    :class:`GraphedTwoPass`."""
    return device.type == "cuda" and n_kf <= DENSE_SCHUR_MAX_KFS


def _two_pass(args, params, robust_th, iters_robust, iters_l2,
              between_iters):
    (kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray, obs_kf, obs_lm,
     obs_px, obs_cam, obs_valid) = args
    poses, _, rho, inlier, _ = ba_solve_invdepth(
        kf_poses_wc, kf_fixed, lm_rho, lm_anchor, lm_ray,
        obs_kf, obs_lm, obs_px, obs_cam, obs_valid, params,
        robust_th=robust_th, iters=iters_robust, between_iters=between_iters)
    poses, pos, rho, inlier2, cost = ba_solve_invdepth(
        poses, kf_fixed, rho, lm_anchor, lm_ray,
        obs_kf, obs_lm, obs_px, obs_cam, obs_valid & inlier, params,
        robust_th=0.0, iters=iters_l2, between_iters=between_iters)
    return poses, pos, rho, inlier & inlier2, cost


def ba_packed_size(Kw: int, Lw: int, O: int) -> int:
    """Length of :func:`pack_ba_invdepth`'s vector."""
    return Kw * 8 + Lw * 4 + O * 6


def pack_ba_invdepth(prob, rho, ray, obs_valid, out=None):
    """Host-side packing matching :func:`ba_invdepth_packed`'s layout (all
    f32; indices are exact below 2^24): poses Kw*7 | fixed Kw | rho Lw |
    anchor Lw | ray Lw*2 | obs_kf O | obs_lm O | obs_px 2O | obs_cam O |
    obs_valid O. ``out`` reuses a buffer."""
    Kw, Lw, O = len(prob.kf_poses), len(rho), len(prob.obs_kf)
    flat = (out if out is not None
            else np.empty(ba_packed_size(Kw, Lw, O), np.float32))
    o = 0
    for a in (prob.kf_poses, prob.kf_fixed, rho, prob.lm_anchor, ray,
              prob.obs_kf, prob.obs_lm, prob.obs_px, prob.obs_cam,
              obs_valid):
        a = np.asarray(a).reshape(-1)
        flat[o:o + a.size] = a
        o += a.size
    return flat


def unpack_ba_invdepth(flat, Kw: int, Lw: int, O: int):
    """:func:`pack_ba_invdepth`'s vector on a device as the ten inputs of
    :func:`ba_solve_invdepth_two_pass`: indices int32, ``obs_cam`` int8,
    masks bool, each a new tensor (so that an eager solve's kernels read
    them as they read separate uploads)."""
    i32 = torch.int32
    o = 0

    def take(n):
        nonlocal o
        o += n
        return flat[o - n:o]

    poses = take(Kw * 7).reshape(Kw, 7).clone()
    fixed = take(Kw) > 0.5
    rho = take(Lw).clone()
    anchor = take(Lw).to(i32)
    ray = take(Lw * 2).reshape(Lw, 2).clone()
    obs_kf = take(O).to(i32)
    obs_lm = take(O).to(i32)
    obs_px = take(2 * O).reshape(O, 2).clone()
    obs_cam = take(O).to(torch.int8)
    obs_valid = take(O) > 0.5
    return (poses, fixed, rho, anchor, ray, obs_kf, obs_lm, obs_px, obs_cam,
            obs_valid)


def pack_ba_out(poses, pos, inlier, cost):
    """The two-pass solve's outputs as one f32 vector: [poses Kw*7 | pos
    Lw*3 | inlier O | cost]."""
    f32 = torch.float32
    return torch.cat([poses.reshape(-1).to(f32), pos.reshape(-1).to(f32),
                      inlier.to(f32), cost.reshape(1).to(f32)])


def ba_invdepth_packed(flat, params: BAParams, Kw: int, Lw: int, O: int,
                       robust_th: float = 5.9915, iters_robust: int = 5,
                       iters_l2: int = 3, between_iters=None, runners=None):
    """Single-buffer transport around the two-pass solve: ``flat`` is
    :func:`pack_ba_invdepth`'s vector on the solve's device (one upload),
    unpacked there into :func:`ba_solve_invdepth_two_pass` (on a GPU, a
    dense window replays :class:`GraphedTwoPass` from ``runners``), and
    the result is one vector [poses Kw*7 | pos Lw*3 | inlier O | cost]
    (one readback). ``between_iters`` is called after each LM
    iteration."""
    if flat.shape != (ba_packed_size(Kw, Lw, O),):
        raise ValueError(f"ba_invdepth_packed: {tuple(flat.shape)} for Kw "
                         f"{Kw}, Lw {Lw}, O {O}")
    poses, pos, _, inlier, cost = ba_solve_invdepth_two_pass(
        *unpack_ba_invdepth(flat, Kw, Lw, O), params, robust_th,
        iters_robust, iters_l2, between_iters, runners)
    return pack_ba_out(poses, pos, inlier, cost)


def pad_landmarks(prob, rho, ray, rows: int):
    """``prob``'s inverse-depth problem (with ``rho``, ``ray``) grown to
    ``rows`` landmark rows, the new ones named by no observation and
    filled as :class:`GraphedTwoPass` pads (inverse depth 1, anchor -1, ray
    0): returns (prob, rho, ray)."""
    n = rows - len(rho)
    pad = GraphedTwoPass._PAD
    grown = copy.copy(prob)
    grown.lm_anchor = np.concatenate([prob.lm_anchor,
                                      np.full(n, pad[3], np.int32)])
    return (grown, np.concatenate([rho, np.full(n, pad[2], np.float32)]),
            np.concatenate([ray, np.full((n, 2), pad[4], np.float32)]))


def landmark_capacity(n_landmarks: int, n_obs: int) -> int:
    """The landmark rows :class:`GraphedTwoPass` pads a problem to: at
    least half the observation rows (a landmark enters a window with two
    observations or more, so a local BA's landmarks fit), in steps of
    256."""
    n = max(n_landmarks, n_obs // 2, 1)
    return ((n + 255) // 256) * 256


class GraphedTwoPass:
    """:func:`ba_solve_invdepth_two_pass` of one problem shape on a GPU,
    replayed as CUDA graphs.

    Eagerly the solve is one host launch per operation (~4400 for a local
    BA window before its LM step became hand kernels), and on a GPU that
    host work, not the device's, is its cost;
    the JAX package compiles the solve once per shape instead. Here the
    landmark rows are padded to :func:`landmark_capacity` (rows that no
    observation names: their sums are 0 and their inverse depths stay), so
    that a window of one size has one shape. A shape's first solve runs
    eagerly on the padded inputs (it also makes the library handles a
    capture may not); its second captures the five stretches between the
    solve's yield points — the robust pass's set-up, one robust iteration,
    the chi2 cull with the L2 pass's set-up, one L2 iteration, the outputs
    — and every solve from then on replays them, calling ``between_iters``
    where the eager solve does. The kernels and their inputs are the eager
    solve's on the padded problem, so a replay gives its numbers bit for
    bit (the unpadded solve's to rounding: sums over the landmarks group
    otherwise). A cache holds a runner per shape and ``params`` object
    (kept alive: the graphs read its tensors): the class's own, or one its
    owner keeps, so that the graphs go with the owner (the estimator).
    Counters: ``eager``, ``captures``, ``replays`` (solves of each kind;
    :meth:`warm` counts on none)."""

    cache = {}
    eager = captures = replays = 0
    # landmark rows' padding: inverse depth, anchor, ray
    _PAD = {2: 1.0, 3: -1, 4: 0.0}

    def __init__(self, args, params, robust_th, iters_robust, iters_l2):
        self.params = params          # the graphs read its tensors
        self.robust_th = robust_th
        self.iters = (iters_robust, iters_l2)
        n_lm = landmark_capacity(args[2].shape[0], args[5].shape[0])
        self.inputs = [
            a.new_empty((n_lm,) + tuple(a.shape[1:])) if i in self._PAD
            else torch.empty_like(a) for i, a in enumerate(args)]
        self.solves = 0
        self.graphs = None
        self.launches = None
        self.outputs = None

    @classmethod
    def runner(cls, args, params, robust_th, iters_robust, iters_l2,
               cache=None):
        """The runner of ``args``' shape in ``cache`` (default the
        class's), made on first use."""
        cache = cls.cache if cache is None else cache
        n_lm = landmark_capacity(args[2].shape[0], args[5].shape[0])
        key = (tuple(a.dtype for a in args),
               tuple(tuple(a.shape) for i, a in enumerate(args)
                     if i not in cls._PAD), n_lm, args[0].device,
               id(params), float(robust_th), iters_robust, iters_l2)
        run = cache.get(key)
        if run is None:
            run = cache[key] = cls(args, params, robust_th, iters_robust,
                                   iters_l2)
        return run

    @classmethod
    def solve(cls, args, params, robust_th, iters_robust, iters_l2,
              between_iters=None, cache=None):
        return cls.runner(args, params, robust_th, iters_robust, iters_l2,
                          cache)(args, between_iters)

    def _load(self, args):
        """Copy ``args`` into the padded inputs; returns the landmarks."""
        n = args[2].shape[0]
        for i, (dst, src) in enumerate(zip(self.inputs, args)):
            if i in self._PAD:
                dst[:n].copy_(src)
                dst[n:].fill_(self._PAD[i])
            else:
                dst.copy_(src)
        return n

    def __call__(self, args, between_iters=None):
        n = self._load(args)
        self.solves += 1
        if self.solves == 1:
            GraphedTwoPass.eager += 1
            out = _two_pass(self.inputs, self.params, self.robust_th,
                            *self.iters, between_iters)
        else:
            if self.graphs is None:
                self._capture()
                GraphedTwoPass.captures += 1
            GraphedTwoPass.replays += 1
            out = self._replay(between_iters)
        poses, pos, rho, inlier, cost = out
        return (poses.clone(), pos[:n].clone(), rho[:n].clone(),
                inlier.clone(), cost.clone())

    def warm(self, args):
        """A shape's first two solves' work ahead of need, on ``args``: an
        eager solve and the capture, so that the next solve replays."""
        self._load(args)
        _two_pass(self.inputs, self.params, self.robust_th, *self.iters,
                  None)
        if self.graphs is None:
            self._capture()
        self.solves = max(self.solves, 1)

    def _replay(self, between_iters):
        """The five graphs in order; each replay counts the hand-kernel
        launches its graph holds (``graphs.count_replay``)."""
        dev = self.inputs[0].device

        def replay(i):
            self.graphs[i].replay()
            graphs.count_replay(self.launches[i], dev)

        replay(0)
        for _ in range(self.iters[0]):
            replay(1)
            if between_iters is not None:
                between_iters()
        replay(2)
        for _ in range(self.iters[1]):
            replay(3)
            if between_iters is not None:
                between_iters()
        replay(4)
        return self.outputs

    def _capture(self):
        """Capture the five stretches, in the order they replay."""
        (poses, fixed, rho, anchor, ray, obs_kf, obs_lm, obs_px, obs_cam,
         obs_valid) = self.inputs
        prm, th = self.params, self.robust_th

        def step(s, robust_th):
            T_cw, rho_new, lam, cost = _lm_step(s, prm, robust_th)
            s["T_cw"].copy_(T_cw)
            s["rho"].copy_(rho_new)
            s["lam"].copy_(lam)
            s["cost"].copy_(cost)

        def cull():
            p1, _, rho1, inl1, _ = _finish(s1, obs_cam, prm, th)
            s2 = _prepare(p1, fixed, rho1, anchor, ray, obs_kf, obs_lm,
                          obs_px, obs_valid & inl1, 1e-3, obs_cam)
            return s2, inl1

        def outputs():
            p2, pos, rho2, inl2, cost = _finish(s2, obs_cam, prm, 0.0)
            return p2, pos, rho2, inl1 & inl2, cost

        with Capture(poses.device) as capture:
            s1 = capture(lambda: _prepare(poses, fixed, rho, anchor, ray,
                                          obs_kf, obs_lm, obs_px, obs_valid,
                                          1e-3, obs_cam))
            capture(lambda: step(s1, th))
            s2, inl1 = capture(cull)
            capture(lambda: step(s2, 0.0))
            self.outputs = capture(outputs)
        self.states = (s1, s2, inl1)  # the graphs write them
        self.launches = capture.launches
        self.graphs = capture.graphs
