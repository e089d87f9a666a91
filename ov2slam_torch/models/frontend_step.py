"""Per-frame and per-keyframe front-end device steps.

Port of ``ov2slam_tpu/models/frontend_step.py``: the per-frame device
computation — CLAHE, pyramid build, landmark-projection priors,
forward-backward KLT, undistortion, essential-RANSAC outlier gating, and
motion-only PnP — the keyframe detection + BRIEF + undistortion step, and
the device-chained variant of the per-frame step with its helpers.

A frame's host inputs are packed into one (N+2, 8) f32 array
(:func:`pack_track_state`) and its results into one (N+3, 5) f32 tensor
(:func:`pack_track_out`), so that one host→device and one device→host copy
carry a frame. RANSAC draws its samples from the caller's
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.camera import distort_fisheye, distort_radtan
from ..core.image import build_pyramid, clahe
from ..geometry.essential import essential_ransac
from ..ops.klt import fb_klt_track_split, klt_track
from ..solvers.pnp_refine import pnp_refine
from ..utils import lie


class CalibArrays(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor     # (4,)

    @classmethod
    def from_camera(cls, cam) -> "CalibArrays":
        f32 = torch.float32
        return cls(fx=cam.fx.to(f32), fy=cam.fy.to(f32), cx=cam.cx.to(f32),
                   cy=cam.cy.to(f32), dist=cam.dist.to(f32))

    def f(self):
        return torch.stack([self.fx, self.fy])

    def c(self):
        return torch.stack([self.cx, self.cy])


def _undistort_px(px, calib: CalibArrays, fisheye: bool, iters: int = 8):
    xn = (px - calib.c()) / calib.f()
    fn = distort_fisheye if fisheye else distort_radtan
    xu = xn
    for _ in range(iters):
        xu = xn - (fn(xu, calib.dist) - xu)
    return xu * calib.f() + calib.c()


# state-row flag bits (column 7 of the packed per-frame state, column 5 of
# the chained step's per-slot map view)
FLAG_VALID = 1
FLAG_IS3D = 2
FLAG_PAIR = 4


def pack_track_state(px, lm_pos, kf_px_und, valid, is3d, pair_valid,
                     T_pred, T_kf, out=None):
    """Host-side packing of all per-frame inputs into one (N+2, 8) f32
    buffer (single upload): rows 0..N-1 = [px(2)|lm_pos(3)|kf_px(2)|flags],
    row N = T_pred, row N+1 = T_kf. ``out`` reuses a preallocated buffer."""
    N = len(px)
    st = out if out is not None else np.zeros((N + 2, 8), np.float32)
    st[:N, 0:2] = px
    st[:N, 2:5] = lm_pos
    st[:N, 5:7] = kf_px_und
    st[:N, 7] = (valid * FLAG_VALID + is3d * FLAG_IS3D
                 + pair_valid * FLAG_PAIR)
    st[N, :7] = T_pred
    st[N + 1, :7] = T_kf
    return st


def unpack_track_state(state):
    """(N+2, 8) packed state on the device → the keyword arguments of
    :func:`fused_track_step` it carries (px … T_kf)."""
    N = state.shape[0] - 2
    flags = state[:N, 7].to(torch.int32)
    return dict(px=state[:N, 0:2], valid=(flags & FLAG_VALID) > 0,
                lm_pos=state[:N, 2:5], kf_px_und=state[:N, 5:7],
                lm_is3d=(flags & FLAG_IS3D) > 0,
                kf_pair_valid=(flags & FLAG_PAIR) > 0,
                T_pred=state[N, :7], T_kf=state[N + 1, :7])


def pack_track_out(out, marker: float = 0.0):
    """One frame's results as one (N+3, 5) f32 tensor, the JAX package's
    layout: rows 0..N-1 = [tracked(2) | und(2) | status], row N =
    [pose_ok, n_inl, marker, 0, 0], row N+1 = T_new[0:5], row N+2 =
    [T_new[5:7], 0, 0, 0]. ``marker`` 1 tags the chained step's output."""
    f32 = torch.float32
    T_new = out["T_new"]
    tail = torch.zeros((3, 5), dtype=f32, device=T_new.device)
    tail[0, 0] = out["pose_ok"]
    tail[0, 1] = out["n_inl"]
    if marker:
        tail[0, 2:3].fill_(marker)   # a kernel, not a host upload
    tail[1] = T_new[:5]
    tail[2, :2] = T_new[5:7]
    return torch.cat([torch.cat([out["tracked"], out["und"],
                                 out["status"][:, None].to(f32)], dim=1),
                      tail], dim=0)


def unpack_track_out(packed: np.ndarray) -> dict:
    """The host's view of :func:`pack_track_out`'s (N+3, 5) array."""
    N = packed.shape[0] - 3
    return dict(tracked=packed[:N, 0:2], und=packed[:N, 2:4],
                status=packed[:N, 4] > 0.5, pose_ok=bool(packed[N, 0] > 0.5),
                n_inl=int(packed[N, 1]), chained=bool(packed[N, 2] > 0.5),
                T_new=np.concatenate([packed[N + 1, :5],
                                      packed[N + 2, :2]]).astype(np.float32))


def fused_detect_describe(img, px, valid, thresh, calib: CalibArrays,
                          detector: str = "fast", cell_size: int = 35,
                          max_out: int = 400, fisheye: bool = False):
    """Keyframe detection + BRIEF description + undistortion.

    Returns (desc (N+max_out, 8) int32 — rows 0..N-1 describe the CURRENT
    keypoints, rows N.. the fresh detections — and a dict of the fresh
    detections: kps (max_out, 2), und (max_out, 2), score, ok).
    """
    from ..ops.brief import describe_brief
    from ..ops.detect import detect_gftt, detect_grid_fast, \
        detect_single_scale

    img = img.to(torch.float32)
    if detector == "gftt":
        kps, scores, ok = detect_gftt(img, px, valid, thresh,
                                      cell_size=cell_size, max_out=max_out)
    elif detector == "single":
        kps, scores, ok = detect_single_scale(
            img, px, valid, thresh, cell_size=cell_size, max_out=max_out)
    else:
        kps, scores, ok = detect_grid_fast(
            img, px, valid, thresh, cell_size=cell_size, max_out=max_out)
    desc_cur, _ = describe_brief(img, px, valid)
    desc_new, ok2 = describe_brief(img, kps, ok)
    und_new = _undistort_px(kps, calib, fisheye)
    return torch.cat([desc_cur, desc_new], dim=0), dict(
        kps=kps, und=und_new, score=scores, ok=ok & ok2)


def fused_track_step(
    img, prev_pyr, px, valid, lm_pos, kf_px_und, lm_is3d, kf_pair_valid,
    T_pred, T_kf, gen: Optional[torch.Generator], calib: CalibArrays, *,
    clahe_val: float = 3.0, max_fbklt_dist: float = 0.5,
    klt_err: float = 30.0, ransac_err_px: float = 3.0,
    robust_th: float = 5.9915, levels: int = 4, win: int = 9,
    iters: int = 30, use_clahe: bool = False, do_epipolar: bool = True,
    do_pose: bool = True, ransac_iters: int = 100, pnp_iters: int = 10,
    fisheye: bool = False, use_prior: bool = True, debug: bool = False,
    split_sub: int = 0, kf_pyr=None, track_from_kf: bool = False,
    ransac_idx=None,
):
    """One frame of tracking (the JAX package's ``_track_body``).

    Args (all tensors on one device):
      img: (H, W) raw current frame; prev_pyr: previous frame's pyramid.
      px (N, 2), valid (N,), lm_pos (N, 3), kf_px_und (N, 2), lm_is3d (N,),
      kf_pair_valid (N,): per-slot state; T_pred, T_kf: (7,) f32 poses.
      ransac_idx: optional (idx5, idx8) sample indices for the epipolar
        RANSAC (tests feed both packages the same samples).

    Returns (cur_pyr, out) with out a dict of tracked (N, 2), und (N, 2),
    status (N,), pose_ok (), n_inl (), T_new (7,) [, debug entries].
    - status: track survived fb-KLT (+ epipolar gate + PnP chi2 gate for 3D
      slots when enabled).
    - T_new: refined pose (T_pred when do_pose is off or failed).
    """
    img = img.to(torch.float32)
    dev = img.device
    im = clahe(img, clahe_val) if use_clahe else img
    cur_pyr = tuple(build_pyramid(im, levels))
    fxy, cxy = calib.f(), calib.c()

    # --- priors: project 3D landmarks under the predicted pose ---------- #
    T_cw = lie.pose_inverse(T_pred)
    pc = lie.pose_apply(T_cw[None], lm_pos)
    z = torch.where(pc[:, 2:3].abs() < 1e-3,
                    torch.full_like(pc[:, 2:3], 1e-3), pc[:, 2:3])
    proj = pc[:, :2] / z * fxy + cxy
    H, W = img.shape
    proj_ok = (lm_is3d & (pc[:, 2] > 0.1)
               & (proj[:, 0] >= 0) & (proj[:, 0] <= W - 1)
               & (proj[:, 1] >= 0) & (proj[:, 1] <= H - 1))
    priors = torch.where(proj_ok[:, None], proj, px) if use_prior else px

    # --- forward-backward KLT ------------------------------------------ #
    fb = torch.zeros(px.shape[0], dtype=px.dtype, device=dev)
    if track_from_kf and do_pose:
        dist_fn = distort_fisheye if fisheye else distort_radtan
        kf_raw = dist_fn((kf_px_und - cxy) / fxy, calib.dist) * fxy + cxy
        src = torch.where(kf_pair_valid[:, None], kf_raw, px)
        fwd, status = fb_klt_track_split(
            kf_pyr, cur_pyr, src, torch.where(proj_ok[:, None], proj, px),
            valid & kf_pair_valid, proj_ok & use_prior,
            n_sub=(split_sub if split_sub > 0 else px.shape[0]),
            win=win, iters=iters, max_err=klt_err,
            max_fb_dist=max_fbklt_dist, n_base_levels=2, priors2=px)
        st_f = st_b = status
    elif split_sub > 0 and do_pose and use_prior:
        fwd, status = fb_klt_track_split(
            prev_pyr, cur_pyr, px, priors, valid, proj_ok,
            n_sub=split_sub, win=win, iters=iters, max_err=klt_err,
            max_fb_dist=max_fbklt_dist)
        st_f = st_b = status
    else:
        fwd, st_f, _ = klt_track(prev_pyr, cur_pyr, px, priors, valid,
                                 win=win, iters=iters, max_err=klt_err)
        bwd, st_b, _ = klt_track((cur_pyr[0],), (prev_pyr[0],), fwd, px,
                                 st_f, win=win, iters=iters,
                                 max_err=klt_err)
        fb = torch.linalg.norm(bwd - px, dim=-1)
        status = st_f & st_b & (fb <= max_fbklt_dist)
    tracked = torch.where(status[:, None], fwd, px)
    out = {}
    if debug:
        out.update(st_fwd=st_f, st_bwd=st_b, fb=fb, priors=priors)

    und = _undistort_px(tracked, calib, fisheye)

    # --- epipolar 2d-2d gate vs the reference keyframe ------------------ #
    if do_epipolar:
        pair = status & kf_pair_valid
        xl = (kf_px_und - cxy) / fxy
        xr = (und - cxy) / fxy
        i5, i8 = ransac_idx if ransac_idx is not None else (None, None)
        E, epi_inl, n_epi = essential_ransac(
            gen, xl, xr, pair, focal=calib.fx, err_th_px=ransac_err_px,
            n_iters=ransac_iters, idx5=i5, idx8=i8)
        # rotation-compensated parallax: raw displacement is dominated by
        # rotation during turns, where E is translation-degenerate
        R_rel = lie.quat_to_matrix(
            lie.quat_mul(lie.quat_conj(T_pred[:4]), T_kf[:4]))
        xn_kf = torch.cat([xl, torch.ones_like(xl[:, :1])], -1)
        rot = xn_kf @ R_rel.T
        rot_px = rot[:, :2] / torch.clamp(rot[:, 2:], min=1e-6) * fxy + cxy
        npair = pair.sum()
        parallax = torch.sum(torch.where(
            pair, torch.linalg.norm(und - rot_px, dim=-1),
            torch.zeros_like(und[:, 0]))) / torch.clamp(npair, min=1)
        # apply only when well-constrained (enough inliers and parallax)
        # and with a majority consensus
        n_pair = torch.clamp(npair, min=1)
        use_gate = ((n_epi >= 10) & (parallax >= 5.0)
                    & (n_epi >= 0.5 * n_pair))
        status = torch.where(use_gate & pair, status & epi_inl, status)
        if debug:
            out.update(epi_inl=epi_inl, n_epi=n_epi, parallax=parallax,
                       use_gate=use_gate)

    # --- motion-only PnP ------------------------------------------------ #
    if do_pose:
        sel3d = status & lm_is3d
        T_ref, pnp_inl, _ = pnp_refine(
            T_pred, lm_pos, und, sel3d,
            calib.fx, calib.fy, calib.cx, calib.cy,
            robust_th=robust_th, iters=pnp_iters)
        n_inl = pnp_inl.sum()
        pose_ok = n_inl >= 5
        T_new = torch.where(pose_ok, T_ref, T_pred)
        # drop 3D observations rejected by the chi2 gate — only when the
        # solve succeeded
        status = status & torch.where(sel3d & pose_ok, pnp_inl,
                                      torch.ones_like(pnp_inl))
        if debug:
            out.update(pnp_inl=pnp_inl, sel3d=sel3d)
    else:
        T_new = T_pred
        pose_ok = torch.zeros((), dtype=torch.bool, device=dev)
        n_inl = torch.zeros((), dtype=torch.int64, device=dev)

    out.update(tracked=tracked, und=und, status=status, pose_ok=pose_ok,
               n_inl=n_inl, T_new=T_new)
    return cur_pyr, out


# --------------------------------------------------------------------- #
# device-chained tracking: no blocking host round trip per frame
# --------------------------------------------------------------------- #
#
# The host-packed step needs the PREVIOUS frame's result on the host before
# it can build the next frame's input. The chained variant keeps the
# recurrent state on the device:
#
#   S (N+2, 8) f32:  rows 0..N-1 [px(2) | und(2) | status | 0 0 0]
#                    row N   = T_cur  (this frame's pose)
#                    row N+1 = T_prev (previous frame's pose)
#   lm_static (N+1, 8) f32: rows 0..N-1 [lm_pos(3) | kf_px_und(2) | flags]
#                    row N = T_kf
#
# and computes the constant-velocity prior on the device
# (`MotionModel::applyMotionModel`, `visual_front_end.hpp:43-58`), scaled
# by the ratio of this frame's interval to the previous one:
#
#   T_pred = T_cur ∘ (T_prev⁻¹ ∘ T_cur)^dt_ratio
#
# The host receives the same packed view as the host-packed step and reads
# it ``pipeline_depth`` frames late.

def pack_lm_static(lm_pos, kf_px_und, valid, is3d, pair_valid, T_kf,
                   out=None):
    """Host-side packing of the slow-changing per-slot map view."""
    N = len(lm_pos)
    st = out if out is not None else np.zeros((N + 1, 8), np.float32)
    st[:N, 0:3] = lm_pos
    st[:N, 3:5] = kf_px_und
    st[:N, 5] = (valid * FLAG_VALID + is3d * FLAG_IS3D
                 + pair_valid * FLAG_PAIR)
    st[N, :7] = T_kf
    return st


def pack_chain_state(px, px_und, status, T_cur, T_prev, out=None):
    """Host-side packing of the recurrent chain state (used to seed or
    re-seed the chain after keyframes / fallbacks)."""
    N = len(px)
    st = out if out is not None else np.zeros((N + 2, 8), np.float32)
    st[:N, 0:2] = px
    st[:N, 2:4] = px_und
    st[:N, 4] = status
    st[N, :7] = T_cur
    st[N + 1, :7] = T_prev
    return st


def chained_prior(T_cur, T_prev, dt_ratio):
    """The constant-velocity prior on the device: T_cur ∘ rel^r with
    rel = T_prev⁻¹ ∘ T_cur and r = ``dt_ratio`` (a (1,) tensor); T_cur
    itself while T_prev is the zero row (no history). No host branch on a
    device value: ``has_prev`` stays a tensor."""
    has_prev = T_prev.abs().sum() > 0
    rel = lie.pose_compose(lie.pose_inverse(T_prev), T_cur)
    r = dt_ratio[0]
    rel_s = torch.cat([lie.so3_exp(lie.so3_log(rel[:4]) * r), rel[4:] * r])
    return torch.where(has_prev, lie.pose_compose(T_cur, rel_s), T_cur)


def fused_track_step_chained(img, prev_pyr, S_prev, lm_static, dt_ratio,
                             gen: Optional[torch.Generator],
                             calib: CalibArrays, **kw):
    """One chained frame: returns (cur_pyr, S_out, packed).

    ``packed`` has :func:`pack_track_out`'s layout with the chained marker
    set (row N, column 2); ``S_out`` feeds the next call. ``kw`` are
    :func:`fused_track_step`'s keyword arguments (``debug`` and the from-KF
    tracking are not taken: the chain tracks frame to frame)."""
    N = S_prev.shape[0] - 2
    T_cur = S_prev[N, :7]
    flags = lm_static[:N, 5].to(torch.int32)
    valid = (S_prev[:N, 4] > 0.5) & ((flags & FLAG_VALID) > 0)
    cur_pyr, out = fused_track_step(
        img, prev_pyr, S_prev[:N, 0:2], valid, lm_static[:N, 0:3],
        lm_static[:N, 3:5], (flags & FLAG_IS3D) > 0,
        (flags & FLAG_PAIR) > 0,
        chained_prior(T_cur, S_prev[N + 1, :7], dt_ratio),
        lm_static[N, :7], gen, calib, **kw)
    packed = pack_track_out(out, marker=1.0)
    S_out = torch.zeros_like(S_prev)
    S_out[:N, 0:5] = packed[:N]
    S_out[N, :7] = out["T_new"]
    S_out[N + 1, :7] = T_cur
    return cur_pyr, S_out, packed


def patch_chain_rows(S, rows, px, und, status):
    """Scatter freshly detected keyframe slots into the chain state.

    ``rows`` is always (max_kps,), padded with an index past the slot rows
    (the JAX package pads with 1 << 20 and drops it in the scatter). PyTorch
    has no drop mode — an out-of-range index is a device-side assert on
    CUDA and a negative one wraps onto the pose rows — so every index
    outside [0, N) is pointed at a scratch row that is cut off afterwards.
    px/und: (max_kps, 2); status: (max_kps,)."""
    N = S.shape[0] - 2
    upd = torch.cat([px, und, status[:, None]], dim=1)
    rows = rows.to(torch.int64)
    rows = torch.where((rows >= 0) & (rows < N), rows,
                       torch.full_like(rows, N + 2))
    ext = torch.cat([S, torch.zeros_like(S[:1])], dim=0)
    cols = ext[:, 0:5].index_put((rows,), upd)
    return torch.cat([cols, ext[:, 5:]], dim=1)[:N + 2]


def advance_chain_patch(pyr_a, pyr_b, px, status, calib: CalibArrays,
                        win: int = 9, iters: int = 30,
                        fisheye: bool = False):
    """Advance freshly detected keyframe slots by ONE frame hop
    (pyr_a → pyr_b), so that their positions are expressed at the chain's
    head frame before :func:`patch_chain_rows` scatters them in. Slots that
    cannot be tracked across the hop are dropped (status → 0)."""
    fwd, st, _ = klt_track(pyr_a, pyr_b, px, px, status > 0.5,
                           win=win, iters=iters)
    und = _undistort_px(fwd, calib, fisheye)
    return fwd, und, st.to(torch.float32) * status


def patch_chain_pose_delta(S, delta):
    """Left-compose a world-frame correction onto the chain's pose rows
    (BA moved the map while frames were in flight: T' = delta ∘ T)."""
    N = S.shape[0] - 2
    poses = lie.pose_compose(delta[None], S[N:, :7])
    return torch.cat([S[:N], torch.cat([poses, S[N:, 7:]], dim=1)])
