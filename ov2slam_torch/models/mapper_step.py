"""Keyframe-mapping device steps over the fixed keypoint capacity.

Port of ``ov2slam_tpu/models/mapper_step.py``: the whole stereo pass
(CLAHE + pyramid + SAD/projection priors + fb-KLT + Sampson gate +
midpoint triangulation + reprojection checks) and the whole temporal
triangulation (per-row anchor poses) as one call each, with masks for
validity. Each step reads one packed f32 state (:func:`pack_stereo_state`,
:func:`pack_temporal_state`, the JAX package's layouts) and returns one
packed f32 tensor, so that a keyframe's step is one upload and one
readback; on a GPU the mapper replays each as a CUDA graph
(:func:`map_steps`).

Reference parity: `MapManager::stereoMatching` (`map_manager.cpp:367-611`),
`Mapper::triangulateStereo` (`mapper.cpp:346-461`),
`Mapper::triangulateTemporal` (`mapper.cpp:191-344`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import undistort_normalize
from ..core.image import build_pyramid, clahe
from ..geometry.essential import sampson_dist_sq
from ..geometry.triangulation import reprojection_checks, triangulate_midpoint
from ..graphs import GraphedStep, counters
from ..ops.klt import fb_klt_track
from ..ops.stereo_sad import line_min_sad
from ..utils import lie
from .frontend_step import FLAG_IS3D, FLAG_VALID, CalibArrays


def _bearing_from_xn(xn):
    """Unit bearing from normalised coordinates."""
    bv = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
    return bv / torch.linalg.norm(bv, dim=-1, keepdim=True)


def _bearing_from_und(px_und, calib: CalibArrays):
    """Unit bearing from an UNDISTORTED pixel (normalize through K)."""
    return _bearing_from_xn((px_und - calib.c()) / calib.f())


def pack_stereo_state(px, lm_pos, valid, is3d, T_wc, out=None):
    """(N+1, 8) f32 single-upload state: rows 0..N-1 =
    [px(2)|lm_pos(3)|flags|0|0], row N = T_wc. ``out`` reuses a buffer."""
    N = len(px)
    st = out if out is not None else np.zeros((N + 1, 8), np.float32)
    st[:N, 0:2] = px
    st[:N, 2:5] = lm_pos
    st[:N, 5] = valid * float(FLAG_VALID) + is3d * float(FLAG_IS3D)
    st[N, :7] = T_wc
    return st


def fused_stereo_map_step(
    left_pyr, right_img, state, T_lr, E_lr,
    calib_l: CalibArrays, calib_r: CalibArrays, *,
    clahe_val: float = 3.0, klt_err: float = 30.0,
    max_fbklt_dist: float = 0.5, max_reproj_err: float = 3.0,
    levels: int = 4, win: int = 9, iters: int = 30,
    use_clahe: bool = False, rectified: bool = True,
    fisheye_r: bool = False,
):
    """Stereo matching + triangulation of one keyframe.

    Args: left_pyr (levels of the left frame), right_img (H, W), state
    (N+1, 8) f32 (:func:`pack_stereo_state`), T_lr (7,) right-in-left
    extrinsic, E_lr (3, 3) stereo essential.

    Returns packed (N, 8) f32: [rpx(2) | pts_w(3) | stereo_ok | tri_ok |
    tri_cand]. stereo_ok: fb-KLT survived + Sampson-gated stereo match.
    tri_ok: newly triangulated (among not-yet-3D stereo matches) passing
    depth and reprojection checks; pts_w only meaningful there.
    """
    right_img = right_img.to(torch.float32)
    N = state.shape[0] - 1
    px = state[:N, 0:2]
    lm_pos = state[:N, 2:5]
    flags = state[:N, 5].to(torch.int32)
    valid = (flags & FLAG_VALID) > 0
    lm_is3d = (flags & FLAG_IS3D) > 0
    T_wc = state[N, :7]
    im = clahe(right_img, clahe_val) if use_clahe else right_img
    right_pyr = tuple(build_pyramid(im, levels))
    H, W = right_img.shape

    # priors: rectified SAD scan for all kps, overridden by the 3D-landmark
    # projection into the right camera
    priors = px
    if rectified:
        sad_priors, _, _ = line_min_sad(left_pyr[0], right_pyr[0], px,
                                        valid)
        priors = torch.where(valid[:, None], sad_priors, px)
    T_wr = lie.pose_compose(T_wc, T_lr)
    pr = lie.pose_apply(lie.pose_inverse(T_wr)[None], lm_pos)
    z = torch.where(pr[:, 2:3].abs() < 1e-3,
                    torch.full_like(pr[:, 2:3], 1e-3), pr[:, 2:3])
    proj = pr[:, :2] / z * calib_r.f() + calib_r.c()
    ok3 = (lm_is3d & (pr[:, 2] > 0.1)
           & (proj[:, 0] >= 0) & (proj[:, 0] <= W - 1)
           & (proj[:, 1] >= 0) & (proj[:, 1] <= H - 1))
    priors = torch.where(ok3[:, None], proj, priors)

    tracked, status = fb_klt_track(
        left_pyr, right_pyr, px, priors, valid,
        win=win, iters=iters, max_err=klt_err,
        max_fb_dist=max_fbklt_dist)

    # Sampson residual gate under the known stereo geometry: the left
    # pixels normalised, the right tracks undistorted and normalised, in
    # one launch on CUDA
    tail = undistort_normalize(tracked, *calib_r.intrinsics(), calib_r.dist,
                               fisheye_r, ref=px,
                               ref_intrinsics=calib_l.intrinsics())
    xl, xr = tail.xl, tail.xr
    d2 = sampson_dist_sq(E_lr, xl, xr)
    epi_ok = d2 < (max_reproj_err / calib_l.fx) ** 2
    stereo_ok = status & epi_ok & valid

    cand = stereo_ok & ~lm_is3d
    # the bearings of px and of the undistorted right tracks, from the
    # same normalised coordinates the gate took
    bl = _bearing_from_xn(xl)
    br = _bearing_from_xn(xr)
    pts_l = triangulate_midpoint(T_lr[None], bl, br)
    ok = reprojection_checks(T_lr, bl, br, pts_l, calib_l.fx,
                             max_reproj_err, min_depth=0.05)
    f32 = torch.float32
    return torch.cat([tracked, lie.pose_apply(T_wc[None], pts_l),
                      stereo_ok[:, None].to(f32),
                      (cand & ok)[:, None].to(f32), cand[:, None].to(f32)],
                     dim=1)


def pack_temporal_state(px_a, px_c, T_a, T_rel, valid, out=None):
    """(N, 19) f32 single-upload state:
    [px_a(2)|px_c(2)|T_a(7)|T_rel(7)|valid]. ``out`` reuses a buffer."""
    N = len(px_a)
    st = out if out is not None else np.zeros((N, 19), np.float32)
    st[:, 0:2] = px_a
    st[:, 2:4] = px_c
    st[:, 4:11] = T_a
    st[:, 11:18] = T_rel
    st[:, 18] = valid
    return st


def fused_temporal_step(state, calib_l: CalibArrays,
                        max_reproj_err: float = 3.0):
    """Temporal triangulation vs each landmark's anchor keyframe — all
    candidates in one batch with per-row poses, from the (N, 19) state of
    :func:`pack_temporal_state`.

    Returns packed (N, 4) f32: [pts_w(3) | ok].
    """
    px_a = state[:, 0:2]
    px_c = state[:, 2:4]
    T_a = state[:, 4:11]
    T_rel = state[:, 11:18]
    valid = state[:, 18] > 0.5
    ba = _bearing_from_und(px_a, calib_l)
    bc = _bearing_from_und(px_c, calib_l)
    pts_a = triangulate_midpoint(T_rel, ba, bc)
    ok = reprojection_checks(T_rel, ba, bc, pts_a, calib_l.fx,
                             max_reproj_err, min_depth=0.05) & valid
    return torch.cat([lie.pose_apply(T_a, pts_a),
                      ok[:, None].to(torch.float32)], dim=1)


def _stereo_graph_fn(*tensors, **static):
    """:func:`fused_stereo_map_step` with the left pyramid's levels, the
    right image and the state as one flat list of tensors (the inputs
    :class:`GraphedStep` copies into its graph)."""
    *left_pyr, right_img, state = tensors
    return fused_stereo_map_step(tuple(left_pyr), right_img, state,
                                 **static)


# the calls of every mapper's graphed steps, by kind (:func:`map_steps`)
stereo_step_counts = counters()
temporal_step_counts = counters()


def map_steps():
    """A mapper's own (stereo, temporal) steps, as it calls them: on a GPU
    each replays one CUDA graph per shape and static arguments, on the CPU
    each calls its step. The graphs bake in the mapper's calibration and
    extrinsics and the KLT kernel's level table (so the left levels are
    among the copied inputs); they go with the mapper. Every mapper's
    steps count on :data:`stereo_step_counts` and
    :data:`temporal_step_counts`."""
    return (GraphedStep(_stereo_graph_fn, stereo_step_counts),
            GraphedStep(fused_temporal_step, temporal_step_counts))
