"""Keyframe-mapping device steps over the fixed keypoint capacity.

Port of ``ov2slam_tpu/models/mapper_step.py``: the whole stereo pass
(CLAHE + pyramid + SAD/projection priors + fb-KLT + Sampson gate +
midpoint triangulation + reprojection checks) and the whole temporal
triangulation (per-row anchor poses) as one call each, with masks for
validity. Inputs are tensors on the caller's device, passed directly.

Reference parity: `MapManager::stereoMatching` (`map_manager.cpp:367-611`),
`Mapper::triangulateStereo` (`mapper.cpp:346-461`),
`Mapper::triangulateTemporal` (`mapper.cpp:191-344`).
"""

from __future__ import annotations

import torch

from ..core.image import build_pyramid, clahe
from ..geometry.essential import sampson_dist_sq
from ..geometry.triangulation import reprojection_checks, triangulate_midpoint
from ..ops.klt import fb_klt_track
from ..ops.stereo_sad import line_min_sad
from ..utils import lie
from .frontend_step import CalibArrays, _undistort_px


def _bearing_from_und(px_und, calib: CalibArrays):
    """Unit bearing from an UNDISTORTED pixel (normalize through K)."""
    xn = (px_und - calib.c()) / calib.f()
    bv = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
    return bv / torch.linalg.norm(bv, dim=-1, keepdim=True)


def fused_stereo_map_step(
    left_pyr, right_img, px, lm_pos, valid, lm_is3d, T_wc, T_lr, E_lr,
    calib_l: CalibArrays, calib_r: CalibArrays, *,
    clahe_val: float = 3.0, klt_err: float = 30.0,
    max_fbklt_dist: float = 0.5, max_reproj_err: float = 3.0,
    levels: int = 4, win: int = 9, iters: int = 30,
    use_clahe: bool = False, rectified: bool = True,
    fisheye_r: bool = False,
):
    """Stereo matching + triangulation of one keyframe.

    Args: left_pyr (levels of the left frame), right_img (H, W), px (N, 2)
    left keypoints, lm_pos (N, 3), valid (N,), lm_is3d (N,), T_wc (7,),
    T_lr (7,) right-in-left extrinsic, E_lr (3, 3) stereo essential.

    Returns a dict: rpx (N, 2), pts_w (N, 3), stereo_ok, tri_ok, tri_cand.
    stereo_ok: fb-KLT survived + Sampson-gated stereo match. tri_ok: newly
    triangulated (among not-yet-3D stereo matches) passing depth and
    reprojection checks; pts_w only meaningful there.
    """
    right_img = right_img.to(torch.float32)
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

    # Sampson residual gate under the known stereo geometry
    xl = (px - calib_l.c()) / calib_l.f()
    r_und = _undistort_px(tracked, calib_r, fisheye_r)
    xr = (r_und - calib_r.c()) / calib_r.f()
    d2 = sampson_dist_sq(E_lr, xl, xr)
    epi_ok = d2 < (max_reproj_err / calib_l.fx) ** 2
    stereo_ok = status & epi_ok & valid

    cand = stereo_ok & ~lm_is3d
    bl = _bearing_from_und(px, calib_l)
    br = _bearing_from_und(r_und, calib_r)
    pts_l = triangulate_midpoint(T_lr[None], bl, br)
    ok = reprojection_checks(T_lr, bl, br, pts_l, calib_l.fx,
                             max_reproj_err, min_depth=0.05)
    return dict(rpx=tracked, pts_w=lie.pose_apply(T_wc[None], pts_l),
                stereo_ok=stereo_ok, tri_ok=cand & ok, tri_cand=cand)


def fused_temporal_step(px_a, px_c, T_a, T_rel, valid,
                        calib_l: CalibArrays, max_reproj_err: float = 3.0):
    """Temporal triangulation vs each landmark's anchor keyframe — all
    candidates in one batch with per-row poses.

    Returns (pts_w (N, 3), ok (N,)).
    """
    ba = _bearing_from_und(px_a, calib_l)
    bc = _bearing_from_und(px_c, calib_l)
    pts_a = triangulate_midpoint(T_rel, ba, bc)
    ok = reprojection_checks(T_rel, ba, bc, pts_a, calib_l.fx,
                             max_reproj_err, min_depth=0.05) & valid
    return lie.pose_apply(T_a, pts_a), ok
