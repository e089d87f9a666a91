"""Pyramidal forward-backward KLT tracking, batched over keypoints.

Port of ``ov2slam_tpu/ops/klt.py`` (the reference's
`FeatureTracker::fbKltTracking` around cv::calcOpticalFlowPyrLK):

- forward pass over the full pyramid with initial-flow priors,
- min-eigenvalue gating of the spatial gradient matrix,
- backward pass on the base level only,
- forward-backward distance check.

Per level, the template and a search window with ``margin`` px of slack on
each side are gathered once (``ops/patch.extract_patches``); each
Gauss-Newton iteration resamples the window inside the search patch
(``ops/patch.sample_window``). Flow corrections beyond the margin within
one level are clamped, as in the JAX version.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .patch import extract_patches, sample_window


def track_level(
    img_prev, img_cur, kps_lvl, flow, alive,
    win: int, iters: int, eps: float, min_eig_th: float, margin: int,
):
    """One pyramid level of Lucas-Kanade for all keypoints.

    Args:
      img_prev/img_cur: (H, W) level images.
      kps_lvl: (N, 2) keypoint positions at this level (xy, px).
      flow: (N, 2) current flow estimates at this level.
      alive: (N,) bool — tracks still valid.

    Returns: (flow, alive, min_eig, residual)
    """
    H, W = img_prev.shape
    r = win // 2
    n_px = win * win

    tpatch = extract_patches(img_prev, kps_lvl - (r + 1), win + 2)
    T = tpatch[:, 1:-1, 1:-1]
    Ix = 0.5 * (tpatch[:, 1:-1, 2:] - tpatch[:, 1:-1, :-2])
    Iy = 0.5 * (tpatch[:, 2:, 1:-1] - tpatch[:, :-2, 1:-1])

    gxx = torch.sum(Ix * Ix, dim=(-2, -1))
    gxy = torch.sum(Ix * Iy, dim=(-2, -1))
    gyy = torch.sum(Iy * Iy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / (
        2.0 * n_px)
    good_g = min_eig > min_eig_th
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12),
                           det)
    iA = gyy / det_safe
    iB = -gxy / det_safe
    iD = gxx / det_safe

    S = win + 2 * margin
    base = torch.floor(kps_lvl + flow) - r - margin        # (N, 2) int-valued
    spatch = extract_patches(img_cur, base, S)

    converged = torch.zeros(flow.shape[0], dtype=torch.bool,
                            device=flow.device)
    for _ in range(iters):
        off = (kps_lvl + flow) - r - base
        I = sample_window(spatch, off, win)
        diff = T - I
        bx = torch.sum(Ix * diff, dim=(-2, -1))
        by = torch.sum(Iy * diff, dim=(-2, -1))
        dx = iA * bx + iB * by
        dy = iB * bx + iD * by
        step_ok = (~converged) & alive & good_g
        flow = torch.where(step_ok[:, None],
                           flow + torch.stack([dx, dy], -1), flow)
        converged = converged | (dx * dx + dy * dy < eps * eps)

    centers = kps_lvl + flow
    in_img = (
        (centers[:, 0] >= r) & (centers[:, 0] <= W - 1 - r)
        & (centers[:, 1] >= r) & (centers[:, 1] <= H - 1 - r)
    )
    I = sample_window(spatch, centers - r - base, win)
    residual = torch.mean(torch.abs(I - T), dim=(-2, -1))
    alive = alive & good_g & in_img
    return flow, alive, min_eig, residual


def klt_track(
    pyr_prev: Sequence[torch.Tensor],
    pyr_cur: Sequence[torch.Tensor],
    kps, priors, valid,
    win: int = 9, iters: int = 30, eps: float = 0.01,
    min_eig_th: float = 1e-4, max_err: float = 30.0, margin: int = 5,
):
    """Forward pyramidal KLT with priors.

    Args:
      pyr_prev/pyr_cur: sequences of level images, level 0 first.
      kps: (N, 2) positions in prev frame (level-0 px).
      priors: (N, 2) initial guesses in cur frame (level-0 px).
      valid: (N,) bool.

    Returns:
      (tracked (N, 2), status (N,), residual (N,))
    """
    levels = len(pyr_prev)
    flow = (priors - kps) / (2.0 ** (levels - 1))
    alive = valid
    residual = torch.zeros(kps.shape[0], dtype=pyr_prev[0].dtype,
                           device=kps.device)

    for lvl in range(levels - 1, -1, -1):
        scale = 2.0 ** lvl
        kps_lvl = kps / scale
        flow, alive, min_eig, residual = track_level(
            pyr_prev[lvl], pyr_cur[lvl], kps_lvl, flow, alive,
            win, iters, eps, min_eig_th, margin)
        if lvl > 0:
            flow = flow * 2.0

    status = alive & (residual < max_err)
    return kps + flow, status, residual


def fb_klt_track_split(
    pyr_prev: Sequence[torch.Tensor],
    pyr_cur: Sequence[torch.Tensor],
    kps, priors, valid, base_only,
    n_sub: int,
    win: int = 9, iters: int = 30, eps: float = 0.01,
    min_eig_th: float = 1e-4, max_err: float = 30.0,
    max_fb_dist: float = 0.5, margin: int = 5,
    n_base_levels: int = 1, priors2=None,
):
    """3D/2D split forward-backward KLT (the reference's two-pass tracking).

      pass 1: fb over the bottom ``n_base_levels`` levels (backward on the
              base level), prior-seeded, all N rows, with the fb gate.
      pass 2: all 2D kps and the fb failures of pass 1, compacted (stable
              sort) into an ``n_sub``-row batch that runs the full fb
              pyramid from px (or from ``priors2`` where given).

    Overflow (more than ``n_sub`` rows need pass 2) behaves as the JAX
    version does: the extra rows keep their pass-1 result and status.

    Returns (tracked (N, 2), status (N,)) — status is fb-validated.
    """
    base_prev = tuple(pyr_prev[:n_base_levels])
    base_cur = tuple(pyr_cur[:n_base_levels])
    fwd1, st1f, _ = klt_track(
        base_prev, base_cur, kps, priors, valid,
        win=win, iters=iters, eps=eps, min_eig_th=min_eig_th,
        max_err=max_err, margin=margin)
    bwd1, st1b, _ = klt_track(
        (base_cur[0],), (base_prev[0],), fwd1, kps, st1f,
        win=win, iters=iters, eps=eps, min_eig_th=min_eig_th,
        max_err=max_err, margin=margin)
    st1 = st1f & st1b & (torch.linalg.norm(bwd1 - kps, dim=-1)
                         <= max_fb_dist)

    need2 = valid & ((~base_only) | (~st1))
    idx = torch.argsort((~need2).to(torch.uint8), stable=True)[:n_sub]
    s_sel = need2[idx]
    s_kps = kps[idx]
    p2 = s_kps if priors2 is None else priors2[idx]
    fwd2, st2 = fb_klt_track(
        pyr_prev, pyr_cur, s_kps, p2, s_sel,
        win=win, iters=iters, eps=eps, min_eig_th=min_eig_th,
        max_err=max_err, max_fb_dist=max_fb_dist, margin=margin)

    fwd = torch.where(st1[:, None], fwd1, kps)
    fwd = fwd.clone()
    fwd[idx] = torch.where(s_sel[:, None], fwd2, fwd[idx])
    status = st1.clone()
    status[idx] = torch.where(s_sel, st2, st1[idx])
    return fwd, status


def fb_klt_track(
    pyr_prev: Sequence[torch.Tensor],
    pyr_cur: Sequence[torch.Tensor],
    kps, priors, valid,
    win: int = 9, iters: int = 30, eps: float = 0.01,
    min_eig_th: float = 1e-4, max_err: float = 30.0,
    max_fb_dist: float = 0.5, back_levels: int = 1, margin: int = 5,
):
    """Forward-backward KLT: forward over the whole pyramid, backward over
    ``back_levels`` (1 = base level only, as the reference), then the
    fb-distance gate.

    Returns (tracked (N, 2), status (N,)).
    """
    fwd, st_f, _ = klt_track(pyr_prev, pyr_cur, kps, priors, valid,
                             win=win, iters=iters, eps=eps,
                             min_eig_th=min_eig_th, max_err=max_err,
                             margin=margin)
    bwd, st_b, _ = klt_track(tuple(pyr_cur[:back_levels]),
                             tuple(pyr_prev[:back_levels]), fwd, kps, st_f,
                             win=win, iters=iters, eps=eps,
                             min_eig_th=min_eig_th, max_err=max_err,
                             margin=margin)
    fb_dist = torch.linalg.norm(bwd - kps, dim=-1)
    status = st_f & st_b & (fb_dist <= max_fb_dist)
    return fwd, status
