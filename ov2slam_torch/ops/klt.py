"""Pyramidal forward-backward KLT tracking, batched over keypoints: the
CUDA kernel and its plain versions.

Port of ``ov2slam_tpu/ops/klt.py`` (the reference's
`FeatureTracker::fbKltTracking` around cv::calcOpticalFlowPyrLK):

- forward pass over the full pyramid with initial-flow priors,
- min-eigenvalue gating of the spatial gradient matrix,
- backward pass on the base level only,
- forward-backward distance check.

:func:`klt_track` and :func:`fb_klt_track` take CPU tensors to their plain
versions (:func:`klt_track_plain`, :func:`fb_klt_track_plain`); on CUDA
tensors each is one launch of ``csrc/klt_track.cu`` (every level, every
step, and in fb mode the backward pass and the fb gate) on the current
stream, or raises. :func:`fb_klt_track_split` is two fb calls around a
compaction in torch.

In the plain version, per level, the template and a search window with
``margin`` px of slack on each side are gathered once
(``ops/patch.extract_patches``); each Gauss-Newton iteration resamples the
window inside the search patch (``ops/patch.sample_window``). Flow
corrections beyond the margin within one level are clamped, as in the JAX
version.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Sequence

import torch

from .. import kernels
from .patch import extract_patches, sample_window

# what csrc/klt_track.cu is sized for
MAX_LEVELS = 8
MAX_WIN = 15
MAX_MARGIN = 8


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


def klt_track_plain(
    pyr_prev: Sequence[torch.Tensor],
    pyr_cur: Sequence[torch.Tensor],
    kps, priors, valid,
    win: int = 9, iters: int = 30, eps: float = 0.01,
    min_eig_th: float = 1e-4, max_err: float = 30.0, margin: int = 5,
):
    """Forward pyramidal KLT with priors, in plain PyTorch: a fixed
    ``iters`` steps at every level.

    Args:
      pyr_prev/pyr_cur: sequences of level images, level 0 first.
      kps: (N, 2) positions in prev frame (level-0 px).
      priors: (N, 2) initial guesses in cur frame (level-0 px).
      valid: (N,) bool.

    Returns:
      (tracked (N, 2), status (N,), residual (N,))
    """
    if kps.is_cuda:
        klt_track_plain.cuda_runs += 1
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


# calls on CUDA tensors (the main path must make none)
klt_track_plain.cuda_runs = 0


def fb_klt_track_plain(
    pyr_prev: Sequence[torch.Tensor],
    pyr_cur: Sequence[torch.Tensor],
    kps, priors, valid,
    win: int = 9, iters: int = 30, eps: float = 0.01,
    min_eig_th: float = 1e-4, max_err: float = 30.0,
    max_fb_dist: float = 0.5, back_levels: int = 1, margin: int = 5,
):
    """Forward-backward KLT in plain PyTorch: forward over the whole
    pyramid, backward over ``back_levels`` (1 = base level only, as the
    reference), then the fb-distance gate.

    Returns (tracked (N, 2), status (N,)).
    """
    if kps.is_cuda:
        fb_klt_track_plain.cuda_runs += 1
    fwd, st_f, _ = klt_track_plain(pyr_prev, pyr_cur, kps, priors, valid,
                                   win=win, iters=iters, eps=eps,
                                   min_eig_th=min_eig_th, max_err=max_err,
                                   margin=margin)
    bwd, st_b, _ = klt_track_plain(tuple(pyr_cur[:back_levels]),
                                   tuple(pyr_prev[:back_levels]), fwd, kps,
                                   st_f, win=win, iters=iters, eps=eps,
                                   min_eig_th=min_eig_th, max_err=max_err,
                                   margin=margin)
    fb_dist = torch.linalg.norm(bwd - kps, dim=-1)
    status = st_f & st_b & (fb_dist <= max_fb_dist)
    return fwd, status


fb_klt_track_plain.cuda_runs = 0


class LaunchArgs:
    """The arguments of one ``klt_track_launch`` call but the outputs and
    the stream, in the C function's order (:meth:`c_args`): the level
    table (2·levels pointers, prev levels then cur levels), the level
    sizes (prev H, prev W, cur H, cur W per level), the inputs' pointers,
    the sizes, the keypoint and prior row strides (floats), and the
    thresholds as the plain version compares them (f32)."""

    def __init__(self, ptrs, dims, levels, back_levels, kps, priors, valid,
                 n, kps_stride, priors_stride, win, iters, margin, eps2,
                 min_eig_th, max_err, max_fb):
        self.ptrs, self.dims = ptrs, dims
        self.levels, self.back_levels = levels, back_levels
        self.kps, self.priors, self.valid = kps, priors, valid
        self.n, self.win, self.iters, self.margin = n, win, iters, margin
        self.kps_stride, self.priors_stride = kps_stride, priors_stride
        self.eps2, self.min_eig_th = eps2, min_eig_th
        self.max_err, self.max_fb = max_err, max_fb

    def c_args(self):
        return (ctypes.addressof(self.ptrs), ctypes.addressof(self.dims),
                self.levels, self.back_levels, self.kps, self.priors,
                self.valid, self.n, self.kps_stride, self.priors_stride,
                self.win, self.iters, self.margin,
                self.eps2, self.min_eig_th, self.max_err, self.max_fb)


def pack_launch(pyr_prev, pyr_cur, kps, priors, valid, back_levels: int,
                win: int, iters: int, eps: float, min_eig_th: float,
                max_err: float, max_fb_dist: float,
                margin: int) -> LaunchArgs:
    """Check the inputs of one kernel launch and pack its arguments.

    Raises TypeError on a dtype the kernel does not take (f32 images,
    keypoints and priors, bool ``valid``) and ValueError on a tensor on
    another device than ``kps``, on a level image or ``valid`` that is not
    contiguous, on keypoints or priors whose rows are not two adjacent
    floats (rows may be strided: the front end passes a column view of its
    packed state, read in place), on shapes that do not match, on more
    than :data:`MAX_LEVELS` levels, and on a window or margin above
    :data:`MAX_WIN`, :data:`MAX_MARGIN`."""
    dev = kps.device
    levels = len(pyr_prev)
    if len(pyr_cur) != levels:
        raise ValueError(f"klt_track: {levels} prev levels but "
                         f"{len(pyr_cur)} cur levels")
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"klt_track: {levels} levels; the kernel takes 1 "
                         f"to {MAX_LEVELS}")
    if not 0 <= back_levels <= levels:
        raise ValueError(f"klt_track: back_levels {back_levels} of "
                         f"{levels} levels")
    if not 1 <= win <= MAX_WIN or not 0 <= margin <= MAX_MARGIN:
        raise ValueError(f"klt_track: win {win}, margin {margin}; the "
                         f"kernel takes win <= {MAX_WIN}, margin <= "
                         f"{MAX_MARGIN}")
    if iters < 0:
        raise ValueError(f"klt_track: iters {iters}")
    n = kps.shape[0]
    tensors = [(f"pyr_prev[{i}]", t, torch.float32)
               for i, t in enumerate(pyr_prev)]
    tensors += [(f"pyr_cur[{i}]", t, torch.float32)
                for i, t in enumerate(pyr_cur)]
    tensors += [("kps", kps, torch.float32), ("priors", priors,
                                              torch.float32),
                ("valid", valid, torch.bool)]
    for name, t, dt in tensors:
        if t.device != dev:
            raise ValueError(f"klt_track: {name} is on {t.device}, kps on "
                             f"{dev}")
        if t.dtype != dt:
            raise TypeError(f"klt_track: {name} must be {dt}, not {t.dtype}")
        rows = name in ("kps", "priors") and t.dim() == 2 and (
            t.stride(1) == 1 and t.stride(0) >= 0)
        if not (rows or t.is_contiguous()):
            raise ValueError(f"klt_track: {name} must be contiguous" + (
                " rows" if name in ("kps", "priors") else ""))
    for name, t, _ in tensors[:2 * levels]:
        if t.dim() != 2:
            raise ValueError(f"klt_track: {name} must be (H, W)")
    if kps.shape != (n, 2) or priors.shape != (n, 2) or \
            valid.shape != (n,):
        raise ValueError("klt_track: kps, priors must be (N, 2) and valid "
                         "(N,)")
    ptrs = (ctypes.c_int64 * (2 * levels))(
        *[t.data_ptr() for t in (*pyr_prev, *pyr_cur)])
    dims = (ctypes.c_int32 * (4 * levels))(
        *[d for a, b in zip(pyr_prev, pyr_cur) for d in (*a.shape,
                                                           *b.shape)])
    return LaunchArgs(ptrs, dims, levels, back_levels, kps.data_ptr(),
                      priors.data_ptr(), valid.data_ptr(), n,
                      kps.stride(0), priors.stride(0), win, iters, margin,
                      float(eps) * float(eps), float(min_eig_th),
                      float(max_err), float(max_fb_dist))


def launch(pyr_prev, pyr_cur, kps, priors, valid, back_levels: int = 0,
           win: int = 9, iters: int = 30, eps: float = 0.01,
           min_eig_th: float = 1e-4, max_err: float = 30.0,
           max_fb_dist: float = 0.5, margin: int = 5, steps=None):
    """One launch of ``csrc/klt_track.cu`` on CUDA tensors, on the current
    stream of their device: :func:`klt_track_plain` (``back_levels`` 0) or
    :func:`fb_klt_track_plain` (``back_levels`` > 0) in one kernel.
    Returns (tracked (N, 2), status (N,), forward residual (N,)). ``steps``,
    an (N,) int32 CUDA tensor, receives the LK steps each keypoint took
    over every pass. N = 0 launches nothing."""
    a = pack_launch(pyr_prev, pyr_cur, kps, priors, valid, back_levels,
                    win, iters, eps, min_eig_th, max_err, max_fb_dist,
                    margin)
    dev = kps.device
    xy = torch.empty((a.n, 2), dtype=torch.float32, device=dev)
    status = torch.empty(a.n, dtype=torch.bool, device=dev)
    residual = torch.empty(a.n, dtype=torch.float32, device=dev)
    if steps is not None and (steps.device != dev or steps.dtype !=
                              torch.int32 or steps.shape != (a.n,)):
        raise ValueError("klt_track: steps must be (N,) int32 on the "
                         "keypoints' device")
    if a.n == 0:
        return xy, status, residual
    lib = kernels.load("klt_track")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.klt_track_launch(
            *a.c_args(), xy.data_ptr(), status.data_ptr(),
            residual.data_ptr(), steps.data_ptr() if steps is not None
            else None, stream)
    if rc != 0:
        raise RuntimeError(f"klt_track launch failed: code {rc}")
    klt_track.launches += 1
    klt_track.shapes[(a.n, a.levels, back_levels > 0)] += 1
    klt_track.origins[(threading.current_thread().name, stream)] += 1
    return xy, status, residual


def _device(kps, fn):
    dev = kps.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    return dev


def klt_track(
    pyr_prev: Sequence[torch.Tensor],
    pyr_cur: Sequence[torch.Tensor],
    kps, priors, valid,
    win: int = 9, iters: int = 30, eps: float = 0.01,
    min_eig_th: float = 1e-4, max_err: float = 30.0, margin: int = 5,
):
    """Forward pyramidal KLT with priors (see :func:`klt_track_plain`).
    CPU tensors take the plain version; CUDA tensors one kernel launch.

    Returns (tracked (N, 2), status (N,), residual (N,))."""
    if _device(kps, "klt_track").type == "cpu":
        return klt_track_plain(pyr_prev, pyr_cur, kps, priors, valid,
                               win=win, iters=iters, eps=eps,
                               min_eig_th=min_eig_th, max_err=max_err,
                               margin=margin)
    return launch(pyr_prev, pyr_cur, kps, priors, valid, 0, win=win,
                  iters=iters, eps=eps, min_eig_th=min_eig_th,
                  max_err=max_err, margin=margin)


# launches of the kernel (by klt_track, fb_klt_track and the split), how
# many at each (N, levels, fb), and how many from each (thread name, CUDA
# stream handle)
klt_track.launches = 0
klt_track.shapes = collections.Counter()
klt_track.origins = collections.Counter()


def fb_klt_track(
    pyr_prev: Sequence[torch.Tensor],
    pyr_cur: Sequence[torch.Tensor],
    kps, priors, valid,
    win: int = 9, iters: int = 30, eps: float = 0.01,
    min_eig_th: float = 1e-4, max_err: float = 30.0,
    max_fb_dist: float = 0.5, back_levels: int = 1, margin: int = 5,
):
    """Forward-backward KLT (see :func:`fb_klt_track_plain`). CPU tensors
    take the plain version; CUDA tensors one kernel launch.

    Returns (tracked (N, 2), status (N,))."""
    if _device(kps, "fb_klt_track").type == "cpu":
        return fb_klt_track_plain(pyr_prev, pyr_cur, kps, priors, valid,
                                  win=win, iters=iters, eps=eps,
                                  min_eig_th=min_eig_th, max_err=max_err,
                                  max_fb_dist=max_fb_dist,
                                  back_levels=back_levels, margin=margin)
    if back_levels < 1:
        raise ValueError(f"fb_klt_track: back_levels {back_levels}")
    xy, status, _ = launch(pyr_prev, pyr_cur, kps, priors, valid,
                           back_levels, win=win, iters=iters, eps=eps,
                           min_eig_th=min_eig_th, max_err=max_err,
                           max_fb_dist=max_fb_dist, margin=margin)
    return xy, status


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

    Each pass is one call of :func:`fb_klt_track` (one launch on CUDA);
    the compaction and the merge are torch ops on the keypoints' device.
    Overflow (more than ``n_sub`` rows need pass 2) behaves as the JAX
    version does: the extra rows keep their pass-1 result and status.

    Returns (tracked (N, 2), status (N,)) — status is fb-validated.
    """
    fwd1, st1 = fb_klt_track(
        tuple(pyr_prev[:n_base_levels]), tuple(pyr_cur[:n_base_levels]),
        kps, priors, valid, win=win, iters=iters, eps=eps,
        min_eig_th=min_eig_th, max_err=max_err, max_fb_dist=max_fb_dist,
        margin=margin)

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
