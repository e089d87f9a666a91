"""The plain reference of the SLAM front end's image and tracking layers,
and the comparison that decides ``correct`` on the frames a SLAM cell
samples from its window.

CLAHE (cv::createCLAHE(clip, (8, 8)) on 256 bins: clipped tile
histograms, their CDFs as look-up tables, bilinear blending between
tiles), the Gaussian pyramid (5-tap [1 4 6 4 1] / 16 blur, edge
replicated, every second row and column) and forward-backward pyramidal
Lucas-Kanade (OpenCV's calcOpticalFlowPyrLK as OV2SLAM's fbKltTracking
calls it: the forward pass over every level from a prior, the backward
pass on the base level, the forward-backward distance gate).
Plain PyTorch in the image's dtype, in the order of the program's plain
versions (``core/image.py``, ``ops/klt.py``, ``ops/patch.py``), so that
in float32 on the same device it rounds alike; ``torch.bfloat16`` images
make the control.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

PYR_TAPS = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]


def _filter_x(img, taps):
    r = len(taps) // 2
    H, W = img.shape
    p = F.pad(img[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for i, t in enumerate(taps):
        if t != 0.0:
            out = out + float(t) * p[:, i:i + W]
    return out


def _filter_y(img, taps):
    r = len(taps) // 2
    H, W = img.shape
    p = F.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for i, t in enumerate(taps):
        if t != 0.0:
            out = out + float(t) * p[i:i + H, :]
    return out


def pyramid(img, levels: int) -> List[torch.Tensor]:
    """Level 0 the image; each level below the blur of the one above, every
    second row and column."""
    pyr = [img]
    for _ in range(levels - 1):
        out = _filter_x(_filter_y(pyr[-1], PYR_TAPS), PYR_TAPS)
        pyr.append(out[::2, ::2].contiguous())
    return pyr


def clahe(img, clip_limit: float = 3.0, tiles=(8, 8), nbins: int = 256):
    """Contrast-limited adaptive histogram equalization of an image in
    [0, 255]."""
    H, W = img.shape
    ty, tx = tiles
    th, tw = -(-H // ty), -(-W // tx)
    padded = F.pad(img[None, None], (0, tx * tw - W, 0, ty * th - H),
                   mode="replicate")[0, 0]
    bins = torch.clamp(padded.to(torch.int64), 0, nbins - 1)
    tiles_img = bins.reshape(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(
        ty * tx, th * tw)
    hist = torch.zeros((ty * tx, nbins), dtype=torch.float32,
                       device=img.device)
    hist.scatter_add_(1, tiles_img, torch.ones_like(tiles_img,
                                                    dtype=torch.float32))
    hist = hist.to(img.dtype)
    npx = th * tw
    limit = max(clip_limit * npx / nbins, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=1,
                       keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins
    cdf = torch.cumsum(hist, dim=1)
    cdf = (cdf - cdf[:, :1]) / torch.clamp(cdf[:, -1:] - cdf[:, :1], min=1.0)
    luts = (cdf * (nbins - 1.0)).reshape(ty, tx, nbins).to(img.dtype)
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=img.dtype, device=img.device),
        torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")
    fy = (yy - th / 2.0 + 0.5) / th
    fx = (xx - tw / 2.0 + 0.5) / tw
    y0 = torch.clamp(torch.floor(fy).long(), 0, ty - 1)
    x0 = torch.clamp(torch.floor(fx).long(), 0, tx - 1)
    y1 = torch.clamp(y0 + 1, 0, ty - 1)
    x1 = torch.clamp(x0 + 1, 0, tx - 1)
    wy = torch.clamp(fy - y0, 0.0, 1.0)
    wx = torch.clamp(fx - x0, 0.0, 1.0)
    b = torch.clamp(img.to(torch.int64), 0, nbins - 1)
    v00 = luts[y0, x0, b]
    v01 = luts[y0, x1, b]
    v10 = luts[y1, x0, b]
    v11 = luts[y1, x1, b]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def preprocess(img_u8, dtype, use_clahe: bool, clip: float, levels: int,
               device) -> List[torch.Tensor]:
    """An 8-bit frame as the front end sees it: CLAHE'd (where the
    configuration says so), then its pyramid."""
    im = torch.as_tensor(img_u8, device=device).to(dtype)
    if use_clahe:
        im = clahe(im, clip)
    return pyramid(im, levels)


# ---- bilinear patches --------------------------------------------------

def _hat_pair(pos):
    i0 = torch.floor(pos)
    w0 = torch.clamp(1.0 - torch.abs(i0 - pos), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(i0 + 1.0 - pos), min=0.0)
    return i0, w0, w1


def _read(img, yi, xi):
    H, W = img.shape
    ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    v = img.reshape(-1)[idx]
    return torch.where(ok, v, torch.zeros_like(v))


def extract_patches(img, top_left, P: int):
    dtype, dev = img.dtype, img.device
    y_pos = top_left[:, 1:2] + torch.arange(P, dtype=dtype, device=dev)[None]
    x_pos = top_left[:, 0:1] + torch.arange(P, dtype=dtype, device=dev)[None]
    y0, wy0, wy1 = _hat_pair(y_pos)
    x0, wx0, wx1 = _hat_pair(x_pos)
    y0 = y0.long()[:, :, None]
    x0 = x0.long()[:, None, :]
    wy0, wy1 = wy0[:, :, None], wy1[:, :, None]
    wx0, wx1 = wx0[:, None, :], wx1[:, None, :]
    r0 = wy0 * _read(img, y0, x0) + wy1 * _read(img, y0 + 1, x0)
    r1 = wy0 * _read(img, y0, x0 + 1) + wy1 * _read(img, y0 + 1, x0 + 1)
    return r0 * wx0 + r1 * wx1


def sample_window(patch, offset, out_size: int):
    N, S, _ = patch.shape
    shifts = S - out_size
    ox = torch.clamp(offset[:, 0], 0.0, float(shifts))
    oy = torch.clamp(offset[:, 1], 0.0, float(shifts))
    ar = torch.arange(out_size, device=patch.device)
    y0, wy0, wy1 = _hat_pair(oy)
    x0, wx0, wx1 = _hat_pair(ox)
    yi = (y0.long()[:, None] + ar[None])[:, :, None]
    xi = (x0.long()[:, None] + ar[None])[:, None, :]
    flat = patch.reshape(N, S * S)
    n = torch.arange(N, device=patch.device)[:, None, None]

    def rd(y, x):
        return flat[n, y.clamp(max=S - 1) * S + x.clamp(max=S - 1)]

    wy0, wy1 = wy0[:, None, None], wy1[:, None, None]
    wx0, wx1 = wx0[:, None, None], wx1[:, None, None]
    r0 = wy0 * rd(yi, xi) + wy1 * rd(yi + 1, xi)
    r1 = wy0 * rd(yi, xi + 1) + wy1 * rd(yi + 1, xi + 1)
    return r0 * wx0 + r1 * wx1


# ---- Lucas-Kanade --------------------------------------------------------

def _track_level(img_prev, img_cur, kps_lvl, flow, alive, win, iters, eps,
                 min_eig_th, margin):
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
    iA, iB, iD = gyy / det_safe, -gxy / det_safe, gxx / det_safe
    S = win + 2 * margin
    base = torch.floor(kps_lvl + flow) - r - margin
    spatch = extract_patches(img_cur, base, S)
    converged = torch.zeros(flow.shape[0], dtype=torch.bool,
                            device=flow.device)
    for _ in range(iters):
        off = (kps_lvl + flow) - r - base
        diff = T - sample_window(spatch, off, win)
        bx = torch.sum(Ix * diff, dim=(-2, -1))
        by = torch.sum(Iy * diff, dim=(-2, -1))
        dx = iA * bx + iB * by
        dy = iB * bx + iD * by
        step_ok = (~converged) & alive & good_g
        flow = torch.where(step_ok[:, None],
                           flow + torch.stack([dx, dy], -1), flow)
        converged = converged | (dx * dx + dy * dy < eps * eps)
    centers = kps_lvl + flow
    in_img = ((centers[:, 0] >= r) & (centers[:, 0] <= W - 1 - r)
              & (centers[:, 1] >= r) & (centers[:, 1] <= H - 1 - r))
    I = sample_window(spatch, centers - r - base, win)
    residual = torch.mean(torch.abs(I - T), dim=(-2, -1))
    return flow, alive & good_g & in_img, residual


def klt(pyr_prev, pyr_cur, kps, priors, valid, win=9, iters=30, eps=0.01,
        min_eig_th=1e-4, max_err=30.0, margin=5):
    """Forward pyramidal KLT from ``priors``: (tracked, status)."""
    levels = len(pyr_prev)
    flow = (priors - kps) / (2.0 ** (levels - 1))
    alive = valid
    residual = torch.zeros(kps.shape[0], dtype=pyr_prev[0].dtype,
                           device=kps.device)
    for lvl in range(levels - 1, -1, -1):
        flow, alive, residual = _track_level(
            pyr_prev[lvl], pyr_cur[lvl], kps / (2.0 ** lvl), flow, alive,
            win, iters, eps, min_eig_th, margin)
        if lvl > 0:
            flow = flow * 2.0
    return kps + flow, alive & (residual < max_err)


def fb_klt(pyr_prev, pyr_cur, kps, priors, valid, win=9, iters=30,
           max_err=30.0, max_fb_dist=0.5):
    """Forward over every level from ``priors``, backward on the base level
    to the previous positions, then the forward-backward gate: (tracked,
    status)."""
    fwd, st_f = klt(pyr_prev, pyr_cur, kps, priors, valid, win=win,
                    iters=iters, max_err=max_err)
    bwd, st_b = klt(pyr_cur[:1], pyr_prev[:1], fwd, kps, st_f, win=win,
                    iters=iters, max_err=max_err)
    fb = torch.linalg.norm((bwd - kps).float(), dim=-1)
    return fwd, st_f & st_b & (fb <= max_fb_dist)


# ---- the comparison ------------------------------------------------------

def compare_images(prog_pyr: Sequence[torch.Tensor],
                   ref_pyr: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The largest gap (grey levels) of level 0 (the CLAHE'd frame) and of
    the levels below it (the pyramid)."""
    def gap(a, b):
        d = (a.float() - b.float().to(a.device)).abs()
        return float(torch.nan_to_num(d, nan=255.0).max())

    return dict(clahe_max_err=gap(prog_pyr[0], ref_pyr[0]),
                pyramid_max_err=max(gap(a, b) for a, b in
                                    zip(prog_pyr[1:], ref_pyr[1:])))


def compare_tracks(prev: dict, cur: dict, ref_prev_pyr, ref_cur_pyr,
                   params: dict, tol_px: float) -> Dict[str, float]:
    """The front end's tracked keypoints of one frame against the
    reference's KLT. The slots that held the same landmark before and after
    the frame and that the program kept are tracked again by the reference
    from their previous positions, its search seeded at the program's
    answer (the program seeds its own from a prediction the reference does
    not have): a right answer is where the reference's search comes to rest
    and passes the forward-backward gate. Returns the slots compared, those
    the reference lost, those where it comes to rest more than ``tol_px``
    away, and the median and largest distance of the rest."""
    dev = ref_cur_pyr[0].device
    dtype = ref_cur_pyr[0].dtype
    px0 = torch.as_tensor(prev["px"], device=dev).to(dtype)
    px1 = torch.as_tensor(cur["px"], device=dev).float()
    lm0 = torch.as_tensor(prev["lmids"], device=dev)
    lm1 = torch.as_tensor(cur["lmids"], device=dev)
    tracked = (torch.as_tensor(prev["valid"], device=dev)
               & torch.as_tensor(cur["valid"], device=dev)
               & (lm0 == lm1) & (lm1 >= 0))
    fwd, st = fb_klt(ref_prev_pyr, ref_cur_pyr, px0, px1.to(dtype), tracked,
                     **params)
    off = torch.linalg.norm(fwd.float() - px1, dim=-1)
    lost = tracked & ~st
    far = tracked & st & ~(off <= tol_px)
    kept = off[tracked & st]
    return dict(tracked=int(tracked.sum()), lost=int(lost.sum()),
                far=int(far.sum()),
                off_p50=float(kept.median()) if kept.numel() else 0.0,
                off_max=float(kept.max()) if kept.numel() else 0.0)
