"""Grid-bucketed corner detection, batched over cells.

Port of ``ov2slam_tpu/ops/detect.py`` (the reference's `FeatureExtractor`):
the response is computed for the whole image and the per-cell top-1
selection is a single reshaped argmax.

Reference semantics kept:
- cells containing a currently-tracked keypoint are skipped,
- candidates within cellsize/4 of an existing keypoint are dropped,
- response threshold relative to the per-image max (quality level),
- sub-pixel corner refinement via quadratic fit or cornerSubPix.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.image import box_filter, scharr_gradients


# --------------------------------------------------------------------------
# Response images
# --------------------------------------------------------------------------

def shi_tomasi_response(img, block: int = 3):
    """Min-eigenvalue of the structure tensor (cv::cornerMinEigenVal)."""
    gx, gy = scharr_gradients(img)
    gxx = box_filter(gx * gx, block)
    gxy = box_filter(gx * gy, block)
    gyy = box_filter(gy * gy, block)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    return (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / 2.0


# standard Bresenham circle of radius 3 (16 px), (dx, dy):
_FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def fast_response(img, threshold: float, arc: int = 9):
    """FAST-N corner response (0 where not a corner, else the sum of
    absolute circle differences exceeding the threshold).

    The 16 ring flags are packed into one int32 per pixel and all 16
    rotations of a contiguous ``arc``-bit mask are tested.
    """
    H, W = img.shape
    pad = 3
    p = F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    ring = torch.stack(
        [p[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
         for (dx, dy) in _FAST_OFFSETS], dim=0)  # (16, H, W)

    diff = ring - img[None]
    brighter = diff > threshold
    darker = diff < -threshold
    weights = (1 << torch.arange(16, dtype=torch.int32, device=img.device))

    def has_arc(flags):
        packed = torch.sum(flags.to(torch.int32) * weights[:, None, None],
                           dim=0)
        out = torch.zeros(flags.shape[1:], dtype=torch.bool,
                          device=img.device)
        base = (1 << arc) - 1
        for s in range(16):
            m = ((base << s) | (base >> (16 - s))) & 0xFFFF
            out = out | ((packed & m) == m)
        return out

    is_corner = has_arc(brighter) | has_arc(darker)
    score = torch.sum(torch.clamp(diff.abs() - threshold, min=0.0), dim=0)
    return torch.where(is_corner, score, torch.zeros_like(score))


# --------------------------------------------------------------------------
# Grid selection
# --------------------------------------------------------------------------

def _subpix_quadratic(resp_pad, px, py):
    """Sub-pixel peak refinement by 1D quadratic fits on the 3x3 response
    neighborhood."""
    c = resp_pad[py + 1, px + 1]
    l = resp_pad[py + 1, px]
    r = resp_pad[py + 1, px + 2]
    u = resp_pad[py, px + 1]
    d = resp_pad[py + 2, px + 1]
    denx = l - 2 * c + r
    deny = u - 2 * c + d
    zero = torch.zeros_like(c)
    dx = torch.where(denx.abs() > 1e-9,
                     0.5 * (l - r) / torch.where(denx.abs() > 1e-9, denx,
                                                 torch.ones_like(denx)),
                     zero)
    dy = torch.where(deny.abs() > 1e-9,
                     0.5 * (u - d) / torch.where(deny.abs() > 1e-9, deny,
                                                 torch.ones_like(deny)),
                     zero)
    return torch.clamp(dx, -0.5, 0.5), torch.clamp(dy, -0.5, 0.5)


def grid_detect(
    response,
    existing_kps,
    existing_valid,
    quality_th,
    cell_size: int,
    max_out: int,
    refine: bool = True,
    two_pass: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cell top-1 detection with occupancy masking.

    Args:
      response: (H, W) corner response image.
      existing_kps: (M, 2) xy of currently tracked keypoints.
      existing_valid: (M,) bool.
      quality_th: absolute response threshold.
      cell_size: grid cell size in px.
      max_out: output capacity (>= number of cells).
      two_pass: GFTT fill-in semantics — candidates above quality_th rank
        first, cells whose best only clears quality_th/2 are still filled.

    Returns:
      kps (max_out, 2) xy, scores (max_out,), valid (max_out,) —
      sorted by score descending.
    """
    H, W = response.shape
    dev = response.device
    gy, gx = H // cell_size, W // cell_size

    radius = cell_size / 4.0
    ex = torch.where(existing_valid[:, None], existing_kps,
                     torch.full_like(existing_kps, -1e6))

    cell_ids = (torch.clamp(torch.div(ex[:, 1], cell_size,
                                      rounding_mode="floor"),
                            0, gy - 1).long() * gx
                + torch.clamp(torch.div(ex[:, 0], cell_size,
                                        rounding_mode="floor"),
                              0, gx - 1).long())
    occupied = torch.zeros(gy * gx, dtype=torch.int64, device=dev)
    occupied.index_add_(0, cell_ids[existing_valid],
                        torch.ones_like(cell_ids[existing_valid]))
    occupied = occupied > 0

    crop = response[: gy * cell_size, : gx * cell_size]
    cells = crop.reshape(gy, cell_size, gx, cell_size).permute(0, 2, 1, 3)
    cells = cells.reshape(gy * gx, cell_size * cell_size)
    best = torch.argmax(cells, dim=-1)
    score = torch.gather(cells, 1, best[:, None])[:, 0]

    by = best // cell_size
    bx = best % cell_size
    ar = torch.arange(gy * gx, device=dev)
    cy = ar // gx
    cx = ar % gx
    px = cx * cell_size + bx
    py = cy * cell_size + by

    cand = torch.stack([px.to(response.dtype), py.to(response.dtype)], -1)
    d2 = torch.sum((cand[:, None, :] - ex[None, :, :]) ** 2, dim=-1)
    near_existing = (d2 < radius * radius).any(dim=1)

    accept_th = quality_th / 2.0 if two_pass else quality_th
    ok = (score > accept_th) & (~occupied) & (~near_existing)

    if refine:
        resp_pad = F.pad(response[None, None], (1, 1, 1, 1),
                         mode="replicate")[0, 0]
        dx, dy = _subpix_quadratic(resp_pad, px, py)
    else:
        dx = dy = torch.zeros_like(score)

    kps = torch.stack([px + dx, py + dy], dim=-1)

    rank_score = score
    if two_pass:
        bonus = torch.where(score > quality_th,
                            torch.full_like(score, 1e30),
                            torch.zeros_like(score))
        rank_score = score + bonus
    key = torch.where(ok, -rank_score, torch.full_like(score, float("inf")))
    order = torch.argsort(key, stable=True)
    kps = kps[order][:max_out]
    score = score[order][:max_out]
    ok = ok[order][:max_out]

    # cross-cell NMS: suppress any candidate within the mask radius of a
    # higher-ranked one
    d2 = torch.sum((kps[:, None, :] - kps[None, :, :]) ** 2, dim=-1)
    n = kps.shape[0]
    ar = torch.arange(n, device=dev)
    higher = ar[None, :] < ar[:, None]
    clash = (d2 < radius * radius) & higher & ok[None, :]
    ok = ok & ~clash.any(dim=1)
    pad = max_out - kps.shape[0]
    if pad > 0:
        kps = F.pad(kps, (0, 0, 0, pad))
        score = F.pad(score, (0, pad))
        ok = F.pad(ok, (0, pad))
    return kps, score, ok


def _bilinear_scalar(im, x, y):
    """Bilinear image sample at fractional (x, y), edge-clamped."""
    H, W = im.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    v00 = im[y0, x0]
    v01 = im[y0, x0 + 1]
    v10 = im[y0 + 1, x0]
    v11 = im[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def corner_subpix(img, kps, valid, half_win: int = 3, iters: int = 5):
    """Iterative sub-pixel corner refinement (cv::cornerSubPix semantics):
    q solves G q = b with G = Σ w ∇I∇Iᵀ and b = Σ w ∇I∇Iᵀ p, ``iters``
    fixed steps batched over keypoints; refinements that move more than
    half_win fall back to the input."""
    gx, gy = scharr_gradients(img)
    r = torch.arange(-half_win, half_win + 1, dtype=img.dtype,
                     device=img.device)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    off = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)   # (K, 2)
    w = torch.exp(-(off ** 2).sum(-1) / (2.0 * (half_win / 2.0) ** 2))

    c = kps
    for _ in range(iters):
        px = c[:, 0:1] + off[None, :, 0]
        py = c[:, 1:2] + off[None, :, 1]
        gxs = _bilinear_scalar(gx, px, py)
        gys = _bilinear_scalar(gy, px, py)
        a = (w * gxs * gxs).sum(-1)
        b = (w * gxs * gys).sum(-1)
        d = (w * gys * gys).sum(-1)
        bx = (w * (gxs * gxs * px + gxs * gys * py)).sum(-1)
        by = (w * (gxs * gys * px + gys * gys * py)).sum(-1)
        det = a * d - b * b
        ok = det.abs() > 1e-9
        det_s = torch.where(ok, det, torch.ones_like(det))
        qx = torch.where(ok, (d * bx - b * by) / det_s, c[:, 0])
        qy = torch.where(ok, (-b * bx + a * by) / det_s, c[:, 1])
        qx = c[:, 0] + torch.clamp(qx - c[:, 0], -1.0, 1.0)
        qy = c[:, 1] + torch.clamp(qy - c[:, 1], -1.0, 1.0)
        c = torch.stack([qx, qy], -1)

    moved = torch.linalg.norm(c - kps, dim=-1)
    keep = (moved <= half_win) & valid
    return torch.where(keep[:, None], c, kps)


def detect_gftt(img, existing_kps, existing_valid, quality_level,
                cell_size: int, max_out: int):
    """GFTT detection: masked Shi-Tomasi, two-pass fill-in, then iterative
    cornerSubPix refinement on the image."""
    resp = shi_tomasi_response(img)
    th = quality_level * torch.max(resp)
    kps, scores, ok = grid_detect(resp, existing_kps, existing_valid, th,
                                  cell_size=cell_size, max_out=max_out,
                                  refine=True, two_pass=True)
    kps = corner_subpix(img, kps, ok)
    return kps, scores, ok


def detect_single_scale(img, existing_kps, existing_valid, quality_level,
                        cell_size: int, max_out: int):
    """Shi-Tomasi single-scale grid detection; quality_level is relative to
    the image's max response, like cv::goodFeaturesToTrack."""
    resp = shi_tomasi_response(img)
    th = quality_level * torch.max(resp)
    return grid_detect(resp, existing_kps, existing_valid, th,
                       cell_size=cell_size, max_out=max_out)


def detect_grid_fast(img, existing_kps, existing_valid, fast_th,
                     cell_size: int, max_out: int):
    """FAST-9 grid detection."""
    resp = fast_response(img, fast_th)
    return grid_detect(resp, existing_kps, existing_valid, 0.0,
                       cell_size=cell_size, max_out=max_out, refine=False)
