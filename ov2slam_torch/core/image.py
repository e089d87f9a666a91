"""Image preprocessing: pyramids, gradients, blur, CLAHE.

Port of ``ov2slam_tpu/core/image.py`` (the reference's OpenCV
preprocessing: CLAHE + buildOpticalFlowPyramid). Images are f32 in
[0, 255]. The separable filters keep the JAX package's edge-replicated
shift-add form, tap by tap, so the port sums in the same order; CLAHE
counts its tile histograms with ``scatter_add`` instead of the TPU's
comparison-reduce (the counts are exact integers either way).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _filter_x(img, taps) -> torch.Tensor:
    """Horizontal FIR via shift-add over an edge-replicated pad."""
    r = len(taps) // 2
    H, W = img.shape
    p = F.pad(img[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for i, t in enumerate(taps):
        if t != 0.0:
            out = out + float(t) * p[:, i:i + W]
    return out


def _filter_y(img, taps) -> torch.Tensor:
    r = len(taps) // 2
    H, W = img.shape
    p = F.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for i, t in enumerate(taps):
        if t != 0.0:
            out = out + float(t) * p[i:i + H, :]
    return out


def separable_filter(img, taps_y, taps_x):
    return _filter_x(_filter_y(img, taps_y), taps_x)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img, sigma: float = 1.0, radius: int = 2):
    """Separable Gaussian blur."""
    k = gaussian_kernel1d(sigma, radius)
    return separable_filter(img, k, k)


def box_filter(img, size: int = 3):
    k = np.full(size, 1.0 / size, np.float32)
    return separable_filter(img, k, k)


def scharr_gradients(img):
    """Scharr x/y gradients (OpenCV 3/10/3 kernel, scaled 1/32 so gradient
    units stay in intensity-per-pixel). Separable: [3,10,3]/16 ⊗ [-1,0,1]/2."""
    smooth = [3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0]
    diff = [-0.5, 0.0, 0.5]
    gx = _filter_x(_filter_y(img, smooth), diff)
    gy = _filter_y(_filter_x(img, smooth), diff)
    return gx, gy


def pyr_down(img):
    """Gaussian 5-tap blur + 2x decimation (cv::pyrDown equivalent)."""
    k = (np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0)
    return separable_filter(img, k, k)[::2, ::2].contiguous()


def build_pyramid(img, levels: int) -> List[torch.Tensor]:
    """Image pyramid, level 0 = full resolution (levels = nklt_pyr_lvl + 1)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


# --------------------------------------------------------------------------
# CLAHE
# --------------------------------------------------------------------------

def clahe(img, clip_limit: float = 3.0, tiles: Tuple[int, int] = (8, 8),
          nbins: int = 256):
    """Contrast-limited adaptive histogram equalization
    (cv::createCLAHE(clip, (8,8)) semantics): per-tile clipped histograms
    → CDF LUTs → bilinear LUT interpolation. Input f32 in [0, 255]; output
    same range.
    """
    H, W = img.shape
    ty, tx = tiles
    th, tw = -(-H // ty), -(-W // tx)  # ceil tile size
    padded = F.pad(img[None, None], (0, tx * tw - W, 0, ty * th - H),
                   mode="replicate")[0, 0]

    bins = torch.clamp(padded.to(torch.int64), 0, nbins - 1)
    tiles_img = bins.reshape(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(
        ty * tx, th * tw)
    hist = torch.zeros((ty * tx, nbins), dtype=torch.float32,
                       device=img.device)
    hist.scatter_add_(1, tiles_img, torch.ones_like(tiles_img,
                                                    dtype=torch.float32))

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
