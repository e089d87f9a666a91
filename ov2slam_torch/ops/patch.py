"""Patch extraction and in-patch resampling by direct gathers.

Port of ``ov2slam_tpu/ops/patch.py``. The JAX package turns the gather into
two GEMMs with hat (bilinear) weight matrices because gathers are slow on a
TPU; here each sample reads its two rows and two columns directly. The
arithmetic is the same separable bilinear interpolation, in the same order:
rows first (``w_y0·img[y0] + w_y1·img[y0+1]``), then columns, with the hat
weights ``max(0, 1 - |i - pos|)`` computed as the JAX code computes them.
Pixels outside the image read as 0, like the JAX version, whose hat weights
vanish there.
"""

from __future__ import annotations

import torch


def _hat_pair(pos):
    """(floor index, weight of floor, weight of floor+1) of float ``pos``."""
    i0 = torch.floor(pos)
    w0 = torch.clamp(1.0 - torch.abs(i0 - pos), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(i0 + 1.0 - pos), min=0.0)
    return i0, w0, w1


def _read(img, yi, xi):
    """img[yi, xi] with 0 outside the image; yi/xi broadcast together."""
    H, W = img.shape
    ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    v = img.reshape(-1)[idx]
    return torch.where(ok, v, torch.zeros_like(v))


def extract_patches(img, top_left, patch_size: int,
                    patch_width: int | None = None):
    """Extract (N, P, Pw) patches at float (x, y) ``top_left`` positions
    with exact bilinear interpolation; rows are y, columns x.

    ``patch_width`` defaults to ``patch_size`` (square); rectangular
    patches serve the stereo epipolar SAD scan.
    """
    P = patch_size
    Pw = patch_width if patch_width is not None else patch_size
    dtype = img.dtype
    dev = img.device
    y_pos = top_left[:, 1:2] + torch.arange(P, dtype=dtype, device=dev)[None]
    x_pos = top_left[:, 0:1] + torch.arange(Pw, dtype=dtype, device=dev)[None]
    y0, wy0, wy1 = _hat_pair(y_pos)                 # (N, P)
    x0, wx0, wx1 = _hat_pair(x_pos)                 # (N, Pw)
    y0 = y0.long()[:, :, None]
    x0 = x0.long()[:, None, :]
    wy0, wy1 = wy0[:, :, None], wy1[:, :, None]
    wx0, wx1 = wx0[:, None, :], wx1[:, None, :]
    # rows stage at columns x0 and x0+1, then the column stage
    r0 = wy0 * _read(img, y0, x0) + wy1 * _read(img, y0 + 1, x0)
    r1 = wy0 * _read(img, y0, x0 + 1) + wy1 * _read(img, y0 + 1, x0 + 1)
    return r0 * wx0 + r1 * wx1


def sample_window(patch, offset, out_size: int):
    """Sample an (out, out) window at float ``offset`` (x, y, patch coords,
    window top-left) from per-keypoint patches (N, S, S) by bilinear
    interpolation inside the patch.

    ``offset`` is clamped to the valid range [0, S-out]; callers detect
    margin overflow themselves if needed.
    """
    N, S, _ = patch.shape
    shifts = S - out_size
    ox = torch.clamp(offset[:, 0], 0.0, float(shifts))
    oy = torch.clamp(offset[:, 1], 0.0, float(shifts))
    ar = torch.arange(out_size, device=patch.device)
    y0, wy0, wy1 = _hat_pair(oy)
    x0, wx0, wx1 = _hat_pair(ox)
    yi = (y0.long()[:, None] + ar[None])[:, :, None]        # (N, out, 1)
    xi = (x0.long()[:, None] + ar[None])[:, None, :]        # (N, 1, out)
    flat = patch.reshape(N, S * S)
    n = torch.arange(N, device=patch.device)[:, None, None]

    def rd(y, x):
        return flat[n, y.clamp(max=S - 1) * S + x.clamp(max=S - 1)]

    wy0, wy1 = wy0[:, None, None], wy1[:, None, None]
    wx0, wx1 = wx0[:, None, None], wx1[:, None, None]
    r0 = wy0 * rd(yi, xi) + wy1 * rd(yi + 1, xi)
    r1 = wy0 * rd(yi, xi + 1) + wy1 * rd(yi + 1, xi + 1)
    return r0 * wx0 + r1 * wx1
