"""BRIEF-256 binary descriptors, batched over keypoints.

Port of ``ov2slam_tpu/ops/brief.py`` (the reference's
`FeatureExtractor::describeBRIEF`, classic 256-bit BRIEF). The sampling
pattern is the same Gaussian pair set from the same seed
(``_make_pattern(seed=7)``), and the arithmetic is the JAX version's: a
bilinear (33, 33) patch at the keypoint, then each pattern point bilinear
inside the patch — here by direct gathers of the four taps instead of a
sparse-in-dense GEMM. Descriptors are packed into 8 int32 words holding the
uint32 bit patterns (bit b of word w is pair 32·w + b).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.image import gaussian_blur
from .patch import extract_patches

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH_SIZE = 31
_P = PATCH_SIZE + 2  # patch side incl. bilinear margin
_HALF = PATCH_SIZE // 2


def _make_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) float32 sampling-pair offsets, clipped to the patch."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_SIZE / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 2, 2)).astype(np.float32)
    return np.clip(pts, -_HALF, _HALF)


def _make_taps(pattern: np.ndarray):
    """Flat patch indices (512, 4) and bilinear weights (512, 4) of every
    pattern point, taps in row-major order (y0x0, y0x1, y1x0, y1x1)."""
    pts = pattern.reshape(-1, 2)
    px = pts[:, 0] + _HALF + 1
    py = pts[:, 1] + _HALF + 1
    x0 = np.floor(px).astype(int)
    y0 = np.floor(py).astype(int)
    fx = px - x0
    fy = py - y0
    idx = np.stack([y0 * _P + x0, y0 * _P + x0 + 1,
                    (y0 + 1) * _P + x0, (y0 + 1) * _P + x0 + 1], -1)
    w = np.stack([(1 - fy) * (1 - fx), (1 - fy) * fx,
                  fy * (1 - fx), fy * fx], -1).astype(np.float32)
    return idx.astype(np.int64), w


_PATTERN = _make_pattern()
_TAP_IDX, _TAP_W = _make_taps(_PATTERN)
_WORD_WEIGHTS = np.left_shift(np.int64(1), np.arange(32, dtype=np.int64))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool → (N, 8) int32 words (uint32 bit patterns)."""
    w = torch.as_tensor(_WORD_WEIGHTS, device=bits.device)
    words = (bits.reshape(-1, N_WORDS, 32).to(torch.int64) * w).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def describe_brief(img, kps, valid, pattern=None):
    """Compute BRIEF-256 descriptors.

    Args:
      img: (H, W) f32 image (raw; smoothing applied internally).
      kps: (N, 2) xy keypoint positions.
      valid: (N,) bool.
      pattern: optional (256, 2, 2) sampling pairs (default: the seed-7
        pattern of ``_make_pattern``).

    Returns:
      desc: (N, 8) int32 packed descriptors (zeros where invalid).
      ok: (N,) bool — valid and fully inside the image.
    """
    H, W = img.shape
    smoothed = gaussian_blur(img, sigma=2.0, radius=4)
    patches = extract_patches(smoothed, kps - (_HALF + 1), _P)
    flat = patches.reshape(-1, _P * _P)
    tap_idx, tap_w = ((_TAP_IDX, _TAP_W) if pattern is None
                      else _make_taps(np.asarray(pattern, np.float32)))
    idx = torch.as_tensor(tap_idx, device=img.device)
    w = torch.as_tensor(tap_w, device=img.device, dtype=flat.dtype)
    taps = flat[:, idx] * w                              # (N, 512, 4)
    samples = ((taps[..., 0] + taps[..., 1]) + taps[..., 2]) + taps[..., 3]
    bits = samples[:, 0::2] < samples[:, 1::2]           # (N, 256)

    half = _HALF + 2
    inside = (
        (kps[:, 0] >= half) & (kps[:, 0] < W - half)
        & (kps[:, 1] >= half) & (kps[:, 1] < H - half)
    )
    ok = valid & inside
    words = pack_bits(bits)
    return torch.where(ok[:, None], words, torch.zeros_like(words)), ok
