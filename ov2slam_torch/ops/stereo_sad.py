"""Rectified-stereo epipolar SAD scan for disparity priors.

Port of ``ov2slam_tpu/ops/stereo_sad.py`` (the reference's
`FeatureTracker::getLineMinSAD`): for each left keypoint, scan along the
same row of the right image over a disparity range and return the
SAD-minimizing position as the stereo-matching prior. One rectangular
patch per image, then all disparities scored by shifted slice differences.
"""

from __future__ import annotations

import torch

from .patch import extract_patches


def line_min_sad(img_left, img_right, kps, valid,
                 win: int = 7, max_disp: int = 100):
    """SAD-scan stereo priors for rectified pairs.

    Args:
      img_left/img_right: (H, W) rectified images.
      kps: (N, 2) left keypoint positions; valid: (N,) bool.
      win: SAD patch size (odd); max_disp: candidate disparities
        0..max_disp-1.

    Returns:
      priors (N, 2): best right-image position (same row, x - d*).
      sad (N,): minimal mean-SAD value; disp (N,): winning disparity.
    """
    r = win // 2
    L = extract_patches(img_left, kps - r, win)
    # the strip's corner, column by column (Python-scalar offsets: a host
    # tensor here would be an upload, which a CUDA graph capture refuses)
    corner = torch.stack([kps[:, 0] - (max_disp + r), kps[:, 1] - r],
                         dim=-1)
    strip = extract_patches(img_right, corner, win,
                            patch_width=win + max_disp)
    n_px = win * win
    sads = torch.stack(
        [torch.sum(torch.abs(strip[:, :, max_disp - d:max_disp - d + win] - L),
                   dim=(1, 2)) / n_px for d in range(max_disp)], dim=1)
    disp_i = torch.argmin(sads, dim=1)
    best = torch.gather(sads, 1, disp_i[:, None])[:, 0]
    disp = disp_i.to(img_left.dtype)
    priors = torch.stack([kps[:, 0] - disp, kps[:, 1]], dim=-1)
    priors = torch.where(valid[:, None], priors, kps)
    return priors, best, disp
