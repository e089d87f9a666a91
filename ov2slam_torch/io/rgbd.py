"""RGB-D → world-frame point cloud fusion.

Port of ``ov2slam_tpu/io/rgbd.py``, the replacement for the fork's CARLA
glue (`scripts/talker.py:273-478` ManySyncListener: per-camera
depth→pointcloud on GPU via torch + world-frame merge;
`src/my_publisher.cpp`: depth/RGB re-stamping + 6-way sync). The
unprojection runs on the depth tensor's device; the world transform stays
on the host in f64, as in the JAX package; the ROS
ApproximateTimeSynchronizer is a plain timestamp matcher.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils import lie_np


def depth_to_points(depth: torch.Tensor, K, stride: int = 1,
                    max_depth: float = 80.0):
    """Unproject a depth image to camera-frame points, on ``depth``'s
    device.

    Args:
      depth: (H, W) metric depth (f32 tensor).
      K: (3, 3) intrinsics (tensor or array).
      stride: pixel subsampling.

    Returns:
      points (N, 3), valid (N,)  where N = (H//stride) * (W//stride).
    """
    K = torch.as_tensor(K, dtype=depth.dtype, device=depth.device)
    d = depth[::stride, ::stride]
    H, W = d.shape
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=depth.dtype, device=depth.device) * stride,
        torch.arange(W, dtype=depth.dtype, device=depth.device) * stride,
        indexing="ij")
    z = d.reshape(-1)
    x = ((xs.reshape(-1) - K[0, 2]) / K[0, 0]) * z
    y = ((ys.reshape(-1) - K[1, 2]) / K[1, 1]) * z
    pts = torch.stack([x, y, z], dim=-1)
    valid = (z > 0.05) & (z < max_depth) & torch.isfinite(z)
    return pts, valid


def fuse_rgbd_frames(
    frames: Sequence[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray,
                           np.ndarray]],
    stride: int = 2,
    device=None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Merge multiple (depth, rgb|None, K, T_wc) frames into one
    world-frame cloud (ManySyncListener.listener_callback equivalent,
    `talker.py:285-340`). Unprojection runs on ``device`` (``None`` = the
    GPU).

    Returns (points (M, 3), colors (M, 3) uint8 or None).
    """
    dev = resolve_device(device)
    all_pts: List[np.ndarray] = []
    all_cols: List[np.ndarray] = []
    have_color = all(f[1] is not None for f in frames)
    for depth, rgb, K, T_wc in frames:
        pts, valid = depth_to_points(
            torch.as_tensor(np.asarray(depth, np.float32), device=dev),
            torch.as_tensor(np.asarray(K, np.float32), device=dev),
            stride=stride)
        pts = pts.cpu().numpy()
        valid = valid.cpu().numpy()
        pts_w = lie_np.pose_apply(np.asarray(T_wc, np.float64),
                                  pts[valid].astype(np.float64))
        all_pts.append(pts_w.astype(np.float32))
        if have_color:
            c = np.asarray(rgb)[::stride, ::stride].reshape(-1, 3)
            all_cols.append(c[valid])
    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
    cols = np.concatenate(all_cols) if have_color and all_cols else None
    return pts, cols


def sync_streams(stamp_lists: Sequence[np.ndarray],
                 tol: float = 0.05) -> List[Tuple[int, ...]]:
    """Approximate-time N-way synchronizer (message_filters equivalent,
    `my_publisher.cpp:81-128`): for each timestamp of stream 0, find the
    nearest stamp in every other stream; emit the tuple if all are within
    ``tol`` seconds."""
    out = []
    others = [np.asarray(s) for s in stamp_lists[1:]]
    for i, t in enumerate(np.asarray(stamp_lists[0])):
        idxs = [i]
        ok = True
        for s in others:
            j = int(np.argmin(np.abs(s - t)))
            if abs(s[j] - t) > tol:
                ok = False
                break
            idxs.append(j)
        if ok:
            out.append(tuple(idxs))
    return out


def voxel_downsample(points: np.ndarray, voxel: float,
                     colors: Optional[np.ndarray] = None):
    """Voxel-grid downsampling (open3d voxel_down_sample equivalent used
    by the fork's viewer scripts): one point per voxel (centroid)."""
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / voxel).astype(np.int64)
    # dictionary-free unique via lexsort
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    n_vox = len(first)
    sums = np.zeros((n_vox, 3), np.float64)
    np.add.at(sums, inv, points)
    counts = np.bincount(inv, minlength=n_vox)[:, None]
    pts = (sums / counts).astype(np.float32)
    cols = None
    if colors is not None:
        csum = np.zeros((n_vox, 3), np.float64)
        np.add.at(csum, inv, colors.astype(np.float64))
        cols = (csum / counts).astype(np.uint8)
    return pts, cols
