"""TartanAir dataset reader.

The reference runs TartanAir through `parameters_files/*/tartanair/*.yaml`
(images over ROS); this reads the public TartanAir folder layout directly.

Expected layout:
    <root>/image_left/NNNNNN_left.png
    <root>/image_right/NNNNNN_right.png        (optional)
    <root>/pose_left.txt                       (gt: x y z qx qy qz qw, NED)

TartanAir has no timestamps; frames are stamped at the nominal 10 Hz.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .euroc import _load_gray

FRAME_RATE_HZ = 10.0


class TartanAirDataset:
    """Iterates (left, right, t) frames of one TartanAir trajectory."""

    def __init__(self, root: str, stereo: bool = True):
        self.root = root
        self.left_dir = os.path.join(root, "image_left")
        self.right_dir = os.path.join(root, "image_right")
        self.stereo = stereo and os.path.isdir(self.right_dir)
        self.names = sorted(
            n for n in os.listdir(self.left_dir) if n.endswith(".png"))
        self.gt_path = os.path.join(root, "pose_left.txt")

    def __len__(self) -> int:
        return len(self.names)

    def _right_name(self, left_name: str) -> str:
        return left_name.replace("_left", "_right")

    def __iter__(self) -> Iterator[Tuple[np.ndarray,
                                         Optional[np.ndarray], float]]:
        for i, name in enumerate(self.names):
            left = _load_gray(os.path.join(self.left_dir, name))
            right = None
            if self.stereo:
                rp = os.path.join(self.right_dir, self._right_name(name))
                if os.path.exists(rp):
                    right = _load_gray(rp)
            yield left, right, i / FRAME_RATE_HZ

    def ground_truth(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(times (N,), poses (N, 7) wxyz|t) from TartanAir pose rows
        (x y z qx qy qz qw)."""
        if not os.path.exists(self.gt_path):
            return None
        rows = np.loadtxt(self.gt_path).reshape(-1, 7)
        n = min(len(rows), len(self.names))
        poses = np.zeros((n, 7))
        poses[:, 0] = rows[:n, 6]        # qw
        poses[:, 1:4] = rows[:n, 3:6]    # qx qy qz
        poses[:, 4:7] = rows[:n, 0:3]    # t
        times = np.arange(n) / FRAME_RATE_HZ
        return times, poses
