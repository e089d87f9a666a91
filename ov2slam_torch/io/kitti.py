"""KITTI odometry dataset reader.

The reference runs KITTI through its `parameters_files/*/kitti/*.yaml`
configs with images replayed over ROS. This is the ROS-free equivalent:
reads the standard KITTI odometry folder layout directly.

Expected layout (KITTI odometry grayscale):
    <root>/sequences/<NN>/image_0/XXXXXX.png   (left)
    <root>/sequences/<NN>/image_1/XXXXXX.png   (right, optional)
    <root>/sequences/<NN>/times.txt
    <root>/poses/<NN>.txt                      (ground truth, optional)
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .euroc import _load_gray


class KittiDataset:
    """Iterates (left, right, t) frames of one KITTI odometry sequence."""

    def __init__(self, root: str, sequence: str = "00",
                 stereo: bool = True):
        seq_dir = os.path.join(root, "sequences", sequence)
        if not os.path.isdir(seq_dir):
            seq_dir = root  # allow pointing directly at the sequence dir
        self.seq_dir = seq_dir
        self.left_dir = os.path.join(seq_dir, "image_0")
        self.right_dir = os.path.join(seq_dir, "image_1")
        self.stereo = stereo and os.path.isdir(self.right_dir)

        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.times = np.array([float(x) for x in f.read().split()])
        self.names = sorted(os.listdir(self.left_dir))
        n = min(len(self.names), len(self.times))
        self.names, self.times = self.names[:n], self.times[:n]

        self.gt_path = os.path.join(
            root, "poses", sequence + ".txt")

    def __len__(self) -> int:
        return len(self.names)

    def __iter__(self) -> Iterator[Tuple[np.ndarray,
                                         Optional[np.ndarray], float]]:
        for name, t in zip(self.names, self.times):
            left = _load_gray(os.path.join(self.left_dir, name))
            right = (_load_gray(os.path.join(self.right_dir, name))
                     if self.stereo
                     and os.path.exists(os.path.join(self.right_dir, name))
                     else None)
            yield left, right, float(t)

    def ground_truth(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(times (N,), poses (N, 7) wxyz|t) from KITTI 3x4 pose rows."""
        if not os.path.exists(self.gt_path):
            return None
        from ..utils import lie_np

        rows = np.loadtxt(self.gt_path).reshape(-1, 3, 4)
        poses = []
        for M34 in rows:
            M = np.eye(4)
            M[:3] = M34
            poses.append(lie_np.pose_from_matrix(M))
        n = min(len(poses), len(self.times))
        return self.times[:n], np.asarray(poses)[:n]
