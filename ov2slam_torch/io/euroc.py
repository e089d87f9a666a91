"""EuRoC MAV (ASL folder format) dataset reader.

Replaces the reference's ROS/rosbag ingestion (`src/ov2slam_node.cpp`:
image topic subscribers + `SensorsGrabber::sync_process` stereo pairing
with 15 ms tolerance, `:103-123`) with a plain directory reader — the
"deterministic replayable inputs" pattern the survey calls out (§4).

Expected layout (standard EuRoC ASL):
    <root>/mav0/cam0/data.csv, <root>/mav0/cam0/data/<stamp>.png
    <root>/mav0/cam1/...
    <root>/mav0/state_groundtruth_estimate0/data.csv   (optional)
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

STEREO_SYNC_TOL_S = 0.015  # 15 ms, `ov2slam_node.cpp:103-112`


def _read_cam_csv(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path, "r") as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            out.append((int(row[0]) * 1e-9, row[1].strip()))
    return out


def _load_gray(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.float32)


class EurocDataset:
    """Iterates time-synchronized (left, right, t) frames."""

    def __init__(self, root: str, stereo: bool = True):
        self.root = root
        mav = os.path.join(root, "mav0")
        if not os.path.isdir(mav):
            mav = root  # allow pointing directly at mav0
        self.cam0_dir = os.path.join(mav, "cam0")
        self.cam1_dir = os.path.join(mav, "cam1")
        self.stereo = stereo and os.path.isdir(self.cam1_dir)

        self.cam0 = _read_cam_csv(os.path.join(self.cam0_dir, "data.csv"))
        self.cam1 = (_read_cam_csv(os.path.join(self.cam1_dir, "data.csv"))
                     if self.stereo else [])
        self.pairs = self._sync()
        self.gt_path = os.path.join(
            mav, "state_groundtruth_estimate0", "data.csv")

    def _sync(self) -> List[Tuple[float, str, Optional[str]]]:
        """Timestamp pairing with the reference's 15 ms tolerance."""
        if not self.stereo:
            return [(t, f, None) for t, f in self.cam0]
        out = []
        j = 0
        for t0, f0 in self.cam0:
            while (j + 1 < len(self.cam1)
                   and abs(self.cam1[j + 1][0] - t0)
                   <= abs(self.cam1[j][0] - t0)):
                j += 1
            if self.cam1 and abs(self.cam1[j][0] - t0) <= STEREO_SYNC_TOL_S:
                out.append((t0, f0, self.cam1[j][1]))
        return out

    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self) -> Iterator[Tuple[np.ndarray,
                                         Optional[np.ndarray], float]]:
        for t, f0, f1 in self.pairs:
            left = _load_gray(os.path.join(self.cam0_dir, "data", f0))
            right = (_load_gray(os.path.join(self.cam1_dir, "data", f1))
                     if f1 else None)
            yield left, right, t

    def ground_truth(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(times (N,), poses (N, 7) wxyz|t of the body frame) or None."""
        if not os.path.exists(self.gt_path):
            return None
        times, poses = [], []
        with open(self.gt_path, "r") as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                times.append(int(row[0]) * 1e-9)
                # ASL: p_x p_y p_z q_w q_x q_y q_z ...
                t = [float(row[1]), float(row[2]), float(row[3])]
                q = [float(row[4]), float(row[5]), float(row[6]),
                     float(row[7])]
                poses.append(q + t)
        return np.asarray(times), np.asarray(poses)


def write_asl_sequence(seq, root: str, gt_rate_hz: Optional[float] = None,
                       T_body_cam: Optional[np.ndarray] = None):
    """Export a SyntheticSequence as an ASL-format directory (for reader
    tests and for running the full EuRoC harness without the dataset).

    ``gt_rate_hz``: when set, the ground-truth csv is written at this rate
    (SE3-interpolated) instead of the camera rate — mirroring real EuRoC,
    whose `state_groundtruth_estimate0` runs at ~200 Hz.
    ``T_body_cam``: when set (pose-7 or 4x4), GT poses are stored in the
    *body* frame T_w_body = T_w_cam · T_body_cam⁻¹, again like real EuRoC.
    """
    from PIL import Image

    from ..utils import lie_np
    from ..utils.evaluation import interpolate_poses

    gt_times = np.asarray(seq.times, np.float64)
    gt_poses = np.asarray(seq.gt_poses, np.float64)
    if gt_rate_hz is not None:
        dense = np.arange(gt_times[0], gt_times[-1], 1.0 / gt_rate_hz)
        gt_poses = interpolate_poses(gt_times, gt_poses, dense)
        gt_times = dense
    if T_body_cam is not None:
        T_bc = np.asarray(T_body_cam, np.float64)
        if T_bc.shape == (4, 4):
            T_bc = lie_np.pose_from_matrix(T_bc)
        gt_poses = lie_np.pose_compose(
            gt_poses, lie_np.pose_inverse(T_bc)[None, :])

    for cam, images in (("cam0", seq.images_left),
                        ("cam1", seq.images_right or [])):
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d, exist_ok=True)
        rows = []
        for t, img in zip(seq.times, images):
            stamp = str(int(round(t * 1e9)))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(d, stamp + ".png"))
            rows.append((stamp, stamp + ".png"))
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for stamp, name in rows:
                f.write(f"{stamp},{name}\n")

    gtd = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gtd, exist_ok=True)
    with open(os.path.join(gtd, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for t, T in zip(gt_times, gt_poses):
            stamp = str(int(round(t * 1e9)))
            f.write(f"{stamp},{T[4]},{T[5]},{T[6]},"
                    f"{T[0]},{T[1]},{T[2]},{T[3]}\n")
