"""Trajectory recording and export — replacement for the reference's static
`Logger` (`include/logger.hpp:35-296`).

Records per-frame world-from-camera poses plus the *relative* pose to the
previous keyframe (`logger.hpp:75-76,113-127`) so the final loop-closure-
corrected full trajectory can be replayed by chaining relative poses from
optimized keyframe poses (`ov2slam.cpp:626-703`).

Output formats (file names match the reference, `ov2slam.cpp:587-615`):
- TUM:   `time tx ty tz qx qy qz qw` (`logger.hpp:135-155`)
- KITTI: 3x4 row-major pose per line (`logger.hpp:205-235`)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from . import lie_np as lie


@dataclasses.dataclass
class FramePose:
    """Mirror of `logger.hpp:66-98` FramePose."""

    time: float
    T_wc: np.ndarray             # (7,) [qw qx qy qz | t]
    is_keyframe: bool
    kf_id: int                   # id of the reference keyframe
    T_kf_cur: np.ndarray         # relative pose: T_kf^-1 * T_wc


class TrajectoryLogger:
    def __init__(self):
        self.frames: List[FramePose] = []

    def add_pose(self, time: float, T_wc: np.ndarray, is_keyframe: bool,
                 kf_id: int, T_w_kf: Optional[np.ndarray] = None):
        """Record a frame pose; `logger.hpp:104-129` addSE3Pose."""
        T_wc = np.asarray(T_wc, dtype=np.float64)
        if T_w_kf is None:
            rel = lie.pose_identity()
        else:
            rel = lie.pose_relative(np.asarray(T_w_kf, np.float64), T_wc)
        self.frames.append(FramePose(time, T_wc, is_keyframe, kf_id, rel))

    def reset(self):
        self.frames.clear()

    # ------------------------------------------------------------------ #

    def write_tum(self, path: str, keyframes_only: bool = False):
        """TUM format writer (`logger.hpp:135-155` writeTrajectory /
        `:240-270` writeKfsTrajectory)."""
        with open(path, "w") as f:
            for fp in self.frames:
                if keyframes_only and not fp.is_keyframe:
                    continue
                q = fp.T_wc[0:4]  # wxyz
                t = fp.T_wc[4:7]
                f.write(
                    f"{fp.time:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
                )

    def write_kitti(self, path: str):
        """KITTI 3x4 row-major format (`logger.hpp:205-235`)."""
        with open(path, "w") as f:
            for fp in self.frames:
                M = np.array(lie.pose_to_matrix(fp.T_wc))[:3, :].reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in M) + "\n")

    def write_tartanair(self, path: str):
        """TartanAir format: `tx ty tz qx qy qz qw` per line, no
        timestamps (`logger.hpp:162-186` writeTrajectoryTartanAir)."""
        with open(path, "w") as f:
            for fp in self.frames:
                q = fp.T_wc[0:4]  # wxyz
                t = fp.T_wc[4:7]
                f.write(
                    f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
                )

    def replay_with_keyframes(
        self, kf_poses: Dict[int, np.ndarray]
    ) -> List[FramePose]:
        """Rebuild the full trajectory from *optimized* keyframe poses by
        chaining stored relative poses — the LC-corrected full-trajectory
        recovery of `ov2slam.cpp:650-695` (writeFullTrajectoryLC)."""
        out = []
        for fp in self.frames:
            if fp.kf_id in kf_poses:
                T = np.array(
                    lie.pose_compose(
                        np.asarray(kf_poses[fp.kf_id], np.float64),
                        fp.T_kf_cur,
                    )
                )
            else:
                T = fp.T_wc
            out.append(FramePose(fp.time, T, fp.is_keyframe, fp.kf_id,
                                 fp.T_kf_cur))
        return out

    @staticmethod
    def write_frames_tum(frames: List[FramePose], path: str):
        tl = TrajectoryLogger()
        tl.frames = frames
        tl.write_tum(path)


def load_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load a TUM trajectory file → (times (N,), poses (N, 7) wxyz|t)."""
    data = np.loadtxt(path).reshape(-1, 8)
    times = data[:, 0]
    t = data[:, 1:4]
    qxyzw = data[:, 4:8]
    q = np.concatenate([qxyzw[:, 3:4], qxyzw[:, 0:3]], axis=1)
    return times, np.concatenate([q, t], axis=1)
