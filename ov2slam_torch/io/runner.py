"""Sequence runner: replay a dataset through the SLAM manager.

Port of ``ov2slam_tpu/io/runner.py``: the equivalent of
`SlamManager::run`'s frame loop (`ov2slam.cpp:116-238`) plus the benchmark
harness (`benchmark_scripts/euroc_bench.sh`): replay, optional real-time
frame dropping (`getNewImage` drain-to-newest, `ov2slam.cpp:292-299`),
end-of-sequence result writing, and ATE evaluation when ground truth is
available. With an output directory it also writes ``viewer.html``, the
interactive map viewer of ``io/viz.py``; a viewer that fails to export is
logged as a warning and the run goes on (the JAX package's runner drops
the error silently).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time as _time
from typing import Optional

import numpy as np

from ..models.slam import SlamManager
from ..utils.config import SlamConfig
from ..utils.evaluation import ate_rmse, transform_body_to_cam
from .viz import export_html_viewer

log = logging.getLogger(__name__)


@dataclasses.dataclass
class RunResult:
    n_frames: int
    n_processed: int
    n_dropped: int
    n_keyframes: int
    n_closures: int
    wall_s: float
    fps: float
    ate: Optional[float] = None
    ate_scaled: Optional[float] = None


def run_sequence(cfg: SlamConfig, frames, times=None,
                 gt_poses: Optional[np.ndarray] = None,
                 gt_times: Optional[np.ndarray] = None,
                 T_body_cam: Optional[np.ndarray] = None,
                 out_dir: Optional[str] = None,
                 slam: Optional[SlamManager] = None,
                 device=None) -> RunResult:
    """Replay ``frames`` (iterable of (left, right, t) or a
    SyntheticSequence) through ``slam``, or through a new SlamManager on
    ``device`` (``None`` = the GPU) when none is given. An
    ``AsyncSlamManager`` passed as ``slam`` is flushed at the end of the
    replay (its trajectory getter waits for the worker); closing it is the
    caller's.

    force_realtime: frames that arrive while processing lags are dropped,
    keeping only the newest (reference frame-dropping semantics) — here
    simulated against the dataset clock.

    ATE association: when ``gt_times`` is given, estimate↔GT pairing is by
    nearest timestamp (EuRoC GT is ~200 Hz vs 20 Hz camera — index pairing
    would compress time 10×); ``T_body_cam`` (4x4 or pose-7) additionally
    transforms body-frame GT into the camera frame before alignment.
    Without ``gt_times`` the 1:1 index pairing of synthetic sequences is
    used.
    """
    slam = slam or SlamManager(cfg, device=device)

    # normalize input
    if hasattr(frames, "images_left"):
        seq = frames
        it = [(seq.images_left[i],
               seq.images_right[i] if seq.stereo else None,
               float(seq.times[i])) for i in range(len(seq.times))]
        if gt_poses is None:
            gt_poses = seq.gt_poses
    else:
        it = frames
        if gt_poses is None and hasattr(frames, "gt_poses"):
            gt_poses = frames.gt_poses  # lazily-rendered SyntheticStream

    n_total = 0
    n_proc = 0
    n_drop = 0
    t_start = _time.perf_counter()
    sim_lag = 0.0
    prev_t = None
    for left, right, t in it:
        n_total += 1
        if cfg.force_realtime and prev_t is not None:
            dt = t - prev_t
            sim_lag -= dt
            if sim_lag > 0:  # still busy: drop this frame
                n_drop += 1
                continue
            sim_lag = 0.0
        t0 = _time.perf_counter()
        slam.process_frame(left, right, t)
        sim_lag += _time.perf_counter() - t0
        prev_t = t
        n_proc += 1
    wall = _time.perf_counter() - t_start

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        slam.write_results(out_dir)
        write_viewer(slam, out_dir)

    est_times, est_poses = slam.estimated_trajectory()
    result = RunResult(
        n_frames=n_total, n_processed=n_proc, n_dropped=n_drop,
        n_keyframes=slam.map.n_keyframes,
        n_closures=(slam.loop_closer.n_closures
                    if slam.loop_closer else 0),
        wall_s=wall, fps=n_proc / max(wall, 1e-9))
    if gt_poses is not None and len(est_poses) and len(gt_poses):
        gt_poses = np.asarray(gt_poses, np.float64)
        if T_body_cam is not None:
            gt_poses = transform_body_to_cam(gt_poses, T_body_cam)
        if gt_times is not None:
            result.ate = ate_rmse(est_poses, gt_poses,
                                  est_times=np.asarray(est_times),
                                  gt_times=np.asarray(gt_times),
                                  align_scale=False)
            result.ate_scaled = ate_rmse(est_poses, gt_poses,
                                         est_times=np.asarray(est_times),
                                         gt_times=np.asarray(gt_times),
                                         align_scale=True)
        else:
            n = min(len(est_poses), len(gt_poses))
            result.ate = ate_rmse(est_poses[:n], gt_poses[:n],
                                  align_scale=False)
            result.ate_scaled = ate_rmse(est_poses[:n], gt_poses[:n],
                                         align_scale=True)
    return result


def write_viewer(slam, out_dir: str) -> Optional[str]:
    """Write ``viewer.html`` (trajectory, keyframe frusta, landmark cloud;
    the reference's `python_files/open3d_visualize_pose.py` role) into
    ``out_dir``. The viewer is not a result of the run: an export that
    fails is logged as a warning, and None is returned."""
    path = os.path.join(out_dir, "viewer.html")
    try:
        _, traj = slam.estimated_trajectory()
        kf_sel = np.nonzero(slam.map.kf_valid)[0]
        return export_html_viewer(traj, slam.map, path,
                                  kf_poses=slam.map.kf_poses[kf_sel])
    except Exception as exc:
        log.warning("viewer export to %s failed: %r", path, exc,
                    exc_info=True)
        return None
