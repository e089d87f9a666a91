"""SlamManager: the session orchestrator.

Port of the synchronous stereo path of ``ov2slam_tpu/models/slam.py`` (the
reference's `SlamManager`, `src/ov2slam.cpp`): owns the camera models,
front-end, mapper, estimator and loop closer; feeds frames through them;
handles tracking-failure reset (`ov2slam.cpp:428-455`), trajectory logging
and result writing (`writeResults`, `ov2slam.cpp:576-623`).

Supported configuration: stereo, synchronous, ``slam_mode`` on,
``use_inv_depth`` on, loop closer on or off, relocalizer off, without
image-level rectification/undistortion, pipelining or the final full BA.
Anything else raises ``NotImplementedError``. All device work runs on
``device`` (``None`` = the GPU; see :mod:`ov2slam_torch.device`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.camera import build_camera
from ..device import resolve_device
from ..mapping.store import MapStore
from ..models.estimator import Estimator
from ..models.frontend import FrontEnd
from ..models.mapper import Mapper
from ..utils.config import SlamConfig
from ..utils.profiler import Profiler
from ..utils.trajectory import TrajectoryLogger


def check_supported(cfg: SlamConfig, use_loop_closer: bool) -> None:
    """Raise NotImplementedError for a configuration outside the port."""
    unsupported = []
    if cfg.mono or not cfg.stereo:
        unsupported.append("mono (monocular initialization)")
    if use_loop_closer and cfg.use_relocalizer:
        unsupported.append("use_relocalizer")
    if cfg.pipelined_frontend:
        unsupported.append("pipelined_frontend")
    if cfg.do_full_ba:
        unsupported.append("do_full_ba")
    if cfg.do_stereo_rect:
        unsupported.append("do_stereo_rect")
    if cfg.do_undist and any(float(d) != 0.0 for d in cfg.cam_left.dist):
        unsupported.append("do_undist with a distorted camera")
    if not cfg.use_inv_depth:
        unsupported.append("use_inv_depth=False (xyz BA)")
    if unsupported:
        raise NotImplementedError(
            "ov2slam_torch.SlamManager does not support: "
            + ", ".join(unsupported))


class SlamManager:
    def __init__(self, cfg: SlamConfig,
                 use_loop_closer: Optional[bool] = None, device=None,
                 seed: int = 42):
        use_lc = (cfg.use_loop_closer if use_loop_closer is None
                  else use_loop_closer)
        check_supported(cfg, use_lc)
        self.cfg = cfg
        self.device = resolve_device(device)
        # RANSAC sample stream of the front-end and the loop closer, held
        # by this manager (the JAX package seeds PRNGKey(42) / (0) / (7))
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.cam_l = build_camera(cfg.cam_left, other=cfg.cam_left,
                                  device=self.device)
        self.cam_r = build_camera(cfg.cam_right, other=cfg.cam_left,
                                  device=self.device)
        self.map = MapStore(cfg)
        self.frontend = FrontEnd(cfg, self.cam_l, self.map, self.gen)
        self.mapper = Mapper(cfg, self.cam_l, self.cam_r, self.map)
        self.estimator = Estimator(cfg, self.cam_l, self.cam_r, self.map)
        self.loop_closer = None
        if use_lc:
            from ..loopclosure.closer import LoopCloser
            self.loop_closer = LoopCloser(cfg, self.cam_l, self.map,
                                          self.estimator, seed=seed + 1)
        self.logger = TrajectoryLogger()
        self.prof = Profiler.instance()
        self.frame_id = -1
        self.n_resets = 0

    # ------------------------------------------------------------------ #

    def process_frame(self, img_left: np.ndarray,
                      img_right: Optional[np.ndarray] = None,
                      time: float = 0.0) -> np.ndarray:
        """Feed one stereo pair; returns the current T_wc."""
        self.frame_id += 1
        is_kf = self.frontend.track_frame(img_left, time)
        return self._post_track(is_kf, img_right)

    def _post_track(self, is_kf: bool, img_right) -> np.ndarray:
        """Everything after per-frame tracking: init/starvation handling,
        keyframe creation, relocalization fallback, trajectory logging —
        for the frame currently resolved in ``fe.frame``."""
        fe = self.frontend
        time = fe.frame.time

        # tracking-failure detection BEFORE keyframe creation: a starving
        # frame must not become a keyframe (`visual_front_end.cpp:100-102`;
        # the reference's absolute 50/20-kp thresholds are scaled to the
        # grid budget: 160 cells at EuRoC resolution -> 31% mono / 12% stereo)
        cap = self.cfg.grid_cells[0] * self.cfg.grid_cells[1]
        # proportional to the kp budget like the reference's 20-of-~160
        # stereo / 50-of-~160 mono absolute gates; a floor of 6 keeps PnP
        # solvable, and anything above must stay below normal working
        # counts or the pipeline can never replenish through keyframes
        reset_th = max(6, int((0.12 if self.cfg.stereo else 0.3) * cap))
        # a bootstrap keyframe has zero tracks BY CONSTRUCTION (detection
        # runs inside keyframe creation) — vetoing it would loop the
        # reset path forever without ever re-establishing tracking
        starved = (fe.initialized and self.map.n_keyframes > 1
                   and fe.frame.n_valid < reset_th
                   and not fe.bootstrap_kf)

        if is_kf and not starved:
            kfid = self._create_keyframe(time, img_right)
            fe.frame.kf_id = kfid
            if kfid < 0:      # featureless re-bootstrap vetoed
                is_kf = False
        if starved:
            self._reset()

        T = fe.frame.T_wc.astype(np.float64)
        kf_id = fe.frame.kf_id
        T_kf = (self.map.kf_poses[kf_id].astype(np.float64)
                if kf_id >= 0 and self.map.kf_valid[kf_id] else None)
        self.logger.add_pose(time, T, is_kf, self._kf_key(kf_id), T_kf)
        return fe.frame.T_wc

    def _kf_key(self, kf_id: int) -> int:
        """Stable trajectory-log key for a keyframe: its insertion seq.
        Slot ids are recycled, so logging the slot would alias an old
        frame's reference KF onto whatever KF later reuses the slot."""
        if kf_id >= 0 and self.map.kf_valid[kf_id]:
            return int(self.map.kf_seq[kf_id])
        return -1

    def _create_keyframe(self, time: float,
                         img_right: Optional[np.ndarray]) -> int:
        """`MapManager::createKeyframe` + Mapper/Estimator dispatch
        (`map_manager.cpp:44-61`, `ov2slam.cpp:168-188`)."""
        fe = self.frontend
        f = fe.frame

        new_rows, desc = fe.detect_and_describe()
        if fe.bootstrap_kf and self.map.n_keyframes >= 1:
            # featureless re-bootstrap veto: after a tracking-loss reset a
            # blank/textureless frame yields (near-)zero detections — a
            # keyframe built on it seeds nothing and permanently pollutes
            # the kept map. Stay lost instead; the relocalizer (or a
            # later textured frame's re-bootstrap) recovers.
            if len(new_rows) < 8:
                f.valid[:] = False
                f.lmids[:] = -1
                f.kf_id = -1
                return -1
        # new keypoints get fresh 2D landmarks; at capacity, drop surplus
        # detections instead of aborting
        n_alloc = min(len(new_rows), self.map.free_landmark_capacity)
        if n_alloc:
            lmids = self.map.new_landmarks(n_alloc)
            f.lmids[new_rows[:n_alloc]] = lmids

        lm_slots = np.where(f.valid, f.lmids, -1).astype(np.int32)
        kfid = self.map.add_keyframe(
            time, f.T_wc, lm_slots, f.px_und, desc.astype(np.uint32))
        f.kf_id = kfid

        if fe.initialized:
            self.mapper.process_keyframe(kfid, f, fe.cur_pyr, img_right)
            if self.cfg.do_track_localmap:
                self.mapper.match_to_local_map(kfid)
            if self.cfg.slam_mode:
                self.estimator.local_ba(kfid)
                self.estimator.map_filtering(kfid)
            if self.loop_closer is not None:
                self.loop_closer.process_keyframe(kfid, img=fe.cur_pyr[0])
            # refresh the front-end pose estimate after BA moved the map
            f.T_wc = self.map.kf_poses[kfid].copy()
            fe.motion.prev_T = f.T_wc.astype(np.float64)
        return kfid

    def _reset(self, full: bool = False):
        """(`SlamManager::reset`, `ov2slam.cpp:428-455`) — clears front-end
        tracking state; ``full`` also discards the map (pre-init bootstrap
        restart; post-init the map is kept)."""
        self.n_resets += 1
        self.frontend.reset()
        if full:
            self.map = MapStore(self.cfg)
            self.frontend.map = self.map
            self.mapper.map = self.map
            self.estimator.map = self.map
            if self.loop_closer is not None:
                self.loop_closer.map = self.map

    def write_results(self, out_dir: str = "."):
        """Final products (`writeResults`, `ov2slam.cpp:576-623`), without
        the optional full BA and the full-trajectory pose graph (neither
        is ported yet)."""
        import os

        self.logger.write_tum(os.path.join(out_dir, "ov2slam_traj.txt"))
        self.logger.write_tum(
            os.path.join(out_dir, "ov2slam_kfs_traj.txt"),
            keyframes_only=True)
        self.logger.write_kitti(
            os.path.join(out_dir, "ov2slam_traj_kitti.txt"))

        # LC-corrected full trajectory from optimized KF poses
        # (`writeFullTrajectoryLC`, `ov2slam.cpp:626-703`); keyed by seq
        kf_poses = {int(self.map.kf_seq[k]):
                    self.map.kf_poses[k].astype(np.float64)
                    for k in np.nonzero(self.map.kf_valid)[0]}
        frames = self.logger.replay_with_keyframes(kf_poses)
        TrajectoryLogger.write_frames_tum(
            frames, os.path.join(out_dir, "ov2slam_full_traj_wlc.txt"))

    def estimated_trajectory(self):
        """(times (F,), poses (F, 7)) of all processed frames."""
        times = np.array([fp.time for fp in self.logger.frames])
        poses = np.stack([fp.T_wc for fp in self.logger.frames])
        return times, poses
