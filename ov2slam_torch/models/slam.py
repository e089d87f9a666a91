"""SlamManager: the session orchestrator.

Port of the synchronous path of ``ov2slam_tpu/models/slam.py`` (the
reference's `SlamManager`, `src/ov2slam.cpp`): owns the camera models,
front-end, mapper, estimator, loop closer and relocalizer; feeds frames
through them; handles monocular initialization (`checkReadyForInit`,
`visual_front_end.cpp:855-984`), image-level stereo rectification and
undistortion (`ov2slam.cpp:343-426`, `camera_calibration.cpp:80-194`),
relocalization or reset after tracking loss (`ov2slam.cpp:428-455`),
trajectory logging and result writing with the optional full BA and the
full-trajectory pose graph (`writeResults`, `ov2slam.cpp:576-703`).

Supported: mono or stereo, ``slam_mode`` on, inverse-depth or xyz BA,
loop closer and relocalizer on or off, and the pipelined front end
(``pipelined_frontend``: each frame's result resolved ``pipeline_depth``
frames late, device-chained at depth >= 2). The asynchronous manager, with
keyframe processing on a worker thread, is
:class:`ov2slam_torch.models.pipeline.AsyncSlamManager`. All device work
runs on ``device`` (``None`` = the GPU; see :mod:`ov2slam_torch.device`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..core.camera import (bilinear_sample, build_camera,
                           compute_rectify_map, stereo_rectify)
from ..device import resolve_device
from ..geometry.essential import relative_pose_ransac
from ..geometry.triangulation import reprojection_checks, triangulate_midpoint
from ..mapping.store import MapStore
from ..models.estimator import Estimator
from ..models.frontend import FrontEnd
from ..models.mapper import Mapper
from ..utils import lie, lie_np
from ..utils.config import SlamConfig
from ..utils.profiler import Profiler
from ..utils.trajectory import TrajectoryLogger

MONO_INIT_SCALE = 0.25  # reference fixes ||t|| = 0.25 (`visual_front_end.cpp:967-969`)


class SlamManager:
    def __init__(self, cfg: SlamConfig,
                 use_loop_closer: Optional[bool] = None, device=None,
                 seed: int = 42):
        self.cfg = cfg
        self.device = resolve_device(device)
        # RANSAC sample streams held by this manager (the JAX package
        # seeds PRNGKey(42) / (0) / (7) / (23)): the front end and the mono
        # initialization draw from ``gen``, the loop closer from seed + 1,
        # the relocalizer from seed + 2
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.cam_l = build_camera(cfg.cam_left, other=cfg.cam_left,
                                  build_undist_map=cfg.do_undist,
                                  device=self.device)
        self.cam_r = (build_camera(cfg.cam_right, other=cfg.cam_left,
                                   device=self.device)
                      if cfg.stereo else None)
        self._remap_l = None   # image remap LUTs (rect/undist mode)
        self._remap_r = None
        if cfg.stereo and cfg.do_stereo_rect:
            self._setup_stereo_rectification()
        elif cfg.do_undist and self.cam_l.undist_map is not None:
            self._setup_mono_undistortion()
        self.map = MapStore(cfg)
        self.frontend = FrontEnd(cfg, self.cam_l, self.map, self.gen)
        self.mapper = Mapper(cfg, self.cam_l, self.cam_r, self.map)
        self.estimator = Estimator(cfg, self.cam_l, self.cam_r, self.map)
        self.loop_closer = None
        self.relocalizer = None
        if cfg.use_loop_closer if use_loop_closer is None else use_loop_closer:
            from ..loopclosure.closer import LoopCloser
            from ..models.relocalizer import Relocalizer

            self.loop_closer = LoopCloser(cfg, self.cam_l, self.map,
                                          self.estimator, seed=seed + 1)
            if cfg.use_relocalizer:
                reloc_gen = torch.Generator(device=self.device)
                reloc_gen.manual_seed(seed + 2)
                self.relocalizer = Relocalizer(
                    cfg, self.cam_l, self.map, self.loop_closer.index,
                    reloc_gen)
        self.logger = TrajectoryLogger()
        self.prof = Profiler.instance()
        self.frame_id = -1
        self.n_resets = 0
        self._prev_rights = []    # right images of the in-flight frames

    # ------------------------------------------------------------------ #

    def _setup_stereo_rectification(self):
        """Image-level stereo rectification (`bdo_stereo_rect`,
        `setupStereoCalibration`, `ov2slam.cpp:343-426`): compute the
        rectifying rotations + shared intrinsics, build remap LUTs, and
        swap both camera models for the rectified pinhole pair (distortion
        folded into the LUTs, D := 0 — `camera_calibration.cpp:134-194`)."""
        R_l, R_r, K_new, baseline = stereo_rectify(self.cam_l, self.cam_r)
        map_l = compute_rectify_map(self.cam_l, R_l, K_new)
        map_r = compute_rectify_map(self.cam_r, R_r, K_new)
        self._remap_l = lambda im: bilinear_sample(im, map_l)
        self._remap_r = lambda im: bilinear_sample(im, map_r)

        dev = self.device
        K = torch.as_tensor(K_new, dtype=torch.float32, device=dev)
        zero_d = torch.zeros_like(self.cam_l.dist)
        # rectified extrinsic: right camera at [+b, 0, 0] in the left
        # rectified frame, shared orientation
        T_c0_cr = lie.make_pose(
            torch.tensor([1.0, 0, 0, 0], device=dev),
            torch.tensor([baseline, 0, 0], dtype=torch.float32, device=dev))
        self.cam_l = dataclasses.replace(
            self.cam_l, model="pinhole", K=K, dist=zero_d,
            T_c0_ci=lie.pose_identity(device=dev), undist_map=None)
        self.cam_r = dataclasses.replace(
            self.cam_r, model="pinhole", K=K, dist=zero_d,
            T_c0_ci=T_c0_cr, undist_map=None)

    def _setup_mono_undistortion(self):
        """Image-level undistortion (`bdo_undist`): remap through the
        undistortion LUT and zero the camera distortion
        (`setUndistMap`, `camera_calibration.cpp:80-133`)."""
        lut = self.cam_l.undist_map
        self._remap_l = lambda im: bilinear_sample(im, lut)
        self.cam_l = dataclasses.replace(
            self.cam_l, dist=torch.zeros_like(self.cam_l.dist),
            undist_map=None)

    def _remap(self, remap, img):
        im = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        return remap(im)

    # ------------------------------------------------------------------ #

    def process_frame(self, img_left: np.ndarray,
                      img_right: Optional[np.ndarray] = None,
                      time: float = 0.0) -> np.ndarray:
        """Feed one frame (mono, or a stereo pair); returns the current
        T_wc.

        With ``cfg.pipelined_frontend`` a frame's result is resolved
        ``pipeline_depth`` frames late, its readback overlapped with the
        next frames' dispatches; the returned pose then belongs to an
        earlier frame. :meth:`finish` (called by the trajectory and result
        getters) resolves the frames still in flight."""
        self.frame_id += 1
        fe = self.frontend
        if self._remap_l is not None:
            img_left = self._remap(self._remap_l, img_left)
        if self._remap_r is not None and img_right is not None:
            img_right = self._remap(self._remap_r, img_right)

        if self.cfg.pipelined_frontend and self._pipeline_ready(fe):
            depth = max(1, self.cfg.pipeline_depth)
            if fe.n_pending >= depth:
                self._resolve_oldest()
            if self._pipeline_ready(fe):   # may have reset / gone lost
                fe.dispatch_frame(img_left, time)
                self._prev_rights.append(img_right)
                return fe.frame.T_wc
        # mode switch / lost state: resolve before the synchronous path
        self.finish()

        # post-reset relocalization (beyond-reference): while lost with a
        # populated map, first try to re-localize against the place index;
        # on failure fall through IMMEDIATELY to the re-bootstrap path —
        # holding the pose and waiting for a place match deadlocks when
        # the camera is in never-visited territory
        if (self.relocalizer is not None
                and self.map.n_keyframes > 1 and fe.frame.kf_id < 0
                and fe.frame.n_valid == 0):
            fe.preprocess(img_left)
            fe.frame.time = time
            if self.relocalizer.try_relocalize(fe):
                T = fe.frame.T_wc.astype(np.float64)
                self.logger.add_pose(time, T, False,
                                     self._kf_key(fe.frame.kf_id), None)
                return fe.frame.T_wc
        is_kf = fe.track_frame(img_left, time)
        return self._post_track(is_kf, img_right)

    def _pipeline_ready(self, fe) -> bool:
        """Steady tracking — the only regime the dispatch/resolve split
        handles; bootstrap, mono init and lost states go through the
        synchronous path."""
        return (fe.initialized and self.map.n_keyframes >= 1
                and not (fe.frame.kf_id < 0 and fe.frame.n_valid == 0)
                and not getattr(fe, "debug_gates", False))

    def _resolve_oldest(self):
        """Resolve the oldest in-flight frame and run everything after
        tracking for it, with its own right image."""
        is_kf = self.frontend.resolve_pending()
        right = self._prev_rights.pop(0) if self._prev_rights else None
        self._post_track(is_kf, right)

    def finish(self):
        """Resolve all in-flight frames (the pipelined mode's barrier)."""
        while self.frontend.has_pending:
            self._resolve_oldest()

    def _post_track(self, is_kf: bool, img_right) -> np.ndarray:
        """Everything after per-frame tracking: init/starvation handling,
        keyframe creation, relocalization fallback, trajectory logging —
        for the frame currently resolved in ``fe.frame``."""
        fe = self.frontend
        time = fe.frame.time

        if not fe.initialized:
            # bootstrap starving: restart from the next frame (the
            # reference resets a failing mono init,
            # `visual_front_end.cpp:98-113`, `mapper.cpp:129-144`). The
            # gate is proportional to the grid budget (the reference's
            # absolute 50 assumes its ~160-cell config); too tight a gate
            # races the init-parallax accumulation and resets forever.
            cap0 = self.cfg.grid_cells[0] * self.cfg.grid_cells[1]
            if (self.map.n_keyframes > 0
                    and fe.frame.n_valid < max(12, int(0.25 * cap0))):
                self._reset(full=True)
                is_kf = False
            else:
                is_kf = self._check_mono_init() or is_kf

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

        if is_kf and not starved and not self._allow_new_kf():
            is_kf = False        # async backpressure (see pipeline.py)
        if is_kf and not starved:
            kfid = self._create_keyframe(time, img_right)
            fe.frame.kf_id = kfid
            if kfid < 0:      # featureless re-bootstrap vetoed
                is_kf = False
        if starved:
            # beyond-reference: try map-preserving relocalization via the
            # place-recognition index before falling back to the
            # reference's reset (`ov2slam.cpp:428-455`)
            if not (self.relocalizer is not None
                    and self.relocalizer.try_relocalize(fe)):
                self._reset()

        T = fe.frame.T_wc.astype(np.float64)
        kf_id = fe.frame.kf_id
        T_kf = (self.map.kf_poses[kf_id].astype(np.float64)
                if kf_id >= 0 and self.map.kf_valid[kf_id] else None)
        self.logger.add_pose(time, T, is_kf, self._kf_key(kf_id), T_kf)
        return fe.frame.T_wc

    def _allow_new_kf(self) -> bool:
        """Keyframe-creation admission hook; the asynchronous manager
        overrides it with mapper-lag backpressure (`bnewkfavailable_`
        semantics, `mapper.cpp:153-162`)."""
        return True

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

        measured = fe.measured()
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

        # the keyframe observes the slots this frame measured and its new
        # detections (see FrontEnd.measured)
        measured[new_rows] = True
        lm_slots = np.where(f.valid & measured, f.lmids, -1).astype(np.int32)
        kfid = self.map.add_keyframe(
            time, f.T_wc, lm_slots, f.px_und, desc.astype(np.uint32))
        f.kf_id = kfid

        if fe.initialized:
            self._map_keyframe(kfid, img_right)
        return kfid

    def _map_keyframe(self, kfid: int, img_right) -> None:
        """Mapping, local BA and loop closure of the new keyframe
        ``kfid``, inline; the asynchronous manager hands it to its worker
        instead."""
        fe = self.frontend
        f = fe.frame
        self.mapper.process_keyframe(kfid, f, fe.cur_pyr, img_right)
        if self.cfg.do_track_localmap:
            self.mapper.match_to_local_map(kfid)
        if self.cfg.slam_mode:
            self.estimator.local_ba(kfid)
            self.estimator.map_filtering(kfid)
            self.estimator.prewarm_next()
        if self.loop_closer is not None:
            self.loop_closer.process_keyframe(kfid, img=fe.cur_pyr[0])
        # refresh the front-end pose estimate after BA moved the map; in
        # chained mode, propagate the same correction into the in-flight
        # device recurrence
        T_old = f.T_wc.copy()
        f.T_wc = self.map.kf_poses[kfid].copy()
        fe.motion.prev_T = f.T_wc.astype(np.float64)
        fe.chain_apply_correction(T_old, f.T_wc)

    # ------------------------------------------------------------------ #

    def _check_mono_init(self) -> bool:
        """Monocular bootstrap (`checkReadyForInit`,
        `visual_front_end.cpp:855-984`): once median parallax vs KF0
        exceeds the gate, recover the relative pose with essential RANSAC
        (scale fixed to 0.25), triangulate, and promote to an initialized
        map."""
        cfg = self.cfg
        fe = self.frontend
        f = fe.frame
        if self.map.n_keyframes == 0 or f.kf_id < 0:
            return False
        kf0 = f.kf_id
        sel = np.nonzero(f.valid & (f.lmids >= 0))[0]
        if len(sel) < 30:
            return False

        kf_slots = {int(l): s for s, l in
                    enumerate(self.map.obs_lmid[kf0]) if l >= 0}
        pairs = [(s, kf_slots[int(f.lmids[s])]) for s in sel
                 if int(f.lmids[s]) in kf_slots]
        if len(pairs) < 30:
            return False
        cur = f.px_und[[p[0] for p in pairs]]
        kf = self.map.obs_px[kf0][[p[1] for p in pairs]]
        parallax = np.median(np.linalg.norm(cur - kf, axis=-1))
        if parallax < cfg.init_parallax:
            return False

        fx, fy, cx, cy = self.cam_l.intrinsics_f
        n = len(pairs)
        cap = ((n + 127) // 128) * 128
        xl_p = np.zeros((cap, 2), np.float32)
        xr_p = np.zeros((cap, 2), np.float32)
        vm = np.zeros(cap, bool)
        xl_p[:n] = (kf - (cx, cy)) / (fx, fy)
        xr_p[:n] = (cur - (cx, cy)) / (fx, fy)
        vm[:n] = True

        dev = self.device

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        T_rel, inl, n_inl = relative_pose_ransac(
            self.gen, t(xl_p), t(xr_p), t(vm), focal=fx,
            err_th_px=cfg.ransac_err, n_iters=cfg.ransac_iter)
        if int(n_inl) < 0.5 * n:
            return False
        T_rel = T_rel.cpu().numpy().astype(np.float64)
        # fix scale: ||t|| = MONO_INIT_SCALE
        tnorm = np.linalg.norm(T_rel[4:7])
        if tnorm < 1e-6:
            return False
        T_rel[4:7] *= MONO_INIT_SCALE / tnorm

        T_kf0 = self.map.kf_poses[kf0].astype(np.float64)
        f.T_wc = lie_np.pose_compose(T_kf0, T_rel).astype(np.float32)

        # triangulate inliers and promote their landmarks
        inl = inl.cpu().numpy()[:n]
        rows = np.array([p[0] for p in pairs])[inl]
        bl = self.cam_l.bearing(t(kf[inl].astype(np.float32)))
        bc = self.cam_l.bearing(t(cur[inl].astype(np.float32)))
        T32 = t(T_rel.astype(np.float32))
        pts0 = triangulate_midpoint(T32[None], bl, bc)
        ok = reprojection_checks(T32, bl, bc, pts0, fx, cfg.max_reproj_err,
                                 min_depth=0.05).cpu().numpy()
        if ok.sum() < 20:
            return False
        pts_w = lie_np.pose_apply(
            T_kf0, pts0.cpu().numpy()[ok].astype(np.float64))
        self.map.set_landmark_positions(
            f.lmids[rows[ok]], pts_w.astype(np.float32))

        fe.initialized = True
        # re-seed the motion model: the init jump is NOT one-frame velocity
        fe.motion.reset()
        fe.motion.prev_T = f.T_wc.astype(np.float64)
        fe.motion.prev_time = f.time
        return True  # make this frame a keyframe

    # ------------------------------------------------------------------ #

    def _reset(self, full: bool = False):
        """(`SlamManager::reset`, `ov2slam.cpp:428-455`) — clears front-end
        tracking state; ``full`` also discards the map (pre-init bootstrap
        restart; post-init the map is kept)."""
        self.n_resets += 1
        self.frontend.reset()
        self._prev_rights = []
        if full:
            self.map = MapStore(self.cfg)
            self.frontend.map = self.map
            self.mapper.map = self.map
            self.estimator.map = self.map
            # unlike the JAX package, whose relocalizer and place index keep
            # the discarded map's keyframes (ROADMAP Queue 3), both follow
            # the new map
            if self.loop_closer is not None:
                self.loop_closer.reset_map(self.map)
            if self.relocalizer is not None:
                self.relocalizer.map = self.map

    def write_results(self, out_dir: str = "."):
        """Final products (`writeResults`, `ov2slam.cpp:576-623`): the
        frame, keyframe and KITTI trajectories, the keyframe trajectory
        after the optional full BA, and the loop-corrected full trajectory
        before and after the full pose graph."""
        self.finish()
        self.logger.write_tum(os.path.join(out_dir, "ov2slam_traj.txt"))
        self.logger.write_tum(
            os.path.join(out_dir, "ov2slam_kfs_traj.txt"),
            keyframes_only=True)
        self.logger.write_kitti(
            os.path.join(out_dir, "ov2slam_traj_kitti.txt"))

        if self.cfg.do_full_ba and self.map.n_keyframes >= 3:
            # optional final global BA (`ov2slam.cpp:600-615` runFullBA),
            # then the post-BA KF trajectory (`ov2slam.cpp:608-614`)
            from ..solvers.ba_variants import full_ba

            full_ba(self.map, self.estimator.params, self.cfg)
            kf_times = {fp.kf_id: fp.time for fp in self.logger.frames
                        if fp.is_keyframe}   # keyed by seq (see _kf_key)
            tl = TrajectoryLogger()
            for k in np.nonzero(self.map.kf_valid)[0]:
                seq = int(self.map.kf_seq[k])
                if seq in kf_times:
                    tl.add_pose(kf_times[seq],
                                self.map.kf_poses[k].astype(np.float64),
                                True, seq)
            tl.write_tum(os.path.join(out_dir,
                                      "ov2slam_fullba_kfs_traj.txt"))

        # LC-corrected full trajectory from optimized KF poses
        # (`writeFullTrajectoryLC`, `ov2slam.cpp:626-703`); keyed by seq
        kf_poses = {int(self.map.kf_seq[k]):
                    self.map.kf_poses[k].astype(np.float64)
                    for k in np.nonzero(self.map.kf_valid)[0]}
        frames = self.logger.replay_with_keyframes(kf_poses)
        TrajectoryLogger.write_frames_tum(
            frames, os.path.join(out_dir, "ov2slam_full_traj_wlc.txt"))
        # full pose graph over all frames, KFs fixed
        # (`Optimizer::fullPoseGraph`, `optimizer.cpp:2783-2865`)
        if len(frames) >= 3:
            from ..solvers.posegraph import full_pose_graph

            opt = full_pose_graph(
                np.stack([fp.T_wc for fp in frames]),
                np.stack([fp.T_wc for fp in self.logger.frames]),
                np.array([fp.is_keyframe for fp in frames]),
                device=self.device)
            opt_frames = [dataclasses.replace(fp, T_wc=opt[i])
                          for i, fp in enumerate(frames)]
            TrajectoryLogger.write_frames_tum(
                opt_frames,
                os.path.join(out_dir, "ov2slam_full_traj_wlc_opt.txt"))

    def estimated_trajectory(self):
        """(times (F,), poses (F, 7)) of all processed frames."""
        self.finish()
        times = np.array([fp.time for fp in self.logger.frames])
        poses = np.stack([fp.T_wc for fp in self.logger.frames])
        return times, poses
