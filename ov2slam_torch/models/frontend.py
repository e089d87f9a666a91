"""Visual front-end: per-frame tracking state machine.

Port of the synchronous path of ``ov2slam_tpu/models/frontend.py`` (the
reference's `VisualFrontEnd`): CLAHE+pyramid preprocessing, constant-
velocity motion model, prior-guided forward-backward KLT, epipolar 2d-2d
outlier gating, P3P + motion-only PnP pose computation, and keyframe-need
heuristics.

The current frame's keypoints live in fixed-capacity host slot arrays (px,
undistorted px, landmark ids, valid mask); each frame runs one
``fused_track_step`` on the device and reads its result back once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.image import build_pyramid, clahe
from ..geometry.pnp import p3p_ransac
from ..solvers.pnp_refine import pnp_refine
from .frontend_step import CalibArrays, fused_detect_describe, \
    fused_track_step
from ..utils import lie_np
from ..utils.config import SlamConfig
from ..utils.profiler import Profiler


def to_u8(img: np.ndarray) -> np.ndarray:
    """The frame as uint8 (dataset replay is 8-bit). A normalized [0, 1]
    float image is rescaled to [0, 255] first."""
    if img.dtype == np.uint8:
        return img
    if img.size and float(img.max()) <= 1.5:
        img = img * 255.0
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


class MotionModel:
    """Constant-velocity SE3 prior (`visual_front_end.hpp:38-90`)."""

    def __init__(self):
        self.prev_T = None
        self.prev_time = None
        self.rel = lie_np.pose_identity()
        self.rel_dt = 0.0

    def predict(self, time: float) -> Optional[np.ndarray]:
        if self.prev_T is None:
            return None
        if self.rel_dt <= 0:
            return self.prev_T.copy()
        dt = time - self.prev_time
        xi = lie_np.so3_log(self.rel[:4])
        scale = dt / self.rel_dt
        step = np.concatenate([lie_np.so3_exp(xi * scale),
                               self.rel[4:] * scale])
        return lie_np.pose_compose(self.prev_T, step)

    def update(self, T_wc: np.ndarray, time: float):
        if self.prev_T is not None and time > self.prev_time:
            self.rel = lie_np.pose_relative(self.prev_T, T_wc)
            self.rel_dt = time - self.prev_time
        self.prev_T = T_wc.copy()
        self.prev_time = time

    def reset(self):
        self.__init__()


@dataclasses.dataclass
class FrameState:
    """Current-frame keypoint slots (fixed capacity N)."""

    px: np.ndarray        # (N, 2) raw pixels
    px_und: np.ndarray    # (N, 2) undistorted pixels
    lmids: np.ndarray     # (N,) int32 (-1 = empty)
    valid: np.ndarray     # (N,) bool
    T_wc: np.ndarray      # (7,)
    time: float = 0.0
    kf_id: int = -1       # reference keyframe

    @classmethod
    def empty(cls, n: int):
        return cls(
            px=np.zeros((n, 2), np.float32),
            px_und=np.zeros((n, 2), np.float32),
            lmids=np.full(n, -1, np.int32),
            valid=np.zeros(n, bool),
            T_wc=lie_np.pose_identity().astype(np.float32),
        )

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


class FrontEnd:
    def __init__(self, cfg: SlamConfig, cam_l: Camera, map_store,
                 gen: torch.Generator):
        self.cfg = cfg
        self.cam = cam_l
        self.device = cam_l.device
        self.map = map_store
        self.motion = MotionModel()
        self.frame = FrameState.empty(cfg.max_kps)
        self.prev_pyr = None
        self.cur_pyr = None
        self.initialized = cfg.stereo   # mono needs bootstrapping
        self.prof = Profiler.instance()
        self._gen = gen
        self._quality = cfg.max_quality
        self._fast_th = float(cfg.fast_th)
        self._frames_since_kf = 0
        self.bootstrap_kf = False      # last returned KF is a bootstrap
        self.last_pose_ok = None       # per-frame diagnostics
        self.last_n_inl = 0
        self.last_n_3d = 0
        self._calib = CalibArrays.from_camera(cam_l)
        self._fisheye = cam_l.model == "fisheye"
        # from-KF tracking (`btrack_keyframetoframe`): the reference
        # keyframe's pyramid, captured at detection time
        self._kf_pyr = None

    # ------------------------------------------------------------------ #

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def upload(self, img) -> torch.Tensor:
        """Frame → f32 tensor on the device (host frames go through
        :func:`to_u8` first; a tensor is taken as it is)."""
        if isinstance(img, np.ndarray):
            img = self._dev(to_u8(img))
        return img.to(torch.float32)

    def preprocess(self, img) -> None:
        """CLAHE + pyramid; swaps prev/cur. The frame is taken as f32
        as it is (no uint8 rounding on this path, as in the JAX package)."""
        im = (self._dev(np.asarray(img, np.float32))
              if isinstance(img, np.ndarray) else img.to(torch.float32))
        if self.cfg.use_clahe:
            im = clahe(im, self.cfg.clahe_val)
        self.prev_pyr = self.cur_pyr
        self.cur_pyr = tuple(build_pyramid(im, self.cfg.klt_levels))

    # ------------------------------------------------------------------ #

    def track_frame(self, img, time: float) -> bool:
        """Process one left frame; returns True if it should become a
        keyframe (`visualTracking`, `visual_front_end.cpp:40-128`)."""
        self.prof.start("0.Full-Front_End")
        try:
            return self._track_frame(img, time)
        finally:
            self.prof.stop("0.Full-Front_End")

    def _track_frame(self, img, time: float) -> bool:
        cfg = self.cfg
        f = self.frame

        self.bootstrap_kf = False
        if self.map.n_keyframes == 0 or (f.kf_id < 0 and f.n_valid == 0):
            # bootstrap (or post-reset re-bootstrap): this frame becomes a
            # keyframe; pose = identity on first start, else keep the last
            # estimate so the map stays consistent
            f.time = time
            self.bootstrap_kf = True
            self.preprocess(img)
            if self.map.n_keyframes == 0:
                f.T_wc = lie_np.pose_identity().astype(np.float32)
            self.motion.update(f.T_wc.astype(np.float64), time)
            self._frames_since_kf = 0
            return True

        self.prof.start("0.FE_pre")
        T_pred = self.motion.predict(time)
        if T_pred is None:
            T_pred = f.T_wc.astype(np.float64)

        # --- host-side slot gathers (vectorized numpy) ----------------- #
        ids = np.maximum(f.lmids, 0)
        live = f.valid & (f.lmids >= 0) & self.map.lm_valid[ids]
        is3d = live & self.map.lm_is3d[ids]
        lm_pos = np.where(is3d[:, None], self.map.lm_pos[ids], 0.0)

        kf_px = np.zeros_like(f.px_und)
        pair_valid = np.zeros(len(f.px), bool)
        T_kf = T_pred
        kfid = f.kf_id
        if kfid >= 0 and self.map.kf_valid[kfid]:
            T_kf = self.map.kf_poses[kfid].astype(np.float64)
            lookup = np.full(self.map.L, -1, np.int32)
            kf_lm = self.map.obs_lmid[kfid]
            sel = kf_lm >= 0
            lookup[kf_lm[sel]] = np.nonzero(sel)[0]
            slot_in_kf = lookup[ids]
            pair_valid = live & (slot_in_kf >= 0)
            kf_px[pair_valid] = self.map.obs_px[
                kfid, slot_in_kf[pair_valid]]
        self.prof.stop("0.FE_pre")

        # --- one device step ------------------------------------------- #
        self.prof.start("0.FE_dispatch")
        do_pose = bool(self.initialized)
        debug = getattr(self, "debug_gates", False)
        from_kf = bool(cfg.track_keyframetoframe and do_pose
                       and self._kf_pyr is not None)
        f32 = np.float32
        cur_pyr, out = fused_track_step(
            self.upload(img), self.cur_pyr,
            self._dev(f.px.astype(f32)), self._dev(f.valid),
            self._dev(lm_pos.astype(f32)), self._dev(kf_px.astype(f32)),
            self._dev(is3d), self._dev(pair_valid),
            self._dev(np.asarray(T_pred, f32)),
            self._dev(np.asarray(T_kf, f32)), self._gen, self._calib,
            clahe_val=float(cfg.clahe_val),
            max_fbklt_dist=float(cfg.max_fbklt_dist),
            klt_err=float(cfg.klt_err),
            ransac_err_px=float(cfg.ransac_err),
            robust_th=float(cfg.robust_mono_th),
            levels=cfg.klt_levels, win=cfg.klt_win_size,
            iters=cfg.max_iter, use_clahe=cfg.use_clahe,
            do_epipolar=cfg.do_epipolar, do_pose=do_pose,
            ransac_iters=cfg.ransac_iter, pnp_iters=cfg.pnp_iters,
            fisheye=self._fisheye, use_prior=cfg.klt_use_prior,
            debug=debug, split_sub=cfg.klt_split_sub,
            kf_pyr=self._kf_pyr if from_kf else None,
            track_from_kf=from_kf)
        self.prev_pyr = self.cur_pyr
        self.cur_pyr = cur_pyr
        self.prof.stop("0.FE_dispatch")

        # --- single readback ------------------------------------------- #
        self.prof.start("0.FE_readback")
        res = {k: v.cpu().numpy() for k, v in out.items()}
        self.prof.stop("0.FE_readback")
        if debug:
            self.last_debug = res
        tracked = res["tracked"]
        und = res["und"]
        status = res["status"]
        pose_ok = bool(res["pose_ok"])
        n_inl = int(res["n_inl"])
        T_new = res["T_new"].astype(np.float32)

        f.time = time
        n_before = int(f.valid.sum())
        f.px = np.where(status[:, None], tracked, f.px)
        f.px_und = np.where(status[:, None], und, f.px_und)
        f.valid &= status

        self.last_pose_ok = pose_ok if do_pose else None
        self.last_n_inl = n_inl if do_pose else 0
        self.last_n_3d = int(is3d.sum())
        # KLT-collapse P3P forcing (`visual_front_end.cpp:228-233`): when
        # under a third of the tracked set survives, re-localize with
        # global P3P-RANSAC instead of trusting the local PnP
        klt_collapsed = (n_before > 0
                         and f.n_valid < 0.33 * n_before)
        if do_pose:
            if klt_collapsed and cfg.do_p3p:
                if not self._p3p_fallback(T_pred):
                    f.T_wc = (T_new if pose_ok
                              else T_pred.astype(np.float32))
            elif pose_ok:
                f.T_wc = T_new
            else:
                # PnP failed: P3P re-localization attempt
                if not (cfg.do_p3p and self._p3p_fallback(T_pred)):
                    f.T_wc = T_pred.astype(np.float32)
        else:
            f.T_wc = T_pred.astype(np.float32)

        self.motion.update(f.T_wc.astype(np.float64), time)
        self._frames_since_kf += 1

        self.prof.start("0.FE_kfcheck")
        is_kf = self.check_new_kf()
        self.prof.stop("0.FE_kfcheck")
        if is_kf:
            self._frames_since_kf = 0
        return is_kf

    def _p3p_fallback(self, T_pred: np.ndarray) -> bool:
        """P3P-RANSAC + motion-only PnP re-localization, used when the
        fused step's PnP fails (`computePose` fallback branch,
        `visual_front_end.cpp:659-851`)."""
        cfg = self.cfg
        f = self.frame
        sel = f.valid & (f.lmids >= 0)
        ids = f.lmids[sel]
        is3d = np.zeros_like(sel)
        is3d[sel] = self.map.lm_is3d[ids] & self.map.lm_valid[ids]
        rows = np.nonzero(is3d)[0]
        n3d = len(rows)
        if n3d < 5:
            f.T_wc = T_pred.astype(np.float32)
            return not self.initialized  # mono pre-init: pose undefined yet
        self.prof.start("1.FE_ComputePose")

        pts = self.map.lm_pos[f.lmids[rows]].astype(np.float32)
        px = f.px_und[rows]
        N = self.cfg.max_kps
        pts_p = np.zeros((N, 3), np.float32)
        px_p = np.zeros((N, 2), np.float32)
        vm = np.zeros(N, bool)
        pts_p[:n3d] = pts
        px_p[:n3d] = px
        vm[:n3d] = True

        fx, fy, cx, cy = self.cam.intrinsics_f

        T0 = T_pred.astype(np.float32)
        use_p3p = cfg.do_p3p
        if use_p3p:
            bv = self.cam.bearing(self._dev(px_p))
            T_p3p, _, n_inl = p3p_ransac(
                self._gen, bv, self._dev(pts_p),
                self._dev(px_p), self._dev(vm), fx, fy, cx, cy,
                err_th=cfg.ransac_err, n_iters=cfg.ransac_iter)
            if int(n_inl) >= 5:
                T0 = T_p3p.cpu().numpy()

        T_ref, inlier, _ = pnp_refine(
            self._dev(T0), self._dev(pts_p), self._dev(px_p),
            self._dev(vm), fx, fy, cx, cy,
            robust_th=cfg.robust_mono_th, iters=self.cfg.pnp_iters)
        inlier = inlier.cpu().numpy()[:n3d]
        n_inl = int(inlier.sum())

        self.prof.stop("1.FE_ComputePose")
        if n_inl < max(5, int(0.25 * n3d)):
            # tracking failure — or a spurious minimum: a re-localized
            # pose explaining under a quarter of the tracked 3D set is
            # far more likely a mirrored/degenerate P3P solution than
            # the true pose; accepting it poisons the motion model and
            # the map. Keep the prediction; caller may reset.
            f.T_wc = T_pred.astype(np.float32)
            return False

        f.T_wc = T_ref.cpu().numpy().astype(np.float32)
        # remove outlier observations from the frame
        f.valid[rows[~inlier]] = False
        return True

    # ------------------------------------------------------------------ #

    def check_new_kf(self) -> bool:
        """Keyframe-need heuristics, mirroring `checkNewKfReq`
        (`visual_front_end.cpp:986-1061`) condition by condition."""
        cfg = self.cfg
        f = self.frame
        if not self.initialized:
            return False  # mono: init path decides
        kfid = f.kf_id
        if kfid < 0 or not self.map.kf_valid[kfid]:
            return False

        cap = cfg.grid_cells[0] * cfg.grid_cells[1]
        n_occup = f.n_valid  # one kp per cell ⇒ occupied-cell proxy
        sel = f.valid & (f.lmids >= 0)
        ids = f.lmids[sel]
        n3d = int((self.map.lm_is3d[ids] & self.map.lm_valid[ids]).sum()) \
            if len(ids) else 0
        kf_lm = self.map.kf_landmark_ids(kfid, only_3d=True)
        kf_n3d = len(kf_lm)
        nb_from_kf = self._frames_since_kf
        time_diff = f.time - float(self.map.kf_times[kfid])

        if n_occup < 0.33 * cap and nb_from_kf >= 5:
            return True
        if n3d < 20 and nb_from_kf >= 2:
            return True
        if n3d > 0.5 * cap and nb_from_kf < 2:
            return False
        if cfg.stereo and time_diff > 1.0:
            return True

        parallax = self._median_parallax_to_kf(kfid) or 0.0
        cx = (parallax >= cfg.init_parallax / 2.0
              or (cfg.stereo and nb_from_kf > 2))
        c0 = parallax >= cfg.init_parallax
        c1 = n3d < 0.75 * kf_n3d
        c2 = n_occup < 0.5 * cap and n3d < 0.85 * kf_n3d
        return (c0 or c1 or c2) and cx

    def _median_parallax_to_kf(self, kfid: int) -> Optional[float]:
        """Rotation-compensated median parallax (`computeParallax`,
        `visual_front_end.cpp:1066-1141`)."""
        f = self.frame
        sel = np.nonzero(f.valid & (f.lmids >= 0))[0]
        if len(sel) < 8:
            return None
        kf_slots = {int(l): s for s, l in enumerate(self.map.obs_lmid[kfid])
                    if l >= 0}
        pairs = [(s, kf_slots[int(f.lmids[s])]) for s in sel
                 if int(f.lmids[s]) in kf_slots]
        if len(pairs) < 8:
            return None
        cur = f.px_und[[p[0] for p in pairs]]
        kf = self.map.obs_px[kfid][[p[1] for p in pairs]]
        # rotation compensation: rotate KF bearings into cur frame
        T_kf = self.map.kf_poses[kfid].astype(np.float64)
        R_rel = lie_np.quat_to_matrix(
            lie_np.pose_relative(f.T_wc.astype(np.float64), T_kf)[:4])
        fx, fy, cx, cy = self.cam.intrinsics_f
        xn = np.concatenate([(kf - (cx, cy)) / (fx, fy),
                             np.ones((len(kf), 1))], -1)
        rot = (R_rel @ xn.T).T
        rot_px = rot[:, :2] / np.maximum(rot[:, 2:], 1e-6) * (fx, fy) + (cx, cy)
        return float(np.median(np.linalg.norm(cur - rot_px, axis=-1)))

    # ------------------------------------------------------------------ #

    def detect_and_describe(self) -> Tuple[np.ndarray, np.ndarray]:
        """Fill empty grid cells with new detections and BRIEF-describe all
        current keypoints (`MapManager::extractKeypoints`,
        `map_manager.cpp:286-341`). Returns (new_rows, descriptors (N, 8)
        int32 words)."""
        cfg = self.cfg
        f = self.frame
        self.prof.start("1.KF_DetectDescribe")
        # `map_manager.cpp:312-323`: use_shi_tomasi → GFTT (two-pass +
        # cornerSubPix), use_fast → grid FAST, use_singlescale_detector →
        # single-scale Shi-Tomasi
        if cfg.use_shi_tomasi:
            detector, thresh = "gftt", self._quality
        elif cfg.use_singlescale_detector:
            detector, thresh = "single", self._quality
        else:
            detector, thresh = "fast", self._fast_th
        n_valid = f.n_valid
        desc_all, det = fused_detect_describe(
            self.cur_pyr[0], self._dev(f.px.astype(np.float32)),
            self._dev(f.valid), float(thresh), self._calib,
            detector=detector, cell_size=cfg.max_dist, max_out=cfg.max_kps,
            fisheye=self._fisheye)
        desc_all = desc_all.cpu().numpy()
        kps = det["kps"].cpu().numpy()
        und_new = det["und"].cpu().numpy()
        ok = det["ok"].cpu().numpy()
        N = len(f.px)

        # adaptive threshold update (`feature_extractor.cpp:418-423,546-552`)
        n_det = int(ok.sum())
        cap = cfg.grid_cells[0] * cfg.grid_cells[1]
        n_free = max(cap - n_valid, 1)
        if cfg.use_singlescale_detector or cfg.use_shi_tomasi:
            if n_det < 0.33 * n_free:
                self._quality /= 2.0
            elif n_det > 0.9 * n_free:
                self._quality *= 1.5
        else:
            # floor above the sensor-noise band: the adaptive loop would
            # otherwise accept noise corners in sparse views
            if n_det < 0.33 * n_free:
                self._fast_th = max(5.0, self._fast_th * 0.5)
            elif n_det > 0.9 * n_free:
                self._fast_th = min(80.0, self._fast_th * 1.5)

        # place new kps into free slots
        free_slots = np.nonzero(~f.valid)[0]
        desc = desc_all[:N].copy()
        new_rows = []
        det_rows = np.nonzero(ok)[0]
        for i, slot in zip(det_rows, free_slots):
            f.px[slot] = kps[i]
            f.px_und[slot] = und_new[i]
            f.valid[slot] = True
            f.lmids[slot] = -1  # landmark assigned by caller
            desc[slot] = desc_all[N + i]
            new_rows.append(slot)
        new_rows = np.array(new_rows, np.int64)
        # this frame becomes the reference keyframe: its pyramid is the
        # from-KF tracking source until the next keyframe
        self._kf_pyr = self.cur_pyr
        self.prof.stop("1.KF_DetectDescribe")
        return new_rows, desc

    # ------------------------------------------------------------------ #

    def reset(self):
        """Tracking-failure reset (`SlamManager::reset`,
        `ov2slam.cpp:428-455`)."""
        self.frame = FrameState.empty(self.cfg.max_kps)
        self.motion.reset()
        self.prev_pyr = None
        self.cur_pyr = None
        self._kf_pyr = None
        self.initialized = self.cfg.stereo
