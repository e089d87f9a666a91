"""Mapper: keyframe → 3D structure.

Port of ``ov2slam_tpu/models/mapper.py`` (the reference's `Mapper` + the
mapping half of `MapManager`
(`src/mapper.cpp`, `src/map_manager.cpp:367-611`): stereo matching of the
new keyframe's keypoints (prior-guided fb-KLT left→right + epipolar gate),
stereo triangulation (`mapper.cpp:346-461`), temporal triangulation versus
each landmark's first observing keyframe (`mapper.cpp:191-344`), and
local-map descriptor matching (`mapper.cpp:469-774`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..geometry.essential import essential_from_pose
from ..ops.matching import projection_match
from ..utils import lie_np
from ..utils.config import SlamConfig
from ..utils.profiler import Profiler
from .frontend import to_u8
from .frontend_step import CalibArrays
from .mapper_step import fused_stereo_map_step, fused_temporal_step


class Mapper:
    def __init__(self, cfg: SlamConfig, cam_l: Camera,
                 cam_r: Optional[Camera], map_store):
        self.cfg = cfg
        self.cam_l = cam_l
        self.cam_r = cam_r
        self.map = map_store
        self.prof = Profiler.instance()
        self.device = cam_l.device
        self._calib_l = CalibArrays.from_camera(cam_l)
        if cam_r is not None:
            self._calib_r = CalibArrays.from_camera(cam_r)
            # right-in-left extrinsic as numpy + device-resident copies
            self.T_lr = cam_r.T_c0_ci.detach().cpu().numpy().astype(
                np.float64)
            self._T_lr_dev = self._dev(self.T_lr.astype(np.float32))
            self._E_lr_dev = essential_from_pose(self._T_lr_dev)
            self.E_lr = self._E_lr_dev.cpu().numpy()
            # rectified pair? (rotation ~identity, baseline along x) —
            # enables the epipolar SAD-scan prior (`getLineMinSAD`)
            rot_angle = float(np.linalg.norm(
                lie_np.so3_log(self.T_lr[:4])))
            t = self.T_lr[4:7]
            self._rectified = (rot_angle < 1e-3
                               and abs(t[0]) > 10 * (abs(t[1]) + abs(t[2]) + 1e-12))
        else:
            self.T_lr = None
            self._rectified = False

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------ #

    def process_keyframe(self, kfid: int, frame, left_pyr,
                         right_img: Optional[np.ndarray] = None,
                         lock=None):
        """Full KF mapping pass (`Mapper::run` body, `mapper.cpp:44-188`).

        ``lock``: optional map lock — held only for the host-side state
        snapshot and the write-back; device dispatches run OUTSIDE it so
        the front-end thread is never blocked on mapper device work (the
        reference's mapper thread holds `map_mutex_` only around state
        access too)."""
        if self.cfg.stereo and right_img is not None:
            self.prof.start("2.KF_StereoMap")
            self.stereo_map(kfid, left_pyr, right_img, lock=lock)
            self.prof.stop("2.KF_StereoMap")
        self.prof.start("2.KF_TriangulateTemporal")
        self.triangulate_temporal(kfid, lock=lock)
        self.prof.stop("2.KF_TriangulateTemporal")

    # ------------------------------------------------------------------ #

    def stereo_map(self, kfid: int, left_pyr, right_img, lock=None):
        """Stereo matching + stereo triangulation in one device step
        (`MapManager::stereoMatching` `map_manager.cpp:367-611` +
        `Mapper::triangulateStereo` `mapper.cpp:346-461`): prior-guided
        fb-KLT left->right, Sampson gate, midpoint triangulation of new
        matches — full-capacity masked arrays, one readback."""
        import contextlib

        lock = lock or contextlib.nullcontext()
        cfg = self.cfg
        m = self.map
        with lock:
            seq_snap = int(m.kf_seq[kfid])
            lmids = m.obs_lmid[kfid].copy()
            ids = np.maximum(lmids, 0)
            valid = (lmids >= 0) & m.lm_valid[ids]
            is3d = valid & m.lm_is3d[ids]
            lm_pos = np.where(is3d[:, None], m.lm_pos[ids], 0.0)
            px = m.obs_px[kfid].astype(np.float32)
            T_wc = m.kf_poses[kfid].astype(np.float32)
        if isinstance(right_img, np.ndarray):
            right_up = self._dev(to_u8(right_img))
        else:
            right_up = right_img
        f32 = np.float32
        out = fused_stereo_map_step(
            left_pyr, right_up, self._dev(px),
            self._dev(lm_pos.astype(f32)), self._dev(valid),
            self._dev(is3d), self._dev(T_wc),
            self._T_lr_dev, self._E_lr_dev,
            self._calib_l, self._calib_r,
            clahe_val=float(cfg.clahe_val), klt_err=float(cfg.klt_err),
            max_fbklt_dist=float(cfg.max_fbklt_dist),
            max_reproj_err=float(cfg.max_reproj_err),
            levels=cfg.klt_levels, win=cfg.klt_win_size,
            iters=cfg.max_iter, use_clahe=cfg.use_clahe,
            rectified=self._rectified,
            fisheye_r=self.cam_r.model == "fisheye")
        res = {k: v.cpu().numpy() for k, v in out.items()}
        rpx = res["rpx"]
        pts_w = res["pts_w"]
        stereo_ok = res["stereo_ok"]
        tri_ok = res["tri_ok"]
        tri_cand = res["tri_cand"]
        with lock:
            # stale-slot guards: the KF may have been culled+recycled and
            # individual observations removed while the solve ran unlocked
            if not m.kf_valid[kfid] or int(m.kf_seq[kfid]) != seq_snap:
                return
            live = m.obs_lmid[kfid] == lmids
            # matches that failed the triangulation checks lose their
            # stereo flag (`mapper.cpp:446-455`)
            new_stereo = stereo_ok & ~(tri_cand & ~tri_ok)
            m.obs_is_stereo[kfid][live] = new_stereo[live]
            sel = stereo_ok & live
            m.obs_rpx[kfid][sel] = rpx[sel]
            ok = tri_ok & live & (lmids >= 0)
            ok[ok] &= m.lm_valid[lmids[ok]]
            if ok.any():
                m.set_landmark_positions(
                    lmids[ok], pts_w[ok].astype(np.float32))

    # ------------------------------------------------------------------ #

    def triangulate_temporal(self, kfid: int, lock=None):
        """Triangulate 2D landmarks against their first observing keyframe
        (`Mapper::triangulateTemporal`, `mapper.cpp:191-344`) — all
        candidates in one fixed-shape step with per-row anchor poses."""
        import contextlib

        lock = lock or contextlib.nullcontext()
        cfg = self.cfg
        m = self.map
        with lock:
            seq_snap = int(m.kf_seq[kfid])
            lmids = m.obs_lmid[kfid].copy()
            N = len(lmids)
            ids = np.maximum(lmids, 0)
            cand = ((lmids >= 0) & m.lm_valid[ids] & ~m.lm_is3d[ids])
            anchor = np.where(cand, m.lm_anchor_kf[ids], -1)
            cand &= (anchor >= 0) & (anchor != kfid)
            cand &= m.kf_valid[np.maximum(anchor, 0)] & (anchor >= 0)
            rows = np.nonzero(cand)[0]
            if len(rows) == 0:
                return
            # anchor-KF slot of each candidate landmark (vectorized lookup
            # in the observer table)
            a_of = anchor[rows]
            obs_match = m.lm_obs_kf[ids[rows]] == a_of[:, None]
            has = obs_match.any(1)
            col = np.argmax(obs_match, 1)
            slot_a = m.lm_obs_slot[ids[rows], col]
            rows, a_of, slot_a = rows[has], a_of[has], slot_a[has]
            if len(rows) == 0:
                return

            px_a = np.zeros((N, 2), np.float32)
            px_c = np.zeros((N, 2), np.float32)
            T_a = np.zeros((N, 7), np.float32)
            T_a[:, 0] = 1.0
            T_rel = np.zeros((N, 7), np.float32)
            T_rel[:, 0] = 1.0
            vm = np.zeros(N, bool)
            px_a[rows] = m.obs_px[a_of, slot_a]
            px_c[rows] = m.obs_px[kfid][rows]
            T_cur = m.kf_poses[kfid].astype(np.float64)
            T_anchor = m.kf_poses[a_of].astype(np.float64)
            T_a[rows] = T_anchor.astype(np.float32)
            T_rel[rows] = lie_np.pose_relative(
                T_anchor, T_cur[None]).astype(np.float32)
            vm[rows] = True

        pts_w, ok = fused_temporal_step(
            self._dev(px_a), self._dev(px_c), self._dev(T_a),
            self._dev(T_rel), self._dev(vm), self._calib_l,
            max_reproj_err=float(cfg.max_reproj_err))
        pts_w = pts_w.cpu().numpy()
        ok = ok.cpu().numpy()
        with lock:
            if not m.kf_valid[kfid] or int(m.kf_seq[kfid]) != seq_snap:
                return
            ok &= (m.obs_lmid[kfid] == lmids) & (lmids >= 0)
            ok[ok] &= m.lm_valid[lmids[ok]] & ~m.lm_is3d[lmids[ok]]
            if ok.any():
                m.set_landmark_positions(
                    lmids[ok], pts_w[ok].astype(np.float32))

    # ------------------------------------------------------------------ #

    def match_to_local_map(self, kfid: int, lock=None) -> int:
        """Project unmatched local-map landmarks into the new KF and match
        descriptors (`matchingToLocalMap`/`matchToMap`,
        `mapper.cpp:469-774`). Matches merge the KF's 2D landmark into the
        map landmark. Returns number of merges."""
        import contextlib

        lock = lock or contextlib.nullcontext()
        cfg = self.cfg
        m = self.map
        with lock:
            seq_snap = int(m.kf_seq[kfid])
            cov = m.covisible_kfs(kfid, min_score=5, max_n=10)
            if len(cov) == 0:
                return 0

            # local map = 3D landmarks of covisible KFs not observed in
            # kfid (vectorized over the slot tables: the per-landmark
            # Python set walk was a measured host hotspot)
            cand = m.obs_lmid[np.asarray(cov, np.int64)].ravel()
            cand = np.unique(cand[cand >= 0])
            cand = cand[m.lm_valid[cand] & m.lm_is3d[cand]]
            own = m.obs_lmid[kfid]
            local = np.setdiff1d(cand, own[own >= 0])
            if len(local) == 0:
                return 0

            # project into kfid
            T_cw = lie_np.pose_inverse(m.kf_poses[kfid].astype(np.float64))
            pc = lie_np.pose_apply(T_cw, m.lm_pos[local].astype(np.float64))
            z = pc[:, 2]
            fx, fy, cx, cy = self.cam_l.intrinsics_f
            with np.errstate(divide="ignore", invalid="ignore"):
                proj = np.stack([pc[:, 0] / z * fx + cx,
                                 pc[:, 1] / z * fy + cy], -1)
            inb = ((z > 0.1) & (proj[:, 0] >= 0)
                   & (proj[:, 0] < self.cam_l.width)
                   & (proj[:, 1] >= 0) & (proj[:, 1] < self.cam_l.height))
            local = np.asarray(local)[inb]
            proj = proj[inb]
            if len(local) == 0:
                return 0

            # pad to capacity and match against the KF's own keypoints
            L = len(local)
            cap = ((L + 127) // 128) * 128
            proj_p = np.zeros((cap, 2), np.float32)
            proj_p[:L] = proj
            pv = np.zeros(cap, bool)
            pv[:L] = True
            pdesc = np.zeros((cap, 8), np.uint32)
            pdesc[:L] = m.lm_desc[local]
            pdesc = pdesc.view(np.int32)
            kp_px = m.obs_px[kfid].copy()
            kp_valid = m.obs_lmid[kfid] >= 0
            kp_desc = m.obs_desc[kfid].copy().view(np.int32)

        idx, dist = projection_match(
            self._dev(proj_p), self._dev(pv), self._dev(pdesc),
            self._dev(kp_px.astype(np.float32)), self._dev(kp_valid),
            self._dev(kp_desc),
            cfg.max_proj_pxdist, int(cfg.max_desc_dist * 256))
        idx = idx.cpu().numpy()[:L]

        n_merged = 0
        with lock:
            if not m.kf_valid[kfid] or int(m.kf_seq[kfid]) != seq_snap:
                return 0
            for i, slot in enumerate(idx):
                if slot < 0:
                    continue
                cur_lm = int(m.obs_lmid[kfid, slot])
                map_lm = int(local[i])
                if cur_lm == map_lm or cur_lm < 0:
                    continue
                if (not m.lm_valid[map_lm] or not m.lm_is3d[map_lm]
                        or m.lm_is3d[cur_lm]):
                    continue  # both 3D: leave to loop-closure merging
                m.merge_landmarks(map_lm, cur_lm)
                n_merged += 1
        return n_merged
