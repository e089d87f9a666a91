"""Map-preserving relocalization after tracking loss.

Port of ``ov2slam_tpu/models/relocalizer.py`` (beyond the reference: OV2SLAM
resets, discarding front-end state, `SlamManager::reset`,
`ov2slam.cpp:428-455`, when tracking starves,
`visual_front_end.cpp:100-102`). Here the lost frame is first
re-localized against the existing map through the place-recognition stack:

  detect + BRIEF describe the lost frame (``fused_detect_describe``)
  -> ``PlaceIndex.query_best``: top-k over every stored keyframe, no
     recency mask, no island gate (the scorer kernel on the GPU)
  -> 2-NN Hamming matching to each candidate keyframe's landmarks
  -> batched P3P RANSAC on the 3D matches
  -> motion-only PnP refinement
  -> on success: restore the front-end frame (pose + matched keypoint
     slots) so KLT resumes tracking the old landmarks.

Only on failure does the manager fall back to the reference's reset.
RANSAC samples come from a ``torch.Generator`` that the manager owns.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..geometry.pnp import p3p_ransac
from ..ops.matching import knn_match_2nn
from ..solvers.pnp_refine import pnp_refine
from ..utils import lie_np
from ..utils.config import SlamConfig
from ..utils.profiler import Profiler
from .frontend_step import fused_detect_describe


class Relocalizer:
    def __init__(self, cfg: SlamConfig, cam_l, map_store, place_index,
                 gen: torch.Generator):
        self.cfg = cfg
        self.cam = cam_l
        self.device = cam_l.device
        self.map = map_store
        self.index = place_index
        self.prof = Profiler.instance()
        self._gen = gen
        self.n_relocs = 0
        # attempt pacing under real-time arrival: attempts are spaced
        # >= reloc_min_interval_s apart on the wall clock, so a paced
        # source that keeps losing tracking cannot turn every lost frame
        # into a full attempt (the JAX package's backoff, kept for parity;
        # offline runs and tests set it to 0)
        self._last_attempt_t = -1e18

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------ #

    def try_relocalize(self, frontend) -> bool:
        """Attempt to re-localize the front-end's current frame against
        the map. On success the frame's pose and keypoint slots are
        restored in place and True is returned."""
        if frontend.cur_pyr is None or len(self.index.kf_ids) < 2:
            return False
        if time.perf_counter() - self._last_attempt_t < float(
                getattr(self.cfg, "reloc_min_interval_s", 0.25)):
            return False
        self.prof.start("5.Relocalize")
        try:
            ok = self._attempt(frontend)
        finally:
            self.prof.stop("5.Relocalize")
        if ok:
            self.n_relocs += 1
        return ok

    def _attempt(self, frontend) -> bool:
        cfg = self.cfg
        m = self.map
        N = cfg.max_kps

        # 1) fresh detections + descriptors on the lost frame, through the
        # keyframe path's detector (no tracked keypoints to mask)
        if cfg.use_shi_tomasi:
            detector, thresh = "gftt", frontend._quality
        elif cfg.use_singlescale_detector:
            detector, thresh = "single", frontend._quality
        else:
            detector, thresh = "fast", frontend._fast_th
        desc_all, det = fused_detect_describe(
            frontend.cur_pyr[0],
            torch.zeros((N, 2), dtype=torch.float32, device=self.device),
            torch.zeros(N, dtype=torch.bool, device=self.device),
            float(thresh), frontend._calib, detector=detector,
            cell_size=cfg.max_dist, max_out=N, fisheye=frontend._fisheye)
        kps = det["kps"].cpu().numpy().astype(np.float32)
        det_ok = det["ok"].cpu().numpy()
        desc = desc_all[N:].cpu().numpy().view(np.uint32)
        if det_ok.sum() < 15:
            return False
        # the backoff clock arms ONLY past the cheap detect gate: a
        # featureless frame (sensor blackout) fails in one dispatch and
        # must not delay the real attempt on the next textured frame
        self._last_attempt_t = time.perf_counter()

        # 2) place-recognition candidates (best-first)
        for cand, _ in self.index.query_best(
                desc, det_ok, top_k=3, seq_lookup=lambda ids: m.kf_seq[ids]):
            if not m.kf_valid[cand]:
                continue
            found = self._verify_candidate(kps, desc, det_ok, cand)
            if found is None:
                continue
            T_wc, rows, lmids, _ = found
            rows, lmids = self._replenish(
                T_wc, kps, desc, det_ok, rows, lmids, cand)
            self._restore_frame(frontend, T_wc, kps, rows, lmids, cand)
            return True
        return False

    # ------------------------------------------------------------------ #

    def _replenish(self, T_wc, kps, desc, det_ok, rows, lmids, cand):
        """Grow the recovered observation set: project the candidate's
        local map (cand + covisible KFs' 3D landmarks) into the recovered
        pose and claim nearby detected keypoints whose BRIEF descriptor
        agrees (the relocalization analogue of `matchingToLocalMap`,
        `mapper.cpp:469-774`)."""
        m = self.map
        cov = m.covisible_kfs(cand, min_score=1, max_n=10)
        kf_list = [cand] + [int(c) for c in cov]
        lm_all = np.unique(m.obs_lmid[kf_list].ravel())
        lm_all = lm_all[lm_all >= 0]
        lm_all = lm_all[m.lm_valid[lm_all] & m.lm_is3d[lm_all]]
        cand_lms = lm_all[~np.isin(lm_all, lmids)].astype(np.int32)
        if len(cand_lms) == 0:
            return rows, lmids

        T_cw = lie_np.pose_inverse(T_wc.astype(np.float64))
        pc = lie_np.pose_apply(T_cw, m.lm_pos[cand_lms].astype(np.float64))
        front = pc[:, 2] > 0.1
        cand_lms, pc = cand_lms[front], pc[front]
        if len(cand_lms) == 0:
            return rows, lmids
        proj = self.cam.project_cam_to_image_dist(
            self._dev(pc.astype(np.float32))).cpu().numpy()
        inb = ((proj[:, 0] > 5) & (proj[:, 0] < self.cam.width - 6)
               & (proj[:, 1] > 5) & (proj[:, 1] < self.cam.height - 6))
        cand_lms, proj = cand_lms[inb], proj[inb]
        if len(cand_lms) == 0:
            return rows, lmids

        free = det_ok.copy()
        free[rows] = False
        free_rows = np.nonzero(free)[0]
        if len(free_rows) == 0:
            return rows, lmids

        # nearest free detection within radius + Hamming agreement
        d2 = ((proj[:, None, :] - kps[free_rows][None, :, :]) ** 2).sum(-1)
        radius2 = (2.0 * self.cfg.ransac_err) ** 2
        lm_desc = m.lm_desc[cand_lms]                      # (L, 8) u32
        ham = np.bitwise_count(
            np.bitwise_xor(lm_desc[:, None, :],
                           desc[free_rows][None, :, :])).sum(-1)
        score = np.where((d2 <= radius2) & (ham <= 80), d2, np.inf)

        add_rows, add_lms = [], []
        taken = np.zeros(len(free_rows), bool)
        for li in np.argsort(score.min(axis=1)):
            j = int(np.argmin(np.where(taken, np.inf, score[li])))
            if not np.isfinite(score[li, j]) or taken[j]:
                continue
            taken[j] = True
            add_rows.append(int(free_rows[j]))
            add_lms.append(int(cand_lms[li]))
        if add_rows:
            rows = np.concatenate([rows, np.asarray(add_rows)])
            lmids = np.concatenate([lmids, np.asarray(add_lms)])
        return rows, lmids

    # ------------------------------------------------------------------ #

    def _verify_candidate(self, kps, desc, det_ok, cand):
        """knn match -> P3P RANSAC -> PnP refine against one candidate KF.

        Returns (T_wc, kp_rows, lm_ids, n_inliers) or None."""
        cfg = self.cfg
        m = self.map

        idx, _ = knn_match_2nn(
            self._dev(desc.view(np.int32)), self._dev(det_ok),
            self._dev(m.obs_desc[cand].view(np.int32)),
            self._dev(m.obs_lmid[cand] >= 0), max_dist_bits=128, ratio=0.85)
        idx = idx.cpu().numpy()
        matched = np.nonzero(idx >= 0)[0]
        if len(matched) < 10:
            return None

        lm_cand = m.obs_lmid[cand][idx[matched]]
        is3d = m.lm_valid[lm_cand] & m.lm_is3d[lm_cand]
        rows3d = matched[is3d]
        lms3d = lm_cand[is3d]
        if len(rows3d) < 6:
            return None

        N = cfg.max_kps
        k3 = len(rows3d)
        pts = np.zeros((N, 3), np.float32)
        kp3 = np.zeros((N, 2), np.float32)
        vmask = np.zeros(N, bool)
        pts[:k3] = m.lm_pos[lms3d]
        kp3[:k3] = kps[rows3d]
        vmask[:k3] = True
        # undistort only the matched rows; padding rows stay at 0 px
        px_u = self.cam.undistort_px(self._dev(kp3))
        px_u = torch.where(self._dev(vmask)[:, None], px_u,
                           torch.zeros_like(px_u))

        fx, fy, cx, cy = self.cam.intrinsics_f
        bv = self.cam.bearing(px_u)
        pts_d, vm_d = self._dev(pts), self._dev(vmask)
        T_p3p, p3p_inl, n_p3p = p3p_ransac(
            self._gen, bv, pts_d, px_u, vm_d, fx, fy, cx, cy,
            err_th=cfg.ransac_err, n_iters=cfg.ransac_iter)
        if int(n_p3p) < 6:
            return None

        T_ref, inl, _ = pnp_refine(
            T_p3p, pts_d, px_u, vm_d & p3p_inl, fx, fy, cx, cy,
            robust_th=cfg.robust_mono_th, iters=10)
        inl = inl.cpu().numpy()[:k3]
        # gate scaled to the keypoint budget like the loop closer's
        # >=30-of-~300 acceptance (`loop_closer.cpp:288`)
        gy, gx = cfg.grid_cells
        if inl.sum() < max(10, int(0.1 * gy * gx)):
            return None
        return (T_ref.cpu().numpy(), rows3d[inl], lms3d[inl],
                int(inl.sum()))

    # ------------------------------------------------------------------ #

    def _restore_frame(self, frontend, T_wc, kps, rows, lmids, cand):
        """Rebuild the front-end frame state from the relocalized matches
        so the next frame's KLT resumes tracking the old landmarks."""
        f = frontend.frame
        f.px[:] = 0.0
        f.px_und[:] = 0.0
        f.lmids[:] = -1
        f.valid[:] = False

        slots = np.arange(len(rows))
        f.px[slots] = kps[rows]
        f.px_und[slots] = self.cam.undistort_px(
            self._dev(kps[rows])).cpu().numpy()
        f.lmids[slots] = lmids
        f.valid[slots] = True
        f.T_wc = T_wc.astype(np.float32)
        f.kf_id = int(cand)
        frontend.motion.reset()
        frontend.motion.update(T_wc.astype(np.float64), f.time)
