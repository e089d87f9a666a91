"""Loop closure pipeline.

Port of ``ov2slam_tpu/loopclosure/closer.py`` (the reference's
`LoopCloser`, `src/loop_closer.cpp`): on every
new keyframe, query the place index; on a hit, verify with the reference's
cascade — 2-NN knn matching (`:378-459`) → epipolar filter (`:462-499`) →
P3P-RANSAC (`:765-830`) → loop-local-map projection matching + PnP
(`:502-763`, `:833-897`) — and on acceptance run the local pose graph
(`Optimizer::localPoseGraph`, `optimizer.cpp:2346-2591`), propagate the
correction to keyframes and landmarks, and merge duplicate landmarks
(`map_manager.cpp:801-882`).

Acceptance gates are the reference's counts (>=15 knn matches, >=10
epipolar inliers, >=5 P3P inliers, >=30 PnP inliers,
`loop_closer.cpp:217,227,251,288`) scaled from its ~300-kp budget to the
configured grid budget, with RANSAC-solvability floors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.essential import essential_ransac
from ..geometry.pnp import p3p_ransac
from ..ops.matching import knn_match_2nn, projection_match
from ..solvers.pnp_refine import pnp_refine
from ..solvers.posegraph import build_chain_edges, pose_graph_solve
from ..utils import lie_np
from ..utils.config import SlamConfig
from ..utils.profiler import Profiler
from .index import PlaceIndex


class LoopCloser:
    def __init__(self, cfg: SlamConfig, cam_l, map_store, estimator,
                 seed: int = 7):
        self.cfg = cfg
        self.cam = cam_l
        self.map = map_store
        self.estimator = estimator
        self.device = cam_l.device
        self.index = PlaceIndex(
            cfg.max_keyframes, recent_mask=cfg.lc_recent_mask,
            island_radius=cfg.lc_island_radius,
            min_score=cfg.lc_min_score, match_bits=cfg.lc_match_bits,
            device=self.device)
        self.prof = Profiler.instance()
        # RANSAC samples of the verification cascade
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.n_closures = 0
        self._last_closure_seq = None
        self._calib_dev = None

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def reset_map(self, map_store):
        """Follow a new (empty) map after a full reset: the old map's
        keyframes leave the place index, since the new map's slots and seqs
        restart at 0 and would alias them."""
        self.map = map_store
        self.index.clear()
        self._last_closure_seq = None
        self.estimator.lc_kf_id = -1

    # ------------------------------------------------------------------ #

    def _extra_query_kps(self, img, kps_px, kps_valid):
        """Up to max_kps extra FAST/BRIEF keypoints for the place query
        (`loop_closer.cpp:89-140`: the reference detects up to 300 fresh
        FAST corners masked around tracked kps and inserts them into the
        vocabulary alongside the landmark descriptors — tracked sets are
        sparse, so this materially lifts recall at low kp budgets).
        The extra kps are query/index-only; they never enter the map."""
        from ..models.frontend_step import CalibArrays, \
            fused_detect_describe

        cfg = self.cfg
        if self._calib_dev is None:
            self._calib_dev = CalibArrays.from_camera(self.cam)
        # a finer grid than the tracker's: 4x the cells, best max_kps
        # kept
        N = len(kps_px)
        desc_all, det = fused_detect_describe(
            img, self._dev(kps_px.astype(np.float32)), self._dev(kps_valid),
            20.0, self._calib_dev, detector="fast",
            cell_size=max(10, cfg.max_dist // 2), max_out=cfg.max_kps,
            fisheye=self.cam.model == "fisheye")
        return (det["kps"].cpu().numpy().astype(np.float32),
                desc_all[N:].cpu().numpy().view(np.uint32),
                det["ok"].cpu().numpy())

    def process_keyframe(self, kfid: int, img=None) -> bool:
        """Query + verify + close (:meth:`query_keyframe`, then
        :meth:`close_candidate`). Returns True if a loop was closed."""
        found = self.query_keyframe(kfid, img=img)
        return found is not None and self.close_candidate(found)

    def query_keyframe(self, kfid: int, img=None):
        """The place query of keyframe ``kfid``: its descriptors, the index
        query and the index add. Returns ``(kfid, candidate, kf seq,
        candidate seq)`` for a candidate past the closure cooldown, else
        None.

        ``img``: the keyframe's image (pyramid base); when given, extra
        FAST/BRIEF keypoints augment the place query + index entry.

        It reads the map and writes the index: the asynchronous worker
        calls it while it holds the map lock for the keyframe's mapping and
        BA (taking the lock again afterwards waited for a whole front-end
        frame each keyframe).
        """
        m = self.map
        desc0 = m.obs_desc[kfid].copy()
        valid0 = m.obs_lmid[kfid] >= 0
        px0 = m.obs_px[kfid].copy()
        seq_kf = int(m.kf_seq[kfid])
        self._extra = None   # (px, desc, valid) of the fresh detections
        if img is not None:
            xp, xd, xv = self._extra_query_kps(img, px0, valid0)
            self._extra = (xp, xd, xv)
            desc = np.concatenate([desc0, xd], axis=0)
            valid = np.concatenate([valid0, xv], axis=0)
        else:
            # keep the index row shape static regardless of augmentation
            desc = np.concatenate([desc0, np.zeros_like(desc0)], axis=0)
            valid = np.concatenate([valid0, np.zeros_like(valid0)], axis=0)

        self.prof.start("4.LC_QueryIndex")
        # exclude covisible KFs (`loop_closer.cpp:201-209`)
        cov = set(int(k) for k in m.covisible_kfs(kfid, min_score=1))
        cand, score = self.index.query(
            desc, valid, exclude=cov,
            seq_lookup=lambda ids: m.kf_seq[ids])
        self.index.add(kfid, desc, valid, seq=int(m.kf_seq[kfid]),
                       seq_lookup=lambda ids: m.kf_seq[np.asarray(ids)])
        cand_ok = cand >= 0 and m.kf_valid[cand]
        seq_cand = int(m.kf_seq[cand]) if cand_ok else -1
        self.prof.stop("4.LC_QueryIndex")
        if not cand_ok:
            return None
        # closure cooldown: right after a successful closure the map has
        # just been corrected; consecutive candidates over the following
        # few keyframes re-close the SAME place and each pose-graph snap
        # re-perturbs a freshly consistent trajectory (measured on a
        # two-lap revisit: 12 back-to-back closures, each followed by
        # tracking starvation + relocalization). The reference's iBoW
        # island consistency plays the same burst-suppression role
        # (`lcdetector.h:42-60` consecutive-loops handling).
        if (self._last_closure_seq is not None
                and seq_kf - self._last_closure_seq
                <= self.cfg.lc_cooldown_kfs):
            return None
        return kfid, int(cand), seq_kf, seq_cand

    def close_candidate(self, found, lock=None) -> bool:
        """Verify and apply the candidate :meth:`query_keyframe` returned.
        Returns True if a loop was closed.

        ``lock``: when given (the async worker's map lock), only the
        closure APPLICATION holds it — the expensive verification cascade
        (knn, epipolar/P3P RANSAC, local-map PnP) runs lock-free so the
        arrival thread keeps tracking through it. The reference runs its
        LoopCloser on a dedicated thread for the same reason
        (`ov2slam.cpp:116-140`). Slot identity is guarded by kf_seq
        snapshots re-checked under the lock before applying, the same
        stale-slot pattern the BA write-back uses.
        """
        kfid, cand, seq_kf, seq_cand = found
        self.prof.start("4.LC_ProcessCandidate")
        ok = self._process_candidate(kfid, cand, lock=lock,
                                     seq_guard=(seq_kf, seq_cand))
        self.prof.stop("4.LC_ProcessCandidate")
        if ok:
            self.n_closures += 1
            self._last_closure_seq = seq_kf
            self.estimator.lc_kf_id = cand
            # also shield it from capacity eviction (`store.add_keyframe`)
            self.map.protected_kf_slots = {cand}
        return ok

    # ------------------------------------------------------------------ #

    def _process_candidate(self, kfid: int, cand: int, lock=None,
                           seq_guard=None) -> bool:
        cfg = self.cfg
        m = self.map

        # acceptance gates scaled to the keypoint budget: the reference's
        # absolute 15/10/5/30 counts (`loop_closer.cpp:217,227,251,288`)
        # assume its ~300-kp budget; at the fast profile's ~160 cells a
        # true revisit yields proportionally fewer matches
        gy, gx = cfg.grid_cells
        budget = gy * gx
        knn_gate = max(8, int(round(budget * 15 / 300)))
        epi_gate = max(6, int(round(budget * 10 / 300)))
        p3p_gate = max(4, int(round(budget * 5 / 300)))

        cur_valid = m.obs_lmid[kfid] >= 0
        cand_valid = m.obs_lmid[cand] >= 0

        # 1) 2-NN knn matching with ratio 0.85 + <=50% bit distance
        idx, dist = knn_match_2nn(
            self._dev(m.obs_desc[kfid].view(np.int32)),
            self._dev(cur_valid),
            self._dev(m.obs_desc[cand].view(np.int32)),
            self._dev(cand_valid), max_dist_bits=128, ratio=0.85)
        idx = idx.cpu().numpy()
        matched = np.nonzero(idx >= 0)[0]
        if len(matched) < knn_gate:
            return False

        cur_px = m.obs_px[kfid][matched]
        cand_px = m.obs_px[cand][idx[matched]]

        # 2) epipolar filter (10x RANSAC iters, `loop_closer.cpp:484`)
        fx, fy, cx, cy = self.cam.intrinsics_f
        n = len(matched)
        cap = ((n + 127) // 128) * 128
        xl = np.zeros((cap, 2), np.float32)
        xr = np.zeros((cap, 2), np.float32)
        vm = np.zeros(cap, bool)
        xl[:n] = (cand_px - (cx, cy)) / (fx, fy)
        xr[:n] = (cur_px - (cx, cy)) / (fx, fy)
        vm[:n] = True
        _, epi_inl, n_epi = essential_ransac(
            self._gen, self._dev(xl), self._dev(xr), self._dev(vm),
            focal=fx, err_th_px=cfg.ransac_err,
            n_iters=min(1000, 10 * cfg.ransac_iter))
        if int(n_epi) < epi_gate:
            return False
        epi_inl = epi_inl.cpu().numpy()[:n]
        matched = matched[epi_inl]

        # 3) P3P on candidate's 3D landmarks seen from the current KF
        lm_cand = m.obs_lmid[cand][idx[matched]]
        is3d = m.lm_valid[lm_cand] & m.lm_is3d[lm_cand]
        rows3d = matched[is3d]
        lms3d = lm_cand[is3d]
        if len(rows3d) < p3p_gate:
            return False
        N = cfg.max_kps
        pts = np.zeros((N, 3), np.float32)
        px = np.zeros((N, 2), np.float32)
        vmask = np.zeros(N, bool)
        k3 = len(rows3d)
        pts[:k3] = m.lm_pos[lms3d]
        px[:k3] = m.obs_px[kfid][rows3d]
        vmask[:k3] = True
        px_d = self._dev(px)
        T_p3p, p3p_inl, n_p3p = p3p_ransac(
            self._gen, self.cam.bearing(px_d), self._dev(pts),
            px_d, self._dev(vmask), fx, fy, cx, cy,
            err_th=cfg.ransac_err, n_iters=cfg.ransac_iter)
        if int(n_p3p) < p3p_gate:
            return False

        # 4) loop-local-map projection matching + PnP refinement.
        # The reference's >=30-inlier gate (`loop_closer.cpp:288`) is 10%
        # of its ~300-kp budget. A pure budget-scaled absolute count is
        # NOT safe at low budgets: a false/inaccurate pose can scrape
        # together ~10 wide-radius matches out of 70 in-view landmarks,
        # and an accepted bad closure merges wrong landmarks and poisons
        # every later closure's local map. Gate on the FRACTION of the
        # in-view local map the pose explains (floor 12, capped at 60 so
        # dense maps aren't asked for hundreds of matches).
        T_loop, n_inliers, extra, n_in_view = self._track_loop_local_map(
            kfid, cand, T_p3p.cpu().numpy())
        pnp_gate = max(12, min(60, int(round(0.3 * n_in_view))))
        if n_inliers < pnp_gate:
            return False

        # 5) pose-graph correction + landmark propagation + merges —
        # the only mutating step; under the worker lock when given, with
        # slot-identity re-validation (the lock-free cascade above may
        # have raced a capacity eviction recycling either KF slot)
        import contextlib

        hold = (lambda: lock) if lock is not None else contextlib.nullcontext
        with hold():
            if seq_guard is not None:
                if (not m.kf_valid[kfid] or not m.kf_valid[cand]
                        or int(m.kf_seq[kfid]) != seq_guard[0]
                        or int(m.kf_seq[cand]) != seq_guard[1]):
                    return False   # slot recycled mid-verification
            self._apply_closure(kfid, cand, T_loop,
                                list(zip(rows3d, lms3d)) + extra)
        return True

    # ------------------------------------------------------------------ #

    def _track_loop_local_map(self, kfid: int, cand: int, T_init):
        """Project the candidate's local map into the P3P pose and match
        descriptors, then PnP (`trackLoopLocalMap`,
        `loop_closer.cpp:502-763`). Returns (T_refined, n_inliers,
        extra_matches [(cur_slot, lmid)], n_in_view)."""
        cfg = self.cfg
        m = self.map
        # local map: 3D landmarks of the candidate and its covisible KFs.
        # Covisible neighbors are restricted to the candidate's temporal
        # era: after a previous closure's merges, covisibility links the
        # loop KF to revisit-era KFs whose landmarks carry the very drift
        # being corrected — mixing them in biases the PnP toward the
        # drifted solution. (Pre-merge, the reference's covisibility graph
        # has the same old-era-only structure implicitly.)
        seq_cand = int(m.kf_seq[cand])
        era = max(10, 2 * self.index.recent_mask)
        local = set(int(l) for l in m.kf_landmark_ids(cand, only_3d=True))
        for k in m.covisible_kfs(cand, min_score=1, max_n=24):
            if abs(int(m.kf_seq[int(k)]) - seq_cand) <= era:
                local |= set(int(l) for l in m.kf_landmark_ids(
                    int(k), only_3d=True))
        local = np.asarray(sorted(local), np.int32)
        if len(local) == 0:
            return T_init, 0, [], 0

        fx, fy, cx, cy = self.cam.intrinsics_f
        gy, gx = cfg.grid_cells
        pair_gate = max(6, int(round(gy * gx * 10 / 300)))

        # match targets = tracked kps ++ the extra FAST/BRIEF detections
        # from the place query: at low kp budgets a projected landmark
        # often has NO tracked kp nearby, but the dense extra detections
        # still witness it. Extra rows verify the pose (PnP inliers) but
        # never merge into the map (they own no landmark slot).
        N0 = cfg.max_kps
        all_px = m.obs_px[kfid]
        all_valid = m.obs_lmid[kfid] >= 0
        all_desc = m.obs_desc[kfid]
        if self._extra is not None:
            xp, xd, xv = self._extra
            all_px = np.concatenate([all_px, xp], axis=0)
            all_valid = np.concatenate([all_valid, xv], axis=0)
            all_desc = np.concatenate([all_desc, xd], axis=0)

        def match_round(T, radius):
            """Project the local map at pose T and claim current-KF kps
            within ``radius`` px with agreeing descriptors."""
            T_cw = lie_np.pose_inverse(T.astype(np.float64))
            pc = lie_np.pose_apply(T_cw, m.lm_pos[local].astype(np.float64))
            z = pc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                proj = np.stack([pc[:, 0] / z * fx + cx,
                                 pc[:, 1] / z * fy + cy], -1)
            inb = ((z > 0.1) & (proj[:, 0] >= 0)
                   & (proj[:, 0] < self.cam.width)
                   & (proj[:, 1] >= 0) & (proj[:, 1] < self.cam.height))
            loc, prj = local[inb], proj[inb]
            n_in_view[0] = max(n_in_view[0], len(loc))
            if len(loc) == 0:
                return []
            L = len(loc)
            capL = ((L + 127) // 128) * 128
            proj_p = np.zeros((capL, 2), np.float32)
            pv = np.zeros(capL, bool)
            pdesc = np.zeros((capL, 8), np.uint32)
            proj_p[:L] = prj
            pv[:L] = True
            pdesc[:L] = m.lm_desc[loc]
            pdesc = pdesc.view(np.int32)
            # LC-specific descriptor gate: across a revisit the same
            # landmark's descriptor drifts far more than across adjacent
            # frames (independent sensor noise + subpixel re-detection
            # offsets — measured ~80/256 bits on synthetic revisits), so
            # the tracking-time fmax_desc_dist gate starves the match.
            # The reference's LC matching also relaxes to <=50% bit
            # distance (`loop_closer.cpp:426-448`); geometric outliers
            # are killed by the staged radius + robust PnP.
            idx, _ = projection_match(
                self._dev(proj_p), self._dev(pv), self._dev(pdesc),
                self._dev(all_px.astype(np.float32)), self._dev(all_valid),
                self._dev(all_desc.view(np.int32)),
                max_px_dist=radius,
                max_dist_bits=128)
            idx = idx.cpu().numpy()[:L]
            return [(int(idx[i]), int(loc[i])) for i in range(L)
                    if idx[i] >= 0]

        def pnp(T, pairs):
            N = all_px.shape[0]
            pts = np.zeros((N, 3), np.float32)
            px = np.zeros((N, 2), np.float32)
            vmask = np.zeros(N, bool)
            k = len(pairs)
            pts[:k] = m.lm_pos[[p[1] for p in pairs]]
            px[:k] = all_px[[p[0] for p in pairs]]
            vmask[:k] = True
            T_ref, inlier, _ = pnp_refine(
                self._dev(T.astype(np.float32)), self._dev(pts),
                self._dev(px), self._dev(vmask), fx, fy, cx, cy,
                robust_th=cfg.robust_mono_th, iters=10)
            inlier = inlier.cpu().numpy()[:k]
            return (T_ref.cpu().numpy().astype(np.float64),
                    [pairs[i] for i in np.nonzero(inlier)[0]])

        # staged coarse -> fine match/refine rounds (the reference's
        # trackLoopLocalMap staged matching, `loop_closer.cpp:502-763`).
        # The P3P init is often translation-degenerate: knn matches favor
        # distant (viewpoint-robust) landmarks, which constrain rotation
        # but leave metres of translation slack — so projections of NEAR
        # landmarks can be 40+ px off at the init. Round 1 therefore
        # matches wide; each robust PnP then pulls translation in using
        # the near points the wider radius captured, and later rounds
        # tighten the radius around the improving pose.
        n_in_view = [0]
        radii = (max(40.0, 8 * cfg.max_proj_pxdist),
                 max(16.0, 3 * cfg.max_proj_pxdist),
                 max(8.0, 1.5 * cfg.max_proj_pxdist))
        T_ref, good = T_init, []
        for r, radius in enumerate(radii):
            pairs = match_round(T_ref, radius)
            if len(pairs) < pair_gate:
                if r == 0:
                    return T_init, 0, [], n_in_view[0]
                break
            T_new, good_new = pnp(T_ref, pairs)
            if len(good_new) < max(len(good) // 2, pair_gate // 2):
                break    # diverging: keep the previous round's result
            T_ref, good = T_new, good_new
        if not good:
            return T_init, 0, [], n_in_view[0]
        # only tracked-kp matches (slot < max_kps) may merge landmarks
        mergeable = [p for p in good if p[0] < N0]
        return T_ref, len(good), mergeable, n_in_view[0]

    # ------------------------------------------------------------------ #

    def _apply_closure(self, kfid: int, cand: int, T_loop, matches):
        """Local pose graph from the loop KF to the new KF + correction
        propagation + landmark merges (`processLoopCandidate` acceptance
        branch, `loop_closer.cpp:300-376`)."""
        m = self.map
        # KFs created between the loop KF and the new KF, oldest first
        # (by insertion seq — slot ids are recycled)
        s_lo, s_hi = int(m.kf_seq[cand]), int(m.kf_seq[kfid])
        window = [int(k) for k in m.kfs_by_seq()
                  if s_lo <= m.kf_seq[k] <= s_hi]
        if len(window) < 2:
            return
        old_poses = m.kf_poses[window].astype(np.float64)

        # chain edges measured at current estimates; loop edge constrains
        # the NEW keyframe to its loop-verified pose in the world of the
        # loop KF: edge (cand_idx -> new_idx) with T_meas from T_loop
        i_cand = window.index(cand)
        i_new = window.index(kfid)
        T_loop_rel = lie_np.pose_relative(old_poses[i_cand], T_loop)
        ei, ej, eT, ew = build_chain_edges(
            old_poses, window, loop_i=i_cand, loop_j=i_new,
            T_loop=T_loop_rel, loop_weight=20.0)
        fixed = np.zeros(len(window), bool)
        fixed[i_cand] = True   # gauge = loop KF (`optimizer.cpp:2387`)

        # bucketed problem shape, as the JAX package pads it (there, to
        # avoid recompiles): padding rows are identity poses pinned by
        # fixed=True; padded edges carry weight 0 and index -1 — both
        # no-ops inside pose_graph_solve. Kept for parity with the JAX
        # solve, whose damping sees the same system.
        M = len(window)
        M_pad = max(16, 1 << int(np.ceil(np.log2(M))))
        E = len(ei)
        E_pad = M_pad + 8
        poses_p = np.zeros((M_pad, 7), np.float32)
        poses_p[:, 0] = 1.0
        poses_p[:M] = old_poses.astype(np.float32)
        fixed_p = np.ones(M_pad, bool)
        fixed_p[:M] = fixed
        ei_p = np.full(E_pad, -1, np.int32); ei_p[:E] = ei
        ej_p = np.full(E_pad, -1, np.int32); ej_p[:E] = ej
        eT_p = np.zeros((E_pad, 7), np.float32)
        eT_p[:, 0] = 1.0
        eT_p[:E] = eT
        ew_p = np.zeros(E_pad, np.float32); ew_p[:E] = ew

        new_poses, _ = pose_graph_solve(
            self._dev(poses_p), self._dev(fixed_p),
            self._dev(ei_p), self._dev(ej_p), self._dev(eT_p),
            self._dev(ew_p), iters=self.cfg.posegraph_iters)
        new_poses = new_poses.cpu().numpy().astype(np.float64)[:M]

        # propagate: landmarks anchored in window KFs move with their
        # anchor's correction (`optimizer.cpp:2528-2585`)
        corr = {w: lie_np.pose_compose(new_poses[i],
                                       lie_np.pose_inverse(old_poses[i]))
                for i, w in enumerate(window)}
        anchors = m.lm_anchor_kf
        live = np.nonzero(m.lm_valid & m.lm_is3d)[0]
        for w, T_c in corr.items():
            sel = live[anchors[live] == w]
            if len(sel):
                m.lm_pos[sel] = lie_np.pose_apply(
                    T_c, m.lm_pos[sel].astype(np.float64)).astype(np.float32)
        for i, w in enumerate(window):
            m.kf_poses[w] = new_poses[i].astype(np.float32)

        # merge duplicate landmarks (cur KF slot ↔ loop landmark)
        for slot, lmid in matches:
            cur_lm = int(m.obs_lmid[kfid, slot])
            if cur_lm >= 0 and cur_lm != int(lmid) and m.lm_valid[cur_lm]:
                m.merge_landmarks(int(lmid), cur_lm)

        # structure-only refinement of the corrected region, then a loose
        # BA over the loop range if the pose correction was large
        # (`loop_closer.cpp:353-371`)
        from ..solvers.ba_variants import loose_ba, structure_only_ba

        structure_only_ba(m, window[-min(8, len(window)):],
                          self.estimator.params, self.cfg)
        pose_shift = float(np.linalg.norm(
            new_poses[i_new][4:7] - old_poses[i_new][4:7]))
        if pose_shift >= 0.02:
            loose_ba(m, cand, kfid, self.estimator.params, self.cfg)
