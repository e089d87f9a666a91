"""Fixed-capacity SoA map state — the TPU-native replacement for the
reference's pointer-graph map (`Frame`/`MapPoint`/`MapManager`,
`src/{frame,map_point,map_manager}.cpp`).

Architecture: the map is structure-of-arrays with validity masks instead of
mutex-guarded hash maps. *Bookkeeping* (keyframe insertion, observation
add/remove, landmark merge, covisibility counting — all pointer-chasing,
kHz-rate, tiny) runs on the host in vectorized numpy; *numerics* (BA,
matching, triangulation — the FLOPs) read padded, device-ready problem
arrays built here. This split replaces the reference's five map mutexes
(`map_manager.hpp:125-128`): stages exchange immutable array snapshots, so
the front-end never blocks on BA.

Capacities are static (from `SlamConfig`), so every downstream jit sees
stable shapes: no recompilation as the map grows. Removed keyframe and
landmark slots are recycled through free-lists (the reference's removals
are first-class, `map_manager.cpp:885-1095`; here allocation pops freed
slots before advancing the fresh cursor), so long sequences with culling
enabled run indefinitely inside fixed capacities. Because slot ids are
therefore NOT temporally ordered, every keyframe carries a monotone
``kf_seq`` sequence number — the stable identity used for age ordering
(gauge fixing, recency windows, loop-closure ranges) and for detecting
stale references to a recycled slot.

Reference parity notes:
- observation tables mirror `Frame::mapkps_` (`frame.hpp:202`),
- the per-landmark observer list mirrors `MapPoint::set_kfids_`
  (`map_point.hpp:80`),
- covisibility scores mirror `Frame::map_covkfs_` (`frame.hpp:229`),
  computed by bincount over observer lists instead of per-insert updates
  (`map_manager.cpp:117-193` updateFrameCovisibility),
- landmark merge mirrors `MapManager::mergeMapPoints`
  (`map_manager.cpp:801-882`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.config import SlamConfig

MAX_OBS_PER_LM = 96  # observer-list capacity; reference is unbounded but
                     # local BA only consumes covisibility-windowed KFs


@dataclasses.dataclass
class BAProblem:
    """Padded, device-ready bundle-adjustment problem arrays."""

    kf_ids: np.ndarray          # (Kw,) int32 (-1 pad)
    kf_poses: np.ndarray        # (Kw, 7) f32 T_wc
    kf_fixed: np.ndarray        # (Kw,) bool — gauge-fixed poses
    lm_ids: np.ndarray          # (Lw,) int32 (-1 pad)
    lm_pos: np.ndarray          # (Lw, 3) f32
    obs_kf: np.ndarray          # (O,) int32 index into kf_ids (-1 pad)
    obs_lm: np.ndarray          # (O,) int32 index into lm_ids
    obs_px: np.ndarray          # (O, 2) f32 undistorted pixels
    obs_cam: np.ndarray         # (O,) int8: 0 = left cam, 1 = right cam
    obs_valid: np.ndarray       # (O,) bool
    # anchored inverse-depth support (`buse_inv_depth`): per-landmark
    # anchor KF (window index) + the measured left-cam undistorted pixel
    # in the anchor KF (`optimizer.cpp:207-290`, `map_point.hpp:85-86`)
    lm_anchor: np.ndarray = None       # (Lw,) int32 window idx (-1 pad)
    lm_anchor_px: np.ndarray = None    # (Lw, 2) f32
    # identity snapshots taken at build time: a solve may run outside the
    # map lock while slots are freed AND recycled (capacity eviction on
    # the front-end thread); write-back must skip any slot whose identity
    # changed, or a recycled slot's brand-new keyframe/landmark would be
    # overwritten with the evicted one's optimized state
    kf_seq_snap: np.ndarray = None     # (Kw,) int64 kf_seq at build (-1 pad)
    lm_gen_snap: np.ndarray = None     # (Lw,) int64 lm_gen at build

    @property
    def n_obs(self) -> int:
        return int(self.obs_valid.sum())


class MapStore:
    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        K = cfg.max_keyframes
        L = cfg.max_landmarks
        N = cfg.max_kps

        self.K, self.L, self.N = K, L, N

        # keyframes
        self.kf_valid = np.zeros(K, bool)
        self.kf_times = np.zeros(K, np.float64)
        self.kf_poses = np.zeros((K, 7), np.float32)
        self.kf_poses[:, 0] = 1.0
        # monotone insertion sequence number (-1 = never used / removed):
        # the temporal identity of a keyframe, robust to slot recycling
        self.kf_seq = np.full(K, -1, np.int64)

        # per-KF observations
        self.obs_lmid = np.full((K, N), -1, np.int32)
        self.obs_px = np.zeros((K, N, 2), np.float32)       # undistorted
        self.obs_rpx = np.zeros((K, N, 2), np.float32)      # right-cam px
        self.obs_is_stereo = np.zeros((K, N), bool)
        self.obs_desc = np.zeros((K, N, 8), np.uint32)

        # landmarks
        self.lm_valid = np.zeros(L, bool)
        # allocation generation per slot — bumped each time the slot is
        # (re)allocated, so snapshots can detect recycled slots
        self.lm_gen = np.zeros(L, np.int64)
        self.lm_is3d = np.zeros(L, bool)
        self.lm_pos = np.zeros((L, 3), np.float32)
        self.lm_desc = np.zeros((L, 8), np.uint32)
        self.lm_anchor_kf = np.full(L, -1, np.int32)
        # observer lists: kf ids observing each landmark (-1 empty)
        self.lm_obs_kf = np.full((L, MAX_OBS_PER_LM), -1, np.int32)
        # slot of the observation within the KF's obs table
        self.lm_obs_slot = np.full((L, MAX_OBS_PER_LM), -1, np.int32)

        self._next_kf = 0
        self._next_lm = 0
        self._kf_seq_counter = 0
        # freed slots available for reuse (LIFO)
        self._free_kf: List[int] = []
        self.n_evictions = 0
        self._free_lm: List[int] = []
        # keyframe slots capacity eviction must never pick (the
        # loop-closure-held KF, `estimator.cpp:129-131`); the origin
        # (kf_seq == 0) is skipped implicitly
        self.protected_kf_slots: set = set()

    # ----------------------------------------------------------------- #
    # landmarks
    # ----------------------------------------------------------------- #

    @property
    def free_landmark_capacity(self) -> int:
        return (self.L - self._next_lm) + len(self._free_lm)

    @property
    def free_keyframe_capacity(self) -> int:
        return (self.K - self._next_kf) + len(self._free_kf)

    def new_landmarks(self, n: int) -> np.ndarray:
        """Allocate n fresh (2D, untriangulated) landmark ids, reusing
        freed slots before advancing the fresh cursor. Callers should
        clamp n to ``free_landmark_capacity`` for graceful degradation."""
        n_reuse = min(n, len(self._free_lm))
        n_fresh = n - n_reuse
        if self._next_lm + n_fresh > self.L:
            raise RuntimeError(
                f"landmark capacity exceeded ({n} requested, "
                f"{self.free_landmark_capacity} free of {self.L})")
        reused = [self._free_lm.pop() for _ in range(n_reuse)]
        ids = np.concatenate([
            np.asarray(reused, np.int32),
            np.arange(self._next_lm, self._next_lm + n_fresh,
                      dtype=np.int32)])
        self._next_lm += n_fresh
        self.lm_gen[ids] += 1
        self.lm_valid[ids] = True
        self.lm_is3d[ids] = False
        # recycled slots must not leak prior state
        self.lm_pos[ids] = 0.0
        self.lm_desc[ids] = 0
        self.lm_anchor_kf[ids] = -1
        self.lm_obs_kf[ids] = -1
        self.lm_obs_slot[ids] = -1
        return ids

    def set_landmark_positions(self, ids: np.ndarray, pos: np.ndarray):
        """Triangulation write-back: promote to 3D
        (`MapManager::updateMapPoint`, `map_manager.cpp:715-766`)."""
        ids = np.asarray(ids, np.int32)
        live = self.lm_valid[ids]
        self.lm_pos[ids[live]] = pos[live]
        self.lm_is3d[ids[live]] = True

    def remove_landmark(self, lmid: int):
        """Full removal incl. all observations
        (`MapManager::removeMapPoint`, `map_manager.cpp:947-1009`)."""
        if not self.lm_valid[lmid]:
            return
        for k, slot in zip(self.lm_obs_kf[lmid], self.lm_obs_slot[lmid]):
            if k >= 0 and self.kf_valid[k] and self.obs_lmid[k, slot] == lmid:
                self.obs_lmid[k, slot] = -1
        self.lm_valid[lmid] = False
        self.lm_is3d[lmid] = False
        self.lm_anchor_kf[lmid] = -1
        self.lm_obs_kf[lmid] = -1
        self.lm_obs_slot[lmid] = -1
        self._free_lm.append(int(lmid))

    def _lm_add_observer(self, lmid: int, kfid: int, slot: int) -> bool:
        row = self.lm_obs_kf[lmid]
        free = np.nonzero(row < 0)[0]
        if len(free) == 0:
            return False
        self.lm_obs_kf[lmid, free[0]] = kfid
        self.lm_obs_slot[lmid, free[0]] = slot
        return True

    def _lm_remove_observer(self, lmid: int, kfid: int):
        sel = self.lm_obs_kf[lmid] == kfid
        self.lm_obs_kf[lmid, sel] = -1
        self.lm_obs_slot[lmid, sel] = -1

    def landmark_observers(self, lmid: int) -> np.ndarray:
        obs = self.lm_obs_kf[lmid]
        return obs[obs >= 0]

    def merge_landmarks(self, keep: int, drop: int):
        """Loop-closure landmark fusion (`mergeMapPoints`,
        `map_manager.cpp:801-882`): every observation of ``drop`` is
        rewritten to ``keep`` (unless that KF already observes ``keep``),
        then ``drop`` is removed."""
        if not (self.lm_valid[keep] and self.lm_valid[drop]):
            return
        for k, slot in zip(self.lm_obs_kf[drop].copy(),
                           self.lm_obs_slot[drop].copy()):
            if k < 0 or not self.kf_valid[k]:
                continue
            if self.obs_lmid[k, slot] != drop:
                continue
            already = (self.lm_obs_kf[keep] == k).any()
            if already:
                self.obs_lmid[k, slot] = -1
            else:
                self.obs_lmid[k, slot] = keep
                self._lm_add_observer(keep, k, slot)
        self.lm_valid[drop] = False
        self.lm_is3d[drop] = False
        self.lm_anchor_kf[drop] = -1
        self.lm_obs_kf[drop] = -1
        self.lm_obs_slot[drop] = -1
        self._free_lm.append(int(drop))

    # ----------------------------------------------------------------- #
    # keyframes
    # ----------------------------------------------------------------- #

    def add_keyframe(
        self,
        time: float,
        T_wc: np.ndarray,
        lmids: np.ndarray,        # (N,) int32, -1 for empty slots
        px_und: np.ndarray,       # (N, 2) undistorted pixels
        desc: np.ndarray,         # (N, 8) uint32
        is_stereo: Optional[np.ndarray] = None,
        rpx: Optional[np.ndarray] = None,
    ) -> int:
        """Insert a keyframe with its observation table
        (`MapManager::addKeyframe`, `map_manager.cpp:621-633`), reusing a
        freed slot when available."""
        if self._free_kf:
            kfid = self._free_kf.pop()
        elif self._next_kf < self.K:
            kfid = self._next_kf
            self._next_kf += 1
        else:
            # graceful degradation at capacity: evict the OLDEST keyframe
            # (a bounded sliding map, like a ring buffer) instead of
            # aborting a long run. Culling normally frees slots first
            # (`Estimator::mapFiltering`); eviction is the backstop when a
            # trajectory produces more non-redundant views than capacity.
            # Loop-closure entries detect the recycled slot via kf_seq.
            # Never evict the origin (the map's gauge anchor, which
            # mapFiltering also refuses to cull) or an LC-protected KF;
            # take the next-oldest instead.
            oldest = self.kfs_by_seq()
            if len(oldest) == 0:
                raise RuntimeError(
                    f"keyframe capacity exceeded (0 free of {self.K})")
            victim = next(
                (int(k) for k in oldest
                 if self.kf_seq[k] != 0
                 and int(k) not in self.protected_kf_slots),
                int(oldest[0]))
            self.remove_keyframe(victim)
            self.n_evictions += 1
            kfid = self._free_kf.pop()
        self.kf_seq[kfid] = self._kf_seq_counter
        self._kf_seq_counter += 1

        lmids = np.asarray(lmids, np.int32)
        self.kf_valid[kfid] = True
        self.kf_times[kfid] = time
        self.kf_poses[kfid] = np.asarray(T_wc, np.float32)
        self.obs_lmid[kfid] = lmids
        self.obs_px[kfid] = px_und
        self.obs_desc[kfid] = desc
        if is_stereo is not None:
            self.obs_is_stereo[kfid] = is_stereo
            self.obs_rpx[kfid] = rpx if rpx is not None else 0.0
        else:
            self.obs_is_stereo[kfid] = False
            self.obs_rpx[kfid] = 0.0

        from .. import native

        if native.AVAILABLE:
            native.add_keyframe_obs(
                kfid, self.obs_lmid[kfid], self.lm_valid,
                self.lm_obs_kf, self.lm_obs_slot, self.lm_anchor_kf)
        else:
            for slot in np.nonzero(lmids >= 0)[0]:
                lmid = lmids[slot]
                if not self.lm_valid[lmid]:
                    self.obs_lmid[kfid, slot] = -1
                    continue
                if not self._lm_add_observer(lmid, kfid, slot):
                    self.obs_lmid[kfid, slot] = -1  # observer list full
                    continue
                if self.lm_anchor_kf[lmid] < 0:
                    self.lm_anchor_kf[lmid] = kfid
        sel = self.obs_lmid[kfid] >= 0
        self.lm_desc[self.obs_lmid[kfid][sel]] = desc[sel]
        return kfid

    def remove_keyframe(self, kfid: int):
        """KF culling (`MapManager::removeKeyframe`,
        `map_manager.cpp:885-945`). The freed slot is recycled; landmarks
        anchored here are re-anchored to their earliest remaining observer
        (the reference re-anchors on anchor loss, `map_manager.cpp:898-918`)."""
        if not self.kf_valid[kfid]:
            return
        obs_lms = self.obs_lmid[kfid][self.obs_lmid[kfid] >= 0]
        for lmid in obs_lms:
            self._lm_remove_observer(int(lmid), kfid)
        anchored = np.unique(obs_lms[self.lm_anchor_kf[obs_lms] == kfid])
        for l in anchored:
            obs = self.lm_obs_kf[l]
            obs = obs[obs >= 0]
            self.lm_anchor_kf[l] = (
                int(obs[np.argmin(self.kf_seq[obs])]) if len(obs) else -1)
        # landmarks left with zero observers are unreachable — free them
        # (the reference erases observation-less MapPoints on KF removal)
        for l in np.unique(obs_lms):
            if self.lm_valid[l] and (self.lm_obs_kf[l] < 0).all():
                self.remove_landmark(int(l))
        self.obs_lmid[kfid] = -1
        self.kf_valid[kfid] = False
        self.kf_seq[kfid] = -1
        self._free_kf.append(int(kfid))

    def kfs_by_seq(self) -> np.ndarray:
        """All valid keyframe slot ids, oldest first (by insertion seq)."""
        ids = np.nonzero(self.kf_valid)[0]
        return ids[np.argsort(self.kf_seq[ids], kind="stable")].astype(
            np.int32)

    def remove_observation(self, kfid: int, lmid: int):
        """(`MapManager::removeMapPointObs`, `map_manager.cpp:1012-1052`)."""
        sel = (self.lm_obs_kf[lmid] == kfid)
        for i in np.nonzero(sel)[0]:
            slot = self.lm_obs_slot[lmid, i]
            if self.obs_lmid[kfid, slot] == lmid:
                self.obs_lmid[kfid, slot] = -1
        self.lm_obs_kf[lmid, sel] = -1
        self.lm_obs_slot[lmid, sel] = -1

    def kf_landmark_ids(self, kfid: int, only_3d: bool = False) -> np.ndarray:
        ids = self.obs_lmid[kfid]
        ids = ids[ids >= 0]
        ids = ids[self.lm_valid[ids]]
        if only_3d:
            ids = ids[self.lm_is3d[ids]]
        return ids

    @property
    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    @property
    def n_landmarks_3d(self) -> int:
        return int((self.lm_valid & self.lm_is3d).sum())

    # ----------------------------------------------------------------- #
    # covisibility
    # ----------------------------------------------------------------- #

    def covisibility_counts(self, kfid: int) -> np.ndarray:
        """(K,) number of 3D landmarks shared with ``kfid``
        (score map of `updateFrameCovisibility`, `map_manager.cpp:117-193`)."""
        from .. import native

        if native.AVAILABLE:
            return native.covisibility_counts(
                kfid, self.obs_lmid, self.lm_valid & self.lm_is3d,
                self.lm_obs_kf, self.kf_valid)
        lmids = self.kf_landmark_ids(kfid, only_3d=True)
        if len(lmids) == 0:
            return np.zeros(self.K, np.int32)
        observers = self.lm_obs_kf[lmids].ravel()
        observers = observers[observers >= 0]
        counts = np.bincount(observers, minlength=self.K).astype(np.int32)
        counts[kfid] = 0
        counts[~self.kf_valid] = 0
        return counts

    def covisible_kfs(self, kfid: int, min_score: int = 1,
                      max_n: Optional[int] = None) -> np.ndarray:
        counts = self.covisibility_counts(kfid)
        ids = np.nonzero(counts >= min_score)[0]
        order = np.argsort(-counts[ids], kind="stable")
        ids = ids[order]
        if max_n is not None:
            ids = ids[:max_n]
        return ids.astype(np.int32)

    # ----------------------------------------------------------------- #
    # BA problem building
    # ----------------------------------------------------------------- #

    def build_ba_problem(
        self,
        window_kf_ids: Sequence[int],
        fixed_kf_ids: Sequence[int],
        max_kfs: int,
        max_obs: int,
        min_obs_per_lm: int = 2,
    ) -> BAProblem:
        """Collect the observations of a keyframe window into padded arrays
        (the array-program analogue of localBA's problem construction,
        `optimizer.cpp:74-407`).

        Fixed KFs contribute observations but their poses are gauge-locked.
        Only 3D landmarks observed >= min_obs_per_lm times inside the
        window enter the problem; others are ignored (the reference adds
        them as const or skips, `optimizer.cpp:207-290`).
        """
        window = [k for k in window_kf_ids if self.kf_valid[k]][:max_kfs]
        kf_ids = np.full(max_kfs, -1, np.int32)
        kf_ids[: len(window)] = window
        kf_index = {k: i for i, k in enumerate(window)}
        fixed = np.zeros(max_kfs, bool)
        for k in fixed_kf_ids:
            if k in kf_index:
                fixed[kf_index[k]] = True

        # landmarks observed in the window (native pointer-chasing when
        # libmapcore is built; numpy/python fallback otherwise)
        from .. import native

        win_arr = np.asarray(window, np.int32)
        is3d_valid = self.lm_valid & self.lm_is3d
        if native.AVAILABLE and len(window):
            counts = native.count_window_lms(
                win_arr, self.obs_lmid, is3d_valid)
        else:
            counts = np.zeros(self.L, np.int32)
            for k in window:
                ids = self.obs_lmid[k]
                ids = ids[ids >= 0]
                ids = ids[is3d_valid[ids]]
                np.add.at(counts, ids, 1)
        lm_sel = np.nonzero(counts >= min_obs_per_lm)[0]
        lm_index = np.full(self.L, -1, np.int32)
        lm_index[lm_sel] = np.arange(len(lm_sel), dtype=np.int32)

        O = max_obs
        if native.AVAILABLE and len(window):
            _, obs_kf, obs_lm, obs_px, obs_cam = native.build_ba_obs(
                win_arr, self.obs_lmid, self.obs_px, self.obs_rpx,
                self.obs_is_stereo, lm_index, max_obs)
        else:
            obs_kf = np.full(O, -1, np.int32)
            obs_lm = np.full(O, -1, np.int32)
            obs_px = np.zeros((O, 2), np.float32)
            obs_cam = np.zeros(O, np.int8)
            n = 0
            for k in window:
                ki = kf_index[k]
                for slot in np.nonzero(self.obs_lmid[k] >= 0)[0]:
                    lmid = int(self.obs_lmid[k, slot])
                    li = lm_index[lmid]
                    if li < 0 or n >= max_obs:
                        continue
                    obs_kf[n] = ki
                    obs_lm[n] = li
                    obs_px[n] = self.obs_px[k, slot]
                    obs_cam[n] = 0
                    n += 1
                    if self.obs_is_stereo[k, slot] and n < max_obs:
                        # stereo measurement = an extra residual row in the
                        # right camera (RightCamKSE3XYZ factors,
                        # `se3left_parametrization.hpp:138-170`)
                        obs_kf[n] = ki
                        obs_lm[n] = li
                        obs_px[n] = self.obs_rpx[k, slot]
                        obs_cam[n] = 1
                        n += 1

        Lw = len(lm_sel)
        # BUCKETED padding: the landmark count is the only dynamic shape
        # in the BA problem; left unpadded, every distinct Lw compiles a
        # fresh XLA program (~3-8 s each) — with 256-buckets the solver
        # signature set collapses to a handful, compiled once per run
        Lcap = max(256, ((Lw + 255) // 256) * 256)
        lm_ids = np.full(Lcap, -1, np.int32)
        lm_pos = np.zeros((Lcap, 3), np.float32)
        lm_anchor = np.full(Lcap, -1, np.int32)
        lm_anchor_px = np.zeros((Lcap, 2), np.float32)
        if Lw:
            lm_ids[:Lw] = lm_sel
            lm_pos[:Lw] = self.lm_pos[lm_sel]

            # anchor selection for inverse-depth BA: the landmark's stored
            # anchor KF when it is inside the window, else its first
            # in-window observer (the reference re-anchors on anchor loss,
            # `map_manager.cpp:715-766` / `map_point.hpp:85-86`)
            win_index = np.full(self.K, -1, np.int32)
            win_index[win_arr] = np.arange(len(window), dtype=np.int32)
            okf = self.lm_obs_kf[lm_sel]                      # (Lw, M)
            oslot = self.lm_obs_slot[lm_sel]
            wi = np.where(okf >= 0, win_index[np.maximum(okf, 0)], -1)
            valid_o = wi >= 0
            is_anch = valid_o & (okf == self.lm_anchor_kf[lm_sel][:, None])
            # fallback anchor = earliest (min-seq) in-window observer;
            # column order of lm_obs_kf is not temporal under slot reuse
            seqs = np.where(valid_o, self.kf_seq[np.maximum(okf, 0)],
                            np.int64(1) << 62)
            col = np.where(is_anch.any(1), np.argmax(is_anch, 1),
                           np.argmin(seqs, 1))
            rows = np.arange(Lw)
            a_kf = np.maximum(okf[rows, col], 0)
            a_slot = np.maximum(oslot[rows, col], 0)
            lm_anchor[:Lw] = np.where(valid_o.any(1), wi[rows, col], -1)
            lm_anchor_px[:Lw] = self.obs_px[a_kf, a_slot]

        return BAProblem(
            kf_ids=kf_ids,
            kf_poses=self.kf_poses[np.maximum(kf_ids, 0)].copy(),
            kf_fixed=fixed,
            lm_ids=lm_ids,
            lm_pos=lm_pos,
            obs_kf=obs_kf,
            obs_lm=obs_lm,
            obs_px=obs_px,
            obs_cam=obs_cam,
            obs_valid=obs_kf >= 0,
            lm_anchor=lm_anchor,
            lm_anchor_px=lm_anchor_px,
            kf_seq_snap=np.where(kf_ids >= 0,
                                 self.kf_seq[np.maximum(kf_ids, 0)], -1),
            lm_gen_snap=np.where(lm_ids >= 0,
                                 self.lm_gen[np.maximum(lm_ids, 0)], -1),
        )

    def apply_ba_result(self, problem: BAProblem, new_kf_poses: np.ndarray,
                        new_lm_pos: np.ndarray,
                        lm_keep: Optional[np.ndarray] = None):
        """Write back optimized poses/landmarks (`optimizer.cpp:737-896`);
        optionally cull landmarks flagged bad by the solver.

        The solve may have run outside the map lock while slots were freed
        and recycled (capacity eviction, culling): any slot whose identity
        snapshot (kf_seq / lm_gen) no longer matches is skipped — it now
        holds a different keyframe/landmark than the one optimized."""
        for i, k in enumerate(problem.kf_ids):
            if k < 0 or problem.kf_fixed[i] or not self.kf_valid[k]:
                continue
            if (problem.kf_seq_snap is not None
                    and self.kf_seq[k] != problem.kf_seq_snap[i]):
                continue
            self.kf_poses[k] = new_kf_poses[i]
        for i, l in enumerate(problem.lm_ids):
            if l < 0 or not self.lm_valid[l]:
                continue
            if (problem.lm_gen_snap is not None
                    and self.lm_gen[l] != problem.lm_gen_snap[i]):
                continue
            if lm_keep is not None and not lm_keep[i]:
                self.remove_landmark(int(l))
            else:
                self.lm_pos[l] = new_lm_pos[i]
