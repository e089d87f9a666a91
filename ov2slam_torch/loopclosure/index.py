"""Binary-descriptor place-recognition index.

Port of ``ov2slam_tpu/loopclosure/index.py`` (the dense replacement for
iBoW-LCD + obindex2): every stored keyframe is scored by *exact*
descriptor match counts — no tree, no approximation.

Score(query, KF) = fraction of query descriptors whose best Hamming
distance into the KF's descriptor set is at most ``match_bits``
(:func:`ov2slam_torch.ops.hamming.match_scores_bits`: the CUDA kernel on a
GPU, its plain version on the CPU).

The store on the device is a ±1 cube, (capacity, N, 256) int8 (+1 or -1
per descriptor bit, 0 for invalid rows; 512 MiB at 2048 keyframes of 1024
descriptors), as the JAX package keeps it for its TPU kernel. ``add``
writes one row in place; compaction rewrites the kept rows from the packed
host copy and zeroes the rest. A query scores only the populated prefix of
the cube. The same code runs on every device. The cube may be written on
one CUDA stream (the asynchronous manager's worker adds keyframes) and
scored on another (the relocalizer on the front end's thread): an event
recorded after every write and after every scoring launch orders the two
streams both ways. Temporal-consistency grouping ("islands") and the
recent-frame mask of the loop-closure ``query`` are host logic; the
relocalizer's ``query_best`` scores every stored row and takes the top k.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import record_event, resolve_device, wait_event
from ..ops.hamming import match_scores_bits, unpack_pm1

_CHUNK = 16
_UNPACK_ROWS = 64   # keyframes unpacked at once when the cube is rewritten


class PlaceIndex:
    """Incremental dense-scoring index with island grouping."""

    def __init__(self, capacity: int, recent_mask: int = 30,
                 island_radius: int = 3, min_score: float = 0.25,
                 match_bits: int = 48, device=None):
        self.device = resolve_device(device)
        cap = ((capacity + _CHUNK - 1) // _CHUNK) * _CHUNK
        self.capacity = cap
        self.recent_mask = recent_mask
        self.island_radius = island_radius
        self.min_score = min_score
        self.match_bits = match_bits
        self._desc: Optional[np.ndarray] = None   # (cap, N, 8) uint32
        self._valid: Optional[np.ndarray] = None  # (cap, N)
        # the store on the device: (cap, N, 256) int8 ±1 cube, rows
        # written in place by `add`, the kept prefix rewritten by `_compact`
        self._cube: Optional[torch.Tensor] = None
        self._dev_valid: Optional[torch.Tensor] = None
        self.kf_ids: List[int] = []
        # insertion seq of each entry's KF: map slot ids are recycled, so
        # an entry is stale when the slot's current seq no longer matches
        self.kf_seqs: List[int] = []
        self._last_candidate: Optional[int] = None
        # events after the last cube write and the last scoring launch
        self._written = None
        self._read = None

    def _begin_write(self):
        """Order a cube write after the last scoring launch."""
        wait_event(self._read, self.device)

    def _end_write(self):
        self._written = record_event(self.device)

    def add(self, kfid: int, desc: np.ndarray, valid: np.ndarray,
            seq: Optional[int] = None, seq_lookup=None):
        if self._desc is None:
            N = desc.shape[0]
            self._desc = np.zeros((self.capacity, N, 8), np.uint32)
            self._valid = np.zeros((self.capacity, N), bool)
            self._cube = torch.zeros((self.capacity, N, 256),
                                     dtype=torch.int8, device=self.device)
            self._dev_valid = torch.zeros((self.capacity, N),
                                          dtype=torch.bool,
                                          device=self.device)
        self._begin_write()
        if len(self.kf_ids) >= self.capacity:
            self._compact(seq_lookup)
        i = len(self.kf_ids)
        self._desc[i] = desc
        self._valid[i] = valid
        self._write_rows(slice(i, i + 1))
        self._end_write()
        self.kf_ids.append(kfid)
        self.kf_seqs.append(-1 if seq is None else int(seq))

    def clear(self):
        """Drop every entry; the device cube is kept and zeroed."""
        if self._cube is not None:
            self._begin_write()
            self._valid[:] = False
            self._cube.zero_()
            self._dev_valid.zero_()
            self._end_write()
        self.kf_ids = []
        self.kf_seqs = []
        self._last_candidate = None

    def _compact(self, seq_lookup=None):
        """Reclaim rows at capacity: a long run pushes more keyframes
        through the index than it holds (map slots recycle via culling /
        eviction). Stale rows — whose map slot was culled or recycled —
        go first; if none are stale, the oldest eighth is dropped (those
        keyframes are the next eviction candidates in a bounded map)."""
        n = len(self.kf_ids)
        keep = np.ones(n, bool)
        if seq_lookup is not None:
            ids = np.asarray(self.kf_ids, np.int64)
            seqs = np.asarray(self.kf_seqs, np.int64)
            cur = np.asarray(seq_lookup(ids), np.int64)
            keep = ~((seqs >= 0) & (cur != seqs))
        if keep.all():
            keep[: max(1, n // 8)] = False
        idx = np.nonzero(keep)[0]
        m = len(idx)
        self._desc[:m] = self._desc[idx]
        self._valid[:m] = self._valid[idx]
        self._valid[m:] = False
        self.kf_ids = [self.kf_ids[j] for j in idx]
        self.kf_seqs = [self.kf_seqs[j] for j in idx]
        for c0 in range(0, m, _UNPACK_ROWS):
            self._write_rows(slice(c0, min(c0 + _UNPACK_ROWS, m)))
        self._cube[m:] = 0
        self._dev_valid[m:] = False
        self._last_candidate = None

    def _write_rows(self, rows: slice):
        """Copy host rows ``rows`` to the device: flags, and the ±1 cube
        unpacked on the device from the packed words."""
        valid = self._to_dev(self._valid[rows])
        self._dev_valid[rows] = valid
        self._cube[rows] = unpack_pm1(
            self._to_dev(self._desc[rows].view(np.int32)), valid)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _mask_stale(self, scores: np.ndarray, seq_lookup) -> np.ndarray:
        """Score stale entries (culled or recycled KF slots) to -1."""
        if seq_lookup is None:
            return scores
        n = len(scores)
        ids = np.asarray(self.kf_ids[:n], np.int64)
        seqs = np.asarray(self.kf_seqs[:n], np.int64)
        cur = np.asarray(seq_lookup(ids), np.int64)
        scores[(seqs >= 0) & (cur != seqs)] = -1.0
        return scores

    def _raw_scores(self, desc: np.ndarray, valid: np.ndarray,
                    usable: int) -> np.ndarray:
        """Scores of the first ``usable`` stored rows (the kernel on a
        GPU): the populated prefix of the cube, contiguous."""
        qv = self._to_dev(np.asarray(valid, bool))
        q = unpack_pm1(
            self._to_dev(np.asarray(desc, np.uint32).view(np.int32)), qv)
        wait_event(self._written, self.device)
        if self.device.type == "cuda":
            # the cube may be scored on another stream than the one it was
            # allocated on
            stream = torch.cuda.current_stream(self.device)
            self._cube.record_stream(stream)
            self._dev_valid.record_stream(stream)
        scores = match_scores_bits(self._cube[:usable],
                                   self._dev_valid[:usable], q, qv,
                                   self.match_bits)
        self._read = record_event(self.device)
        return scores.cpu().numpy()

    def query_best(self, desc: np.ndarray, valid: np.ndarray,
                   top_k: int = 3,
                   seq_lookup=None) -> List[Tuple[int, float]]:
        """Top-k scoring keyframes with NO recency mask and NO island
        temporal-consistency gate — used for relocalization after tracking
        loss, where a single lost frame must match immediately and recent
        keyframes are the most likely matches. Stale entries never come
        back."""
        n = len(self.kf_ids)
        if n == 0 or self._desc is None:
            return []
        scores = self._mask_stale(self._raw_scores(desc, valid, n),
                                  seq_lookup)
        order = np.argsort(-scores)[:top_k]
        return [(self.kf_ids[int(i)], float(scores[int(i)]))
                for i in order if scores[int(i)] >= 0]

    def query(self, desc: np.ndarray, valid: np.ndarray,
              exclude: Optional[set] = None,
              seq_lookup=None) -> Tuple[int, float]:
        """Best loop candidate for a query descriptor set.

        Returns (kf_id, score) or (-1, 0.0). Requires temporal consistency:
        two consecutive queries must hit the same island
        (`lcdetector.cc` island tracking) before a candidate is emitted.
        """
        n = len(self.kf_ids)
        usable = n - self.recent_mask
        if usable < 1:
            return -1, 0.0
        scores = self._mask_stale(self._raw_scores(desc, valid, usable),
                                  seq_lookup)
        if exclude:
            for i, k in enumerate(self.kf_ids[:usable]):
                if k in exclude:
                    scores[i] = -1.0

        # scored islands (`ibow_lcd::LCDetector` island grouping,
        # `lcdetector.cc` / `island.h`): group above-threshold entries
        # into temporally contiguous islands, score each island by the
        # SUM of its member scores (a true revisit lights up several
        # consecutive stored keyframes; a perceptual-aliasing one-off
        # usually lights up one), apply a prior boost to the island
        # consistent with the previous query, and require two consecutive
        # consistent hits before emitting.
        #
        # Consistency is TRACKED at half the emission threshold: a true
        # revisit's scores ramp up over several keyframes (approach
        # geometry), and gating the tracker at the full threshold would
        # throw away that history — the first full-threshold hit then
        # finds no prior island and a short revisit window (a closing
        # circle) ends before a second one arrives. Emission still
        # requires min_score AND a consistent previous island.
        above = np.nonzero(scores >= 0.5 * self.min_score)[0]
        if len(above) == 0:
            self._last_candidate = None
            return -1, 0.0
        # contiguous runs with gaps <= island_radius
        splits = np.nonzero(np.diff(above) > self.island_radius)[0] + 1
        islands = np.split(above, splits)

        def island_stats(members):
            ssum = float(scores[members].sum())
            center = int(members[np.argmax(scores[members])])
            return ssum, center

        stats = [island_stats(m) for m in islands]
        if self._last_candidate is not None:
            # prior: prefer the island containing/near the last match
            stats = [
                (ssum * (1.5 if abs(center - self._last_candidate)
                         <= 2 * self.island_radius else 1.0), center)
                for ssum, center in stats]
        ssum, island_center = max(stats)
        best_score = float(scores[island_center])

        consistent = (
            self._last_candidate is not None
            and abs(self._last_candidate - island_center)
            <= 2 * self.island_radius
        )
        self._last_candidate = island_center
        if not consistent or best_score < self.min_score:
            return -1, 0.0
        return self.kf_ids[island_center], best_score



def bit_signature(desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Cheap (256,) bit-frequency signature of a keyframe's valid BRIEF
    descriptors ((N, 8) uint32), centred and unit-norm (kept for
    diagnostics); zeros when no descriptor is valid."""
    if valid.sum() == 0:
        return np.zeros(256, np.float32)
    d = desc[valid]
    bits = np.unpackbits(
        d.view(np.uint8), bitorder="little").reshape(len(d), 256)
    sig = bits.mean(axis=0).astype(np.float32) - 0.5
    n = np.linalg.norm(sig)
    return sig / n if n > 0 else sig
