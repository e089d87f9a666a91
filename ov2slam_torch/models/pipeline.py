"""Asynchronous stage-overlap pipeline.

Port of ``ov2slam_tpu/models/pipeline.py``. The reference runs front-end ∥
mapper ∥ BA ∥ loop-closer as OS threads sharing the map under mutexes
(`ov2slam_node.cpp:198-208`, `mapper.cpp:38-51`), connected by bounded
keyframe queues with backpressure (`mapper.cpp:784-819`,
`estimator.cpp:185-218`).

Here the front end stays on the caller's thread (it is the real-time
path); keyframe processing (mapper + local BA + loop closure) runs on one
worker thread. Queue semantics mirror the reference:

- the worker drains its queue to the *latest* keyframe, folding skipped
  ones into the BA window (Estimator::getNewKf drain,
  `estimator.cpp:185-218`),
- under backpressure the optional stages (local-map matching, loop
  closure) are skipped (`bnewkfavailable_` checks, `mapper.cpp:153-162`).

Map consistency: one coarse lock guards map mutations — the granularity of
the reference's `map_mutex_`. The solvers take it for the problem snapshot
and the write-back only (`optimizer.cpp:741`); the worker holds it through
a keyframe's mapping and local BA all the same (see below).

On a GPU the worker runs on a CUDA stream of its own, so its kernels
overlap the front end's. The lock orders the host only; the streams are
ordered by events:

- each queued keyframe carries an event recorded on the front end's
  stream after its pyramid and right image were made; the worker waits on
  it before any use and ``record_stream``s every tensor it takes over, so
  the caching allocator cannot hand their memory back to the front end
  while worker kernels still read them;
- the place index orders its cube's writes (worker) and scoring
  (relocalizer, front end) with events of its own;
- the worker never touches the front end's device state: a pose
  correction reaches the device recurrence as a host delta that the front
  end applies at its next dispatch.

Neither thread synchronizes the device: a readback waits on its own
stream or event only.

Where the port departs from the JAX package, on measurements of both on
the 752x480 loop the port's smoke test drives (slice E) and on the tests'
376x240 loop:

- every keyframe is registered in the frame that requests it. The JAX
  package's device-chained mode defers the detection's readback and the
  registration to the next frame (it hid a remote TPU's round trip); on
  the GPU that wait is a few milliseconds, while the deferral added a
  second KLT hop for the new slots and a frame of mapping lag, and the
  paced slice dropped 9-13 of 80 frames against 0-3 without it;
- a frame waits until every queued keyframe is mapped (see
  ``process_frame``);
- the worker holds the map lock (a :class:`TurnLock`) through a
  keyframe's mapping, local BA and place query, so that its host work
  never interleaves with a front-end frame's: on a GPU both are
  launch-bound Python on one interpreter, and interleaved they took
  longer than in turn (the paced slice dropped 9-19 of 80 frames against
  0-3 held); their device work still overlaps on the worker's stream.
  The threads take turns: after the mapping and after every LM iteration
  the worker hands the lock to a frame that waits for it and takes it
  back once that frame is done, so no frame waits through a whole local
  BA (hundreds of ms on a CPU). The loop closer's cascade stays outside
  the lock;
- a loop closure's correction reaches the front end as BA's does.
"""

from __future__ import annotations

import queue
import threading
import time as _time
import traceback
from typing import Optional

import numpy as np
import torch

from ..device import record_event, stream_context, wait_event
from ..utils import lie_np
from .slam import SlamManager


class TurnLock:
    """The asynchronous manager's map lock: re-entrant, and its holder can
    hand it to a thread that waits for it at a point of its choosing
    (:meth:`yield_turn`), taking it back as soon as that thread lets go.
    A bare ``RLock`` released and taken again at once does not hand over:
    the waiter is woken, but the releasing thread runs on and wins the
    lock again. One thread (the worker) yields; any thread may wait."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._owner = None        # thread ident
        self._depth = 0
        self._waiting = 0         # threads blocked in acquire
        self._grants = 0          # acquisitions, re-entries not counted
        self._reclaim = None      # the grant a yielder takes it back after
        self.handoffs = 0

    def acquire(self) -> bool:
        me = threading.get_ident()
        with self._cv:
            if self._owner == me:
                self._depth += 1
                return True
            self._waiting += 1
            try:
                while self._owner is not None or (
                        self._reclaim is not None
                        and self._grants >= self._reclaim):
                    self._cv.wait()
            finally:
                self._waiting -= 1
            self._owner, self._depth = me, 1
            self._grants += 1
            return True

    def release(self) -> None:
        with self._cv:
            if self._owner != threading.get_ident():
                raise RuntimeError("TurnLock: release by a thread that "
                                   "does not hold it")
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._cv.notify_all()

    def owned(self) -> bool:
        """Whether the calling thread holds the lock."""
        return self._owner == threading.get_ident()

    def yield_turn(self) -> bool:
        """Called by the holder: if another thread waits for the lock,
        hand it over (whatever the holder's depth), wait until that thread
        has taken and released it, and take it back at the same depth.
        Returns whether it handed over."""
        me = threading.get_ident()
        with self._cv:
            if self._owner != me:
                raise RuntimeError("TurnLock: yield by a thread that does "
                                   "not hold it")
            if self._waiting == 0:
                return False
            depth, self._owner, self._depth = self._depth, None, 0
            self._reclaim = self._grants + 1
            self._cv.notify_all()
            while self._owner is not None or self._grants < self._reclaim:
                self._cv.wait()
            self._reclaim = None
            self._owner, self._depth = me, depth
            self.handoffs += 1
            return True

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


class AsyncSlamManager(SlamManager):
    """SlamManager with keyframe processing on a worker thread (and, on a
    GPU, a worker CUDA stream). ``close()`` joins the worker."""

    def __init__(self, cfg, use_loop_closer: Optional[bool] = None,
                 queue_size: int = 64, device=None, seed: int = 42):
        super().__init__(cfg, use_loop_closer, device=device, seed=seed)
        self.map_lock = TurnLock()
        self._kf_queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        # in-flight work count (queued + being processed): flush() waits
        # for the worker to be IDLE, not merely for the queue to be empty
        self._pending = 0
        self._pending_cv = threading.Condition()
        # keyframes enqueued but not yet stereo-matched/triangulated —
        # the quantity KF backpressure keys on (_allow_new_kf)
        self._unmapped = 0
        self._kf_deferrals = 0
        self._fold_backlog = []   # inline-mapped KFs awaiting a BA window
        self.n_worker_errors = 0
        self.n_folded = 0         # keyframes folded into a later BA window
        self.n_deferred = 0       # keyframe requests deferred by backpressure
        self.worker_stream = (torch.cuda.Stream(device=self.device)
                              if self.device.type == "cuda" else None)
        # what the constructor made on this thread's stream (camera and
        # mapper tensors) is ordered before the worker's first use
        self._built = record_event(self.device)
        self._worker = threading.Thread(target=self._kf_worker,
                                        name="kf-worker", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ #
    # overrides
    # ------------------------------------------------------------------ #

    def _map_keyframe(self, kfid, img_right):
        self._enqueue(kfid, self.frontend.cur_pyr, img_right)

    def _enqueue(self, kfid, pyr, img_right):
        """Hand keyframe ``kfid`` to the worker. EVERY keyframe must be
        mapped (stereo match + triangulation) — the reference's queue is
        unbounded and only OPTIONAL stages skip under backpressure
        (`mapper.cpp:153-162,784-819`). If the queue is full, map INLINE:
        blocking here would deadlock (this thread holds the map lock the
        worker needs), and real-time shedding belongs at the INPUT (frame
        dropping, `ov2slam.cpp:292-299`). The seq snapshot detects a
        cull + recycle before processing; the event orders the worker's
        stream after this thread's work on ``pyr`` and ``img_right``."""
        item = (kfid, int(self.map.kf_seq[kfid]), pyr, img_right,
                record_event(self.device))
        try:
            self._kf_queue.put_nowait(item)
            with self._pending_cv:
                self._pending += 1
                self._unmapped += 1
        except queue.Full:
            # overload fallback: map inline and leave the keyframe for the
            # worker's next BA window via the fold list
            # (`estimator.cpp:195-214` folds skipped keyframes the same way)
            self.mapper.process_keyframe(kfid, self.frontend.frame, pyr,
                                         img_right)
            with self._pending_cv:
                self._fold_backlog.append(kfid)

    def _allow_new_kf(self) -> bool:
        """Mapper-lag backpressure (`bnewkfavailable_` checks,
        `mapper.cpp:153-162`): while the worker still owes stereo matching
        and triangulation for queued keyframes, the front end's keyframe
        heuristics run against an un-triangulated map and fire keyframe
        cascades.

        Deferral is bounded and engages only at a REAL backlog (more than
        one keyframe still unmapped): at most 2 consecutive frames, and
        never when the track set is genuinely thinning — the reference
        sheds load by skipping OPTIONAL mapper stages, never by delaying
        keyframe creation for long (`mapper.cpp:153-162`)."""
        if self._unmapped <= 1:
            self._kf_deferrals = 0
            return True
        cap = self.cfg.grid_cells[0] * self.cfg.grid_cells[1]
        if self.frontend.frame.n_valid < max(10, int(0.45 * cap)):
            self._kf_deferrals = 0
            return True
        self._kf_deferrals += 1
        if self._kf_deferrals > 2:
            self._kf_deferrals = 0
            return True
        self.n_deferred += 1
        return False

    def process_frame(self, img_left, img_right=None, time: float = 0.0):
        # the in-flight frame's readback is the only long blocking wait on
        # this thread — wait for it OUTSIDE the map lock so the worker
        # keeps running through it (the reference's `map_mutex_` never
        # covers a device wait)
        self.frontend.wait_pending()
        # input backpressure: the next frame waits (up to
        # backpressure_wait_s) until every queued keyframe is stereo-mapped
        # and triangulated; local BA and loop closure stay asynchronous.
        # The JAX package waits only while MORE than one keyframe is
        # unmapped, so frames are tracked against a keyframe whose new
        # landmarks are still 2D; on a camera turning 3 degrees per frame
        # that raised the asynchronous ATE from 0.04 m to 0.09-0.15 m (the
        # tests' 376x240 loop, 80 frames, CPU). The reference's
        # non-realtime mode lets the INPUT queue grow instead
        # (`ov2slam.cpp:268-307` without `force_realtime`); blocking the
        # caller here is the bounded-memory equivalent.
        with self._pending_cv:
            deadline = float(self.cfg.backpressure_wait_s)
            while self._unmapped > 0 and deadline > 0:
                self._pending_cv.wait(0.05)
                deadline -= 0.05
        with self.map_lock:
            return super().process_frame(img_left, img_right, time)

    # ------------------------------------------------------------------ #

    def _take_over(self, item):
        """Order the worker's stream after the front end's work on a
        queued keyframe's tensors, and mark them used on this stream."""
        _, _, pyr, img_right, ev = item
        if self.worker_stream is None:
            return
        wait_event(ev, self.device)
        for t in (*(pyr or ()), img_right):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(self.worker_stream)

    def _kf_worker(self):
        with stream_context(self.worker_stream):
            wait_event(self._built, self.device)
            while not self._stop.is_set():
                try:
                    item = self._kf_queue.get(timeout=0.05)
                except queue.Empty:
                    # idle: the next BA capacity's graphs, if one is due
                    self.estimator.prewarm_next()
                    continue
                # drain to the newest KF. Reference semantics: the Mapper
                # maps EVERY keyframe but skips the optional stages under
                # backpressure (`mapper.cpp:153-162`), while the Estimator
                # optimizes only the LATEST, folding the skipped ids into
                # its BA window (`estimator.cpp:195-214`).
                items = [item]
                while True:
                    try:
                        items.append(self._kf_queue.get_nowait())
                    except queue.Empty:
                        break
                self._process_items(items)

    def _process_items(self, items):
        backlogged = len(items) > 1
        try:
            for it in items:
                self._take_over(it)
            skipped = []
            for kfid, seq, pyr, img_right, _ in items[:-1]:
                with self.map_lock:
                    if self.map.kf_valid[kfid] \
                            and int(self.map.kf_seq[kfid]) == seq:
                        self.mapper.process_keyframe(
                            kfid, self.frontend.frame, pyr, img_right,
                            lock=self.map_lock)
                        skipped.append(kfid)
                with self._pending_cv:
                    self._unmapped = max(0, self._unmapped - 1)
                    self._pending_cv.notify_all()
            kfid, seq, pyr, img_right, _ = items[-1]
            with self._pending_cv:
                skipped.extend(self._fold_backlog)
                self._fold_backlog = []
            self.n_folded += len(skipped)
            self._process_kf(kfid, seq, pyr, img_right,
                             under_pressure=backlogged, fold_kfs=skipped)
        except Exception:  # the worker must survive; surfaced by the count
            traceback.print_exc()
            self.n_worker_errors += 1
            # the per-item _unmapped decrements may have been skipped by
            # the raise; recompute from the items still queued so that
            # backpressure cannot wedge open
            with self._pending_cv:
                self._unmapped = self._kf_queue.qsize()
                self._pending_cv.notify_all()
        finally:
            with self._pending_cv:
                self._pending -= len(items)
                self._pending_cv.notify_all()

    def _process_kf(self, kfid, seq, pyr, img_right, under_pressure: bool,
                    fold_kfs=()):
        found = None
        with self.map_lock:
            if not self.map.kf_valid[kfid] \
                    or int(self.map.kf_seq[kfid]) != seq:
                with self._pending_cv:
                    self._unmapped = max(0, self._unmapped - 1)
                    self._pending_cv.notify_all()
                return   # culled (and possibly recycled) while queued
            self.mapper.process_keyframe(kfid, self.frontend.frame, pyr,
                                         img_right, lock=self.map_lock)
            with self._pending_cv:
                self._unmapped = max(0, self._unmapped - 1)
                self._pending_cv.notify_all()
            self.map_lock.yield_turn()
            if self.cfg.do_track_localmap and not under_pressure:
                self.mapper.match_to_local_map(kfid, lock=self.map_lock)
            if self.cfg.slam_mode:
                T_kf_pre = self.map.kf_poses[kfid].copy()
                self.estimator.local_ba(kfid, lock=self.map_lock,
                                        extra_window=fold_kfs,
                                        between_iters=self.map_lock.yield_turn)
                self.estimator.map_filtering(kfid)
                self._correct_front_end(kfid, seq, T_kf_pre)
            if self.loop_closer is not None and not under_pressure:
                # the place query and add run here, still under the lock;
                # the verification cascade below runs without it
                T_kf_pre = self.map.kf_poses[kfid].copy()
                found = self.loop_closer.query_keyframe(
                    kfid, img=pyr[0] if pyr is not None else None)
        if found is not None and self.loop_closer.close_candidate(
                found, lock=self.map_lock):
            with self.map_lock:
                self._correct_front_end(kfid, seq, T_kf_pre)

    def _correct_front_end(self, kfid, seq, T_kf_pre):
        """Propagate the correction that BA or a loop closure made to
        keyframe ``kfid`` into the live front end (the synchronous manager
        sets the frame's pose to the keyframe's after both): the
        keyframe's world-frame delta, left-composed onto the frame pose,
        the motion model and the in-flight chain. Call with the map lock
        held. The JAX package propagates BA's correction only; a closure's
        would otherwise leave the front end's prior in the pre-closure
        frame while the map moved."""
        if not self.map.kf_valid[kfid] or int(self.map.kf_seq[kfid]) != seq:
            return
        fe = self.frontend
        f = fe.frame
        T_old = f.T_wc.copy()
        delta = lie_np.pose_compose(
            self.map.kf_poses[kfid].astype(np.float64),
            lie_np.pose_inverse(T_kf_pre.astype(np.float64)))
        f.T_wc = lie_np.pose_compose(
            delta, f.T_wc.astype(np.float64)).astype(np.float32)
        if fe.motion.prev_T is not None:
            fe.motion.prev_T = lie_np.pose_compose(delta, fe.motion.prev_T)
        fe.chain_apply_correction(T_old, f.T_wc)

    # ------------------------------------------------------------------ #

    def flush(self, timeout: float = 120.0):
        """Wait until all queued keyframes are fully PROCESSED — not just
        dequeued (the end-of-sequence barrier: `writeResults` waits for
        BA/LC, `ov2slam.cpp:579-582`)."""
        deadline = _time.time() + timeout
        with self._pending_cv:
            while self._pending > 0:
                remain = deadline - _time.time()
                if remain <= 0:
                    break
                self._pending_cv.wait(remain)

    def close(self):
        """Flush, stop the worker and join it (a thread still launching
        device work at interpreter exit can abort the process)."""
        self.flush()
        self._stop.set()
        self._worker.join(timeout=120.0)

    def _drain(self):
        """Resolve every in-flight frame and wait for the worker to finish
        the keyframes they made."""
        self.frontend.wait_pending()
        with self.map_lock:
            self.finish()
        self.flush()

    def estimated_trajectory(self):
        self._drain()
        with self.map_lock:
            return super().estimated_trajectory()

    def write_results(self, out_dir: str = "."):
        self._drain()
        with self.map_lock:
            super().write_results(out_dir)
