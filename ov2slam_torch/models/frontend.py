"""Visual front-end: per-frame tracking state machine.

Port of ``ov2slam_tpu/models/frontend.py`` (the reference's
`VisualFrontEnd`): CLAHE+pyramid preprocessing, constant-velocity motion
model, prior-guided forward-backward KLT, epipolar 2d-2d outlier gating,
P3P + motion-only PnP pose computation, and keyframe-need heuristics.

The current frame's keypoints live in fixed-capacity host slot arrays (px,
undistorted px, landmark ids, valid mask). Each frame is one dispatch
(:meth:`FrontEnd.dispatch_frame`: one packed upload, one device step, one
packed readback started into pinned memory) and one resolve
(:meth:`FrontEnd.resolve_pending`: wait for that frame's event, apply the
result). The synchronous path resolves at once; the pipelined manager
resolves ``pipeline_depth`` frames late, and at depth >= 2 the tracking
recurrence itself stays on the device (``fused_track_step_chained``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.image import build_pyramid, clahe
from ..geometry.pnp import p3p_ransac
from ..solvers.pnp_refine import pnp_refine
from .frontend_step import (CalibArrays, advance_chain_patch,
                            detect_describe, fused_track_step,
                            fused_track_step_chained, pack_chain_state,
                            pack_lm_static, pack_track_out, pack_track_state,
                            patch_chain_pose_delta, patch_chain_rows,
                            unpack_track_out, unpack_track_state)
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


class Staging:
    """A ring of host staging slots for the per-frame copies.

    On CUDA each slot's buffers are pinned, its uploads and readbacks are
    ``non_blocking`` copies on the current stream, and one event recorded
    after the slot's last copy orders them: :meth:`next` waits on a slot's
    event before its buffers are written again, and :meth:`read` before
    they are read. With ``pipeline_depth + 1`` slots a dispatch never waits
    on a frame still in flight. On the CPU the copies are plain and there
    are no events."""

    def __init__(self, device: torch.device, n: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs = [dict() for _ in range(n)]
        self._events = [None] * n
        self._i = 0

    def next(self) -> int:
        """The next slot, once its earlier copies have completed."""
        k = self._i
        self._i = (k + 1) % len(self._bufs)
        self.wait(k)
        return k

    def _host(self, k: int, name: str, shape, dtype) -> torch.Tensor:
        buf = self._bufs[k].get(name)
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
            self._bufs[k][name] = buf
        return buf

    def upload(self, k: int, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the device, through slot ``k``'s buffer ``name``."""
        arr = np.ascontiguousarray(arr)
        if not self.cuda:
            return torch.from_numpy(arr.copy()).to(self.device)
        buf = self._host(k, name, arr.shape, torch.from_numpy(arr[:0]).dtype)
        buf.numpy()[...] = arr
        return buf.to(self.device, non_blocking=True)

    def upload_parts(self, k: int, name: str, arrs):
        """``arrs`` on the device as one copy: slot ``k``'s byte buffer
        ``name`` holds them one after another (each at a 16-byte offset),
        and each comes back as a view of the uploaded bytes."""
        arrs = [np.ascontiguousarray(a) for a in arrs]
        offs, n = [], 0
        for a in arrs:
            offs.append(n)
            n += -(-a.nbytes // 16) * 16
        if self.cuda:
            buf = self._host(k, name, (n,), torch.uint8)
        else:
            buf = torch.empty(n, dtype=torch.uint8)
        host = buf.numpy()
        for a, o in zip(arrs, offs):
            host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = (buf.to(self.device, non_blocking=True) if self.cuda
               else buf)
        return [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
                .view(a.shape) for a, o in zip(arrs, offs)]

    def download(self, k: int, name: str, t: torch.Tensor) -> None:
        """Start the copy of ``t`` into slot ``k``'s buffer ``name``."""
        if not self.cuda:
            self._bufs[k][name] = t.detach().clone()
            return
        self._host(k, name, t.shape, t.dtype).copy_(t, non_blocking=True)

    def record(self, k: int) -> None:
        """Mark the end of slot ``k``'s copies on the current stream."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self._events[k] = ev

    def wait(self, k: int) -> None:
        """Block until slot ``k``'s copies have completed (its own event
        only, never the device or a stream)."""
        ev = self._events[k]
        if ev is not None:
            ev.synchronize()
            self._events[k] = None

    def read(self, k: int, name: str) -> np.ndarray:
        """A host copy of slot ``k``'s buffer ``name``, after its event."""
        self.wait(k)
        return self._bufs[k][name].numpy().copy()

    def clear(self) -> None:
        """Forget every slot's pending copies (after waiting for them)."""
        for k in range(len(self._bufs)):
            self.wait(k)


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
        # staging for the per-frame copies: pipeline_depth + 1 slots, so a
        # dispatch never overwrites a frame still in flight; a keyframe's
        # detection and its chain patch have their own
        depth = max(1, cfg.pipeline_depth) if cfg.pipelined_frontend else 1
        self._stage = Staging(self.device, depth + 1)
        self._stage_kf = Staging(self.device, 2)
        N = cfg.max_kps
        self._state_buf = np.zeros((N + 2, 8), np.float32)
        # in-flight frame records for the dispatch/resolve split (FIFO; the
        # synchronous path keeps it at length <= 1)
        self._pendings = collections.deque()
        # slot-birth bookkeeping: a pending dispatched BEFORE a slot was
        # (re)detected carries no information about it — its resolve must
        # not touch that slot (depth >= 2 keeps several frames in flight
        # across keyframe insertions)
        self._dispatch_seq = 0
        self._resolved_seq = 0       # seq of the last resolved frame
        self._slot_birth = np.zeros(N, np.int64)
        # device-chained recurrence state (pipeline_depth >= 2): the chain
        # tensor and the latest dispatched frame's pyramid
        self._chain_S = None
        self._chain_pyr = None
        self._chain_patch = None     # (N, 6) [row, px, und, status] tensor
        self._chain_delta = None     # host pose correction not yet applied
        self._chain_last_time = None
        self._chain_dt = 0.0
        # rows 0..N: the per-slot map view; row N+1: [delta(7) | dt ratio]
        self._lm_buf = np.zeros((N + 2, 8), np.float32)
        self._chain_buf = np.zeros((N + 2, 8), np.float32)
        # from-KF tracking (`btrack_keyframetoframe`): the reference
        # keyframe's pyramid, captured at detection time
        self._kf_pyr = None

    # ------------------------------------------------------------------ #

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def preprocess(self, img) -> None:
        """CLAHE + pyramid; swaps prev/cur. The frame is taken as f32
        as it is (no uint8 rounding on this path, as in the JAX package)."""
        im = (self._dev(np.asarray(img, np.float32))
              if isinstance(img, np.ndarray) else img.to(torch.float32))
        if self.cfg.use_clahe:
            im = clahe(im, self.cfg.clahe_val)
        self.prev_pyr = self.cur_pyr
        self.cur_pyr = tuple(build_pyramid(im, self.cfg.klt_levels))

    def _upload_image(self, k: int, img) -> torch.Tensor:
        """The frame on the device as uint8 through staging slot ``k``
        (host frames go through :func:`to_u8`); a device tensor (rectified
        or undistorted) is taken as it is."""
        if isinstance(img, np.ndarray):
            return self._stage.upload(k, "img", to_u8(img))
        return img

    # ------------------------------------------------------------------ #

    def track_frame(self, img, time: float) -> bool:
        """Process one left frame; returns True if it should become a
        keyframe (`visualTracking`, `visual_front_end.cpp:40-128`).

        Synchronous path: dispatch + immediate resolve. The pipelined
        manager calls :meth:`dispatch_frame` / :meth:`resolve_pending`
        separately, so a frame's readback overlaps the next frames'
        dispatches."""
        self.prof.start("0.Full-Front_End")
        try:
            if self.dispatch_frame(img, time) is None:
                return True              # bootstrap path resolved inline
            return self.resolve_pending()
        finally:
            self.prof.stop("0.Full-Front_End")

    @property
    def has_pending(self) -> bool:
        return len(self._pendings) > 0

    @property
    def n_pending(self) -> int:
        return len(self._pendings)

    def wait_pending(self):
        """Wait for the OLDEST in-flight frame's readback WITHOUT applying
        it (so that the blocking wait can happen outside any map lock —
        the copy touches no shared state). Waits on that frame's event
        only."""
        if self._pendings:
            self._stage.wait(self._pendings[0]["slot"])

    def dispatch_frame(self, img, time: float):
        """Upload + dispatch the fused step for one frame WITHOUT reading
        the result back. Returns the pending record (resolved later by
        :meth:`resolve_pending`), or None when the frame took the inline
        bootstrap path (the caller treats it as an immediate KF request).

        With ``pipeline_depth >= 2`` the dispatch rides the device-chained
        recurrence (host slot state may trail by several frames); at
        depth 1 it requires the previous frame to be resolved."""
        cfg = self.cfg
        f = self.frame

        self.bootstrap_kf = False
        if self.map.n_keyframes == 0 or (f.kf_id < 0 and f.n_valid == 0):
            # bootstrap (or post-reset re-bootstrap): this frame becomes a
            # keyframe; pose = identity on first start, else keep the last
            # estimate so the map stays consistent. The flag exempts this
            # keyframe from the starvation veto — it has zero tracks BY
            # CONSTRUCTION (detection happens inside keyframe creation).
            f.time = time
            self.bootstrap_kf = True
            self.preprocess(img)
            if self.map.n_keyframes == 0:
                f.T_wc = lie_np.pose_identity().astype(np.float32)
            self.motion.update(f.T_wc.astype(np.float64), time)
            self._frames_since_kf = 0
            return None

        debug = getattr(self, "debug_gates", False)
        if (cfg.pipelined_frontend and cfg.pipeline_depth >= 2
                and self.initialized and not debug):
            return self._dispatch_chained(img, time)

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
        # `kltTrackingFromKF` (`visual_front_end.cpp:278-442`): replaces
        # frame-to-frame tracking when enabled and a KF pyramid exists
        # (host-packed path only — the device chain tracks frame to frame)
        from_kf = bool(cfg.track_keyframetoframe and do_pose
                       and self._kf_pyr is not None)
        k = self._stage.next()
        state = self._stage.upload(k, "state", pack_track_state(
            f.px, lm_pos, kf_px, f.valid, is3d, pair_valid,
            np.asarray(T_pred, np.float32), np.asarray(T_kf, np.float32),
            out=self._state_buf))
        cur_pyr, out = fused_track_step(
            self._upload_image(k, img), self.cur_pyr,
            **unpack_track_state(state), gen=self._gen, calib=self._calib,
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
        if debug:
            self.last_debug = {n: v.cpu().numpy() for n, v in out.items()}
        self.prev_pyr = self.cur_pyr
        self.cur_pyr = cur_pyr
        self._stage.download(k, "out", pack_track_out(out))
        self._stage.record(k)
        self._dispatch_seq += 1
        pend = dict(slot=k, time=time, T_pred=T_pred, do_pose=do_pose,
                    is3d=is3d, pyr=None, seq=self._dispatch_seq)
        self._pendings.append(pend)
        self.prof.stop("0.FE_dispatch")
        return pend

    # ------------------------------------------------------------------ #
    # device-chained dispatch (pipeline_depth >= 2)
    # ------------------------------------------------------------------ #

    def _gather_lm_static(self) -> np.ndarray:
        """Pack the per-slot map view for the chained step into
        ``_lm_buf[:N + 1]`` (a host gather, uploaded with every dispatch so
        BA updates / 2D→3D promotions / culls reach the device recurrence
        within one frame); returns the slots' 3D flags."""
        f = self.frame
        m = self.map
        ids = np.maximum(f.lmids, 0)
        # f.valid is included so host-side slot invalidation (P3P-rescue
        # outliers, starvation culls) reaches the device recurrence at the
        # next dispatch; the chain's own status recurrence never
        # resurrects a slot it killed
        live = f.valid & (f.lmids >= 0) & m.lm_valid[ids]
        is3d = live & m.lm_is3d[ids]
        lm_pos = np.where(is3d[:, None], m.lm_pos[ids], 0.0)
        kf_px = np.zeros_like(f.px_und)
        pair_valid = np.zeros(len(f.px), bool)
        kfid = f.kf_id
        T_kf = f.T_wc.astype(np.float64)
        if kfid >= 0 and m.kf_valid[kfid]:
            T_kf = m.kf_poses[kfid].astype(np.float64)
            lookup = np.full(m.L, -1, np.int32)
            kf_lm = m.obs_lmid[kfid]
            sel = kf_lm >= 0
            lookup[kf_lm[sel]] = np.nonzero(sel)[0]
            slot_in_kf = lookup[ids]
            pair_valid = live & (slot_in_kf >= 0)
            kf_px[pair_valid] = m.obs_px[kfid, slot_in_kf[pair_valid]]
        pack_lm_static(lm_pos, kf_px, live, is3d, pair_valid,
                       T_kf.astype(np.float32),
                       out=self._lm_buf[:len(f.px) + 1])
        return is3d

    def _dispatch_chained(self, img, time: float):
        """One chained dispatch: the recurrent tracking state stays on the
        device (``fused_track_step_chained``); the host ships only the
        image, the refreshed per-slot map view (with the interval ratio and
        any pending pose correction in its extra row), and occasional
        new-slot patches — and reads results ``pipeline_depth`` frames
        late."""
        cfg = self.cfg
        f = self.frame
        N = cfg.max_kps
        self.prof.start("0.FE_dispatch")
        is3d = self._gather_lm_static()
        # dt ratio vs the previous dispatch interval (frame drops /
        # uneven arrival): scales the device prior
        dt = time - self._chain_last_time if self._chain_last_time else 0.0
        ratio = 1.0
        if self._chain_dt > 0 and dt > 0:
            ratio = float(np.clip(dt / self._chain_dt, 0.2, 6.0))
        if dt > 0:
            self._chain_dt = dt
        self._chain_last_time = time
        extra = self._lm_buf[N + 1]
        extra[:7] = (self._chain_delta if self._chain_delta is not None
                     else lie_np.pose_identity())
        extra[7] = ratio
        k = self._stage.next()
        lm_up = self._stage.upload(k, "lm", self._lm_buf)

        if self._chain_S is None:
            # seed from the resolved host state; T_prev reconstructed from
            # the motion model's last relative step
            T_cur = f.T_wc.astype(np.float64)
            T_prev = lie_np.pose_compose(
                T_cur, lie_np.pose_inverse(self.motion.rel))
            self._chain_S = self._stage.upload(k, "chain", pack_chain_state(
                f.px, f.px_und, f.valid.astype(np.float32),
                T_cur.astype(np.float32), T_prev.astype(np.float32),
                out=self._chain_buf))
            self._chain_pyr = self.cur_pyr
        else:
            if self._chain_delta is not None:
                self._chain_S = patch_chain_pose_delta(
                    self._chain_S, lm_up[N + 1, :7])
            if self._chain_patch is not None:
                # advanced to the chain's head frame by `detect_and_describe`
                # (see advance_chain_patch)
                p = self._chain_patch
                self._chain_S = patch_chain_rows(
                    self._chain_S, p[:, 0], p[:, 1:3], p[:, 3:5], p[:, 5])
        self._chain_patch = None
        self._chain_delta = None

        cur_pyr, S_out, packed = fused_track_step_chained(
            self._upload_image(k, img), self._chain_pyr, self._chain_S,
            lm_up[:N + 1], lm_up[N + 1, 7:8], self._gen, self._calib,
            clahe_val=float(cfg.clahe_val),
            max_fbklt_dist=float(cfg.max_fbklt_dist),
            klt_err=float(cfg.klt_err),
            ransac_err_px=float(cfg.ransac_err),
            robust_th=float(cfg.robust_mono_th),
            levels=cfg.klt_levels, win=cfg.klt_win_size,
            iters=cfg.max_iter, use_clahe=cfg.use_clahe,
            do_epipolar=cfg.do_epipolar, do_pose=True,
            ransac_iters=cfg.ransac_iter, pnp_iters=cfg.pnp_iters,
            fisheye=self._fisheye, use_prior=cfg.klt_use_prior,
            split_sub=cfg.klt_split_sub)
        self._chain_S = S_out
        self._chain_pyr = cur_pyr
        self._stage.download(k, "out", packed)
        self._stage.record(k)
        self._dispatch_seq += 1
        pend = dict(slot=k, time=time, T_pred=None, do_pose=True,
                    is3d=is3d, pyr=cur_pyr, seq=self._dispatch_seq)
        self._pendings.append(pend)
        self.prof.stop("0.FE_dispatch")
        return pend

    def measured(self) -> np.ndarray:
        """Valid slots that the resolved frame measured: a slot born after
        that frame was dispatched (a keyframe's fresh detection, patched
        into the device chain while the frame was in flight) still holds
        the position of the frame it was detected in, so a keyframe made
        from the resolved frame must not observe it."""
        return self.frame.valid & (self._slot_birth <= self._resolved_seq)

    def chain_apply_correction(self, T_old: np.ndarray, T_new: np.ndarray):
        """Propagate a map-side pose correction (BA / pose-graph /
        P3P-rescue snapped the resolved frame from T_old to T_new) into the
        pipelined recurrence:

        - the world-frame delta is left-composed onto the device chain's
          pose rows at the next dispatch (so future dispatches predict from
          corrected state). It is kept on the host until then, so the
          asynchronous worker, which calls this under the map lock, never
          touches the chain tensor from its own stream;
        - every in-flight pending is tagged with the same delta, so when
          its already-computed result is resolved, its pose is re-expressed
          in the corrected world frame instead of the stale one."""
        if float(np.abs(T_new.astype(np.float64)
                        - T_old.astype(np.float64)).max()) < 1e-9:
            return   # no-op correction (e.g. BA left the pose unchanged)
        delta = lie_np.pose_compose(
            T_new.astype(np.float64),
            lie_np.pose_inverse(T_old.astype(np.float64)))
        for p in self._pendings:
            p["delta"] = (delta if p.get("delta") is None
                          else lie_np.pose_compose(delta, p["delta"]))
        if self._chain_S is None:
            return
        self._chain_delta = (delta if self._chain_delta is None
                             else lie_np.pose_compose(delta,
                                                      self._chain_delta))

    def resolve_pending(self) -> bool:
        """Read back and apply the OLDEST in-flight frame's result:
        slot/pose update, motion model, P3P fallback, keyframe decision.
        Returns the keyframe request for THAT frame."""
        cfg = self.cfg
        f = self.frame
        p = self._pendings.popleft()
        self._resolved_seq = p["seq"]
        time = p["time"]
        do_pose = p["do_pose"]
        is3d = p["is3d"]
        f.time = time
        if p["pyr"] is not None:      # chained: expose this frame's
            self.prev_pyr = self.cur_pyr   # pyramid to the KF path
            self.cur_pyr = p["pyr"]
        T_pred = p["T_pred"]
        if T_pred is None:            # chained: the prior was computed on
            T_pred = self.motion.predict(time)   # the device; reconstruct
            if T_pred is None:
                T_pred = f.T_wc.astype(np.float64)
        # one packed readback, in flight since the dispatch; waits on this
        # frame's event only
        self.prof.start("0.FE_readback")
        res = unpack_track_out(self._stage.read(p["slot"], "out"))
        self.prof.stop("0.FE_readback")
        tracked, und, status = res["tracked"], res["und"], res["status"]
        pose_ok, n_inl, T_new = res["pose_ok"], res["n_inl"], res["T_new"]
        if p.get("delta") is not None:
            # a map correction (BA/pose-graph/rescue) landed while this
            # frame was in flight: re-express its pose in the corrected
            # world frame (see chain_apply_correction)
            T_new = lie_np.pose_compose(
                p["delta"], T_new.astype(np.float64)).astype(np.float32)
        n_before = int(f.valid.sum())
        # slots born after this frame was dispatched carry no signal in
        # its output — leave them untouched (they join at a later seq)
        known = self._slot_birth <= p["seq"]
        upd = status & known
        f.px = np.where(upd[:, None], tracked, f.px)
        f.px_und = np.where(upd[:, None], und, f.px_und)
        f.valid &= status | ~known

        self.last_pose_ok = pose_ok if do_pose else None
        self.last_n_inl = n_inl if do_pose else 0
        self.last_n_3d = int(is3d.sum())
        # KLT-collapse P3P forcing (`visual_front_end.cpp:228-233`): when
        # under a third of the tracked set survives, re-localize with
        # global P3P-RANSAC instead of trusting the local PnP
        klt_collapsed = (n_before > 0
                         and f.n_valid < 0.33 * n_before)
        chained = p["pyr"] is not None
        if do_pose:
            if klt_collapsed and cfg.do_p3p:
                if self._p3p_fallback(T_pred):
                    if chained:
                        # rescue succeeded: snap the device recurrence (and
                        # in-flight results) onto the rescued pose — else
                        # the next resolve would overwrite the rescue with
                        # the chain's diverged pose
                        self.chain_apply_correction(
                            np.array(T_new, np.float64), f.T_wc)
                else:
                    f.T_wc = (T_new if pose_ok
                              else T_pred.astype(np.float32))
            elif pose_ok:
                f.T_wc = T_new
            else:
                # PnP failed: P3P re-localization attempt
                if cfg.do_p3p and self._p3p_fallback(T_pred):
                    if chained:
                        self.chain_apply_correction(
                            np.array(T_new, np.float64), f.T_wc)
                else:
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
        `map_manager.cpp:286-341`): one upload, one device step, and both
        readbacks (descriptors, detections) started together behind one
        event. Returns (new_rows, descriptors (N, 8) int32 words).

        The JAX package can also defer the readback and the keyframe's
        registration to the next frame (its asynchronous chained mode);
        the port registers every keyframe at once (see
        ``models/pipeline.py``)."""
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
        k = self._stage_kf.next()
        slots = self._stage_kf.upload(k, "slots", np.concatenate(
            [f.px, f.valid[:, None]], axis=1).astype(np.float32))
        img = self.cur_pyr[0]
        thresh = float(thresh)
        if img.is_cuda:   # an input of the graph (see detect_describe)
            thresh = torch.full((), thresh, dtype=torch.float32,
                                device=img.device)
        desc_all, det = detect_describe(
            img, slots[:, 0:2].contiguous(), slots[:, 2] > 0.5, thresh,
            calib=self._calib, detector=detector, cell_size=cfg.max_dist,
            max_out=cfg.max_kps, fisheye=self._fisheye)
        self._stage_kf.download(k, "desc", desc_all)
        self._stage_kf.download(k, "det", torch.cat(
            [det["kps"], det["und"], det["ok"][:, None].to(torch.float32)],
            dim=1))
        self._stage_kf.record(k)
        desc_all = self._stage_kf.read(k, "desc")
        det = self._stage_kf.read(k, "det")
        kps, und_new, ok = det[:, 0:2], det[:, 2:4], det[:, 4] > 0.5
        N = len(f.px)

        # adaptive threshold update (`feature_extractor.cpp:418-423,546-552`)
        n_det = int(ok.sum())
        cap = cfg.grid_cells[0] * cfg.grid_cells[1]
        n_free = max(cap - f.n_valid, 1)
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
        if len(new_rows):
            # chain bookkeeping: these slots exist only from the NEXT
            # dispatch on (device recurrence patched then; older in-flight
            # resolves must not touch them)
            self._slot_birth[new_rows] = self._dispatch_seq + 1
            if self._chain_S is not None:
                self._chain_patch = self._build_chain_patch(new_rows)
        self.prof.stop("1.KF_DetectDescribe")
        return new_rows, desc

    def _build_chain_patch(self, new_rows: np.ndarray):
        """Express the fresh detections at the device chain's HEAD frame:
        KLT-advance them across every in-flight frame's pyramid (one device
        hop each, no readback), so that ``patch_chain_rows`` scatters
        positions consistent with the pyramid the next chained step will
        track from. Returns one (N, 6) [row, px, und, status] tensor,
        padded with row index 1 << 20 (outside the slot rows)."""
        cfg = self.cfg
        f = self.frame
        N = cfg.max_kps
        n = len(new_rows)
        patch = np.zeros((N, 6), np.float32)
        patch[:, 0] = 1 << 20
        patch[:n, 0] = new_rows
        patch[:n, 1:3] = f.px[new_rows]
        patch[:n, 3:5] = f.px_und[new_rows]
        patch[:n, 5] = 1.0
        k = self._stage_kf.next()
        p = self._stage_kf.upload(k, "patch", patch)
        self._stage_kf.record(k)
        # only the n new rows are tracked (rows are independent)
        px_d, und_d, st_d = p[:n, 1:3], p[:n, 3:5], p[:n, 5]
        pyr_prev = self.cur_pyr
        for q in self._pendings:
            if q.get("pyr") is None:
                continue
            px_d, und_d, st_d = advance_chain_patch(
                pyr_prev, q["pyr"], px_d, st_d, self._calib,
                win=cfg.klt_win_size, iters=cfg.max_iter,
                fisheye=self._fisheye)
            pyr_prev = q["pyr"]
        out = p.clone()
        out[:n, 1:3], out[:n, 3:5], out[:n, 5] = px_d, und_d, st_d
        return out

    # ------------------------------------------------------------------ #

    def reset(self):
        """Tracking-failure reset (`SlamManager::reset`,
        `ov2slam.cpp:428-455`)."""
        self.frame = FrameState.empty(self.cfg.max_kps)
        self.motion.reset()
        self.prev_pyr = None
        self.cur_pyr = None
        self._pendings.clear()
        self._stage.clear()
        self._chain_S = None
        self._chain_pyr = None
        self._chain_patch = None
        self._chain_delta = None
        self._chain_last_time = None
        self._chain_dt = 0.0
        self._slot_birth[:] = 0
        self._kf_pyr = None
        self.initialized = self.cfg.stereo
