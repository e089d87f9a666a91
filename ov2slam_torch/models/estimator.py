"""Estimator: local bundle adjustment + keyframe filtering.

Port of ``ov2slam_tpu/models/estimator.py`` (the reference's `Estimator`,
`src/estimator.cpp`): drives windowed BA over the covisibility graph
(`applyLocalBA`, `:67-98`) — anchored inverse depth with ``use_inv_depth``,
xyz points otherwise — and culls redundant keyframes (`mapFiltering`,
`:101-183`).

BA is a bounded solve (fixed iterations) on the estimator's device. The
inverse-depth local BA is the JAX package's single-buffer transport: the
problem packed into one f32 vector (one upload through a pinned buffer),
:func:`~ov2slam_torch.solvers.ba_invdepth.ba_invdepth_packed` (CUDA graph
replays on a GPU), one vector read back; when a window nears its landmark
capacity, the graphs of the next capacity are built ahead of need.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..solvers.ba import ba_solve_two_pass, make_ba_params
from ..solvers.ba_invdepth import (GraphedTwoPass, ba_invdepth_packed,
                                   ba_solve_invdepth_two_pass, graphed,
                                   invdepth_state, landmark_capacity,
                                   pack_ba_invdepth, pad_landmarks,
                                   unpack_ba_invdepth)
from ..utils.config import SlamConfig
from ..utils.profiler import Profiler
from .frontend import Staging

log = logging.getLogger(__name__)


def _on(params):
    dev = params.fx.device
    return lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)


def solve_problem(prob, rho, ray, obs_valid, params, cfg, iters=None,
                  between_iters=None):
    """Two-pass inverse-depth solve of a host BAProblem on the params'
    device; returns numpy (poses, points, rho, inlier, cost).
    ``between_iters`` is called after each LM iteration."""
    t = _on(params)
    out = ba_solve_invdepth_two_pass(
        t(prob.kf_poses), t(prob.kf_fixed), t(rho), t(prob.lm_anchor),
        t(ray), t(prob.obs_kf), t(prob.obs_lm), t(prob.obs_px),
        t(prob.obs_cam), t(obs_valid), params,
        robust_th=float(cfg.robust_mono_th),
        iters_robust=iters or cfg.ba_iters,
        iters_l2=3 if cfg.apply_l2_after_robust else 0,
        between_iters=between_iters)
    return tuple(o.cpu().numpy() for o in out)


def solve_problem_xyz(prob, params, cfg, iters=None, between_iters=None):
    """Two-pass xyz solve of a host BAProblem on the params' device;
    returns numpy (poses, points, inlier, cost). ``between_iters`` is
    called after each LM iteration."""
    t = _on(params)
    out = ba_solve_two_pass(
        t(prob.kf_poses), t(prob.kf_fixed), t(prob.lm_pos),
        t(prob.obs_kf), t(prob.obs_lm), t(prob.obs_px), t(prob.obs_cam),
        t(prob.obs_valid), params,
        robust_th=float(cfg.robust_mono_th),
        iters_robust=iters or cfg.ba_iters,
        iters_l2=3 if cfg.apply_l2_after_robust else 0,
        between_iters=between_iters)
    return tuple(o.cpu().numpy() for o in out)


class Estimator:
    # over every estimator: pre-warms that built their graphs, and those
    # that raised (each logged with its traceback)
    prewarms = prewarm_failures = 0

    def __init__(self, cfg: SlamConfig, cam_l, cam_r, map_store):
        self.cfg = cfg
        self.map = map_store
        self.params = make_ba_params(cam_l, cam_r)
        self.prof = Profiler.instance()
        self.lc_kf_id = -1   # loop-closure-protected KF (`estimator.cpp:129-131`)
        self.device = self.params.fx.device
        # pinned host buffers of local BA's one upload and one readback
        self._stage = Staging(self.device, 2)
        # local BA's graph runners (GraphedTwoPass): they read this
        # estimator's params, and go with it
        self._ba_runners = {}
        self._warmed = set()     # landmark capacities used or pre-warmed
        self._next_warm = None   # (capacity, problem) for prewarm_next

    def _solve_kw(self):
        cfg = self.cfg
        return dict(robust_th=float(cfg.robust_mono_th),
                    iters_robust=cfg.ba_iters,
                    iters_l2=3 if cfg.apply_l2_after_robust else 0)

    def _prewarm_bucket(self, Lcap: int, problem) -> None:
        """Build local BA's graphs for landmark capacity ``Lcap``: an eager
        solve, then the capture (:meth:`GraphedTwoPass.warm`), of
        ``problem`` ((prob, rho, ray, obs_valid), a window) grown to
        ``Lcap`` landmark rows that no observation names, so the solve is
        well posed. The first real solve at ``Lcap`` then replays.

        Counterpart of the JAX package's ahead-of-need compile. That
        compile runs on a background thread, free of the interpreter's
        lock; this build is Python launching kernels, and on a thread it
        contended with the frames for that lock (measured on the H100 by
        chip_smoke, PERF.md §6), so it runs on the calling thread. Only
        for a window that replays graphs, once per capacity; a failure is
        logged and counted (``Estimator.prewarm_failures``), never
        swallowed."""
        prob, rho, ray, obs_valid = problem
        Kw, O = len(prob.kf_poses), len(prob.obs_kf)
        if (not self.cfg.use_inv_depth or not graphed(self.device, Kw)
                or Lcap in self._warmed):
            return
        self._warmed.add(Lcap)
        try:
            kw = self._solve_kw()
            flat = torch.from_numpy(pack_ba_invdepth(
                *pad_landmarks(prob, rho, ray, Lcap), obs_valid))
            args = unpack_ba_invdepth(flat.to(self.device), Kw, Lcap, O)
            GraphedTwoPass.runner(
                args, self.params, kw["robust_th"], kw["iters_robust"],
                kw["iters_l2"], self._ba_runners).warm(args)
            Estimator.prewarms += 1
        except Exception:
            log.exception("local BA pre-warm of capacity %d failed", Lcap)
            Estimator.prewarm_failures += 1

    def prewarm_next(self) -> None:
        """Pre-warm the next landmark capacity when :meth:`solve_packed`
        queued it. The managers call this where the solving thread holds
        up the fewest frames: the asynchronous worker when its queue is
        empty, the synchronous manager after a keyframe's local BA."""
        if self._next_warm is not None:
            nxt, self._next_warm = self._next_warm, None
            self._prewarm_bucket(*nxt)

    def solve_packed(self, prob, rho, ray, obs_valid, between_iters=None):
        """The inverse-depth two-pass solve of ``prob`` by the packed
        transport: one upload, :func:`ba_invdepth_packed`, one readback.
        On a GPU, a window whose landmarks come within one step (256) of
        its graphs' capacity queues the next capacity's pre-warm
        (:meth:`prewarm_next`): the next window may cross into it.
        (Pre-warming at a capacity's first use, as the JAX package
        compiles, costs 0.15-0.3 s of host time a run that the card's
        slices, far below the 4096-row capacity, never use; on the worker
        it dropped frames of paced arrival, PERF.md §6.) Returns numpy
        (poses (Kw, 7), points (Lw, 3), inlier (O,))."""
        Kw, Lw, O = len(prob.kf_poses), len(rho), len(prob.obs_kf)
        k = self._stage.next()
        flat = self._stage.upload(
            k, "ba_in", pack_ba_invdepth(prob, rho, ray, obs_valid))
        out = ba_invdepth_packed(flat, self.params, Kw, Lw, O,
                                 between_iters=between_iters,
                                 runners=self._ba_runners,
                                 **self._solve_kw())
        self._stage.download(k, "ba_out", out)
        self._stage.record(k)
        res = self._stage.read(k, "ba_out")
        if graphed(self.device, Kw):
            L = landmark_capacity(Lw, O)
            self._warmed.add(L)
            if Lw + 256 > L and L + 256 not in self._warmed:
                self._next_warm = (L + 256, (prob, rho, ray, obs_valid))
        return (res[:Kw * 7].reshape(Kw, 7),
                res[Kw * 7:Kw * 7 + Lw * 3].reshape(Lw, 3),
                res[Kw * 7 + Lw * 3:-1] > 0.5)

    # ------------------------------------------------------------------ #

    def local_ba(self, kfid: int, lock=None, extra_window=(),
                 between_iters=None) -> int:
        """Windowed BA around ``kfid`` (`Optimizer::localBA`,
        `optimizer.cpp:34-897`). Returns the number of observations used.

        ``lock``: optional map lock — held for problem build and
        write-back only; the solve runs outside it (the reference
        pattern: Ceres solves outside `map_mutex_`, write-back inside,
        `optimizer.cpp:436-479,741`).
        ``extra_window``: keyframe ids forced into the window regardless
        of covisibility score — the drain path folds skipped KFs in so
        they still get optimized (`estimator.cpp:195-214`).
        ``between_iters``: called after each LM iteration of the solve."""
        import contextlib

        lock = lock or contextlib.nullcontext()
        cfg = self.cfg
        m = self.map
        if m.n_keyframes < 3:
            return 0
        self.prof.start("3.LocalBA")

        with lock:
            forced = [int(k) for k in extra_window
                      if k != kfid and m.kf_valid[k]]
            cov = m.covisible_kfs(kfid, min_score=cfg.min_cov_score,
                                  max_n=cfg.local_ba_max_kfs - 1)
            if len(cov) == 0:
                cov = m.covisible_kfs(kfid, min_score=1,
                                      max_n=cfg.local_ba_max_kfs - 1)
            window = [kfid] + forced + [
                int(k) for k in cov if int(k) not in set(forced)]
            window = window[:cfg.local_ba_max_kfs]

            # gauge: fix the two oldest KFs in the window (the reference
            # fixes 1 for stereo, `optimizer.cpp:396-407`, because Ceres
            # converges the weakly-observable window-scale mode to
            # machine precision; a bounded-iteration f32 LM leaves that
            # long-valley direction under-converged, so anchoring two
            # poses pins window scale explicitly — measured 1.7x ATE win
            # on long stereo sequences), or the origin KF if present
            # (age = insertion seq — slot ids are recycled)
            by_age = sorted(window, key=lambda k: int(m.kf_seq[k]))
            n_fix = 2
            fixed = by_age[:n_fix]
            origin = [k for k in window if m.kf_seq[k] == 0]
            fixed = list(set(fixed) | set(origin))

            prob = m.build_ba_problem(
                window, fixed, max_kfs=cfg.local_ba_max_kfs,
                max_obs=cfg.local_ba_max_obs)
        if prob.n_obs < 20:
            self.prof.stop("3.LocalBA")
            return 0

        if cfg.use_inv_depth:
            # anchored inverse-depth parameterization (`buse_inv_depth`,
            # KSE3AnchInvDepth factors, `optimizer.cpp:207-290`)
            rho, ray, obs_valid = invdepth_state(prob, self.params)
            poses, points, inlier = self.solve_packed(
                prob, rho, ray, obs_valid, between_iters=between_iters)
        else:
            poses, points, inlier, _ = solve_problem_xyz(
                prob, self.params, cfg, between_iters=between_iters)

        # landmark culling: drop landmarks whose observations are mostly
        # outliers (`optimizer.cpp:805-882`) — vectorized per-landmark
        # inlier/total counts via bincount.
        # vv must be the SAME validity the solver saw: in the invdepth
        # branch that is the anchor-masked set from invdepth_state —
        # anchorless observations never entered the solve, come back with
        # inlier=False, and counting them against prob.obs_valid would
        # remove every one of them from the map as a "chi2 outlier"
        # (observed as total 3D-landmark die-off in async runs whose
        # shifting windows orphan many anchors).
        Lw = len(prob.lm_ids)
        vv = (np.asarray(obs_valid, bool) if cfg.use_inv_depth
              else prob.obs_valid)
        tot = np.bincount(prob.obs_lm[vv], minlength=Lw)[:Lw]
        good = np.bincount(prob.obs_lm[vv & inlier], minlength=Lw)[:Lw]
        lm_ok = (prob.lm_ids < 0) | (tot == 0) | (
            good >= np.maximum(2, 0.5 * tot))

        with lock:
            m.apply_ba_result(prob, poses, points, lm_ok)
            # remove the individual chi2-outlier OBSERVATIONS from the map
            # (`optimizer.cpp:492-592` collects them per factor list and
            # erases them) — leaving them in would poison every subsequent
            # window solve with the same bad measurements. A right-camera
            # outlier row only clears the stereo flag; a left-camera one
            # removes the whole observation.
            out_rows = np.nonzero(vv & ~inlier)[0]
            for r in out_rows:
                k = int(prob.kf_ids[prob.obs_kf[r]])
                l = int(prob.lm_ids[prob.obs_lm[r]])
                if k < 0 or l < 0 or not m.kf_valid[k]:
                    continue
                if (prob.kf_seq_snap is not None
                        and m.kf_seq[k] != prob.kf_seq_snap[prob.obs_kf[r]]):
                    continue
                if not m.lm_valid[l]:
                    continue
                if prob.obs_cam[r] == 1:
                    sel = m.lm_obs_kf[l] == k
                    slots = m.lm_obs_slot[l][sel]
                    for sl in slots:
                        if m.obs_lmid[k, sl] == l:
                            m.obs_is_stereo[k, sl] = False
                else:
                    m.remove_observation(k, l)
        self.prof.stop("3.LocalBA")
        return int(prob.n_obs)

    # ------------------------------------------------------------------ #

    def map_filtering(self, kfid: int):
        """Cull redundant covisible KFs: >=95% of their 3D landmarks seen
        >=4 times elsewhere (`mapFiltering`, `estimator.cpp:101-183`)."""
        cfg = self.cfg
        m = self.map
        if cfg.kf_filtering_ratio >= 1.0 or m.n_keyframes < 20:
            return
        seq_cur = int(m.kf_seq[kfid])
        for k in m.covisible_kfs(kfid, min_score=cfg.min_cov_score):
            k = int(k)
            if m.kf_seq[k] == 0 or k == kfid or k == self.lc_kf_id:
                continue
            if int(m.kf_seq[k]) >= seq_cur - 3:   # keep the most recent KFs
                continue
            lmids = m.kf_landmark_ids(k, only_3d=True)
            if len(lmids) == 0:
                continue
            n_obs = (m.lm_obs_kf[lmids] >= 0).sum(axis=1)
            if (n_obs >= 4).mean() > cfg.kf_filtering_ratio:
                m.remove_keyframe(k)
