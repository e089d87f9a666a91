"""Estimator: local bundle adjustment + keyframe filtering.

Port of ``ov2slam_tpu/models/estimator.py`` (the reference's `Estimator`,
`src/estimator.cpp`): drives windowed BA over the covisibility graph
(`applyLocalBA`, `:67-98`) — anchored inverse depth with ``use_inv_depth``,
xyz points otherwise — and culls redundant keyframes (`mapFiltering`,
`:101-183`).

BA is a bounded solve (fixed iterations) on the estimator's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solvers.ba import ba_solve_two_pass, make_ba_params
from ..solvers.ba_invdepth import ba_solve_invdepth_two_pass, invdepth_state
from ..utils.config import SlamConfig
from ..utils.profiler import Profiler


def _on(params):
    dev = params.fx.device
    return lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)


def solve_problem(prob, rho, ray, obs_valid, params, cfg, iters=None):
    """Two-pass inverse-depth solve of a host BAProblem on the params'
    device; returns numpy (poses, points, rho, inlier, cost)."""
    t = _on(params)
    out = ba_solve_invdepth_two_pass(
        t(prob.kf_poses), t(prob.kf_fixed), t(rho), t(prob.lm_anchor),
        t(ray), t(prob.obs_kf), t(prob.obs_lm), t(prob.obs_px),
        t(prob.obs_cam), t(obs_valid), params,
        robust_th=float(cfg.robust_mono_th),
        iters_robust=iters or cfg.ba_iters,
        iters_l2=3 if cfg.apply_l2_after_robust else 0)
    return tuple(o.cpu().numpy() for o in out)


def solve_problem_xyz(prob, params, cfg, iters=None):
    """Two-pass xyz solve of a host BAProblem on the params' device;
    returns numpy (poses, points, inlier, cost)."""
    t = _on(params)
    out = ba_solve_two_pass(
        t(prob.kf_poses), t(prob.kf_fixed), t(prob.lm_pos),
        t(prob.obs_kf), t(prob.obs_lm), t(prob.obs_px), t(prob.obs_cam),
        t(prob.obs_valid), params,
        robust_th=float(cfg.robust_mono_th),
        iters_robust=iters or cfg.ba_iters,
        iters_l2=3 if cfg.apply_l2_after_robust else 0)
    return tuple(o.cpu().numpy() for o in out)


class Estimator:
    def __init__(self, cfg: SlamConfig, cam_l, cam_r, map_store):
        self.cfg = cfg
        self.map = map_store
        self.params = make_ba_params(cam_l, cam_r)
        self.prof = Profiler.instance()
        self.lc_kf_id = -1   # loop-closure-protected KF (`estimator.cpp:129-131`)

    # ------------------------------------------------------------------ #

    def local_ba(self, kfid: int, lock=None, extra_window=()) -> int:
        """Windowed BA around ``kfid`` (`Optimizer::localBA`,
        `optimizer.cpp:34-897`). Returns the number of observations used.

        ``lock``: optional map lock — held for problem build and
        write-back only; the solve runs outside it (the reference
        pattern: Ceres solves outside `map_mutex_`, write-back inside,
        `optimizer.cpp:436-479,741`).
        ``extra_window``: keyframe ids forced into the window regardless
        of covisibility score — the drain path folds skipped KFs in so
        they still get optimized (`estimator.cpp:195-214`)."""
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
            poses, points, _, inlier, _ = solve_problem(
                prob, rho, ray, obs_valid, self.params, cfg)
        else:
            poses, points, inlier, _ = solve_problem_xyz(
                prob, self.params, cfg)

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
