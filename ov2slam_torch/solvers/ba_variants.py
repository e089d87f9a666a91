"""The remaining Optimizer problem types, on top of the BA solvers.

Port of ``ov2slam_tpu/solvers/ba_variants.py`` (the reference's Optimizer
problem types, `include/optimizer.hpp:33-67`). Each solves with the
anchored inverse-depth BA when ``use_inv_depth`` is set (as the reference
does for every problem type) and with the xyz BA otherwise:

- ``structure_only_ba`` — landmarks only, poses const
  (`Optimizer::structureOnlyBA`, `optimizer.cpp:2594-2781`): every pose
  gauge-fixed.
- ``loose_ba`` — all KFs in an insertion-seq range, the two oldest fixed
  (`Optimizer::looseBA`, `optimizer.cpp:900-1672`), used after loop
  closure.
- ``full_ba`` — every KF, the oldest fixed (two for mono), twice the
  local BA's iterations (`Optimizer::fullBA`, `optimizer.cpp:1674-2332`):
  the optional final pass (``do_full_ba``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from .ba import BAParams
from .ba_invdepth import invdepth_state


def _solve_window(map_store, window, fixed_ids, params: BAParams,
                  cfg, max_kfs: int, max_obs: int,
                  iters: Optional[int] = None):
    from ..models.estimator import solve_problem, solve_problem_xyz

    prob = map_store.build_ba_problem(
        window, fixed_ids, max_kfs=max_kfs, max_obs=max_obs)
    if prob.n_obs < 10:
        return 0
    if getattr(cfg, "use_inv_depth", False):
        rho, ray, obs_valid = invdepth_state(prob, params)
        poses, points, _, _, _ = solve_problem(prob, rho, ray, obs_valid,
                                               params, cfg, iters=iters)
    else:
        poses, points, _, _ = solve_problem_xyz(prob, params, cfg,
                                                iters=iters)
    map_store.apply_ba_result(prob, poses, points)
    return int(prob.n_obs)


def structure_only_ba(map_store, kf_ids: Sequence[int], params: BAParams,
                      cfg) -> int:
    """Refine only the landmarks observed by ``kf_ids``; poses constant."""
    window = [int(k) for k in kf_ids if map_store.kf_valid[k]]
    return _solve_window(
        map_store, window, window, params, cfg,
        max_kfs=min(len(window) + 1, cfg.local_ba_max_kfs),
        max_obs=cfg.local_ba_max_obs)


def loose_ba(map_store, kf_min: int, kf_max: int, params: BAParams,
             cfg) -> int:
    """BA over the keyframes created between ``kf_min`` and ``kf_max``
    (inclusive, by insertion seq — slot ids are recycled); the two oldest
    are gauge-fixed (post-LC refinement)."""
    m = map_store
    s_lo, s_hi = int(m.kf_seq[kf_min]), int(m.kf_seq[kf_max])
    window = [int(k) for k in m.kfs_by_seq()
              if s_lo <= m.kf_seq[k] <= s_hi]
    if len(window) < 3:
        return 0
    fixed = window[:2]
    cap_kfs = max(cfg.local_ba_max_kfs, len(window))
    return _solve_window(map_store, window, fixed, params, cfg,
                         max_kfs=cap_kfs, max_obs=4 * cfg.local_ba_max_obs)


def full_ba(map_store, params: BAParams, cfg,
            iters: Optional[int] = None) -> int:
    """Global BA over every valid keyframe; the oldest (and the next oldest
    for the mono gauge) fixed. The reference runs it only at shutdown when
    ``do_full_ba`` is set (`ov2slam.cpp:600-615`)."""
    window = [int(k) for k in map_store.kfs_by_seq()]
    if len(window) < 3:
        return 0
    n_fix = 1 if cfg.stereo else 2
    return _solve_window(
        map_store, window, window[:n_fix], params, cfg,
        max_kfs=len(window), max_obs=8 * cfg.local_ba_max_obs,
        iters=iters or 2 * cfg.ba_iters)
