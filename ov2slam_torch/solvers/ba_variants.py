"""Post-loop-closure BA problem types on top of the inverse-depth solver.

Port of the inverse-depth branch of ``ov2slam_tpu/solvers/ba_variants.py``
(the reference's Optimizer problem types, `include/optimizer.hpp:33-67`):

- ``structure_only_ba`` — landmarks only, poses const
  (`Optimizer::structureOnlyBA`, `optimizer.cpp:2594-2781`): every pose
  gauge-fixed.
- ``loose_ba`` — all KFs in an insertion-seq range, the two oldest fixed
  (`Optimizer::looseBA`, `optimizer.cpp:900-1672`), used after loop
  closure.

``full_ba`` (the optional final pass) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .ba import BAParams
from .ba_invdepth import invdepth_state


def _solve_window(map_store, window, fixed_ids, params: BAParams,
                  cfg, max_kfs: int, max_obs: int,
                  iters: Optional[int] = None):
    from ..models.estimator import solve_problem

    if not getattr(cfg, "use_inv_depth", False):
        raise NotImplementedError(
            "ov2slam_torch: only the inverse-depth BA is ported")
    prob = map_store.build_ba_problem(
        window, fixed_ids, max_kfs=max_kfs, max_obs=max_obs)
    if prob.n_obs < 10:
        return 0
    rho, ray, obs_valid = invdepth_state(prob, params)
    poses, points, _, _, _ = solve_problem(prob, rho, ray, obs_valid,
                                           params, cfg, iters=iters)
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
