"""The port's top-level entry points, counterparts of the repository root's
``__graft_entry__.py``:

- ``entry()`` — the flagship computation as one callable: the front end's
  forward-backward pyramidal KLT (``ops/klt.py::fb_klt_track``, ``win=9,
  iters=30``) of 256 keypoints over two 4-level pyramids of 752x480 noise
  images made from seed 0 — the same arrays as the JAX package's
  ``entry()``;
- ``dryrun_multichip(n)`` — the distributed Schur bundle adjustment
  (``parallel/dist_ba.py``) with ``n`` landmark shards on a realistic
  28-keyframe stereo window and on a skewed one, with the JAX dryrun's
  checks.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.image import build_pyramid
from .device import resolve_device
from .ops.klt import fb_klt_track
from .utils import lie_np


def entry_arrays():
    """The numpy inputs of ``entry()``: two (480, 752) f32 images and 256
    keypoints, drawn from ``default_rng(0)`` in the JAX ``entry()``'s
    order."""
    rng = np.random.default_rng(0)
    img0 = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    img1 = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    kps = rng.uniform([30, 30], [720, 450], (256, 2)).astype(np.float32)
    return img0, img1, kps


def fb_klt_entry(pyr0, pyr1, kps, priors, valid):
    """``fb_klt_track`` at the front end's window and iteration count."""
    return fb_klt_track(pyr0, pyr1, kps, priors, valid, win=9, iters=30)


def entry(device=None):
    """Returns ``(fn, args)``: ``fn(*args)`` tracks the keypoints from one
    pyramid into the other on ``device`` (``None`` = the GPU) and returns
    (tracked (256, 2), status (256,))."""
    dev = resolve_device(device)
    img0, img1, kps = entry_arrays()
    pyr0 = tuple(build_pyramid(torch.as_tensor(img0, device=dev), 4))
    pyr1 = tuple(build_pyramid(torch.as_tensor(img1, device=dev), 4))
    k = torch.as_tensor(kps, device=dev)
    valid = torch.ones(256, dtype=torch.bool, device=dev)
    return fb_klt_entry, (pyr0, pyr1, k, k, valid)


def mean_t_err(poses, prob, gt_poses) -> float:
    """Mean translation error (m) of a BA window's live poses against the
    ground truth of its keyframes."""
    live = prob.kf_ids >= 0
    _, t = lie_np.pose_distance(poses[live].astype(np.float64),
                                gt_poses[: live.sum()].astype(np.float64))
    return float(np.mean(t))


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """Run the distributed BA solve with ``n_shards`` in-process landmark
    shards on ``device`` (``None`` = the GPU) over two problems built
    through the actual MapStore (``parallel/problems.py``): a 28-KF
    covisibility-sparse stereo window with 10k+ observations (seed 0), and
    the skewed one with 25% hub landmarks seen from most of the window
    (seed 1), where the LPT-balanced assignment must keep shard padding
    below 15%. Each must give finite poses and cost and lower the mean
    translation error in 3 iterations. Raises on a failed check; returns
    the figures it prints."""
    from .parallel.dist_ba import (distributed_ba_solve, shard_ba_problem,
                                   shard_padding_overhead)
    from .parallel.problems import realistic_window_problem

    out = {}
    for name, seed, skew in (("uniform", 0, 0.0), ("skewed", 1, 0.25)):
        _, prob, params, gt = realistic_window_problem(
            n_kf=28, n_lm=6000, seed=seed, skew=skew, device=device)
        n_obs = int(prob.obs_valid.sum())
        pad = shard_padding_overhead(shard_ba_problem(prob, n_shards))
        if skew:
            _check(pad < 0.15, f"skewed-shard padding {pad:.1%} too high")
        else:
            _check(n_obs >= 10_000, f"problem too small: {n_obs} obs")
        poses, _, cost = distributed_ba_solve(
            n_shards, prob, params, robust_th=5.9915, iters=3,
            device=device)
        _check(bool(np.isfinite(poses).all()) and bool(np.isfinite(cost)),
               f"{name}: poses or cost not finite")
        t0 = mean_t_err(prob.kf_poses, prob, gt)
        t1 = mean_t_err(poses, prob, gt)
        _check(t1 < t0, f"{name}: mean |t| error rose {t0:.4f} -> {t1:.4f}")
        print(f"dryrun_multichip({n_shards}) {name}: 28-KF/{n_obs}-obs "
              f"distributed BA OK, cost={cost:.1f}, shard padding "
              f"{pad:.1%}, mean |t| err {t0:.4f} -> {t1:.4f}", flush=True)
        out[name] = dict(obs=n_obs, padding=pad, cost=cost,
                         t_err_before=t0, t_err_after=t1)
    return out
