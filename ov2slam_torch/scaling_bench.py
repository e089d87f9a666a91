"""Distributed-BA scaling on one card: the port's counterpart of the root
``scaling_bench.py``.

The 28-keyframe, 6000-landmark MapStore window
(``parallel/problems.py::realistic_window_problem``) solved by the sharded
Schur step (``parallel/dist_ba.py``) with 1, 2, 4 and 8 shards, all in
this process on one device (the shard axis is batched, so one set of
launches serves every shard). Measured, per shard count:

- the per-shard observation load after the LPT balanced assignment, its
  work efficiency (ideal load over the padded one) and padding;
- ``reduction_bytes``: what one LM iteration all-reduces when the shards
  are spread over processes (Hpp, bp, S_corr, b_corr and the two costs,
  as f64 sums; 0 for one shard); the JAX script's ``psum_bytes`` counts
  its compiled psum operands instead;
- ``lm_iter_ms``: the best of 3 solves of 5 LM iterations over 5, each
  ending with a synchronize, and the final cost;

and the skewed window (25% far-field hub landmarks seen from most of the
window) at 8 shards, with the contiguous split's efficiency for contrast,
solved for 3 iterations. With two or more cards the 8-shard solve also
runs as 2, 4 and 8 NCCL ranks (``parallel/worker.py::run_ranks``), as
many as there are cards; with one it prints ``"nccl: skipped, 1
device"``. No link time is modelled.

Prints ONE JSON line, naming the device.

    python -m ov2slam_torch.scaling_bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .device import resolve_device, synchronize
from .roofline import device_record, reduction_bytes

SHARDS = (1, 2, 4, 8)
WINDOW = dict(n_kf=28, n_lm=6000)
ITERS = 5
SKEW = 0.25
ROBUST_TH = 5.9915


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def shard_figures(prob, n: int):
    """The shard arrays of ``prob`` at ``n`` shards and their load: per-
    shard observations (padded), work efficiency and padding share."""
    from .parallel.dist_ba import shard_ba_problem, shard_padding_overhead

    n_obs = int(np.sum(prob.obs_valid))
    shard_np = shard_ba_problem(prob, n)
    per_shard = int(shard_np["obs_valid"].shape[1])
    return shard_np, dict(obs_per_shard=per_shard,
                          efficiency=(n_obs / n) / per_shard,
                          padding=shard_padding_overhead(shard_np))


def skew_figures(prob, n: int):
    """The balanced split's load of a skewed window at ``n`` shards, and
    a contiguous split's efficiency for contrast (it pads every shard to
    the densest block of landmarks)."""
    shard_np, fig = shard_figures(prob, n)
    n_obs = int(np.sum(prob.obs_valid))
    counts = np.bincount(np.maximum(prob.obs_lm, 0)[prob.obs_valid],
                         minlength=len(prob.lm_ids))
    blocks = np.array_split(np.arange(len(counts)), n)
    contig_max = max(int(counts[b].sum()) for b in blocks)
    return shard_np, dict(n_shards=n, n_obs=n_obs,
                          efficiency=fig["efficiency"],
                          padding=fig["padding"],
                          contiguous_efficiency=(n_obs / n)
                          / max(contig_max, 1))


def _solve(prob, params, shard_np, n, iters, dev):
    """A solver for ``prob``'s shard arrays over ``n`` in-process shards:
    returns ``run()`` -> (poses, lm_pos, cost) tensors on ``dev``."""
    from .parallel import dist_ba

    mesh = dist_ba.make_mesh(n)
    shards = dist_ba.put_sharded(mesh, shard_np, len(prob.kf_ids), dev)
    step = dist_ba.make_distributed_ba(mesh, params, ROBUST_TH, iters)
    poses = torch.as_tensor(prob.kf_poses, device=dev)
    fixed = torch.as_tensor(prob.kf_fixed, device=dev)
    return lambda: step(poses, fixed, shards)


def run(dev):
    """The sweep, the skewed row and (with two or more cards) the NCCL
    rows on ``dev``; returns the result line as a dict."""
    from .parallel.problems import realistic_window_problem

    _, prob, params, _ = realistic_window_problem(**WINDOW, device=dev)
    n_obs = int(np.sum(prob.obs_valid))
    Kw = len(prob.kf_ids)
    log(f"{Kw} KFs, {n_obs} obs on {dev}")

    sweep = []
    for n in SHARDS:
        shard_np, fig = shard_figures(prob, n)
        solve = _solve(prob, params, shard_np, n, ITERS, dev)
        out = solve()
        synchronize(dev)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = solve()
            synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        sweep.append(dict(n_shards=n, **fig,
                          reduction_bytes=reduction_bytes(Kw) if n > 1
                          else 0,
                          lm_iter_ms=best / ITERS * 1e3,
                          cost=float(out[2])))
        log(f"n={n}: eff={fig['efficiency']:.1%} pad={fig['padding']:.2%} "
            f"{best / ITERS * 1e3:.2f} ms/iter")

    # skewed covisibility: hub landmarks seen from most of the window
    _, sk_prob, _, _ = realistic_window_problem(**WINDOW, skew=SKEW,
                                                device=dev)
    n = SHARDS[-1]
    sk_shard, skew = skew_figures(sk_prob, n)
    # the skewed problem must also SOLVE on the shards
    out = _solve(sk_prob, params, sk_shard, n, 3, dev)()
    skew["cost"] = float(out[2])
    log(f"skew: eff={skew['efficiency']:.1%} (contiguous would be "
        f"{skew['contiguous_efficiency']:.1%}), cost={skew['cost']:.1f}")

    eff8 = sweep[-1]["efficiency"]
    return {
        "metric": "dist_ba_8shard",
        "value": eff8,
        "unit": "work-scaling efficiency (balanced shards)",
        "vs_baseline": eff8 / 0.70,   # BASELINE.md: >= 70%
        "problem": f"{Kw} KFs / {WINDOW['n_lm']} lms / {n_obs} obs "
                   "(MapStore window)",
        "sweep": sweep,
        "skew": skew,
        "nccl": nccl_rows(prob, params, dev),
        "note": "shards in one process on one device; lm_iter_ms from the "
                "host clock around a synchronized solve; reduction_bytes: "
                "the f64 sums one LM iteration all-reduces across ranks",
    }


def nccl_rows(prob, params, dev, n_shards: int = 8):
    """With two or more cards: the 8-shard solve as 2, 4 and 8 NCCL ranks
    (one card each, as many as there are), each rank a process of
    ``parallel/worker.py``; the cost and the poses' largest difference
    from the in-process solve's."""
    import tempfile

    from .parallel import dist_ba, worker
    from .utils import lie_np

    if dev.type != "cuda":
        return "skipped (cpu)"
    if torch.cuda.device_count() < 2:
        log("nccl: skipped, 1 device")
        return "skipped, 1 device"
    ref, _, _ = dist_ba.distributed_ba_solve(n_shards, prob, params,
                                             robust_th=ROBUST_TH,
                                             iters=ITERS, device=dev)
    rows = []
    for ranks in (2, 4, 8):
        if ranks > torch.cuda.device_count():
            break
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            poses, _, cost = worker.run_ranks(prob, params, tmp, ranks,
                                              n_shards, iters=ITERS,
                                              robust_th=ROBUST_TH,
                                              timeout=600)
        rot, tr = lie_np.pose_distance(poses.astype(np.float64),
                                       ref.astype(np.float64))
        rows.append(dict(ranks=ranks, shards=n_shards, cost=cost,
                         vs_in_process_m=float(tr.max()),
                         vs_in_process_rad=float(rot.max()),
                         wall_s=time.perf_counter() - t0))
        log(f"nccl: {json.dumps(rows[-1])}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the GPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = run(dev)
    res["device"] = device_record(dev)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
