"""One rank of a multi-process distributed BA solve, and its launcher.

``run_ranks`` writes a ``BAProblem`` and its calibration to an ``.npz``,
starts ``world_size`` processes of this module with ``sys.executable``,
each of which joins a ``torch.distributed`` group through a ``file://``
rendezvous, solves its rows of the shard axis with
``dist_ba.distributed_ba_solve`` and, on rank 0, writes the result to
another ``.npz``. ``time_all_reduce`` starts ranks that time an
``all_reduce`` of a payload of f64 sums instead (``--all-reduce-bytes``;
the problem file is then not read). Every process is waited for with a
timeout and killed past it. Imports numpy, torch and this package only.

    python -m ov2slam_torch.parallel.worker PROBLEM.npz OUT.npz \\
        --init-method file:///tmp/pg --rank 0 --world-size 2 \\
        --n-shards 8 --iters 5 [--device cpu] [--all-reduce-bytes N]

Each rank runs on the GPU (``cuda:rank`` modulo the card count, over
NCCL) unless ``--device cpu`` is given (gloo).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
from typing import Optional

import numpy as np

_PARAMS = ("fx", "fy", "cx", "cy", "T_rl")


def save_problem(path: str, prob, params) -> None:
    """``prob``'s arrays and ``params``' fields into one ``.npz``."""
    arrays = {k: v for k, v in dataclasses.asdict(prob).items()
              if v is not None}
    arrays.update({f"param_{k}": np.asarray(getattr(params, k).cpu())
                   for k in _PARAMS})
    np.savez(path, **arrays)


def load_problem(path: str, device):
    """(BAProblem, BAParams on ``device``) from :func:`save_problem`."""
    from .. import interop

    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    params = interop.ba_params(*(state.pop(f"param_{k}") for k in _PARAMS),
                               device=device)
    return interop.ba_problem(state), params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("problem")
    ap.add_argument("out")
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the GPU")
    ap.add_argument("--n-shards", type=int, required=True)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--robust-th", type=float, default=5.9915)
    ap.add_argument("--all-reduce-bytes", type=int, default=0,
                    help="time an all_reduce of this many bytes instead")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .dist_ba import distributed_ba_solve, init_multihost, make_mesh

    from ..device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    init_multihost(args.init_method, args.world_size, args.rank, device)
    try:
        if args.all_reduce_bytes:
            ms = _time_all_reduce(args.all_reduce_bytes, device)
            if args.rank == 0:
                np.savez(args.out, ms=ms)
            return 0
        prob, params = load_problem(args.problem, device)
        mesh = make_mesh(args.n_shards, group=dist.group.WORLD)
        poses, lm, cost = distributed_ba_solve(
            mesh, prob, params, robust_th=args.robust_th, iters=args.iters,
            device=device)
        if args.rank == 0:
            np.savez(args.out, poses=poses, lm_pos=lm, cost=cost)
    finally:
        dist.destroy_process_group()
    return 0


def _time_all_reduce(n_bytes: int, device, runs: int = 20) -> float:
    """Median ms of one ``all_reduce`` over the default group of
    ``n_bytes`` of f64 on ``device`` (each timed run ends with a
    synchronize, after a warm-up)."""
    import time

    import torch
    import torch.distributed as dist

    from ..device import synchronize

    buf = torch.zeros(max(1, n_bytes // 8), dtype=torch.float64,
                      device=device)
    dist.all_reduce(buf)
    synchronize(device)
    times = []
    for _ in range(runs):
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return 1e3 * sorted(times)[len(times) // 2]


def run_ranks(prob, params, tmp_dir: str, world_size: int, n_shards: int,
              iters: int = 5, robust_th: float = 5.9915,
              device=None, timeout: float = 120.0,
              env: Optional[dict] = None):
    """Solve ``prob`` with ``n_shards`` shards over ``world_size``
    processes of this module (rendezvous in ``tmp_dir``) on ``device``'s
    type (``None`` = the GPU, raising here without one; ``"cpu"`` = gloo
    ranks). Returns rank 0's (poses (Kw, 7), lm_pos (Lw, 3), cost); raises
    if a process fails or outlives ``timeout`` seconds. ``env`` adds to
    the processes' environment."""
    from ..device import resolve_device

    dev_type = resolve_device(device).type     # raises before any I/O
    problem = os.path.join(tmp_dir, "problem.npz")
    save_problem(problem, prob, params)
    out = _launch(tmp_dir, world_size, dev_type, timeout, env, problem,
                  ["--n-shards", str(n_shards), "--iters", str(iters),
                   "--robust-th", str(robust_th)])
    with np.load(out) as z:
        return z["poses"], z["lm_pos"], float(z["cost"])


def time_all_reduce(n_bytes: int, tmp_dir: str, world_size: int,
                    device=None, timeout: float = 120.0,
                    env: Optional[dict] = None) -> float:
    """Median ms of an ``all_reduce`` of ``n_bytes`` of f64 sums across
    ``world_size`` processes of this module, one card each (``None`` =
    the GPU, NCCL; ``"cpu"`` = gloo ranks), as rank 0 times it."""
    from ..device import resolve_device

    out = _launch(tmp_dir, world_size, resolve_device(device).type,
                  timeout, env, "-",
                  ["--n-shards", str(world_size),
                   "--all-reduce-bytes", str(int(n_bytes))])
    with np.load(out) as z:
        return float(z["ms"])


def _launch(tmp_dir, world_size, dev_type, timeout, env, problem, extra):
    """Start ``world_size`` ranks of this module on ``dev_type`` with
    ``extra`` arguments, wait for them all, and return rank 0's output
    file; raises if a process fails or outlives ``timeout`` seconds."""
    out = os.path.join(tmp_dir, "result.npz")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    penv = dict(os.environ, **(env or {}))
    penv["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    init = "file://" + os.path.join(tmp_dir, "pg")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ov2slam_torch.parallel.worker", problem, out,
         "--init-method", init, "--rank", str(r), "--world-size",
         str(world_size), "--device", dev_type, *extra],
        env=penv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world_size)]
    logs, failed = [], []
    try:
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
                failed.append(f"rank {r} timed out after {timeout} s")
            else:
                if p.returncode != 0:
                    failed.append(f"rank {r} exited {p.returncode}")
            logs.append(log)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("; ".join(failed) + "\n" + "\n".join(
            f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs)))
    return out


if __name__ == "__main__":
    sys.exit(main())
