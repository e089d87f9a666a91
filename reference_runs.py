#!/usr/bin/env python3
"""Reference figures for the port's chip-smoke slices.

By default runs the JAX package's ``SlamManager`` (``ov2slam_tpu``) on the
CPU over slices of ``chip_smoke.py`` — same sequence, same config, same
frame script (``chip_smoke.drive_slice``) — and prints one JSON line per
slice with the figures ``chip_smoke.slice_outcome`` computes (A, B, E:
ATE, endpoint error; C: mono initialization, scale-aligned ATE, the
full-BA keyframe ATE; D: the relocalization's pose errors, the last
frame's error), keyframes, closures and resets. Slice E is slice B with
the device-chained front end (``pipelined_frontend``, depth 2) through the
synchronous ``SlamManager``, which is deterministic; ``chip_smoke.py``
runs the same sequence and config through the asynchronous manager,
whose runs depend on thread timing, and prints this figure beside its
gate. Slice F (paced asynchronous arrival) has no synchronous
counterpart. ``chip_smoke.py`` gates the port
against these figures. With ``--port`` it runs the port (``ov2slam_torch``) on
``--device`` (``cpu`` by default, or ``cuda``) instead. ``--seeds`` runs
once per value: the port's ``SlamManager(seed=...)``, which seeds its
RANSAC generators, or for the JAX package its PRNG keys (manager s, loop
closer s + 1000, front end s + 2000 and s + 3000, relocalizer s + 4000) in place of its fixed
ones. A seed given twice shows whether two runs agree to the last bit.

    JAX_PLATFORMS=cpu python reference_runs.py A B
    JAX_PLATFORMS=cpu python reference_runs.py C D
    JAX_PLATFORMS=cpu python reference_runs.py E
    JAX_PLATFORMS=cpu python reference_runs.py A --seeds 1 2 3
    python reference_runs.py --port A --seeds 1 2 3
    python reference_runs.py --port E
    python3 reference_runs.py --port --device cuda A --seeds 42 42 1 2 3
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time


def run(name, slam, seq, ate_rmse, lie_np):
    """Drive slice ``name`` and compute its figures (results of slices C
    and D written to a temporary directory, as chip_smoke does)."""
    import tempfile

    import chip_smoke

    t0 = time.perf_counter()
    trace = chip_smoke.drive_slice(name, slam, seq)
    wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = None
        if name in ("C", "D"):
            out_dir = tmp
            slam.write_results(tmp)
        res = chip_smoke.slice_outcome(name, slam, seq, trace, ate_rmse,
                                       lie_np, out_dir)
    _, poses = slam.estimated_trajectory()
    return poses, res, wall


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("slices", nargs="*", default=["A", "B"])
    ap.add_argument("--port", action="store_true",
                    help="run ov2slam_torch on the CPU instead of JAX")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"],
                    help="the port's device (with --port)")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="default: the port's seed 42, the JAX package's "
                    "own keys")
    args = ap.parse_args(argv)

    import chip_smoke

    if args.port:
        from ov2slam_torch.io import synthetic
        from ov2slam_torch.models.slam import SlamManager
        from ov2slam_torch.utils import lie_np, profiles
        from ov2slam_torch.utils.evaluation import ate_rmse

        def managers(cfg):
            for s in args.seeds or [42]:
                yield dict(seed=s), SlamManager(cfg, device=args.device,
                                                seed=s)
        package, backend = "ov2slam_torch", args.device
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from ov2slam_tpu.io import synthetic
        from ov2slam_tpu.models.slam import SlamManager
        from ov2slam_tpu.utils import lie_np, profiles
        from ov2slam_tpu.utils.evaluation import ate_rmse

        def managers(cfg):
            if args.seeds is None:
                yield {}, SlamManager(cfg)
            for s in args.seeds or []:
                slam = SlamManager(cfg)
                slam._rng = jax.random.PRNGKey(s)
                slam.loop_closer._rng = jax.random.PRNGKey(s + 1000)
                if slam.relocalizer is not None:
                    slam.relocalizer._rng = jax.random.PRNGKey(s + 4000)
                slam.frontend._rng = jax.random.PRNGKey(s + 2000)
                slam.frontend._key_dev = jax.random.PRNGKey(s + 3000)
                yield dict(seed=s), slam
        package, backend = "ov2slam_tpu", "cpu"

    for name in args.slices:
        seq, cfg = chip_smoke.make_slice(name, synthetic, profiles)
        for extra, slam in managers(cfg):
            poses, res, wall = run(name, slam, seq, ate_rmse, lie_np)
            print(json.dumps(dict(
                slice=name, package=package, backend=backend, **extra,
                width=seq.width, height=seq.height, frames=len(poses),
                **res, trajectory_sha1=hashlib.sha1(
                    poses.astype("<f8").tobytes()).hexdigest()[:16],
                wall_s=wall)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
