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
counterpart. Slice G fuses the CARLA rig's 180 RGB-D frames into the TSDF
volume and prints ``chip_smoke.slice_g_figures``; slice H writes the
KITTI- and TartanAir-layout directories and runs the root ``run_slam.py``
over them in-process (``--port``: ``python -m ov2slam_torch.run_slam``).
Slice I solves chip_smoke's three distributed-BA problems (the JAX
dryrun's two 28-keyframe windows and the 64-keyframe one) with 8 shards:
the JAX package on 8 virtual CPU devices, the port with 8 in-process
shards. Slice Q is one run of the protocol bench's ``fast_arc`` cell at
1000 frames (``tools/protocol_bench.py``, or ``--port``:
``ov2slam_torch.protocol_bench``). Slice P is test_pipeline.py::
test_async_paced_arrival_bench_conditions on the port, with
the front end's wait and map lock as ``--rule`` says (once per
``--seeds`` value: the runs differ by timing only); with ``--port`` and
``--rule``, slices E and F run as ``chip_smoke.run_async_slice`` does,
under that rule. ``chip_smoke.py``
gates the port against these figures. With ``--port`` it runs the port
(``ov2slam_torch``) instead, on ``--device``: the GPU by default (it
raises without one), or ``--device cpu``; slice P runs on that device
too. The JAX package always runs on the CPU. ``--seeds`` runs
once per value: the port's ``SlamManager(seed=...)``, which seeds its
RANSAC generators, or for the JAX package its PRNG keys (manager s, loop
closer s + 1000, front end s + 2000 and s + 3000, relocalizer s + 4000) in place of its fixed
ones. A seed given twice shows whether two runs agree to the last bit.
``--pose plain`` (with ``--port``) routes every caller of the pose
functions (``essential_ransac``, ``pnp_refine``) to their plain versions,
on the card too, so that one call can hold the kernels' runs against the
plain path's. ``--ba plain`` does the same for local BA's dense step
(``normal_equations``, ``schur_step``, ``lm_accept``); ``--ba all_rows``
also keeps the rows that are not valid in the solve's bins, as the step
did before its kernels.

    JAX_PLATFORMS=cpu python reference_runs.py A B
    JAX_PLATFORMS=cpu python reference_runs.py C D
    JAX_PLATFORMS=cpu python reference_runs.py E
    JAX_PLATFORMS=cpu python reference_runs.py G H
    JAX_PLATFORMS=cpu python reference_runs.py I
    JAX_PLATFORMS=cpu python reference_runs.py Q
    python3 reference_runs.py --port I
    python reference_runs.py --port --device cpu P --rule jax-wait \
        --seeds 1 2 3
    python3 reference_runs.py --port --rule jax-wait E F
    JAX_PLATFORMS=cpu python reference_runs.py A --seeds 1 2 3
    python reference_runs.py --port --device cpu A --seeds 1 2 3
    python reference_runs.py --port --device cpu E
    python3 reference_runs.py --port A --seeds 42 42 1 2 3
    python3 reference_runs.py --port --pose plain A --seeds 42 1 2 3
    python3 reference_runs.py --port --ba plain A --seeds 42 1 2 3 4 5
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
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


def run_g(args):
    """Slice G: the CARLA rig's 180 RGB-D frames (rendered with
    ``chip_smoke.render_rgbd`` on the CPU) fused into slice G's volume of
    the JAX package (or of the port with ``--port``), then the figures
    ``chip_smoke.slice_g_figures`` gates on. The ms per integration is a
    CPU figure."""
    import tempfile

    import chip_smoke

    if args.port:
        from ov2slam_torch.mapping import tsdf
        vol = chip_smoke.slice_g_volume(tsdf, args.device)
        package = "ov2slam_torch"
    else:
        from ov2slam_tpu.mapping import tsdf
        vol = chip_smoke.slice_g_volume(tsdf)
        package = "ov2slam_tpu"
    scene = chip_smoke.street_scene()
    K = chip_smoke.rig_intrinsics()
    walls = []
    for T_wc in chip_smoke.rig_poses():
        depth, rgb = chip_smoke.render_rgbd(scene, T_wc, K, "cpu")
        t0 = time.perf_counter()
        vol.integrate(depth.numpy(), K, T_wc, rgb=rgb.numpy())
        if args.port:
            from ov2slam_torch.device import synchronize
            synchronize(vol.device)
        else:
            vol.tsdf.block_until_ready()
        walls.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        figs = chip_smoke.slice_g_figures(vol, scene, tmp)
    return dict(slice="G", package=package,
                backend=args.device if args.port else "cpu",
                integrations=vol.n_integrated,
                integrate_ms_median=1e3 * sorted(walls)[len(walls) // 2],
                **figs)


def run_h(part, args):
    """Slice H: the KITTI-layout (``part`` "kitti") or TartanAir-layout
    ("tartanair") directory chip_smoke writes, through the root
    ``run_slam.py`` (the JAX package) or, with ``--port``, through
    ``python -m ov2slam_torch.run_slam --device``. Returns the report."""
    import contextlib
    import io
    import tempfile

    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        argv = chip_smoke.write_slice_h(part, tmp)
        t0 = time.perf_counter()
        if args.port:
            from ov2slam_torch import run_slam

            report, slam = run_slam.main(argv + ["--device", args.device])
            resets = int(slam.n_resets)
        else:
            import jax

            import run_slam

            # the root script points JAX's compilation cache at a fixed
            # directory in the home; this run keeps no cache
            update = jax.config.update

            def no_cache(key, value):
                if "cache" not in key:
                    update(key, value)
            k = argv.index("--save-map")      # the port's flag only
            root_argv = argv[:k] + argv[k + 2:]
            buf = io.StringIO()
            jax.config.update = no_cache
            try:
                with contextlib.redirect_stdout(buf):
                    sys.argv = ["run_slam.py"] + root_argv
                    run_slam.main()
            finally:
                jax.config.update = update
            report = json.loads(buf.getvalue().strip().splitlines()[-1])
            resets = None
        wall = time.perf_counter() - t0
        files = chip_smoke.result_files(argv)
    return dict(slice="H", part=part,
                package="ov2slam_torch" if args.port else "ov2slam_tpu",
                backend=args.device if args.port else "cpu", **report,
                resets=resets, files=files, run_s=wall)


def run_i(args):
    """Slice I: the distributed Schur BA over ``chip_smoke``'s three
    problems (the JAX dryrun's two 28-KF windows, 3 LM iterations, and the
    64-KF window, 5) with 8 shards: the JAX package's
    ``distributed_ba_solve`` on 8 virtual CPU devices, or with ``--port``
    the port's with 8 in-process shards on ``--device``. Yields, per
    problem, the mean |t| error before and after and the cost."""
    import chip_smoke
    from ov2slam_torch.entry import mean_t_err

    if args.port:
        from ov2slam_torch.parallel import dist_ba, problems
        mesh, package = 8, "ov2slam_torch"

        def build(kw):
            return problems.realistic_window_problem(**kw,
                                                     device=args.device)

        def solve(prob, params, iters):
            return dist_ba.distributed_ba_solve(
                mesh, prob, params, robust_th=chip_smoke.SLICE_I_ROBUST_TH,
                iters=iters, device=args.device)
    else:
        import jax

        from ov2slam_tpu.parallel import dist_ba, problems
        if len(jax.devices()) < 8:
            raise SystemExit("reference_runs: slice I needs 8 devices")
        mesh, package = dist_ba.make_mesh(jax.devices()[:8]), "ov2slam_tpu"

        def build(kw):
            return problems.realistic_window_problem(**kw)

        def solve(prob, params, iters):
            return dist_ba.distributed_ba_solve(
                mesh, prob, params, robust_th=chip_smoke.SLICE_I_ROBUST_TH,
                iters=iters)

    for name, kw, iters in chip_smoke.SLICE_I_PROBLEMS:
        _, prob, params, gt = build(kw)
        t0 = time.perf_counter()
        poses, _, cost = solve(prob, params, iters)
        wall = time.perf_counter() - t0
        yield dict(slice="I", problem=name, package=package,
                   backend=args.device if args.port else "cpu", shards=8,
                   keyframes=len(prob.kf_ids),
                   obs=int(prob.obs_valid.sum()), iters=iters,
                   t_err_before=mean_t_err(prob.kf_poses, prob, gt),
                   t_err_after=mean_t_err(poses, prob, gt),
                   cost=cost, wall_s=wall)


def run_q(args):
    """Slice Q: the JAX package's ``tools/protocol_bench.py``, one run of
    the ``fast_arc`` cell at 1000 frames (throughput and 20 fps online),
    on the CPU, with its persistent compilation cache (a directory in the
    home) off and its records written to a temporary file; or, with
    ``--port``, ``ov2slam_torch.protocol_bench`` on ``--device``. Returns
    the records."""
    import tempfile

    argv = ["--cells", "fast_arc", "--runs", "1", "--frames", "1000"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "runs.jsonl")
        if args.port:
            from ov2slam_torch import protocol_bench

            protocol_bench.main(argv + ["--out", out, "--device",
                                        args.device])
        else:
            import jax

            sys.path.insert(0, os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "tools"))
            import protocol_bench

            update = jax.config.update

            def no_cache(key, value):
                if "cache" not in key:
                    update(key, value)
            jax.config.update = no_cache
            sys.argv = ["protocol_bench.py"] + argv + ["--out", out]
            try:
                protocol_bench.main()
            finally:
                jax.config.update = update
        with open(out) as f:
            return [json.loads(x) for x in f]


def paced_manager(rule: str):
    """The port's ``AsyncSlamManager`` with the front end's wait and lock
    as ``rule`` says: "tree" (as the package stands: a frame waits until
    every queued keyframe is mapped and holds the map lock for the whole
    frame), "jax-wait" (the JAX package's wait, past one unmapped
    keyframe), or "narrow-lock" (the steady chained state dispatches its
    launches outside the map lock; resolving a frame stays under it)."""
    from ov2slam_torch.models.pipeline import AsyncSlamManager
    from ov2slam_torch.models.slam import SlamManager

    class Paced(AsyncSlamManager):
        def _wait_for_mapping(self, allowed: int):
            with self._pending_cv:
                deadline = float(self.cfg.backpressure_wait_s)
                while self._unmapped > allowed and deadline > 0:
                    self._pending_cv.wait(0.05)
                    deadline -= 0.05

        def process_frame(self, img_left, img_right=None, time=0.0):
            self.frontend.wait_pending()
            self._wait_for_mapping(1 if rule == "jax-wait" else 0)
            fe = self.frontend
            steady = False
            if rule == "narrow-lock":
                with self.map_lock:
                    steady = (self.cfg.pipelined_frontend
                              and self._pipeline_ready(fe))
                    if steady:
                        if fe.n_pending >= max(1, self.cfg.pipeline_depth):
                            self._resolve_oldest()
                        steady = self._pipeline_ready(fe)
            if steady:
                self.frame_id += 1
                fe.dispatch_frame(img_left, time)
                self._prev_rights.append(img_right)
                return fe.frame.T_wc
            with self.map_lock:
                return SlamManager.process_frame(self, img_left, img_right,
                                                 time)

    if rule not in ("tree", "jax-wait", "narrow-lock"):
        raise SystemExit(f"reference_runs: unknown rule {rule}")
    return Paced if rule != "tree" else AsyncSlamManager


def run_paced(rule: str, device: str):
    """test_pipeline.py::test_async_paced_arrival_bench_conditions on the
    port (``chip_smoke.paced_arrival``, slice F's stream and config) on
    ``device`` with the front end's ``rule``: frames dropped, ATE, and the
    worker's local BA and stereo-mapping ms per keyframe."""
    import numpy as np
    import torch

    import chip_smoke
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.utils import profiles
    from ov2slam_torch.utils.evaluation import ate_rmse
    from ov2slam_torch.utils.profiler import Profiler

    if device == "cpu":
        torch.set_num_threads(1)
    seq = synthetic.stream_sequence(**chip_smoke.slice_configs()["F"][0],
                                    realism=synthetic.DEFAULT_REALISM)
    frames = list(seq)
    cfg = chip_smoke.slice_config("F", seq, profiles)
    slam = paced_manager(rule)(cfg, device=device)
    prof = Profiler.instance()
    prof.reset()
    try:
        dropped, pace_fps, med, *_ = chip_smoke.paced_arrival(slam,
                                                              frames)
        times, poses = slam.estimated_trajectory()
    finally:
        slam.close()
    gt = np.asarray(seq.gt_poses)
    idx = np.clip(np.searchsorted(np.asarray(seq.times), times), 0,
                  len(gt) - 1)
    st = prof.stats()
    paced = len(frames) - chip_smoke.SLICE_F_WARM
    ate = ate_rmse(poses, gt[idx], align_scale=False)
    return dict(slice="F", rule=rule, package="ov2slam_torch",
                backend=device, dropped=dropped, paced_frames=paced,
                pace_fps=pace_fps, flat_out_fps=1.0 / med, ate_m=ate,
                worker_errors=slam.n_worker_errors,
                local_ba_ms=st.get("3.LocalBA", {}).get("mean_ms"),
                stereo_map_ms=st.get("2.KF_StereoMap", {}).get("mean_ms"),
                passed=bool(dropped <= chip_smoke.SLICE_F_MAX_DROP_SHARE
                            * paced and ate < chip_smoke.SLICE_F_MAX_ATE))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("slices", nargs="*", default=["A", "B"])
    ap.add_argument("--port", action="store_true",
                    help="run ov2slam_torch instead of JAX (on the CPU)")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="the port's device, with --port and for slice P "
                    "(default: the GPU)")
    ap.add_argument("--rule", default=None,
                    choices=["tree", "jax-wait", "narrow-lock"],
                    help="the front end's wait and lock rule: slice P (the "
                    "paced-arrival test on the port), or with --port "
                    "slices E and F")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="default: the port's seed 42, the JAX package's "
                    "own keys")
    ap.add_argument("--pose", default="kernel", choices=["kernel", "plain"],
                    help="with --port: the pose functions' kernels (the "
                    "wrappers) or their plain versions")
    ap.add_argument("--ba", default="kernel",
                    choices=["kernel", "plain", "all_rows"],
                    help="with --port: local BA's dense-step kernels (the "
                    "wrappers), their plain versions, or those on bins "
                    "that keep the rows that are not valid")
    args = ap.parse_args(argv)

    import chip_smoke

    if args.port or "P" in args.slices:
        from ov2slam_torch.device import resolve_device

        args.device = resolve_device(args.device).type

    if args.port:
        from ov2slam_torch.io import synthetic
        from ov2slam_torch.models.slam import SlamManager
        from ov2slam_torch.utils import lie_np, profiles
        from ov2slam_torch.utils.evaluation import ate_rmse

        def managers(cfg):
            # each run happens between two yields, so inside the swap
            with (chip_smoke.Swap.plain_pose() if args.pose == "plain"
                  else contextlib.nullcontext()), (
                      chip_smoke.Swap.plain_ba(args.ba == "all_rows")
                      if args.ba != "kernel" else contextlib.nullcontext()):
                for s in args.seeds or [42]:
                    yield dict(seed=s, pose=args.pose, ba=args.ba), \
                        SlamManager(cfg, device=args.device, seed=s)
        package, backend = "ov2slam_torch", args.device
    else:
        # slice I shards over 8 virtual CPU devices; the flag must be set
        # before JAX starts its backend
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
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
        if name == "P":
            for _ in args.seeds or [0]:      # one run per value given
                print(json.dumps(run_paced(args.rule or "tree",
                                           args.device)), flush=True)
            continue
        if args.port and args.rule and name in ("E", "F"):
            # chip_smoke's asynchronous slice with the front end's rule
            import torch

            from ov2slam_torch.models import pipeline
            pipeline.AsyncSlamManager = paced_manager(args.rule)
            r = chip_smoke.run_async_slice(name, torch.device(args.device))
            print(json.dumps(dict(rule=args.rule, **r)), flush=True)
            continue
        if name == "G":
            print(json.dumps(run_g(args)), flush=True)
            continue
        if name == "I":
            for r in run_i(args):
                print(json.dumps(r), flush=True)
            continue
        if name == "Q":
            for r in run_q(args):
                print(json.dumps(r), flush=True)
            continue
        if name == "H":
            for part in ("kitti", "tartanair"):
                print(json.dumps(run_h(part, args)), flush=True)
            continue
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
