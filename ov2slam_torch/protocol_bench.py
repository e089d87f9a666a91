"""Protocol-scale benchmark of the port: the reference's EuRoC replay
protocol (`benchmark_scripts/euroc_bench.sh:3-20`: 1,800-3,700-frame
sequences, 5 runs each, `rosbag play -r 1.0` real-time arrival) on
photometrically-realistic rendered sequences at full 752x480 resolution,
as the JAX package's ``tools/protocol_bench.py`` runs it.

Each (config x sequence) cell runs N times with different render seeds
(100 + run) in two modes per run, both through ``AsyncSlamManager`` with
the chained front end at depth 2 after 30 warm frames:

  throughput  flat-out feeding: net frames/s with mapping/BA/LC
              overlapped on the worker,
  online      frames arrive on the 20 fps protocol clock; when processing
              falls a full frame behind, the arrival queue drops to the
              newest frame (`force_realtime`, `ov2slam.cpp:292-299`;
              ``bench.paced_replay``).

Appends one JSON line per run to ``--out`` (``protocol_runs.jsonl`` beside
this module), each naming the device it ran on. A run that raises, or
whose worker raised, is written as a record with an ``error`` and the
process exits non-zero at the end.

    python -m ov2slam_torch.protocol_bench [--frames 1000] [--runs 5] \\
        [--cells fast_arc,accurate_arc,fast_revisit] [--smoke] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

from .bench import log, paced_replay, timestamp_errors
from .device import resolve_device, synchronize
from .roofline import device_record

CELLS = {
    # name: (profile, kind, loop_closer)
    "fast_arc": ("fast", "arc", False),
    "average_arc": ("average", "arc", False),
    "accurate_arc": ("accurate", "arc", False),
    "fast_revisit": ("fast", "revisit_y", True),
    "fast_lawnmower": ("fast", "lawnmower", True),
}
N_WARM = 30


def render(n_frames, kind, seed):
    from .io.synthetic import DEFAULT_REALISM, stream_sequence

    t0 = time.perf_counter()
    seq = stream_sequence(
        n_frames=n_frames, stereo=True, width=752, height=480,
        n_points=12000, seed=seed, kind=kind, speed=0.05,
        realism=DEFAULT_REALISM)
    frames = list(seq)
    render_s = time.perf_counter() - t0
    log(f"rendered {n_frames}f {kind} seed={seed} ({render_s:.0f}s)")
    return seq, frames, render_s


def run_once(seq, frames, profile, use_lc, pace_fps, dev):
    from .models.pipeline import AsyncSlamManager
    from .utils.profiles import apply_profile

    cfg = seq.make_config()
    apply_profile(cfg, profile)
    cfg.pipelined_frontend = True
    cfg.pipeline_depth = 2
    cfg.use_loop_closer = use_lc
    if pace_fps:
        cfg.backpressure_wait_s = 2.0 / pace_fps
    cfg.validate()
    mgr = AsyncSlamManager(cfg, device=dev)
    try:
        for left, right, t in frames[:N_WARM]:
            mgr.process_frame(left, right, t)
        arr = paced_replay(frames, lambda f: mgr.process_frame(*f), N_WARM,
                           pace_fps)
        synchronize(dev)
        wall = time.perf_counter() - arr.t_start
        n_proc = len(arr.processed)
        mgr.flush()
        ate, end_err = timestamp_errors(seq, *mgr.estimated_trajectory())
        gt = np.asarray(seq.gt_poses)
        span = float(np.linalg.norm(gt[1:, 4:7] - gt[:-1, 4:7],
                                    axis=1).sum())
        return dict(
            fps_net=n_proc / wall, ate_m=ate, end_err_m=end_err,
            traj_len_m=span, n_kf=int(mgr.map.n_keyframes),
            n_lm=int(mgr.map.n_landmarks_3d),
            n_closures=int(mgr.loop_closer.n_closures) if use_lc else 0,
            n_dropped=int(arr.n_dropped), n_proc=int(n_proc),
            n_resets=int(mgr.n_resets),
            n_worker_errors=int(mgr.n_worker_errors),
        )
    finally:
        mgr.close()


def main(argv=None) -> int:
    """Run the cells, append a record per run; 0 when no run failed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--cells", default="fast_arc,accurate_arc,fast_revisit")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "protocol_runs.jsonl"))
    ap.add_argument("--smoke", action="store_true",
                    help="120 frames, 1 run, fast_arc only")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the GPU")
    args = ap.parse_args(argv)
    if args.smoke:
        args.frames, args.runs, args.cells = 120, 1, "fast_arc"
    cells = args.cells.split(",")
    unknown = [c for c in cells if c not in CELLS]
    if unknown:
        ap.error(f"unknown cell(s) {unknown}")

    dev = resolve_device(args.device)
    device = device_record(dev)
    log(f"device: {json.dumps(device)}")

    n_failed = 0
    for cell in cells:
        profile, kind, use_lc = CELLS[cell]
        # accurate costs ~2x fast per frame; trim its run count
        n_runs = args.runs if profile == "fast" else max(
            2, (args.runs + 1) // 2)
        for r in range(n_runs):
            seq, frames, render_s = render(args.frames, kind, seed=100 + r)
            for mode, pace in (("throughput", None), ("online", 20.0)):
                t0 = time.perf_counter()
                try:
                    res = run_once(seq, frames, profile, use_lc, pace, dev)
                except Exception as e:     # recorded; exits non-zero
                    traceback.print_exc()
                    res = {"error": f"{type(e).__name__}: {e}"[:200]}
                if res.get("n_worker_errors"):
                    res["error"] = f"{res['n_worker_errors']} worker errors"
                n_failed += "error" in res
                rec = dict(cell=cell, profile=profile, kind=kind,
                           mode=mode, run=r, seed=100 + r,
                           n_frames=args.frames, backend=dev.type,
                           device=device, render_s=render_s,
                           wall_s=time.perf_counter() - t0, **res)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                log(f"{cell} run{r} {mode}: "
                    + json.dumps({k: res[k] for k in
                                  ("fps_net", "ate_m", "n_kf", "n_closures",
                                   "n_dropped", "error")
                                  if k in res}))
            del frames, seq
    return 1 if n_failed else 0


if __name__ == "__main__":
    sys.exit(main())
