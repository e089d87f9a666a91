#!/usr/bin/env python3
"""Device trace of the port on one chip-smoke slice (GPU only).

Runs ``--warmup`` frames of slice A or B of ``chip_smoke.py`` through
``ov2slam_torch``'s ``SlamManager``, then ``--frames`` more under
``torch.profiler`` (CPU + CUDA activities), and prints one JSON line:
wall time of the traced frames, the summed device time of their CUDA
kernels, the device's busy share (kernel time over wall time; one stream,
so kernels do not overlap), kernel launches per frame, and the kernels
that take the most device time.

    python3 trace_slice.py B --warmup 20 --frames 30
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("slice", choices=["A", "B"])
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("trace_slice: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.models.slam import SlamManager
    from ov2slam_torch.utils import profiles

    seq, cfg = chip_smoke.make_slice(args.slice, synthetic, profiles)
    slam = SlamManager(cfg)
    n0, n1 = args.warmup, args.warmup + args.frames
    if n1 > len(seq.times):
        raise SystemExit(f"trace_slice: the slice has {len(seq.times)} "
                         "frames")

    def step(i):
        slam.process_frame(seq.images_left[i], seq.images_right[i],
                           float(seq.times[i]))

    for i in range(n0):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n0, n1):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # kernels appear either as CUDA-typed events or attached to the CPU
    # ops that launched them, depending on the profiler build
    events = prof.events()
    kernels = [(e.name, e.time_range.elapsed_us()) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        kernels = [(k.name, k.duration) for e in events for k in e.kernels]
    busy_us = sum(t for _, t in kernels)
    by_name = {}
    for name, t_us in kernels:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + t_us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
    print(json.dumps(dict(
        slice=args.slice, device=torch.cuda.get_device_name(0),
        frames=args.frames, keyframes=int(slam.map._kf_seq_counter),
        wall_s=wall, kernel_time_s=busy_us * 1e-6,
        busy_share=busy_us * 1e-6 / wall,
        kernel_launches=len(kernels),
        launches_per_frame=len(kernels) / args.frames,
        top_kernels=[dict(name=k[:80], launches=n, device_ms=t * 1e-3)
                     for k, (n, t) in top])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
