#!/usr/bin/env python3
"""Device trace of the port on one chip-smoke slice (GPU only).

Slices A and B: runs ``--warmup`` frames of the slice through
``ov2slam_torch``'s ``SlamManager``, then ``--frames`` more under
``torch.profiler`` (CPU + CUDA activities), and prints one JSON line: wall
time of the traced frames, the summed device time of their CUDA kernels,
the device's busy share (kernel time over wall time; one stream, so
kernels do not overlap), kernel launches per frame, the kernels that take
the most device time, and launches and device ms per frame grouped two
ways: by ``Profiler`` scope and by the port function that the models layer
called (a function of ``ov2slam_torch``'s ops, core, geometry, solvers,
loopclosure or mapping packages, the outermost one when they nest;
"(models: <scope>)" for the models layer's own tensor ops). While traced,
each scope and each such function, as the models modules hold it, runs
inside a ``record_function`` range; each device event is charged to the
ranges around the runtime call that launched it (hand kernels' ctypes
launches included). The trace holds the device events of only some of the
KLT kernel's launches, so its device time is missing from those figures;
the line gives its launches per frame from the wrapper's counter beside
the ones the trace holds.

Slices E and F: runs ``chip_smoke.run_async_slice`` (``AsyncSlamManager``,
the front end on the calling thread, keyframes on the ``kf-worker`` thread
and its own CUDA stream) and traces the front end's frames ``--warmup`` to
``--warmup + --frames`` (counted in ``process_frame`` calls; slice F's
first 30 are its flat-out warm frames). The profiler records CUDA
activities only (kernels, copies, and the CUDA runtime calls of every
thread, from which each thread's launches are counted), and is started
once before the slice so that CUPTI's set-up falls outside the window;
the time it takes to start and stop is taken out of ``chip_smoke``'s
clock, so that slice F's pacing does not count it as the system's. The
waits of both threads (the in-flight frame's readback, the keyframe
backpressure condition, the map lock) and the ``Profiler`` scopes are
recorded beside the trace. The JSON line adds the device's idle share
over the union of all streams, launches per frame by thread, kernels by
stream, each thread's map-lock waits charged to the scopes open around
them, the longest idle gaps of the device with what each thread was
inside during each, and the traced run's own outcome (fps, ATE,
keyframes, frames dropped): a window of a run that lost tracking does
not describe the slice.

Slice I: one distributed BA solve (``parallel/dist_ba.py``) of
``chip_smoke``'s 64-KF window with each of ``--shards`` in-process shard
counts, ``--frames`` LM iterations, traced after a warm solve: per LM
iteration, the device time and launches of the kernels that take the
most, and the device's busy share of the solve.

Slice P: the bench's ``full_ba_pcg`` problem (``ov2slam_torch/bench.py``:
200 KFs, 357218 observations, above the dense-Schur limit) solved by
``ba_solve_invdepth`` for ``--frames`` robust LM iterations, each a
matrix-free PCG step, traced after a warm solve: per LM iteration and per
CG step, the kernels that take the most device time, the device's busy
share, and the CUDA runtime calls by count (a synchronizing call in the
CG loop shows here).

    python3 trace_slice.py B --warmup 20 --frames 10
    python3 trace_slice.py E --warmup 60 --frames 8
    python3 trace_slice.py F --warmup 45 --frames 8
    python3 trace_slice.py I --frames 5 --shards 1 8
    python3 trace_slice.py P --frames 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("slice", choices=["A", "B", "E", "F", "I", "P"])
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--shards", type=int, nargs="+", default=[8],
                    help="slice I's in-process shard counts")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("trace_slice: needs a CUDA device", file=sys.stderr)
        return 2
    if args.slice == "I":
        for n in args.shards:
            print(json.dumps(trace_dist_ba(n, args.frames, args.top,
                                           torch.device("cuda"))),
                  flush=True)
        return 0
    if args.slice == "P":
        print(json.dumps(trace_pcg(args.frames, args.top,
                                   torch.device("cuda"))), flush=True)
        return 0
    if args.slice in ("E", "F"):
        print(json.dumps(trace_async(args.slice, args.warmup, args.frames,
                                     args.top, torch.device("cuda"))),
              flush=True)
        return 0
    import chip_smoke
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.models.slam import SlamManager
    from ov2slam_torch.ops import klt
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
    klt_n0 = klt.klt_track.launches
    with scoped_ranges() as scopes, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n0, n1):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    klt_launches = klt.klt_track.launches - klt_n0

    events = prof.events()
    n_kernels, busy_us, top = kernel_table(events, args.top)
    groups = kernel_groups(events, scopes)
    klt_traced = sum(1 for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and chip_smoke.KLT_KERNEL_SYMBOL in e.name)
    print(json.dumps(dict(
        slice=args.slice, device=torch.cuda.get_device_name(0),
        frames=args.frames, keyframes=int(slam.map._kf_seq_counter),
        wall_s=wall, kernel_time_s=busy_us * 1e-6,
        busy_share=busy_us * 1e-6 / wall,
        kernel_launches=n_kernels,
        launches_per_frame=n_kernels / args.frames,
        top_kernels=[dict(name=k[:80], launches=n, device_ms=t * 1e-3)
                     for k, n, t in top],
        **{f"per_frame_by_{how}": per_frame(g, args.frames)
           for how, g in groups.items()},
        klt_kernel=dict(
            launches_per_frame=klt_launches / args.frames,
            traced_per_frame=klt_traced / args.frames,
            note="the trace holds the device events of only some of the "
                 "KLT kernel's launches (its wrapper's counter gives the "
                 "launches): its device time is missing from the figures "
                 "above; chip_smoke.py's [kernels] klt_track lines time "
                 "it with CUDA events"))), flush=True)
    return 0


# the packages whose functions the models layer calls: a kernel launched
# under one is charged to the outermost such function
LAYERS = ("ops", "core", "geometry", "solvers", "loopclosure", "mapping")
MODELS = ("frontend_step", "frontend", "mapper_step", "mapper", "estimator",
          "relocalizer", "slam", "pipeline")


class scoped_ranges:
    """While entered: every ``Profiler`` scope is also a
    ``torch.profiler.record_function`` range, and every function of a
    ``LAYERS`` package that a ``MODELS`` module holds runs inside a range
    ``fn <package/module.py>::<name>``. Yields the set of scope names
    seen."""

    def __enter__(self):
        import importlib
        import inspect
        import threading

        from torch.profiler import record_function

        from ov2slam_torch.utils.profiler import Profiler

        self.scopes = set()
        self._open = {}
        self._orig = Profiler.start, Profiler.stop
        orig_start, orig_stop = self._orig

        def start(prof, name):
            r = record_function(name)
            r.__enter__()
            self._open[(threading.get_ident(), name)] = r
            self.scopes.add(name)
            return orig_start(prof, name)

        def stop(prof, name, sync=None):
            out = orig_stop(prof, name, sync)
            r = self._open.pop((threading.get_ident(), name), None)
            if r is not None:
                r.__exit__(None, None, None)
            return out

        Profiler.start, Profiler.stop = start, stop
        self._patched = []
        for m in MODELS:
            mod = importlib.import_module(f"ov2slam_torch.models.{m}")
            for name, fn in list(vars(mod).items()):
                parts = getattr(fn, "__module__", "").split(".")
                if (inspect.isfunction(fn) and parts[0] == "ov2slam_torch"
                        and parts[1:2] and parts[1] in LAYERS):
                    label = "/".join(parts[1:]) + f".py::{fn.__name__}"
                    setattr(mod, name, _ranged(fn, "fn " + label))
                    self._patched.append((mod, name, fn))
        return self.scopes

    def __exit__(self, *exc):
        from ov2slam_torch.utils.profiler import Profiler

        Profiler.start, Profiler.stop = self._orig
        for mod, name, fn in self._patched:
            setattr(mod, name, fn)


def _ranged(fn, label):
    """``fn`` inside a ``record_function`` range ``label``."""
    from torch.profiler import record_function

    def ranged(*a, **k):
        with record_function(label):
            return fn(*a, **k)
    return ranged


# the CUDA runtime calls that put work on a stream
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def kernel_groups(events, scopes):
    """Kernel launches and device µs grouped by ``Profiler`` scope (the
    innermost one open at the launch, "(none)" outside every scope) and by
    port function (see the module docstring). Each device event is joined
    to the runtime call that launched it (same correlation id), and that
    call's enclosing CPU events name the groups; device events whose call
    the trace lacks are "(unattributed)"."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    calls = {e.id: e for e in events
             if e.device_type == cpu and e.name in LAUNCHES}
    out = {"scope": {}, "function": {}}
    for d in events:
        if d.device_type != cuda or getattr(d, "is_user_annotation", False):
            continue
        scope = fn = None
        p = calls.get(d.id)
        if p is None:
            scope = fn = "(unattributed)"
        while p is not None:
            if scope is None and p.name in scopes:
                scope = p.name
            if p.name.startswith("fn "):
                fn = p.name[3:]
            p = p.cpu_parent
        scope = scope or "(none)"
        for how, key in (("scope", scope),
                         ("function", fn or f"(models: {scope})")):
            c, t = out[how].get(key, (0, 0.0))
            out[how][key] = (c + 1, t + d.time_range.elapsed_us())
    return out


def per_frame(group, frames: int):
    """{key: {launches, device_ms}} per frame, by device time."""
    return {k: dict(launches=n / frames, device_ms=1e-3 * t / frames)
            for k, (n, t) in sorted(group.items(), key=lambda kv: -kv[1][1])}


def kernel_table(events, top: int):
    """(count, device µs, the ``top`` kernels by device time as (name,
    launches, µs)) of a profiler's events."""
    import torch

    # kernels appear either as CUDA-typed events or attached to the CPU
    # ops that launched them, depending on the profiler build
    kernels = [(e.name, e.time_range.elapsed_us()) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        kernels = [(k.name, k.duration) for e in events for k in e.kernels]
    by_name = {}
    for name, t_us in kernels:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + t_us)
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return (len(kernels), sum(t for _, t in kernels),
            [(k, n, t) for k, (n, t) in top_k])


def trace_dist_ba(n_shards: int, iters: int, top: int, dev):
    """Slice I's 64-KF window solved with ``n_shards`` in-process shards
    and ``iters`` LM iterations under the profiler (after one warm
    solve); figures per LM iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from ov2slam_torch.parallel import dist_ba
    from ov2slam_torch.parallel.problems import realistic_window_problem

    _, kw, _ = chip_smoke.SLICE_I_PROBLEMS[2]
    _, prob, params, _ = realistic_window_problem(**kw, device=dev)
    mesh = dist_ba.make_mesh(n_shards)
    shards = dist_ba.put_sharded(mesh, dist_ba.shard_ba_problem(
        prob, n_shards), len(prob.kf_ids), dev)
    step = dist_ba.make_distributed_ba(mesh, params,
                                       chip_smoke.SLICE_I_ROBUST_TH, iters)
    poses = torch.as_tensor(prob.kf_poses, device=dev)
    fixed = torch.as_tensor(prob.kf_fixed, device=dev)
    step(poses, fixed, shards)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(poses, fixed, shards)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n, busy_us, top_k = kernel_table(prof.events(), top)
    return dict(
        slice="I", device=torch.cuda.get_device_name(0), shards=n_shards,
        keyframes=len(prob.kf_ids), obs=int(prob.obs_valid.sum()),
        iters=iters, wall_ms_per_iter=1e3 * wall / iters,
        device_ms_per_iter=1e-3 * busy_us / iters,
        busy_share=busy_us * 1e-6 / wall, kernels_per_iter=n / iters,
        top_kernels=[dict(name=k[:80], launches_per_iter=c / iters,
                          device_ms_per_iter=1e-3 * t / iters)
                     for k, c, t in top_k])


def trace_pcg(iters: int, top: int, dev):
    """Slice P: ``iters`` robust LM iterations of the bench's full_ba_pcg
    problem under the profiler (after one warm solve); figures per LM
    iteration and per CG step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ov2slam_torch import bench
    from ov2slam_torch.solvers import ba_invdepth

    c = bench.FULL_BA_PCG
    prob = bench.synth_ba_problem(c["n_kf"], c["n_lm"])
    args, params = bench.ba_inputs(prob, dev)
    cg = min(max(100, 2 * c["n_kf"]), 600)   # the branch's CG iterations

    def solve():
        return ba_invdepth.ba_solve_invdepth(
            *args, params, robust_th=bench.ROBUST_TH, iters=iters)

    solve()
    torch.cuda.synchronize()
    calls0 = ba_invdepth._solve_iteration_inv_cg.calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pcg_steps = ba_invdepth._solve_iteration_inv_cg.calls - calls0
    n, busy_us, top_k = kernel_table(prof.events(), top)
    api = sorted(((e.key, e.count) for e in prof.key_averages()
                  if e.key.startswith("cuda")), key=lambda kv: -kv[1])
    return dict(
        slice="P", device=torch.cuda.get_device_name(0),
        keyframes=c["n_kf"], obs=prob["n_obs"], iters=iters,
        pcg_steps=pcg_steps, cg_iters_per_step=cg,
        wall_ms_per_iter=1e3 * wall / iters,
        device_ms_per_iter=1e-3 * busy_us / iters,
        busy_share=busy_us * 1e-6 / wall, kernels_per_iter=n / iters,
        kernels_per_cg_iter=n / iters / cg,
        wall_us_per_cg_iter=1e6 * wall / iters / cg,
        runtime_calls_per_iter={k: v / iters for k, v in api[:8]},
        top_kernels=[dict(name=k[:80], launches_per_iter=m / iters,
                          device_ms_per_iter=1e-3 * t / iters)
                     for k, m, t in top_k])


class Recorder:
    """Intervals (thread id, thread name, label, start, end; µs since the
    epoch) recorded while ``active``."""

    def __init__(self):
        import threading

        self.active = False
        self.rows = []
        self.threads = {}
        self._lock = threading.Lock()

    @staticmethod
    def now() -> float:
        return time.time_ns() / 1e3

    def add(self, label: str, t0: float, t1: float) -> None:
        import threading

        if self.active:
            th = threading.current_thread()
            with self._lock:
                self.threads[th.native_id] = th
                self.rows.append((th.native_id, th.name, label, t0, t1))

    def timed(self, label: str, fn):
        """``fn`` with each call recorded as an interval ``label``."""
        def call(*a, **k):
            t0 = self.now()
            try:
                return fn(*a, **k)
            finally:
                self.add(label, t0, self.now())
        return call


class PausableClock:
    """The ``time`` module with ``perf_counter`` less the time spent in
    :meth:`paused` blocks."""

    def __init__(self):
        self._paused = 0.0

    def perf_counter(self) -> float:
        return time.perf_counter() - self._paused

    def paused(self, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self._paused += time.perf_counter() - t0

    def __getattr__(self, name):
        return getattr(time, name)


class TimedLock:
    """A lock whose waits to acquire are recorded as "wait: map lock"."""

    def __init__(self, lock, rec: Recorder):
        self._lock, self._rec = lock, rec

    def acquire(self, *a, **k):
        t0 = self._rec.now()
        got = self._lock.acquire(*a, **k)
        self._rec.add("wait: map lock", t0, self._rec.now())
        return got

    def release(self):
        self._lock.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


def traced_manager(rec: Recorder, prof, first: int, n: int, window,
                   clock: PausableClock):
    """``AsyncSlamManager`` with its waits and scopes recorded, and the
    profiler on for front-end frames ``first`` ... ``first + n - 1``
    (its start and stop paused on ``clock``)."""
    import threading

    import torch

    from ov2slam_torch.models.pipeline import AsyncSlamManager

    class TimedCondition(threading.Condition):
        def wait(self, timeout=None):
            t0 = rec.now()
            try:
                return super().wait(timeout)
            finally:
                rec.add("wait: keyframe condition", t0, rec.now())

    class Traced(AsyncSlamManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            # the worker is idle on its queue: it holds neither yet
            self.map_lock = TimedLock(self.map_lock, rec)
            self._pending_cv = TimedCondition()
            self.frontend.wait_pending = rec.timed(
                "wait: in-flight frame readback", self.frontend.wait_pending)
            self._frames = 0

        def process_frame(self, *a, **k):
            i = self._frames
            self._frames += 1
            if i == first:
                torch.cuda.synchronize()
                clock.paused(prof.start)
                rec.active = True
                window.append(rec.now())
            t0 = rec.now()
            try:
                return super().process_frame(*a, **k)
            finally:
                rec.add("process_frame", t0, rec.now())
                if i == first + n - 1:
                    torch.cuda.synchronize()
                    window.append(rec.now())
                    rec.active = False
                    clock.paused(prof.stop)

    return Traced


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def trace_async(name: str, warmup: int, frames: int, top: int, dev):
    """Slice E or F under ``traced_manager``; returns the figures."""
    import os
    import tempfile
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from ov2slam_torch.models import pipeline
    from ov2slam_torch.utils.profiler import Profiler

    rec = Recorder()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    clock = PausableClock()
    window = []
    orig_cls = pipeline.AsyncSlamManager
    orig_start, orig_stop = Profiler.start, Profiler.stop
    scope_t0 = {}

    def start(self, scope):
        scope_t0[(threading.get_ident(), scope)] = rec.now()
        return orig_start(self, scope)

    def stop(self, scope, sync=None):
        out = orig_stop(self, scope, sync)
        t0 = scope_t0.pop((threading.get_ident(), scope), None)
        if t0 is not None:
            rec.add(scope, t0, rec.now())
        return out

    pipeline.AsyncSlamManager = traced_manager(rec, prof, warmup, frames,
                                               window, clock)
    Profiler.start, Profiler.stop = start, stop
    chip_smoke.time = clock
    try:
        res = chip_smoke.run_async_slice(name, dev)
    finally:
        pipeline.AsyncSlamManager = orig_cls
        Profiler.start, Profiler.stop = orig_start, orig_stop
        chip_smoke.time = time
    if len(window) != 2:
        raise SystemExit(f"trace_slice: slice {name} ended before frame "
                         f"{warmup + frames}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    w0, w1 = window[0] - base, window[1] - base
    wall = w1 - w0
    dev_ev, runtime = [], []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev_ev.append((e["ts"], e["ts"] + e.get("dur", 0), cat,
                           e.get("args", {}).get("stream"), e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append((e["ts"], e["ts"] + e.get("dur", 0), e["tid"],
                            e["name"]))
    busy = _union([(max(a, w0), min(b, w1)) for a, b, *_ in dev_ev
                   if b > w0 and a < w1])
    busy_us = sum(b - a for a, b in busy)
    gaps = [(w0, busy[0][0])] if busy else [(w0, w1)]
    gaps += [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps.append((busy[-1][1], w1))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:top]
    # the trace names a thread by its system id or, for CUDA runtime
    # calls off the main thread, by the low 32 bits of its pthread id
    names = {}
    for th in threading.enumerate() + list(rec.threads.values()):
        who = "front end" if th is threading.main_thread() else th.name
        for key in (th.native_id, th.ident, th.ident & 0xFFFFFFFF):
            names.setdefault(key, who)
    rows = [(names.get(tid, tname), lab, a - base, b - base)
            for tid, tname, lab, a, b in rec.rows]
    launch = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
              "cuLaunchKernelEx")
    launches, by_stream, by_kernel = {}, {}, {}
    for a, b, tid, nm in runtime:
        if nm in launch and w0 <= a < w1:
            who = names.get(tid, str(tid))
            launches[who] = launches.get(who, 0) + 1
    if not launches or not dev_ev:
        raise SystemExit("trace_slice: the trace holds no kernel launches "
                         "in the window")
    for a, b, cat, stream, nm in dev_ev:
        if w0 <= a < w1:
            by_stream[str(stream)] = by_stream.get(str(stream), 0) + 1
            n, t = by_kernel.get(nm, (0, 0.0))
            by_kernel[nm] = (n + 1, t + (b - a))

    def inside(g0, g1):
        out = {}
        for who, lab, a, b in rows:
            ov = _overlap(a, b, g0, g1)
            if ov > 0:
                d = out.setdefault(who, {})
                d[lab] = round(d.get(lab, 0.0) + ov * 1e-3, 4)
        for a, b, tid, nm in runtime:
            ov = _overlap(a, b, g0, g1)
            if ov > 0.1 * (g1 - g0) and nm not in launch:
                d = out.setdefault(names.get(tid, str(tid)), {})
                d["cuda: " + nm] = round(d.get("cuda: " + nm, 0.0)
                                         + ov * 1e-3, 4)
        return out

    scopes = {}
    for who, lab, a, b in rows:
        k = f"{who}: {lab}"
        n, t = scopes.get(k, (0, 0.0))
        scopes[k] = (n + 1, t + _overlap(a, b, w0, w1))
    # each thread's map-lock waits charged to the scopes open around them
    lock_in = {}
    waits = [(who, a, b) for who, lab, a, b in rows
             if lab == "wait: map lock"]
    for who, lab, a, b in rows:
        if lab.startswith("wait: ") or lab == "process_frame":
            continue
        t = sum(_overlap(wa, wb, max(a, w0), min(b, w1))
                for ww, wa, wb in waits if ww == who)
        if t > 0:
            k = f"{who}: {lab}"
            lock_in[k] = lock_in.get(k, 0.0) + t
    top_k = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(
        slice=name, device=torch.cuda.get_device_name(0), frames=frames,
        first_frame=warmup, wall_s=wall * 1e-6,
        device_busy_s=busy_us * 1e-6, idle_share=1.0 - busy_us / wall,
        kernels=sum(by_stream.values()), kernels_by_stream=by_stream,
        launches_per_frame={k: v / frames for k, v in launches.items()},
        thread_time_ms={k: dict(n=n, ms=round(t * 1e-3, 3))
                        for k, (n, t) in sorted(scopes.items())},
        map_lock_wait_in_scope_ms={k: round(t * 1e-3, 3)
                                   for k, t in sorted(lock_in.items())},
        longest_idle_gaps=[dict(start_ms=round((g0 - w0) * 1e-3, 3),
                                ms=round((g1 - g0) * 1e-3, 3),
                                threads=inside(g0, g1))
                           for g0, g1 in gaps],
        top_kernels=[dict(name=k[:80], launches=n, device_ms=t * 1e-3)
                     for k, (n, t) in top_k],
        slice_result={k: res[k] for k in (
            "fps", "ate_m", "end_err_m", "keyframes", "worker_errors",
            "dropped") if k in res})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
