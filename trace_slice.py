#!/usr/bin/env python3
"""Device trace of the port on one chip-smoke slice (GPU only).

Slices A and B: runs ``--warmup`` frames of the slice through
``ov2slam_torch``'s ``SlamManager``, then ``--frames`` more under
``torch.profiler`` (CPU + CUDA activities), and prints one JSON line: wall
time of the traced frames, the summed device time of their CUDA kernels,
the device's busy share (kernel time over wall time; one stream, so
kernels do not overlap), kernel launches per frame, the kernels that take
the most device time, the host's launch calls per frame (a CUDA graph's
replay is one ``cudaGraphLaunch``, whatever kernels it holds), and
launches, host calls and device ms per frame grouped two ways: by
``Profiler`` scope and by the port function that the models layer
called (a function of ``ov2slam_torch``'s ops, core, geometry, solvers,
loopclosure or mapping packages, the outermost one when they nest;
"(models: <scope>)" for the models layer's own tensor ops). Besides the
``Profiler`` scopes, the methods in ``TRACE_SCOPES`` (local-map matching,
the loop closer's keyframe step, and the rest of ``process_frame``) are
traced as scopes of their own, "(trace) Class.method", so that no launch
falls outside every scope; the port's ``Profiler`` has no scope there, as the
JAX package has none. While traced, each scope and each such function, as
the models modules hold it, runs inside a ``record_function`` range; each
device event is charged to the ranges around the runtime call that
launched it, the hand kernels' (``csrc``, launched through ctypes) as
every other kernel's: their device ms are their device events' time, and
their launch calls are counted once, as the trace's runtime calls. A hand
kernel launched inside a CUDA graph runs on the graph's replays, where the
trace holds its device events (``in_graph_replays``).
:class:`HandKernelTimer` counts each call of each hand-kernel library's
launch functions (no timing) and reads the wrappers' ``.launches``
counters over the same frames; the line's ``hand_kernels`` gives, for each
library, the launch calls, the wrappers' launches, and the trace's
kernels, device ms and runtime calls a frame, and ``hand_kernel_check``
whether they agree: the trace's kernels equal to the wrappers' launches
times the kernels a launch starts, and the trace's runtime launch calls of
hand kernels equal to the kernels of the counted launch calls.

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
hand kernels' launch calls in the window are counted as for A and B, and
their device events are the trace's; the idle share is given from the
trace's device events (the hand kernels' among them). The
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
import re
import sys
import threading
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
    with scoped_ranges() as scopes, HandKernelTimer() as hand, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n0, n1):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.events()
    n_kernels, busy_us, top = kernel_table(events, args.top)
    groups, by_order = kernel_groups(events, scopes, hand)
    hand_rows = hand.per_frame(args.frames, hand_events(events))
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
        **{f"host_calls_per_frame_by_{how}": {
            k: n / args.frames for k, n in sorted(g.items(),
                                                  key=lambda kv: -kv[1])}
           for how, g in host_call_groups(events, scopes).items()},
        hand_kernels=hand_rows, hand_kernel_check=hand_check(hand_rows),
        hand_kernels_grouped_by_order=by_order,
        host_calls_per_frame=runtime_calls(events, args.frames))),
        flush=True)
    return 0


# the hand kernels of each csrc library
HAND_KERNELS = {
    "klt_track": ("klt_kernel",),
    "essential_ransac": ("essential_ransac_kernel",),
    "pnp_refine": ("pnp_refine_kernel",),
    "hamming_score": ("score_kernel",),
    "ba_normal_eq": ("ba_rows_kernel", "ba_sums_kernel"),
    "ba_schur_step": ("schur_prepare_kernel", "schur_step_kernel"),
    "undistort_points": ("undistort_points_kernel",
                         "undistort_normalize_kernel"),
    "separable_filter": ("filter_kernel", "pyramid_kernel", "scharr_kernel"),
    "clahe": ("clahe_kernel",),
    "tsdf": ("tsdf_integrate_kernel", "esdf_sweep_kernel",
             "esdf_sweep4_kernel"),
}
# the wrappers that count each library's launches: (the module under
# ov2slam_torch, its wrappers' names)
HAND_WRAPPERS = {
    "klt_track": ("ops.klt", ("klt_track",)),
    "essential_ransac": ("geometry.essential", ("essential_ransac",)),
    "pnp_refine": ("solvers.pnp_refine", ("pnp_refine",)),
    "hamming_score": ("ops.hamming", ("match_scores_bits",)),
    "ba_normal_eq": ("solvers.ba_invdepth", ("normal_equations",
                                             "lm_accept")),
    "ba_schur_step": ("solvers.ba_invdepth", ("schur_step",)),
    "undistort_points": ("core.camera", ("undistort_points",
                                         "undistort_normalize")),
    "separable_filter": ("core.image", ("separable_filter", "build_pyramid",
                                        "scharr_gradients")),
    "clahe": ("core.image", ("clahe",)),
    "tsdf": ("mapping.tsdf", ("_tsdf_integrate", "_esdf_sweep")),
}


def kernels_per_launch(lib: str) -> int:
    """Kernels one call of library ``lib``'s launch functions starts."""
    from ov2slam_torch.solvers import ba_invdepth

    return ba_invdepth.KERNELS_PER_LAUNCH.get(lib, 1)


def wrapper_launches():
    """{library: the launches its wrappers have counted} (a launch inside
    a CUDA graph counts at each replay)."""
    import importlib

    out = {}
    for lib, (mod, names) in HAND_WRAPPERS.items():
        m = importlib.import_module(f"ov2slam_torch.{mod}")
        out[lib] = sum(getattr(getattr(m, n), "launches", 0) for n in names)
    return out
# a kernel's name, demangled or mangled (after its length), not inside a
# longer identifier
_HAND_RE = re.compile(r"(?<![A-Za-z_])(" + "|".join(
    k for ks in HAND_KERNELS.values() for k in ks) + r")(?![a-z0-9_])")
# what is open on each thread: ("scope", name) and ("fn", label) entries
_OPEN = threading.local()


def _open_stack():
    if not hasattr(_OPEN, "stack"):
        _OPEN.stack = []
    return _OPEN.stack


def hand_kernel_of(name: str):
    """The library whose hand kernel a device event ``name`` is, or None
    (a name inside a longer identifier is not one)."""
    m = _HAND_RE.search(name)
    if m is None:
        return None
    return next(lib for lib, ks in HAND_KERNELS.items() if m.group(1) in ks)


def hand_events(events):
    """{library: {"kernels", "us", "runtime_calls", "in_graph",
    "in_graph_us"}} of the hand kernels' device events a trace holds: all
    of them and their device µs, the eager ones whose runtime launch call
    the trace holds (joined by correlation id), and those a CUDA graph's
    replay ran."""
    import torch

    graphed = graph_kernel_ids(events)
    calls = {e.id for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name in LAUNCHES and e.name not in GRAPH_LAUNCHES}
    out = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            lib = hand_kernel_of(e.name)
            if lib is None:
                continue
            us = e.time_range.elapsed_us()
            r = out.setdefault(lib, dict(kernels=0, us=0.0, runtime_calls=0,
                                         in_graph=0, in_graph_us=0.0))
            r["kernels"] += 1
            r["us"] += us
            if e.id in graphed:
                r["in_graph"] += 1
                r["in_graph_us"] += us
            elif e.id in calls:
                r["runtime_calls"] += 1
    return out


def graph_kernel_ids(events):
    """Correlation ids of the device events that a CUDA graph's replay
    ran (their runtime call is a graph launch)."""
    import torch

    return {e.id for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name in GRAPH_LAUNCHES}


class HandKernelTimer:
    """While entered and ``active``: every launch function of every
    hand-kernel library (``kernels.entry_points``) is wrapped, so that each
    call outside a capture is counted once, with the kernels it starts
    (:func:`kernels_per_launch`) and the ``Profiler`` scope and port
    function open around it on its thread (the innermost scope, the
    outermost function; see :class:`scoped_ranges`). It times nothing: the
    hand kernels' device time is their device events' in the trace, as
    every other kernel's (:func:`kernel_groups`). While active it also
    reads the wrappers' ``.launches`` counters (:func:`wrapper_launches`),
    to hold the trace's counts against."""

    def __init__(self):
        self._active = False
        self.rows = []            # (library, kernels, scope, function)
        self.wrapper_delta = {}
        self._w0 = {}
        self._saved = []
        self._lock = threading.Lock()
        self.active = True

    @property
    def active(self) -> bool:
        return self._active

    @active.setter
    def active(self, on: bool) -> None:
        if on and not self._active:
            self._w0 = wrapper_launches()
        elif self._active and not on:
            for lib, n in wrapper_launches().items():
                self.wrapper_delta[lib] = (self.wrapper_delta.get(lib, 0)
                                           + n - self._w0[lib])
        self._active = on

    def __enter__(self):
        from ov2slam_torch import kernels

        kernels.build_all(HAND_KERNELS)
        for name in HAND_KERNELS:
            lib = kernels.load(name)
            for fn_name in kernels.entry_points(name):
                orig = getattr(lib, fn_name)
                setattr(lib, fn_name, self._counted(name, orig))
                self._saved.append((lib, fn_name, orig))
        return self

    def __exit__(self, *exc):
        self.active = False
        for lib, fn_name, orig in self._saved:
            setattr(lib, fn_name, orig)

    def _counted(self, name, orig):
        import torch

        n_kernels = kernels_per_launch(name)

        def call(*args):
            # a launch into a graph being captured runs on its replays,
            # where the trace holds it
            if self._active and not torch.cuda.is_current_stream_capturing():
                stack = _open_stack()
                scope = next((v for k, v in reversed(stack)
                              if k == "scope"), "(none)")
                fn = next((v for k, v in stack if k == "fn"),
                          f"(models: {scope})")
                with self._lock:
                    self.rows.append((name, n_kernels, scope, fn))
            return orig(*args)
        return call

    def per_frame(self, frames: int, traced):
        """Each library's figures a frame: ``launch_calls`` (the calls of
        its launch functions, counted here) and the kernels they start,
        ``wrapper_launches`` (its wrappers' counters over the same frames:
        launches in graph replays too), and from the trace (``traced``:
        :func:`hand_events`) its kernels, their device ms, the runtime
        launch calls joined to the eager ones, and the kernels and device
        ms of graph replays; plus the totals (not a frame's) that
        :func:`hand_check` compares."""
        calls = {}
        for name, n, _, _ in self.rows:
            c, k = calls.get(name, (0, 0))
            calls[name] = (c + 1, k + n)
        out = {}
        for name in sorted(set(calls) | set(traced)
                           | {k for k, v in self.wrapper_delta.items()
                              if v}):
            c, k = calls.get(name, (0, 0))
            t = traced.get(name, dict(kernels=0, us=0.0, runtime_calls=0,
                                      in_graph=0, in_graph_us=0.0))
            w = self.wrapper_delta.get(name, 0)
            out[name] = dict(
                launch_calls=c / frames, launched_kernels=k / frames,
                wrapper_launches=w / frames,
                kernels=t["kernels"] / frames,
                device_ms=1e-3 * t["us"] / frames,
                runtime_calls=t["runtime_calls"] / frames,
                in_graph_replays=t["in_graph"] / frames,
                in_graph_device_ms=1e-3 * t["in_graph_us"] / frames,
                totals=dict(launch_calls=c, launched_kernels=k,
                            wrapper_launches=w, kernels=t["kernels"],
                            runtime_calls=t["runtime_calls"],
                            in_graph=t["in_graph"],
                            kernels_per_launch=kernels_per_launch(name)))
        return out


def hand_check(rows):
    """{library: ok} and "all": the trace's hand kernels equal to the
    wrappers' launches times the kernels a launch starts, and the trace's
    runtime launch calls of eager hand kernels equal to the kernels of the
    launch calls :class:`HandKernelTimer` counted (each launch counted
    once, in the trace)."""
    out = {}
    for name, r in rows.items():
        t = r["totals"]
        out[name] = (t["kernels"] == t["wrapper_launches"]
                     * t["kernels_per_launch"]
                     and t["runtime_calls"] == t["launched_kernels"])
    out["all"] = all(out.values())
    return out


# the packages whose functions the models layer calls: a kernel launched
# under one is charged to the outermost such function
LAYERS = ("ops", "core", "geometry", "solvers", "loopclosure", "mapping")
MODELS = ("frontend_step", "frontend", "mapper_step", "mapper", "estimator",
          "relocalizer", "slam", "pipeline")


# methods that launch outside every ``Profiler`` scope (the JAX package
# has none around them either), each traced as a scope of its own, named
# "(trace) Class.method": the innermost scope open at a launch takes it,
# so the ``Profiler`` scopes inside them keep theirs. The loop closer's
# keyframe step and local-map matching held all of slice B's unscoped
# launches (PERF.md, PR 12); what a frame launches outside every other
# scope falls to "(trace) SlamManager.process_frame"
TRACE_SCOPES = (
    ("models.slam", "SlamManager", "process_frame"),
    ("models.mapper", "Mapper", "match_to_local_map"),
    ("loopclosure.closer", "LoopCloser", "process_keyframe"),
)


class scoped_ranges:
    """While entered: every ``Profiler`` scope is also a
    ``torch.profiler.record_function`` range, each ``TRACE_SCOPES`` method
    runs inside a scope of its own, and every function of a ``LAYERS``
    package that a ``MODELS`` module holds runs inside a range
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
            _open_stack().append(("scope", name))
            return orig_start(prof, name)

        def stop(prof, name, sync=None):
            out = orig_stop(prof, name, sync)
            r = self._open.pop((threading.get_ident(), name), None)
            if r is not None:
                r.__exit__(None, None, None)
                stack = _open_stack()
                if ("scope", name) in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(
                        ("scope", name))]
            return out

        Profiler.start, Profiler.stop = start, stop
        self._patched = []
        for mod_name, cls_name, meth in TRACE_SCOPES:
            cls = getattr(importlib.import_module(
                f"ov2slam_torch.{mod_name}"), cls_name)
            orig = cls.__dict__[meth]
            label = f"(trace) {cls_name}.{meth}"
            self.scopes.add(label)
            setattr(cls, meth, _scoped(orig, label))
            self._patched.append((cls, meth, orig))
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


def _scoped(fn, label):
    """``fn`` inside a ``record_function`` range ``label`` that counts as
    a scope (:func:`_group_keys`, :class:`HandKernelTimer`)."""
    import functools

    from torch.profiler import record_function

    @functools.wraps(fn)
    def scoped(*a, **k):
        stack = _open_stack()
        stack.append(("scope", label))
        try:
            with record_function(label):
                return fn(*a, **k)
        finally:
            del stack[len(stack) - 1 - stack[::-1].index(("scope", label))]
    return scoped


def _ranged(fn, label):
    """``fn`` inside a ``record_function`` range ``label``."""
    from torch.profiler import record_function

    def ranged(*a, **k):
        stack = _open_stack()
        stack.append(("fn", label[3:]))
        try:
            with record_function(label):
                return fn(*a, **k)
        finally:
            stack.pop()
    return ranged


# the CUDA runtime calls that put work on a stream
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
            *GRAPH_LAUNCHES)


def _group_keys(call, scopes):
    """(scope, function) of a runtime call (None: its device event had no
    call in the trace): the innermost ``Profiler`` scope and the outermost
    port function among its enclosing CPU events."""
    if call is None:
        return "(unattributed)", "(unattributed)"
    scope = fn = None
    p = call
    while p is not None:
        if scope is None and p.name in scopes:
            scope = p.name
        if p.name.startswith("fn "):
            fn = p.name[3:]
        p = p.cpu_parent
    scope = scope or "(none)"
    return scope, fn or f"(models: {scope})"


def kernel_groups(events, scopes, hand=None):
    """Kernel launches and device µs grouped by ``Profiler`` scope (the
    innermost one open at the launch, "(none)" outside every scope) and by
    port function (see the module docstring), the hand kernels' among
    them; and the number of hand kernels grouped by order. Each device
    event is joined to the runtime call that launched it (same correlation
    id), and that call's enclosing CPU events name the groups. An eager
    hand kernel whose runtime call the trace lacks takes, in the order of
    its library's device events, the scope and function of the next
    launch call ``hand`` (:class:`HandKernelTimer`) counted for its
    library; other device events whose call the trace lacks are
    "(unattributed)"."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    calls = {e.id: e for e in events
             if e.device_type == cpu and e.name in LAUNCHES}
    rows = {}
    for name, n, scope, fn in (hand.rows if hand is not None else ()):
        rows.setdefault(name, []).extend([(scope, fn)] * n)
    taken = {}
    out = {"scope": {}, "function": {}}
    devs = sorted((d for d in events if d.device_type == cuda
                   and not getattr(d, "is_user_annotation", False)),
                  key=lambda d: d.time_range.start)
    for d in devs:
        call = calls.get(d.id)
        lib = hand_kernel_of(d.name) if call is None else None
        if lib is not None and taken.get(lib, 0) < len(rows.get(lib, ())):
            scope, fn = rows[lib][taken.get(lib, 0)]
            taken[lib] = taken.get(lib, 0) + 1
        else:
            scope, fn = _group_keys(call, scopes)
        for how, key in (("scope", scope), ("function", fn)):
            c, t = out[how].get(key, (0, 0.0))
            out[how][key] = (c + 1, t + d.time_range.elapsed_us())
    return out, sum(taken.values())


def host_call_groups(events, scopes):
    """The host's launch calls (``LAUNCHES``; a CUDA graph's replay is one,
    a hand kernel's launch one) grouped as :func:`kernel_groups` groups
    kernels."""
    import torch

    out = {"scope": {}, "function": {}}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU \
                and e.name in LAUNCHES:
            for how, key in zip(("scope", "function"),
                                _group_keys(e, scopes)):
                out[how][key] = out[how].get(key, 0) + 1
    return out


def runtime_calls(events, frames: int):
    """The host's calls a frame that put work on a stream (``LAUNCHES``:
    a CUDA graph's replay is one ``cudaGraphLaunch`` however many kernels
    it holds; a hand kernel's ctypes launch is its runtime call), by
    name."""
    import torch

    out = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU \
                and e.name in LAUNCHES:
            out[e.name] = out.get(e.name, 0) + 1
    return {k: n / frames for k, n in sorted(out.items())}


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
    """A lock whose waits to acquire are recorded as "wait: map lock", and
    the worker's turns given away at its yield points as "wait: map lock
    (yielded)"."""

    def __init__(self, lock, rec: Recorder):
        self._lock, self._rec = lock, rec

    def acquire(self, *a, **k):
        t0 = self._rec.now()
        got = self._lock.acquire(*a, **k)
        self._rec.add("wait: map lock", t0, self._rec.now())
        return got

    def release(self):
        self._lock.release()

    def yield_turn(self):
        t0 = self._rec.now()
        gave = self._lock.yield_turn()
        if gave:
            self._rec.add("wait: map lock (yielded)", t0, self._rec.now())
        return gave

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def __getattr__(self, name):
        return getattr(self._lock, name)


def traced_manager(rec: Recorder, prof, first: int, n: int, window,
                   clock: PausableClock, hand: HandKernelTimer):
    """``AsyncSlamManager`` with its waits and scopes recorded, and the
    profiler and ``hand`` on for front-end frames ``first`` ... ``first + n
    - 1`` (the profiler's start and stop paused on ``clock``)."""
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
                # the worker launches its BA graphs only while it holds the
                # map lock: the profiler's start or stop during a graph
                # launch on another thread deadlocked (CUPTI)
                with self.map_lock._lock:
                    clock.paused(prof.start)
                rec.active = hand.active = True
                window.append(rec.now())
            t0 = rec.now()
            try:
                return super().process_frame(*a, **k)
            finally:
                rec.add("process_frame", t0, rec.now())
                if i == first + n - 1:
                    torch.cuda.synchronize()
                    window.append(rec.now())
                    rec.active = hand.active = False
                    with self.map_lock._lock:
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

    hand = HandKernelTimer()
    hand.active = False
    pipeline.AsyncSlamManager = traced_manager(rec, prof, warmup, frames,
                                               window, clock, hand)
    Profiler.start, Profiler.stop = start, stop
    chip_smoke.time = clock
    try:
        with hand:
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
              "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
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
    # the hand kernels' device events in the window (runtime calls are not
    # joined here: the window's events are the chrome trace's)
    traced = {}
    for a, b, cat, stream, nm in dev_ev:
        lib = hand_kernel_of(nm)
        if lib is not None and w0 <= a < w1:
            r = traced.setdefault(lib, dict(kernels=0, us=0.0,
                                            runtime_calls=0, in_graph=0,
                                            in_graph_us=0.0))
            r["kernels"] += 1
            r["us"] += b - a
    hand_rows = hand.per_frame(frames, traced)
    return dict(
        slice=name, device=torch.cuda.get_device_name(0), frames=frames,
        first_frame=warmup, wall_s=wall * 1e-6,
        device_busy_s=busy_us * 1e-6, idle_share=1.0 - busy_us / wall,
        hand_kernels=hand_rows,
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
