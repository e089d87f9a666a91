"""CUDA graphs of the port's fixed-shape device steps.

Eagerly, a step of the port is one host launch per tensor operation, and on
a GPU that host work is most of its cost: a local BA window is ~2200
launches, a keyframe's detection ~240. The JAX package compiles such a step
once per shape; a CUDA graph captured once per shape and replayed is the
port's counterpart. A replay runs the captured kernels on the captured
inputs' memory, so a step is captured only where its shapes are fixed and
it never reads a value back to the host.

:class:`Capture` captures callables in order into one memory pool;
:class:`GraphedStep` wraps a step of tensors in one graph per input
signature. Both capture on a side stream in the thread-local mode, so that
other threads (the asynchronous manager's front end) keep launching while
the worker captures, and a replay runs on the caller's current stream.

A hand kernel's wrapper counts its launches through :func:`count_launch`:
a launch made while its thread captures is only recorded into the graph,
so it is counted on each replay instead (:func:`count_replay`), with the
replaying thread and stream.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import types

import torch
from torch.utils import _pytree as pytree

# per thread: the list the graph being captured notes its hand-kernel
# launches in, or None
_capturing = threading.local()

# captures under way over all threads, and whether the cyclic garbage
# collector ran before the first of them
_held = [0, False]
_held_lock = threading.Lock()


@contextlib.contextmanager
def collector_off():
    """The cyclic garbage collector off while any thread is inside. A
    collection may free an object that holds a CUDA graph (a manager
    dropped in a reference cycle), and a graph's destruction is a call a
    capturing thread may not make: made on the capturing thread, it
    invalidates the capture."""
    with _held_lock:
        if _held[0] == 0:
            _held[1] = gc.isenabled()
            gc.disable()
        _held[0] += 1
    try:
        yield
    finally:
        with _held_lock:
            _held[0] -= 1
            if _held[0] == 0 and _held[1]:
                gc.enable()


def _count(fn, key, stream) -> None:
    fn.launches += 1
    fn.shapes[key] += 1
    fn.origins[(threading.current_thread().name, stream)] += 1


def count_launch(fn, key, stream) -> None:
    """One launch of a hand kernel by its wrapper ``fn`` (counters
    ``launches``, ``shapes`` per ``key`` and ``origins`` per (thread name,
    stream handle)): counted now, or, while this thread captures a graph,
    noted for that graph's replays."""
    noted = getattr(_capturing, "launches", None)
    if noted is not None:
        noted.append((fn, key))
    else:
        _count(fn, key, stream)


def count_replay(launches, device) -> None:
    """Counts the hand-kernel launches a graph replay ran (``launches`` as
    its capture noted them) on the current thread and stream."""
    if launches:
        stream = torch.cuda.current_stream(device).cuda_stream
        for fn, key in launches:
            _count(fn, key, stream)


class Capture:
    """``with Capture(device) as cap: out = cap(fn)`` captures each ``fn``
    (no arguments; it reads and writes tensors that outlive the capture) as
    one CUDA graph, with the garbage collector off (:func:`collector_off`),
    all in one memory pool, on a side stream ordered after the current
    one; the current stream is ordered after the capture on
    exit. The graphs, in order, are ``cap.graphs``; they must replay in
    that order (a graph may replay several times before the next).
    ``cap.launches[i]`` holds the hand-kernel launches graph ``i`` runs
    (for :func:`count_replay`)."""

    def __init__(self, device):
        self.device = device
        self.graphs = []
        self.launches = []

    def __enter__(self):
        self._cur = torch.cuda.current_stream(self.device)
        self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(self._cur)
        self._ctx = torch.cuda.stream(self._side)
        self._ctx.__enter__()
        return self

    def __call__(self, fn):
        g = torch.cuda.CUDAGraph()
        noted = []
        _capturing.launches = noted
        try:
            with collector_off():
                g.capture_begin(
                    pool=self.graphs[0].pool() if self.graphs else None,
                    capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    g.capture_end()
        finally:
            _capturing.launches = None
        self.graphs.append(g)
        self.launches.append(noted)
        return out

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        self._cur.wait_stream(self._side)


def counters():
    """A set of ``eager``, ``captures`` and ``replays`` counters: a
    :class:`GraphedStep`'s ``counts``, its own or shared."""
    return types.SimpleNamespace(eager=0, captures=0, replays=0)


class GraphedStep:
    """``step(*tensors, **static)`` as one CUDA graph per signature (the
    tensors' shapes, dtypes and device, and the ``static`` arguments, which
    the graph bakes in: they must be hashable and stay the same objects).
    On the CPU it calls ``fn``. On a GPU a signature's first call runs
    ``fn`` eagerly (it also makes the library handles a capture may not),
    its second captures, and every call from then on copies its tensors
    into the captured inputs and replays; outputs (any nesting of tuples,
    lists and dicts of tensors) are copies. ``counts`` (:func:`counters`;
    the steps of one function that each owner makes share one) counts the
    calls of each kind, read as the step's ``eager``, ``captures`` and
    ``replays``; each replay counts the hand-kernel launches its graph
    holds (:func:`count_replay`). The graphs, and the static objects their
    key names, live as long as the step."""

    def __init__(self, fn, counts=None):
        self.fn = fn
        self.cache = {}
        self.counts = counters() if counts is None else counts

    eager = property(lambda self: self.counts.eager)
    captures = property(lambda self: self.counts.captures)
    replays = property(lambda self: self.counts.replays)

    def __call__(self, *args, **static):
        if not args[0].is_cuda:
            return self.fn(*args, **static)
        key = (tuple((tuple(a.shape), a.dtype, a.device) for a in args),
               tuple(sorted((k, id(v) if not isinstance(
                   v, (int, float, str, bool, type(None))) else v)
                   for k, v in static.items())))
        e = self.cache.get(key)
        if e is None:
            self.counts.eager += 1
            # keeps the static objects the key names by id alive
            self.cache[key] = dict(static=static)
            return self.fn(*args, **static)
        if "graph" not in e:
            e["inputs"] = [a.clone() for a in args]
            with Capture(args[0].device) as cap:
                e["outputs"] = cap(lambda: self.fn(*e["inputs"], **static))
            e["graph"], e["launches"] = cap.graphs[0], cap.launches[0]
            self.counts.captures += 1
        for dst, src in zip(e["inputs"], args):
            dst.copy_(src)
        e["graph"].replay()
        count_replay(e["launches"], args[0].device)
        self.counts.replays += 1
        return pytree.tree_map(lambda t: t.clone(), e["outputs"])
