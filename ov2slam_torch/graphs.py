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
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


class Capture:
    """``with Capture(device) as cap: out = cap(fn)`` captures each ``fn``
    (no arguments; it reads and writes tensors that outlive the capture) as
    one CUDA graph, all in one memory pool, on a side stream ordered after
    the current one; the current stream is ordered after the capture on
    exit. The graphs, in order, are ``cap.graphs``; they must replay in
    that order (a graph may replay several times before the next)."""

    def __init__(self, device):
        self.device = device
        self.graphs = []

    def __enter__(self):
        self._cur = torch.cuda.current_stream(self.device)
        self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(self._cur)
        self._ctx = torch.cuda.stream(self._side)
        self._ctx.__enter__()
        return self

    def __call__(self, fn):
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.graphs[0].pool() if self.graphs else None,
                        capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            g.capture_end()
        self.graphs.append(g)
        return out

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        self._cur.wait_stream(self._side)


class GraphedStep:
    """``step(*tensors, **static)`` as one CUDA graph per signature (the
    tensors' shapes, dtypes and device, and the ``static`` arguments, which
    the graph bakes in: they must be hashable and stay the same objects).
    On the CPU it calls ``fn``. On a GPU a signature's first call runs
    ``fn`` eagerly (it also makes the library handles a capture may not),
    its second captures, and every call from then on copies its tensors
    into the captured inputs and replays; outputs (any nesting of tuples,
    lists and dicts of tensors) are copies. ``eager``, ``captures`` and
    ``replays`` count the calls of each kind."""

    def __init__(self, fn):
        self.fn = fn
        self.cache = {}
        self.eager = self.captures = self.replays = 0

    def __call__(self, *args, **static):
        if not args[0].is_cuda:
            return self.fn(*args, **static)
        key = (tuple((tuple(a.shape), a.dtype, a.device) for a in args),
               tuple(sorted((k, id(v) if not isinstance(
                   v, (int, float, str, bool, type(None))) else v)
                   for k, v in static.items())))
        e = self.cache.get(key)
        if e is None:
            self.eager += 1
            # keeps the static objects the key names by id alive
            self.cache[key] = dict(static=static)
            return self.fn(*args, **static)
        if "graph" not in e:
            e["inputs"] = [a.clone() for a in args]
            with Capture(args[0].device) as cap:
                e["outputs"] = cap(lambda: self.fn(*e["inputs"], **static))
            e["graph"] = cap.graphs[0]
            self.captures += 1
        for dst, src in zip(e["inputs"], args):
            dst.copy_(src)
        e["graph"].replay()
        self.replays += 1
        return pytree.tree_map(lambda t: t.clone(), e["outputs"])
