"""Named-scope wall-clock profiler — PyTorch equivalent of the reference's
singleton Profiler (`include/profiler.hpp:38-229`): Welford running
mean/std plus min/max per named scope, with a summary table printer.

Adds device-sync awareness: when timing GPU work, pass the result tensor
(or any CUDA tensor) as ``sync`` so asynchronous launches don't hide the
cost.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch


def _synchronize(sync) -> None:
    """Wait for the device that holds ``sync`` (a tensor, or a nested
    list/tuple/dict of them)."""
    if isinstance(sync, torch.Tensor):
        if sync.is_cuda:
            torch.cuda.synchronize(sync.device)
    elif isinstance(sync, dict):
        for v in sync.values():
            _synchronize(v)
    elif isinstance(sync, (list, tuple)):
        for v in sync:
            _synchronize(v)


class _ScopeStats:
    __slots__ = ("n", "mean", "m2", "vmin", "vmax", "_t0")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        # start times per thread: the asynchronous manager's worker and
        # front end can time the same scope at once
        self._t0: Dict[int, float] = {}

    def add(self, dt_ms: float):
        # Welford update (`profiler.hpp:61-77`)
        self.n += 1
        delta = dt_ms - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (dt_ms - self.mean)
        self.vmin = min(self.vmin, dt_ms)
        self.vmax = max(self.vmax, dt_ms)

    @property
    def std(self) -> float:
        return math.sqrt(self.m2 / self.n) if self.n > 1 else 0.0


class Profiler:
    """Thread-safe named scope timer (a scope's start is kept per
    thread). Scope taxonomy mirrors the
    reference's instrumentation points ("0.Full-Front_End",
    "2.BA_Optimize", "1.KF_stereoMatching", ...)."""

    _instance: Optional["Profiler"] = None
    _instance_lock = threading.Lock()

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._scopes: Dict[str, _ScopeStats] = {}

    @classmethod
    def instance(cls) -> "Profiler":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def start(self, name: str):
        if not self.enabled:
            return
        with self._lock:
            st = self._scopes.setdefault(name, _ScopeStats())
            st._t0[threading.get_ident()] = time.perf_counter()

    def stop(self, name: str, sync=None):
        if not self.enabled:
            return
        if sync is not None:
            _synchronize(sync)
        t1 = time.perf_counter()
        with self._lock:
            st = self._scopes.get(name)
            t0 = None if st is None else st._t0.pop(threading.get_ident(),
                                                     None)
            if t0 is None:
                return
            st.add((t1 - t0) * 1e3)

    @contextmanager
    def scope(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def reset(self):
        with self._lock:
            self._scopes.clear()

    def summary(self) -> str:
        """Formatted table, like `Profiler::displayTimeLogs`."""
        lines = [f"{'scope':<32}{'calls':>8}{'mean ms':>10}{'std':>9}"
                 f"{'min':>9}{'max':>9}"]
        with self._lock:
            for name in sorted(self._scopes):
                s = self._scopes[name]
                if s.n == 0:
                    continue
                lines.append(
                    f"{name:<32}{s.n:>8}{s.mean:>10.3f}{s.std:>9.3f}"
                    f"{s.vmin:>9.3f}{s.vmax:>9.3f}"
                )
        return "\n".join(lines)

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {
                k: dict(n=v.n, mean_ms=v.mean, std_ms=v.std,
                        min_ms=v.vmin, max_ms=v.vmax)
                for k, v in self._scopes.items()
            }

    @staticmethod
    @contextmanager
    def device_trace(log_dir: str):
        """Capture a torch.profiler trace (CPU ops and, on a GPU, CUDA
        kernels) for everything executed inside the context — the
        hardware-level complement to the wall-clock scopes above. Writes a
        Chrome trace (``trace.json``) under ``log_dir``."""
        import os
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        try:
            yield prof
        finally:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
