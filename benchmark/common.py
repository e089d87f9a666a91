"""What every cell of the benchmark shares: finding a cell's files by name,
the environment a run sets before it imports the program, the result line,
the statistics, the device record, the look for forbidden modules, and the
reduction of a profiler trace to busy time, idle gaps and kernels.

Nothing here imports torch at module level, so that ``run.py`` can set the
environment first.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's own cache directories, at fixed paths, so that only the
# first run in a checkout compiles
CACHE = os.path.join(HERE, "_cache")
# top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "ov2slam_tpu")


def set_environment() -> None:
    """Pins every compile cache inside the checkout and keeps libraries
    from loading JAX. Called before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    """The cell's file, with its configuration's file under ``config_file``
    (the configuration as it is run)."""
    cell = load_json(os.path.join(HERE, "workloads", name + ".json"))
    cell["config_file"] = load_json(
        os.path.join(HERE, "configs", cell["config"] + ".json"))
    return cell


def traffic(kind: str):
    """The module that generates and drives traffic of ``kind``."""
    return importlib.import_module(f"benchmark.traffic.{kind}")


def metric_reader(name: str):
    """The ``read(obs)`` function of per-layer metric ``name``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    s = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics of ``BENCHMARK.json`` that ``cell`` reports: its
    end-to-end metrics without ``--trace``, its per-layer ones with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_loaded() -> List[str]:
    """The forbidden top-level module names that this process holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


# -------------------------------------------------------------------------
# statistics
# -------------------------------------------------------------------------

def quantile(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile of ``values`` by linear interpolation between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("quantile of no values")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# -------------------------------------------------------------------------
# the device and the result line
# -------------------------------------------------------------------------

def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def device_record(count: int, memory_peak: int, busy_s=None,
                  window_s=None) -> dict:
    import torch

    rec = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
               count=count, memory_peak_bytes=int(memory_peak))
    if busy_s is not None:
        rec.update(busy_s=busy_s, window_s=window_s)
    return rec


def checks_text(checks: Dict[str, Tuple[float, float, str]]) -> List[str]:
    """One line a compared number: its name, value, limit and sense."""
    return [f"check {name}: {value!r} (limit {sense} {limit!r})"
            for name, (value, limit, sense) in checks.items()]


def passes(checks: Dict[str, Tuple[float, float, str]]) -> bool:
    """Every number within its limit (``<=`` or ``>=``); a NaN fails."""
    ok = True
    for value, limit, sense in checks.values():
        v = float(value)
        ok &= (v <= limit) if sense == "<=" else (v >= limit)
        ok &= not math.isnan(v)
    return bool(ok)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Tuple[float, str]], device: dict,
                checks: Dict[str, Tuple[float, float, str]],
                breakdown: Optional[dict] = None) -> str:
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed),
               metrics={k: dict(value=v, unit=u)
                        for k, (v, u) in metrics.items()},
               device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: dict(value=v, limit=lim, sense=s)
                     for k, (v, lim, s) in checks.items()}
    return json.dumps(out)


# -------------------------------------------------------------------------
# profiler traces
# -------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def profiler(cuda: bool):
    """A ``torch.profiler.profile`` of host calls (and, on the card, device
    activity), not started. A first profile is taken and dropped, so that
    the profiler's own set-up falls in set-up, before the traced window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts):
        pass
    return profile(activities=acts)


def read_trace(prof) -> dict:
    """The events of a finished ``torch.profiler.profile`` as plain lists,
    on the epoch clock in µs (``time.time_ns() / 1e3``): ``device`` (start,
    end, category, name) and ``host`` (start, end, category, name). The
    Chrome trace goes through a file of this process in the checkout's
    cache directory, removed once read."""
    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    dev, host = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        a = e["ts"] + base
        b = a + e.get("dur", 0)
        if cat in DEVICE_CATS:
            dev.append((a, b, cat, e.get("name", "")))
        elif cat in HOST_CATS:
            host.append((a, b, cat, e.get("name", "")))
    return dict(device=dev, host=host)


def union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_traces(traces: Sequence[dict], w0: float, w1: float,
                  top: int = 10) -> dict:
    """Busy time, kernels and idle gaps of one or more processes' traces
    (``read_trace``) over the window [w0, w1] (epoch µs): the device's busy
    seconds (the union of every device event of every process), the
    window's seconds, the kernels that started in it (name, device µs),
    the ``top`` device operations by time, and the ``top`` longest idle
    gaps, each named by the innermost host event that spans its middle."""
    dev = [(max(a, w0), min(b, w1), cat, name) for t in traces
           for a, b, cat, name in t["device"] if b > w0 and a < w1]
    busy = union((a, b) for a, b, _, _ in dev)
    busy_us = sum(b - a for a, b in busy)
    kernels = [(name, b - a) for a, b, cat, name in dev if cat == "kernel"]
    by_name: Dict[str, float] = {}
    for a, b, cat, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:top]
    host = [h for t in traces for h in t["host"]]

    def what(g0, g1):
        mid = 0.5 * (g0 + g1)
        inside = [(b - a, name) for a, b, cat, name in host if a <= mid <= b]
        return min(inside)[1] if inside else "host: no traced call"

    return dict(
        busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
        kernels=kernels,
        device_ops=[[n[:120], t * 1e-6] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[what(a, b)[:120], (b - a) * 1e-6] for a, b in gaps])


def idle_share(tr: dict) -> Optional[float]:
    """The share of the traced window, in %, in which no device operation
    ran; None without a window or without any device operation in it."""
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
