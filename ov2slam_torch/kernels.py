"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/ov2slam_torch/lib<name>.so`` — a shared library with a plain C
interface, loaded with ``ctypes`` — at first use, or ahead of time with
:func:`build_all` (one ``nvcc`` process per source, all started together).
A library newer than its source and than every ``csrc`` header the source
includes is reused. ptxas's resource report (registers, shared memory,
spills) of each build is kept in :data:`BUILD_LOG`. Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "ov2slam_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}   # nvcc's output of each build, by kernel

_C = ctypes
# C signatures of the exported launch functions
_SIGNATURES = {
    "hamming_score": ("hamming_score_launch", _C.c_int,
                      [_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
                       _C.c_int, _C.c_int, _C.c_int, _C.c_int,
                       _C.c_void_p, _C.c_void_p, _C.c_void_p]),
    "klt_track": ("klt_track_launch", _C.c_int,
                  [_C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int,
                   _C.c_void_p, _C.c_void_p, _C.c_void_p,
                   _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
                   _C.c_int, _C.c_float, _C.c_float, _C.c_float, _C.c_float,
                   _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
                   _C.c_void_p]),
}
KERNELS = tuple(_SIGNATURES)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("ov2slam_torch: nvcc not found (set CUDA_HOME)")
    return found


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _headers(path: str, seen=None) -> set:
    """The ``csrc`` headers that ``path`` includes, directly or through
    another such header."""
    seen = set() if seen is None else seen
    with open(path) as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        h = os.path.join(CSRC, inc)
        if os.path.exists(h) and h not in seen:
            seen.add(h)
            _headers(h, seen)
    return seen


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(p) for p in (src, *_headers(src)))
    return os.path.getmtime(lib) < newest


def _start(name: str):
    src, lib = _paths(name)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, lib


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Compile every stale kernel library in parallel; returns seconds.
    Raises with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock:
        jobs = [(n, *_start(n)) for n in names if _stale(n)]
        errors = []
        for name, proc, tmp, lib in jobs:
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build_all([name])
    with _lock:
        if name not in _libs:
            dll = ctypes.CDLL(_paths(name)[1])
            fn_name, restype, argtypes = _SIGNATURES[name]
            fn = getattr(dll, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
            _libs[name] = dll
        return _libs[name]
