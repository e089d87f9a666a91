"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/ov2slam_torch/lib<name>.so`` — a shared library with a plain C
interface, loaded with ``ctypes`` — at first use, or ahead of time with
:func:`build_all` (one ``nvcc`` process per source, all started together).
A library newer than its source and than every ``csrc`` header the source
includes is reused. Loading a library declares every launch function it
exports (:func:`entry_points`) and runs its set-up function, if it has one
(``_INIT``: kernel attributes such as dynamic shared memory above 48 KB). ptxas's resource report (registers, shared memory,
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
    "essential_ransac": ("essential_ransac_launch", _C.c_int,
                         [_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
                          _C.c_void_p, _C.c_int, _C.c_void_p, _C.c_int,
                          _C.c_void_p, _C.c_void_p, _C.c_float, _C.c_float,
                          _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
                          _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
                          _C.c_void_p]),
    "pnp_refine": ("pnp_refine_launch", _C.c_int,
                   [_C.c_void_p, _C.c_void_p, _C.c_int, _C.c_void_p,
                    _C.c_int, _C.c_void_p, _C.c_int, _C.c_void_p,
                    _C.c_void_p, _C.c_float, _C.c_int, _C.c_float,
                    _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p]),
    # (a pointer to the host's argument struct, the stream)
    "ba_normal_eq": ("ba_normal_eq_launch", _C.c_int,
                     [_C.c_void_p, _C.c_void_p]),
    "ba_schur_step": ("ba_schur_step_launch", _C.c_int,
                      [_C.c_void_p, _C.c_void_p]),
    "undistort_points": ("undistort_points_launch", _C.c_int,
                         [_C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p,
                          _C.c_void_p, _C.c_void_p, _C.c_void_p,
                          _C.c_void_p, _C.c_int, _C.c_int, _C.c_int,
                          _C.c_void_p, _C.c_void_p]),
    "separable_filter": ("separable_filter_launch", _C.c_int,
                         [_C.c_void_p, _C.c_int, _C.c_int, _C.c_int,
                          _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p,
                          _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p,
                          _C.c_void_p]),
    "clahe": ("clahe_launch", _C.c_int,
              [_C.c_void_p, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
               _C.c_int, _C.c_float, _C.c_int, _C.c_void_p, _C.c_void_p]),
    # the state and the images, the sizes, the pose, intrinsics, origin,
    # voxel and the plain version's f32 constants, the weight mode
    "tsdf": ("tsdf_integrate_launch", _C.c_int,
             [*[_C.c_void_p] * 5, *[_C.c_int] * 5, *[_C.c_float] * 23,
              _C.c_int, _C.c_void_p]),
}
KERNELS = tuple(_SIGNATURES)
# a library's further launch functions, beside its first above
_EXTRA_SIGNATURES = {
    "undistort_points": {
        "undistort_normalize_launch": (
            _C.c_int, [_C.c_void_p, _C.c_int, _C.c_void_p, _C.c_int,
                       _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_void_p,
                       _C.c_int, *[_C.c_void_p] * 9, _C.c_int, _C.c_int,
                       *[_C.c_void_p] * 6]),
    },
    "tsdf": {
        "esdf_sweep_launch": (
            _C.c_int, [_C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int,
                       _C.c_int, _C.c_float, _C.c_float, _C.c_void_p]),
    },
    "separable_filter": {
        "separable_pyramid_launch": (
            _C.c_int, [_C.c_void_p, _C.c_int, _C.c_int, _C.c_int,
                       _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p]),
        "separable_scharr_launch": (
            _C.c_int, [_C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p,
                       _C.c_void_p, _C.c_void_p]),
    },
}
# a library's set-up function (no arguments; a CUDA error code), called
# once when it is loaded: the kernels' attributes, such as dynamic shared
# memory above 48 KB, set before any launch and outside any capture
_INIT = {"separable_filter": "separable_filter_init",
         "clahe": "clahe_init"}


def entry_points(name: str) -> Dict[str, tuple]:
    """Every launch function library ``name`` exports: {C name: (restype,
    argtypes)}, its first (``_SIGNATURES``) first."""
    fn, restype, argtypes = _SIGNATURES[name]
    return {fn: (restype, argtypes), **_EXTRA_SIGNATURES.get(name, {})}


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
            for fn_name, (restype, argtypes) in entry_points(name).items():
                fn = getattr(dll, fn_name)
                fn.restype = restype
                fn.argtypes = argtypes
            if name in _INIT:
                init = getattr(dll, _INIT[name])
                init.restype, init.argtypes = ctypes.c_int, []
                rc = init()
                if rc != 0:
                    raise RuntimeError(f"{_INIT[name]} failed: code {rc}")
            _libs[name] = dll
        return _libs[name]
