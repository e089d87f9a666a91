"""ctypes bindings for the native map-core runtime (``native/mapcore.cpp``).

Builds the shared library into ``build/ov2slam_torch/`` on first import if
a C++ compiler is available; falls back to the numpy implementations in
`mapping/store.py` when it is not (``AVAILABLE`` is False then), and logs a
warning when it does.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "mapcore.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "ov2slam_torch")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmapcore.so")

_log = logging.getLogger(__name__)
_lib = None


def _ensure_built() -> bool:
    global _lib
    if _lib is not None:
        return True
    if not os.path.exists(_LIB_PATH) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)):
        if not os.path.exists(_SRC):
            _log.warning("native map core: %s missing; using numpy", _SRC)
            return False
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
                 "-shared", "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB_PATH)
        except (OSError, subprocess.SubprocessError) as e:
            _log.warning("native map core did not build (%s); using numpy",
                         e)
            return False
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _log.warning("native map core did not load (%s); using numpy", e)
        return False

    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i8p = ctypes.POINTER(ctypes.c_int8)

    lib.add_keyframe_obs.restype = ctypes.c_int32
    lib.add_keyframe_obs.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, u8p, i32p, i32p, i32p]
    lib.count_window_lms.restype = None
    lib.count_window_lms.argtypes = [
        ctypes.c_int32, i32p, i32p, ctypes.c_int32, u8p, i32p]
    lib.build_ba_obs.restype = ctypes.c_int32
    lib.build_ba_obs.argtypes = [
        ctypes.c_int32, i32p, i32p, f32p, f32p, u8p, ctypes.c_int32,
        i32p, ctypes.c_int32, i32p, i32p, f32p, i8p]
    lib.covisibility_counts.restype = None
    lib.covisibility_counts.argtypes = [
        ctypes.c_int32, i32p, ctypes.c_int32, u8p, i32p, ctypes.c_int32,
        u8p, i32p]
    _lib = lib
    return True


AVAILABLE = _ensure_built()


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def add_keyframe_obs(kfid: int, lmids: np.ndarray, lm_valid: np.ndarray,
                     lm_obs_kf: np.ndarray, lm_obs_slot: np.ndarray,
                     lm_anchor: np.ndarray) -> int:
    """In-place observer insertion; see mapcore.cpp. Arrays must be
    contiguous with the dtypes used by MapStore."""
    assert lmids.dtype == np.int32 and lmids.flags.c_contiguous
    lv = np.ascontiguousarray(lm_valid, np.uint8)
    return _lib.add_keyframe_obs(
        kfid, len(lmids), lm_obs_kf.shape[1],
        _p(lmids, ctypes.c_int32), _p(lv, ctypes.c_uint8),
        _p(lm_obs_kf, ctypes.c_int32), _p(lm_obs_slot, ctypes.c_int32),
        _p(lm_anchor, ctypes.c_int32))


def count_window_lms(window: np.ndarray, obs_lmid: np.ndarray,
                     lm_is3d_valid: np.ndarray) -> np.ndarray:
    counts = np.zeros(len(lm_is3d_valid), np.int32)
    w = np.ascontiguousarray(window, np.int32)
    v = np.ascontiguousarray(lm_is3d_valid, np.uint8)
    _lib.count_window_lms(
        len(w), _p(w, ctypes.c_int32), _p(obs_lmid, ctypes.c_int32),
        obs_lmid.shape[1], _p(v, ctypes.c_uint8),
        _p(counts, ctypes.c_int32))
    return counts


def build_ba_obs(window: np.ndarray, obs_lmid: np.ndarray,
                 obs_px: np.ndarray, obs_rpx: np.ndarray,
                 obs_stereo: np.ndarray, lm_index: np.ndarray,
                 max_obs: int):
    """Returns (n_rows, out_kf, out_lm, out_px, out_cam), padded arrays."""
    out_kf = np.full(max_obs, -1, np.int32)
    out_lm = np.full(max_obs, -1, np.int32)
    out_px = np.zeros((max_obs, 2), np.float32)
    out_cam = np.zeros(max_obs, np.int8)
    w = np.ascontiguousarray(window, np.int32)
    st = np.ascontiguousarray(obs_stereo, np.uint8)
    n = _lib.build_ba_obs(
        len(w), _p(w, ctypes.c_int32), _p(obs_lmid, ctypes.c_int32),
        _p(obs_px, ctypes.c_float), _p(obs_rpx, ctypes.c_float),
        _p(st, ctypes.c_uint8), obs_lmid.shape[1],
        _p(np.ascontiguousarray(lm_index, np.int32), ctypes.c_int32),
        max_obs, _p(out_kf, ctypes.c_int32), _p(out_lm, ctypes.c_int32),
        _p(out_px, ctypes.c_float), _p(out_cam, ctypes.c_int8))
    return n, out_kf, out_lm, out_px, out_cam


def covisibility_counts(kfid: int, obs_lmid: np.ndarray,
                        lm_is3d_valid: np.ndarray, lm_obs_kf: np.ndarray,
                        kf_valid: np.ndarray) -> np.ndarray:
    counts = np.zeros(len(kf_valid), np.int32)
    v = np.ascontiguousarray(lm_is3d_valid, np.uint8)
    kv = np.ascontiguousarray(kf_valid, np.uint8)
    _lib.covisibility_counts(
        kfid, _p(obs_lmid, ctypes.c_int32), obs_lmid.shape[1],
        _p(v, ctypes.c_uint8), _p(lm_obs_kf, ctypes.c_int32),
        lm_obs_kf.shape[1], _p(kv, ctypes.c_uint8),
        _p(counts, ctypes.c_int32))
    return counts
