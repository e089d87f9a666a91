"""Map checkpoint / resume.

The reference has **no** persistence: all state is lost on exit except
trajectory text files (survey §5 "Checkpoint/resume — none"). Because our
map is SoA arrays, checkpointing is a single compressed-npz save of the
arrays + scalar cursors — making session resume, post-hoc map inspection,
and crash recovery first-class.
"""

from __future__ import annotations

import numpy as np

from .store import MapStore

_ARRAYS = [
    "kf_valid", "kf_times", "kf_poses", "kf_seq",
    "obs_lmid", "obs_px", "obs_rpx", "obs_is_stereo", "obs_desc",
    "lm_valid", "lm_is3d", "lm_pos", "lm_desc", "lm_anchor_kf",
    "lm_obs_kf", "lm_obs_slot", "lm_gen",
]
_SCALARS = ["_next_kf", "_next_lm", "_kf_seq_counter"]
_FREELISTS = ["_free_kf", "_free_lm"]


def save_map(store: MapStore, path: str):
    """Write the full map state to a compressed .npz."""
    data = {name: getattr(store, name) for name in _ARRAYS}
    for name in _SCALARS:
        data[name] = np.asarray(getattr(store, name))
    for name in _FREELISTS:
        data[name] = np.asarray(getattr(store, name), np.int64)
    data["capacities"] = np.asarray([store.K, store.L, store.N])
    np.savez_compressed(path, **data)


def load_map(store: MapStore, path: str) -> MapStore:
    """Restore map state in place (capacities must match the config)."""
    with np.load(path) as data:
        K, L, N = data["capacities"]
        if (K, L, N) != (store.K, store.L, store.N):
            raise ValueError(
                f"checkpoint capacities {(K, L, N)} != config "
                f"{(store.K, store.L, store.N)}")
        for name in _ARRAYS:
            if name in data:
                getattr(store, name)[...] = data[name]
        for name in _SCALARS:
            if name in data:
                setattr(store, name, int(data[name]))
        for name in _FREELISTS:
            if name in data:
                setattr(store, name, [int(v) for v in data[name]])
    return store
