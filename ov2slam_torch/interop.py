"""Carry state from numpy arrays into the port's objects.

Takes another implementation's state — as numpy arrays, e.g. read off the
JAX package's ``MapStore``, ``PlaceIndex`` and ``Camera`` — and builds the
port's objects on a given device, so the same map, index and camera can be
stepped on both sides. Imports numpy and torch only.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .core.camera import Camera
from .device import resolve_device
from .loopclosure.index import PlaceIndex
from .mapping.store import MapStore
from .utils.config import SlamConfig


def map_store(state: Mapping[str, object], cfg: SlamConfig) -> MapStore:
    """A ``MapStore`` holding a copy of ``state`` — the attribute dict of a
    store of the same layout (``vars(store)``): arrays, counters, sets."""
    m = MapStore(cfg)
    for k, v in state.items():
        if k == "cfg":
            continue
        setattr(m, k, np.array(v) if isinstance(v, np.ndarray)
                else copy.deepcopy(v))
    return m


def place_index(desc: np.ndarray, valid: np.ndarray,
                kf_ids: Sequence[int], kf_seqs: Sequence[int],
                capacity: int, device=None, *, recent_mask: int = 30,
                island_radius: int = 3, min_score: float = 0.25,
                match_bits: int = 48,
                last_candidate: Optional[int] = None) -> PlaceIndex:
    """A ``PlaceIndex`` whose store holds rows ``desc`` (n, N, 8) uint32 and
    ``valid`` (n, N) for keyframes ``kf_ids`` / ``kf_seqs``."""
    ix = PlaceIndex(capacity, recent_mask=recent_mask,
                    island_radius=island_radius, min_score=min_score,
                    match_bits=match_bits, device=device)
    for i, (k, s) in enumerate(zip(kf_ids, kf_seqs)):
        ix.add(int(k), np.asarray(desc[i], np.uint32),
               np.asarray(valid[i], bool), seq=int(s))
    ix._last_candidate = last_candidate
    return ix


def camera(model: str, width: int, height: int, K: np.ndarray,
           dist: np.ndarray, T_c0_ci: np.ndarray, device=None,
           dtype=torch.float32) -> Camera:
    """A ``Camera`` from its intrinsics, distortion and extrinsic."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return Camera(model=model, width=int(width), height=int(height),
                  K=t(K), dist=t(dist), T_c0_ci=t(T_c0_ci))


def brief_pattern(pattern: np.ndarray) -> np.ndarray:
    """The BRIEF sampling pattern as the port's describe_brief takes it:
    (256, 2, 2) float32 offsets."""
    p = np.asarray(pattern, np.float32)
    if p.shape != (256, 2, 2):
        raise ValueError(f"BRIEF pattern must be (256, 2, 2), got {p.shape}")
    return p
