"""Carry state from numpy arrays into the port's objects.

Takes another implementation's state — as numpy arrays, e.g. read off the
JAX package's ``MapStore``, ``PlaceIndex``, ``Camera``, ``TsdfVolume``,
``BAParams`` and ``BAProblem`` — and builds the port's objects on a given
device, so the same map, index, camera, volume and bundle-adjustment
problem can be stepped on both sides. Imports numpy and torch
only. (A map's state also travels through the checkpoint ``.npz``, whose
format both packages share.)
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .core.camera import Camera
from .device import resolve_device
from .loopclosure.index import PlaceIndex
from .mapping.store import BAProblem, MapStore
from .mapping.tsdf import TsdfVolume
from .solvers.ba import BAParams
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


def tsdf_volume(state: Mapping[str, object], device=None) -> TsdfVolume:
    """A ``TsdfVolume`` on ``device`` holding another volume's state:
    ``tsdf`` (V,), ``weight`` (V,), ``color`` (V, 3) or None, ``origin``,
    ``dims``, the parameters (``voxel_size``, ``truncation``, ``min_ray``,
    ``max_ray``, ``use_const_weight``, ``max_weight``) and
    ``n_integrated``."""
    color = state.get("color")
    vol = TsdfVolume(
        origin=np.asarray(state["origin"], np.float32),
        dims=tuple(int(n) for n in state["dims"]),
        voxel_size=float(state["voxel_size"]),
        truncation=float(state["truncation"]),
        min_ray=float(state["min_ray"]), max_ray=float(state["max_ray"]),
        use_const_weight=bool(state["use_const_weight"]),
        max_weight=float(state["max_weight"]),
        with_color=color is not None, device=device)
    V = int(np.prod(vol.dims))

    def t(a, shape):
        a = np.array(a, np.float32)     # a copy the volume owns
        if a.shape != shape:
            raise ValueError(f"TSDF state of shape {a.shape}, want {shape}")
        return torch.from_numpy(a).to(vol.device)

    vol.tsdf = t(state["tsdf"], (V,))
    vol.weight = t(state["weight"], (V,))
    vol.color = None if color is None else t(color, (V, 3))
    vol.n_integrated = int(state.get("n_integrated", 0))
    return vol


def ba_params(fx, fy, cx, cy, T_rl, device=None) -> BAParams:
    """The solvers' calibration from the fields of another package's
    ``BAParams``: the four intrinsics (scalars) and ``T_rl`` (7,), the
    left camera's pose in the right camera's frame."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    intr = tuple(float(np.asarray(x)) for x in (fx, fy, cx, cy))
    return BAParams(fx=t(fx), fy=t(fy), cx=t(cx), cy=t(cy), T_rl=t(T_rl),
                    intr=intr)


def ba_problem(state: Mapping[str, object]) -> BAProblem:
    """A ``BAProblem`` holding copies of ``state``'s arrays, a mapping of
    its field names (e.g. ``dataclasses.asdict`` of another package's
    problem); a field ``state`` lacks or holds as None keeps its
    default."""
    names = {f.name for f in dataclasses.fields(BAProblem)}
    return BAProblem(**{k: np.array(v) for k, v in state.items()
                        if k in names and v is not None})
