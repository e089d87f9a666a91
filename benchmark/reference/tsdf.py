"""The plain reference of projective TSDF fusion (voxblox's update as the
fork's ``launch/carla.launch`` sets it), for a sample of a dense grid's
voxels, and the comparison that decides ``correct`` in the fusion cells.

Every voxel of the grid is projected into each depth frame and updated:
the signed distance to the measured surface in truncation units, clamped to
[-1, 1], averaged with the *old* weight; the weight 1/z^2 of the measured
depth (or 1), clamped to ``max_weight`` after the average; the colour
averaged alike; voxels more than one truncation behind the surface, out of
the image, or under a depth outside [min_ray, max_ray] (NaN and inf
included) take a zero weight; NaN depth poisons the voxel's tsdf. The
arithmetic is plain PyTorch, f32, in the order of the program's plain
path (``mapping/tsdf.py``), one element at a time, so that on the same
device it rounds alike.

The update of one voxel depends on that voxel alone, so the reference
follows a sample of voxels through every integration: for each distinct
frame it forms the sample's observation once (weight, weight x tsdf,
weight x colour), then replays the integrations in order. ``dtype`` sets
the precision of the grid and its update: ``torch.bfloat16`` is the
control that ``correct`` has to refuse.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..scenes import lie

MIN_DEPTH, MIN_DENOM, Z_MIN = 1e-3, 1e-9, 1e-6


def _f32(x) -> float:
    return float(np.float32(x))


def sample_voxels(V: int, n: int, seed: int) -> torch.Tensor:
    """``n`` distinct voxel indices of a grid of ``V``, drawn from
    ``seed``, sorted (int64, CPU)."""
    g = torch.Generator().manual_seed(seed % (1 << 63))
    n = min(n, V)
    idx = torch.unique(torch.randint(V, (n,), generator=g))
    while len(idx) < n:
        more = torch.randint(V, (n - len(idx),), generator=g)
        idx = torch.unique(torch.cat([idx, more]))
    return idx


def _centers_cam(idx, dims, origin, voxel, T_cw):
    """Camera-frame x, y, z of the voxel centres ``origin + (i + 0.5) *
    voxel`` under T_cw [q, t], the rotation one coordinate at a time."""
    nx, ny, nz = dims
    i = [idx // (ny * nz), (idx // nz) % ny, idx % nz]
    vox = _f32(voxel)
    p = [(i[k].to(torch.float32) + 0.5) * vox + _f32(origin[k])
         for k in range(3)]
    qw, qx, qy, qz, tx, ty, tz = (_f32(v) for v in T_cw)
    uv = (qy * p[2] - qz * p[1], qz * p[0] - qx * p[2],
          qx * p[1] - qy * p[0])
    uuv = (qy * uv[2] - qz * uv[1], qz * uv[0] - qx * uv[2],
           qx * uv[1] - qy * uv[0])
    return [p[k] + 2.0 * (qw * uv[k] + uuv[k]) + t
            for k, t in enumerate((tx, ty, tz))]


def observation(idx, depth, rgb, T_wc, K, grid: dict):
    """One frame's observation of the voxels ``idx``: (w_obs, w_obs x
    tsdf_obs, w_obs x colour or None), f32 on ``depth``'s device."""
    T_cw = np.asarray(lie.pose_inverse(np.asarray(T_wc, np.float64)),
                      np.float32)
    H, W = depth.shape
    x, y, z = _centers_cam(idx, grid["dims"], grid["origin"],
                           grid["voxel"], T_cw)
    zs = torch.where(z > Z_MIN, z, 1.0)
    u = _f32(K[0, 0]) * x / zs + _f32(K[0, 2])
    v = _f32(K[1, 1]) * y / zs + _f32(K[1, 2])
    pix = (torch.round(v).clamp_(0, H - 1).to(torch.int32) * W
           + torch.round(u).clamp_(0, W - 1).to(torch.int32))
    in_img = (z > Z_MIN) & (u >= 0) & (u <= W - 1) & (v >= 0) \
        & (v <= H - 1)
    d = depth.reshape(-1)[pix]
    d_ok = torch.isfinite(d) & (d >= _f32(grid["min_ray"])) \
        & (d <= _f32(grid["max_ray"]))
    sdf = d - z
    upd = in_img & d_ok & (sdf > -_f32(grid["trunc"]))
    tsdf_obs = torch.clamp(sdf / _f32(grid["trunc"]), -1.0, 1.0)
    if grid["const_weight"]:
        w_obs = torch.ones_like(d)
    else:
        w_obs = 1.0 / torch.clamp(d, min=MIN_DEPTH) ** 2
    w_obs = torch.where(upd, w_obs, 0.0)
    cw = None
    if rgb is not None:
        cw = rgb.reshape(-1, 3)[pix].mul_(w_obs[:, None])
    return w_obs, tsdf_obs * w_obs, cw


def fuse(idx, frames: Sequence[Tuple], order: Sequence[int], K, grid: dict,
         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The sampled voxels' tsdf, weight and colour after integrating
    ``frames[order[0]]``, ``frames[order[1]]``, ... into an empty grid
    (tsdf 1, weight 0, colour 0). ``frames`` are (depth, rgb or None,
    T_wc); the grid and its update are in ``dtype``."""
    dev = frames[0][0].device
    idx = idx.to(dev)
    used = sorted(set(int(f) for f in order))
    slot = {f: k for k, f in enumerate(used)}
    S = len(idx)
    color = frames[0][1] is not None
    wo = torch.empty((len(used), S), dtype=dtype, device=dev)
    tw = torch.empty_like(wo)
    cw = (torch.empty((len(used), S, 3), dtype=dtype, device=dev)
          if color else None)
    for f in used:
        depth, rgb, T_wc = frames[f]
        a, b, c = observation(idx, depth, rgb, T_wc, K, grid)
        wo[slot[f]], tw[slot[f]] = a, b
        if color:
            cw[slot[f]] = c
    tsdf = torch.ones(S, dtype=dtype, device=dev)
    weight = torch.zeros(S, dtype=dtype, device=dev)
    col = torch.zeros((S, 3), dtype=dtype, device=dev) if color else None
    max_w = _f32(grid["max_weight"])
    for f in order:
        k = slot[int(f)]
        w_new = weight + wo[k]
        denom = torch.clamp(w_new, min=MIN_DENOM)
        tsdf.mul_(weight).add_(tw[k]).div_(denom)
        if color:
            col.mul_(weight[:, None]).add_(cw[k]).div_(denom[:, None])
        weight = torch.clamp(w_new, max=max_w)
    out = dict(tsdf=tsdf.float(), weight=weight.float())
    if color:
        out["color"] = col.float()
    return out


def compare(prog: Dict[str, torch.Tensor],
            ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers ``correct`` compares: voxels whose tsdf is NaN on one
    side only; the largest tsdf gap (truncation units) where both are
    numbers; the largest weight gap relative to the reference's weight or
    the least weight one observation gives (1 / 10 m squared), whichever
    is larger; the largest colour gap (0-255 units)."""
    out = {}
    pt, rt = prog["tsdf"].float(), ref["tsdf"].to(prog["tsdf"].device)
    nan_p, nan_r = torch.isnan(pt), torch.isnan(rt)
    out["tsdf_nan_mismatch"] = float((nan_p ^ nan_r).sum())
    both = ~(nan_p | nan_r)
    out["tsdf_max_err"] = float((pt - rt).abs()[both].max()) \
        if both.any() else 0.0
    pw = prog["weight"].float()
    rw = ref["weight"].to(pw.device)
    rel = (pw - rw).abs() / torch.clamp(rw.abs(), min=1e-2)
    out["weight_max_rel_err"] = float(torch.nan_to_num(rel, nan=1.0).max())
    if "color" in ref:
        pc, rc = prog["color"].float(), ref["color"].to(pw.device)
        gap = torch.nan_to_num((pc - rc).abs(), nan=255.0)
        out["color_max_err"] = float(gap.max())
    return out
