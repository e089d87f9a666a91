"""Dense fusion of an RGB-D rig, closed loop, back to back.

Set-up renders every camera frame of the rig's drive on the device from
the seed (the street's boxes and colours; the rig's path and the cameras
are the configuration's), builds the grid, and warms one integration. The
window then fuses rig steps one after another: a step is one
``TsdfVolume.integrate`` call a camera (depth, colour and pose already
resident) and one ``torch.cuda.synchronize()``; the drive's steps are
replayed forward, then backward, and so on (``step_at``). A step's latency
runs from the first call to the end of the last integration, read from
CUDA events recorded around the step (host timing is too coarse for a
step of a few ms).

``correct``: a sample of voxels drawn from the seed is followed through
every integration of the window by the plain reference
(``reference/tsdf.py``), once the window has closed and the program's grid
has been read and freed.
"""

from __future__ import annotations

import time
from typing import List

from .. import common
from ..reference import tsdf as ref_tsdf
from ..scenes import street


def step_at(steps: int, s: int) -> int:
    """The rig step fused ``s``-th: 0, 1, ..., steps - 1, steps - 2, ...,
    1, 0, 1, ... (forward, then backward)."""
    if steps == 1:
        return 0
    period = 2 * (steps - 1)
    k = s % period
    return k if k < steps else period - k


def _volume(tsdf_mod, grid: dict, device):
    import numpy as np

    return tsdf_mod.TsdfVolume(
        origin=np.asarray(grid["origin"], np.float32),
        dims=tuple(grid["dims"]), voxel_size=grid["voxel"],
        truncation=grid["trunc"], min_ray=grid["min_ray"],
        max_ray=grid["max_ray"], use_const_weight=grid["const_weight"],
        max_weight=grid["max_weight"], with_color=grid["color"],
        device=device)


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    """One run of a fusion cell on ``device`` ("cuda", or "cpu" for the
    tests); ``t_start`` is the process's start on the ``perf_counter``
    clock. Returns the pieces of the result line (see ``run.py``)."""
    import torch

    from ov2slam_torch.mapping import tsdf as tsdf_mod

    cfg = cell["config_file"]
    rig, grid, traffic = cfg["rig"], cfg["grid"], cell["traffic"]
    cuda = device == "cuda"
    dev = torch.device(device)
    if cuda:
        from ov2slam_torch import kernels

        kernels.build_all(["tsdf"])
    scene = street.street_scene(seed)
    K = street.rig_intrinsics(rig)
    poses = street.rig_poses(rig)
    W, H, n_cams = rig["width"], rig["height"], rig["n_cams"]
    frames = []
    for T_wc in poses:
        depth, rgb = street.render_rgbd(scene, T_wc, K, W, H, dev)
        frames.append((depth, rgb if grid["color"] else None, T_wc))
    vol = _volume(tsdf_mod, grid, dev)
    vol.integrate(frames[0][0], K, frames[0][2], rgb=frames[0][1])
    del vol
    vol = _volume(tsdf_mod, grid, dev)
    if cuda:
        torch.cuda.synchronize()

    def step(p: int, host_ms=None):
        for c in range(n_cams):
            depth, rgb, T_wc = frames[p * n_cams + c]
            if host_ms is None:
                vol.integrate(depth, K, T_wc, rgb=rgb)
            else:
                t0 = time.perf_counter()
                vol.integrate(depth, K, T_wc, rgb=rgb)
                host_ms.append(1e3 * (time.perf_counter() - t0))

    prof = common.profiler(cuda) if trace else None
    if prof is not None:
        prof.start()
    w0 = time.time_ns() / 1e3
    trace_s = traffic["trace_seconds"]
    host_ms: List[float] = []
    marks, step_ms = [], []
    n = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    tracing = prof is not None
    while True:
        p = step_at(rig["steps"], n)
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            step(p, None if tracing or not trace else host_ms)
            e1.record()
            torch.cuda.synchronize()
            marks.append((e0, e1))
        else:
            s0 = time.perf_counter()
            step(p, None if tracing or not trace else host_ms)
            step_ms.append(1e3 * (time.perf_counter() - s0))
        n += 1
        now = time.perf_counter() - t0
        if tracing and now >= trace_s:
            w1 = time.time_ns() / 1e3
            prof.stop()
            tracing = False
        if now >= seconds:
            break
    window_s = time.perf_counter() - t0
    if tracing:
        w1 = time.time_ns() / 1e3
        prof.stop()
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in marks]
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    integrations = n * n_cams

    # the program's grid at the sample, then its state freed
    V = grid["dims"][0] * grid["dims"][1] * grid["dims"][2]
    idx = ref_tsdf.sample_voxels(V, cell["check"]["voxels"], seed)
    idx_d = idx.to(dev)
    prog = dict(tsdf=vol.tsdf[idx_d].clone(),
                weight=vol.weight[idx_d].clone())
    if grid["color"]:
        prog["color"] = vol.color[idx_d].clone()
    del vol
    if cuda:
        torch.cuda.empty_cache()
    fused = [step_at(rig["steps"], s) * n_cams + c for s in range(n)
             for c in range(n_cams)]
    ref = ref_tsdf.fuse(idx, frames, fused, K, grid)
    nums = ref_tsdf.compare(prog, ref)
    checks = {k: (v, cell["check"]["limits"][k], "<=")
              for k, v in nums.items()}

    tr = None
    if prof is not None:
        tr = common.reduce_traces([common.read_trace(prof)], w0, w1)
    obs = dict(trace=tr, host_ms={"integrate": host_ms},
               shapes={"tsdf_integrate": dict(
                   V=V, H=H, W=W, color=grid["color"],
                   const_weight=grid["const_weight"])})
    return dict(
        setup_s=setup_s, attempted=integrations, failed=0,
        e2e={"fused_frames_per_s": (integrations / window_s, "frames/s"),
             "rig_step_ms_p95": (common.quantile(step_ms, 0.95), "ms")},
        obs=obs, checks=checks, memory_peak=peak, chips=1, trace=tr)
