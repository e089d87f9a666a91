#!/usr/bin/env python3
"""Device times of the dense-fusion kernels (``csrc/tsdf.cu``) at slice G's
size, with digests of their outputs (GPU only).

Builds a 640x640x64 grid (slice G's, 26.2 M voxels) holding a state seen
before (every voxel with a weight in [0, 5), a tsdf in [-1, 1] and a
colour, from ``--seed``), renders slice G's first rig step (six 800x600
RGB-D frames, ``chip_smoke.render_rgbd``) and an occupancy grid (1% of the
voxels, from the seed), then:

- ``integrate``: one integration of frame 0 (colour on, 1/z^2 weights)
  through ``mapping/tsdf.py::_tsdf_integrate``: ms a call (CUDA events
  around one call, the median of ``--runs``), device ms a call (``--runs``
  calls queued behind a sleep), and ms after the card idled (a call after
  ``--idle-s`` seconds with nothing queued, the median of 5:
  ``chip_smoke.time_after_idle``);
- ``sweep``: ``_esdf_sweep`` of the occupancy grid, 50 sweeps a call, the
  same figures per sweep (after idling: one call of 50 sweeps);
- digests: the sha1 of the tsdf, weight and colour after the six frames'
  integrations in each option set (colour on or off, constant or 1/z^2
  weights) from the seeded state, and of 50 sweeps' field. Equal digests
  across two trees mean equal bits.

Prints one JSON line with the card's name and power limit, each figure
beside its bound (``roofline.tsdf_integrate_bound``, ``esdf_sweep_bound``)
and ptxas's registers and stack of each kernel. Runs on any tree of the
port that has the kernels, so that two builds compare in one chip call:
unpack the other tree (``git archive``), copy this script there, and run
both in turns (this, other, other, this).

    python3 tsdf_probe.py --label change --runs 20
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys


def digest(*ts) -> str:
    h = hashlib.sha1()
    for t in ts:
        if t is not None:
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--idle-s", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from ov2slam_torch import kernels, roofline
    from ov2slam_torch.mapping import tsdf

    if not torch.cuda.is_available():
        print("tsdf_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernels.build_all(["tsdf"])
    ptxas = [ln.strip() for ln in kernels.BUILD_LOG.get("tsdf", "")
             .splitlines() if "registers" in ln or "stack frame" in ln]

    g = cs.SLICE_G
    dims = g["dims"]
    V = dims[0] * dims[1] * dims[2]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = (torch.rand(V, device=dev, generator=gen) * 2 - 1,
             torch.rand(V, device=dev, generator=gen) * 5,
             torch.rand((V, 3), device=dev, generator=gen) * 255)
    K = cs.rig_intrinsics()
    scene = cs.street_scene()
    frames = []
    for T_wc in cs.rig_poses()[:g["n_cams"]]:
        depth, rgb = cs.render_rgbd(scene, T_wc, K, dev)
        frames.append((depth, rgb, cs.lie_np_inverse32(T_wc)))
    origin = np.asarray(g["origin"], np.float32)

    def integrate(st, frame, color=True, const=False):
        depth, rgb, T_cw = frame
        tsdf._tsdf_integrate(
            st[0], st[1], st[2] if color else None, depth,
            rgb if color else None, T_cw, K[0, 0], K[1, 1], K[0, 2],
            K[1, 2], origin, g["voxel"], g["trunc"], g["min_ray"],
            g["max_ray"], 1e4, dims=dims, use_const_weight=const)

    digests = {}
    for color in (True, False):
        for const in (False, True):
            st = [x.clone() for x in state]
            for frame in frames:
                integrate(st, frame, color, const)
            digests[f"integrate color={color} const={const}"] = digest(
                st[0], st[1], st[2] if color else None)
            del st
    occ = torch.rand(dims, device=dev, generator=gen) < 0.01
    d0 = torch.where(occ, 0.0, 1e9).to(torch.float32)
    n_sweeps = int(round(g["esdf_max"] / g["voxel"]))
    digests["sweep 50"] = digest(tsdf._esdf_sweep(d0, g["voxel"], n_sweeps))

    st = [x.clone() for x in state]
    run = lambda: integrate(st, frames[0])          # noqa: E731
    sweeps = lambda: tsdf._esdf_sweep(d0, g["voxel"], n_sweeps)  # noqa
    H, W = frames[0][0].shape
    rec = dict(
        label=args.label, device=roofline.nvidia_smi_line(),
        torch=torch.__version__, ptxas=ptxas, digests=digests,
        integrate=dict(
            ms=cs.time_cuda(run, args.runs),
            device_ms=cs.time_cuda_queued(run, args.runs),
            ms_after_idle=cs.time_after_idle(run, args.idle_s),
            **roofline.tsdf_integrate_bound(V, H, W)),
        sweep=dict(
            ms=cs.time_cuda(sweeps, max(args.runs // 4, 3)) / n_sweeps,
            device_ms=cs.time_cuda_queued(sweeps, max(args.runs // 4, 3))
            / n_sweeps,
            ms_after_idle=cs.time_after_idle(sweeps, args.idle_s)
            / n_sweeps,
            **roofline.esdf_sweep_bound(V)))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
