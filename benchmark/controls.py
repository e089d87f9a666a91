"""The controls that ``correct`` has to refuse, read at a cell's own size.

    python3 -m benchmark.controls carla_rig.fuse --seeds 11 12 13 \\
        --integrations 110000
    python3 -m benchmark.controls euroc_stereo.fleet --seeds 11 12 13 \\
        --seconds 51

For a fusion cell: the plain reference computed with its grid and update
in bfloat16, put in the program's place, against the same reference in
float32, over the integrations a window makes (the drive replayed as the
window replays it). For a SLAM fleet: a run of the cell in which every
session, past its window, also puts the reference in bfloat16 in the
program's place on its sampled frames (the CLAHE'd frame, the pyramid and
the KLT), judged by the same comparison. Prints one JSON line a seed with
the numbers the cell compares (the program's and the control's) and its
limits. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def fuse_control(cell: dict, seed: int, integrations: int, device: str,
                 dtype_name: str = "bfloat16") -> dict:
    """The fusion cell's numbers for the reference in ``dtype_name`` against
    the reference in float32, on the cell's voxel sample."""
    import torch

    from .reference import tsdf as ref_tsdf
    from .scenes import street
    from .traffic.rig_fuse import step_at

    cfg = cell["config_file"]
    rig, grid = cfg["rig"], cfg["grid"]
    dev = torch.device(device)
    scene = street.street_scene(seed)
    K = street.rig_intrinsics(rig)
    frames = []
    for T_wc in street.rig_poses(rig):
        d, c = street.render_rgbd(scene, T_wc, K, rig["width"],
                                  rig["height"], dev)
        frames.append((d, c if grid["color"] else None, T_wc))
    n_cams = rig["n_cams"]
    steps = -(-integrations // n_cams)
    order = [step_at(rig["steps"], s) * n_cams + c for s in range(steps)
             for c in range(n_cams)]
    V = grid["dims"][0] * grid["dims"][1] * grid["dims"][2]
    idx = ref_tsdf.sample_voxels(V, cell["check"]["voxels"], seed)
    t0 = time.perf_counter()
    ref = ref_tsdf.fuse(idx, frames, order, K, grid)
    t_ref = time.perf_counter() - t0
    low = ref_tsdf.fuse(idx, frames, order, K, grid,
                        dtype=getattr(torch, dtype_name))
    nums = ref_tsdf.compare(low, ref)
    return dict(cell=cell["name"], seed=seed, integrations=len(order),
                control=dtype_name, reference_s=t_ref, numbers=nums,
                limits=cell["check"]["limits"],
                refused=any(nums[k] > cell["check"]["limits"][k]
                            for k in nums))


def fleet_control(cell: dict, seed: int, seconds: float, device: str,
                  inproc: bool = False) -> dict:
    """A fleet run with each session's control numbers beside its own."""
    from .traffic import slam_fleet

    out = slam_fleet.run(cell, seed, seconds, False, device,
                         time.perf_counter(), inproc=inproc, control=True)
    ctrl = [s["control"] for s in out["per_session"]]
    low = dict(
        clahe_max_err=max([c["clahe_max_err"] for c in ctrl] or [0.0]),
        pyramid_max_err=max([c["pyramid_max_err"] for c in ctrl] or [0.0]),
        klt_mismatch_share=slam_fleet.mismatch_share(
            [t for c in ctrl for t in c["tracks"]]))
    lim = cell["check"]["limits"]
    return dict(cell=cell["name"], seed=seed, control="bfloat16",
                program={k: v for k, (v, _, _) in out["checks"].items()},
                numbers=low, limits=lim,
                e2e={k: v for k, (v, _) in out["e2e"].items()},
                sessions=[dict(frames=s["frames"], keyframes=s["keyframes"],
                               ate_rmse_m=s["ate_rmse_m"])
                          for s in out["per_session"]],
                refused=any(low[k] > lim[k] for k in low))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--integrations", type=int, default=110000)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    from . import common

    common.set_environment()
    cell = common.workload(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("controls: needs a CUDA device", file=sys.stderr)
        return 1
    for seed in args.seeds:
        if cell["traffic"]["kind"] == "slam_fleet":
            out = fleet_control(cell, seed, args.seconds, "cuda")
        else:
            out = fuse_control(cell, seed, args.integrations, "cuda")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
