"""Command line: replay a dataset through the port's SLAM pipeline.

Port of the repository's root ``run_slam.py`` (the equivalent of
`ov2slam_node`, `src/ov2slam_node.cpp:159-223`, without ROS): replay an
EuRoC, KITTI or TartanAir directory, or a generated synthetic sequence,
write the trajectory files and ``viewer.html`` into ``--out``, and print a
one-line JSON report (ATE when there is ground truth).

Usage:
    python -m ov2slam_torch.run_slam --kitti /data/kitti --kitti-seq 00 \\
        --config <yaml> [--profile fast|average|accurate] [--out results/]
    python -m ov2slam_torch.run_slam --synthetic loop --frames 160 [--mono]

It runs on the GPU unless ``--device cpu`` is given. Beyond the root
script's flags it takes ``--device`` and ``--save-map PATH`` (the final map
as a checkpoint ``.npz``, which either package's ``load_map`` reads).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ov2slam_torch.run_slam")
    ap.add_argument("--euroc", help="EuRoC ASL sequence root")
    ap.add_argument("--kitti", help="KITTI odometry root")
    ap.add_argument("--kitti-seq", default="00", help="KITTI sequence id")
    ap.add_argument("--tartanair", help="TartanAir trajectory root")
    ap.add_argument("--config", help="parameter YAML (reference format)")
    ap.add_argument("--synthetic",
                    choices=["arc", "forward", "loop", "revisit",
                             "revisit_y", "lawnmower"],
                    help="generate a synthetic sequence instead")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--realism", action="store_true",
                    help="photometric realism: sensor noise, exposure "
                         "drift, vignetting, moving occluders")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="run mapping/BA on the async worker thread")
    ap.add_argument("--profile", choices=["fast", "average", "accurate"])
    ap.add_argument("--mono", action="store_true")
    ap.add_argument("--out", default=".")
    ap.add_argument("--timings", action="store_true")
    ap.add_argument("--trace", metavar="DIR",
                    help="capture a torch.profiler trace into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--save-map", metavar="PATH",
                    help="write the final map as a checkpoint (.npz)")
    return ap


def _dataset(args, error):
    """(cfg, frames, gt poses, gt times, body-from-camera) for ``args``."""
    from .utils.config import SlamConfig, load_config

    if args.synthetic:
        from .io.synthetic import DEFAULT_REALISM, stream_sequence

        # streaming render: frames are generated lazily, so long
        # validation runs don't hold the whole image stack in memory
        seq = stream_sequence(
            n_frames=args.frames, stereo=not args.mono,
            kind=args.synthetic, width=752, height=480, n_points=8000,
            speed=0.05,
            realism=DEFAULT_REALISM if args.realism else None)
        return seq.make_config(), seq, seq.gt_poses, None, None
    if not (args.euroc or args.kitti or args.tartanair):
        error("need --euroc, --kitti, --tartanair or --synthetic")
    cfg = load_config(args.config) if args.config else SlamConfig()
    if args.mono:
        cfg.mono, cfg.stereo = True, False
    if args.euroc:
        from .io.euroc import EurocDataset

        ds = EurocDataset(args.euroc, stereo=cfg.stereo)
    elif args.kitti:
        from .io.kitti import KittiDataset

        ds = KittiDataset(args.kitti, args.kitti_seq, stereo=cfg.stereo)
    else:
        from .io.tartanair import TartanAirDataset

        ds = TartanAirDataset(args.tartanair, stereo=cfg.stereo)
    gt = ds.ground_truth()
    # EuRoC GT is the body (IMU) frame: push through body_T_cam0
    T_body_cam = cfg.cam_left.T_body_cam if args.euroc else None
    return (cfg, iter(ds), gt[1] if gt else None, gt[0] if gt else None,
            T_body_cam)


def main(argv: Optional[Sequence[str]] = None):
    """Run the command line ``argv`` (default: ``sys.argv[1:]``); prints the
    report and returns ``(report dict, SLAM manager)``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    from .io.runner import run_sequence
    from .mapping.checkpoint import save_map
    from .models.slam import SlamManager
    from .utils.profiler import Profiler
    from .utils.profiles import apply_profile

    os.makedirs(args.out, exist_ok=True)
    cfg, frames, gt, gt_times, T_body_cam = _dataset(args, ap.error)
    if args.profile:
        apply_profile(cfg, args.profile)
    cfg.validate()

    if args.use_async:
        from .models.pipeline import AsyncSlamManager

        slam = AsyncSlamManager(cfg, device=args.device)
    else:
        slam = SlamManager(cfg, device=args.device)
    try:
        kw = dict(gt_poses=gt, gt_times=gt_times, T_body_cam=T_body_cam,
                  out_dir=args.out, slam=slam)
        if args.trace:
            with Profiler.device_trace(args.trace):
                res = run_sequence(cfg, frames, **kw)
        else:
            res = run_sequence(cfg, frames, **kw)
    finally:
        if args.use_async:
            slam.close()
    if args.save_map:
        save_map(slam.map, args.save_map)
    report = dict(
        frames=res.n_frames, processed=res.n_processed,
        dropped=res.n_dropped, keyframes=res.n_keyframes,
        closures=res.n_closures, wall_s=round(res.wall_s, 2),
        fps=round(res.fps, 2),
        ate_m=None if res.ate is None else round(res.ate, 4),
        ate_scaled_m=(None if res.ate_scaled is None
                      else round(res.ate_scaled, 4)),
    )
    print(json.dumps(report), flush=True)
    if args.timings:
        print(Profiler.instance().summary(), file=sys.stderr)
    return report, slam


if __name__ == "__main__":
    main()
