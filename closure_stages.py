#!/usr/bin/env python3
"""Where slice A's endpoint error comes from: the loop closure, stage by
stage, for given RANSAC seeds of the port.

Runs slice A of ``chip_smoke.py`` through ``ov2slam_torch``'s
``SlamManager(seed=s)`` on ``--device`` and, at the loop closure, records
each window keyframe's position error against the ground truth after the
pose graph, before the loose BA and after it. The loose BA's problem is
also solved on the CPU from the same inputs, so a difference between
devices shows apart from a difference between problems. One JSON line per
seed.

    python3 closure_stages.py --device cuda 3 42
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--dump", default=None,
                    help="write the first seed's loose-BA input here")
    args = ap.parse_args(argv)

    import chip_smoke
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.models import estimator
    from ov2slam_torch.models.slam import SlamManager
    from ov2slam_torch.solvers import ba_variants
    from ov2slam_torch.solvers.ba_invdepth import ba_solve_invdepth_two_pass
    from ov2slam_torch.utils import profiles

    seq, cfg = chip_smoke.make_slice("A", synthetic, profiles)
    events = []
    in_loose = [False]

    def kf_errs(m, kfs):
        frames = [int(np.argmin(np.abs(seq.times - m.kf_times[k])))
                  for k in kfs]
        return [round(float(np.linalg.norm(
            m.kf_poses[k, 4:7] - seq.gt_poses[i, 4:7])), 4)
            for k, i in zip(kfs, frames)]

    def window(m, lo, hi):
        s_lo, s_hi = int(m.kf_seq[lo]), int(m.kf_seq[hi])
        return [int(k) for k in m.kfs_by_seq()
                if s_lo <= m.kf_seq[k] <= s_hi]

    structure_only_ba = ba_variants.structure_only_ba
    loose_ba = ba_variants.loose_ba
    solve_problem = estimator.solve_problem

    def traced_structure_only(m, kf_ids, params, cfg_):
        # the closer runs it right after the pose graph and the merges
        events.append(dict(stage="after_pose_graph",
                           kf_errs=kf_errs(m, list(kf_ids))))
        return structure_only_ba(m, kf_ids, params, cfg_)

    def traced_loose(m, kf_min, kf_max, params, cfg_):
        w = window(m, kf_min, kf_max)
        events.append(dict(stage="before_loose_ba", kf_errs=kf_errs(m, w)))
        in_loose[0] = True
        n = loose_ba(m, kf_min, kf_max, params, cfg_)
        in_loose[0] = False
        events.append(dict(stage="after_loose_ba", kf_errs=kf_errs(m, w)))
        return n

    dumped = []

    def dump_problem(prob, rho, ray, obs_valid, params, cfg_, iters):
        kf = prob.kf_ids
        gt = np.zeros((len(kf), 3))
        for w, k in enumerate(kf):
            if k >= 0:
                gt[w] = seq.gt_poses[int(np.argmin(np.abs(
                    seq.times - slam_now[0].map.kf_times[k]))), 4:7]
        np.savez_compressed(
            args.dump, **{f: getattr(prob, f) for f in (
                "kf_ids", "kf_poses", "kf_fixed", "lm_ids", "lm_pos",
                "obs_kf", "obs_lm", "obs_px", "obs_cam", "obs_valid",
                "lm_anchor", "lm_anchor_px")},
            rho=rho, ray=ray, obs_valid_inv=obs_valid,
            intr=np.asarray(params.intr, np.float64),
            T_rl=params.T_rl.cpu().numpy(),
            robust_th=float(cfg_.robust_mono_th),
            iters_robust=int(iters or cfg_.ba_iters),
            iters_l2=3 if cfg_.apply_l2_after_robust else 0,
            gt_pos=gt, seed=args.seeds[0], device=args.device)

    def traced_solve(prob, rho, ray, obs_valid, params, cfg_, iters=None):
        out = solve_problem(prob, rho, ray, obs_valid, params, cfg_,
                            iters=iters)
        if in_loose[0] and args.dump and not dumped:
            dump_problem(prob, rho, ray, obs_valid, params, cfg_, iters)
            dumped.append(args.dump)
        if in_loose[0]:
            cpu = params._replace(**{f: getattr(params, f).cpu() for f in
                                     ("fx", "fy", "cx", "cy", "T_rl")})
            ref = ba_solve_invdepth_two_pass(
                *[torch.as_tensor(np.ascontiguousarray(a)) for a in (
                    prob.kf_poses, prob.kf_fixed, rho, prob.lm_anchor, ray,
                    prob.obs_kf, prob.obs_lm, prob.obs_px, prob.obs_cam,
                    obs_valid)], cpu,
                robust_th=float(cfg_.robust_mono_th),
                iters_robust=iters or cfg_.ba_iters,
                iters_l2=3 if cfg_.apply_l2_after_robust else 0)
            moved = [float(np.abs(p[:, 4:7] - prob.kf_poses[:, 4:7]).max())
                     for p in (out[0], ref[0].numpy())]
            events.append(dict(
                stage="loose_ba_solve", n_obs=int(prob.n_obs),
                cost=[float(out[4]), float(ref[4])],
                inliers=[int(out[3].sum()), int(ref[3].sum())],
                max_pose_move_m=moved,
                device_vs_cpu_m=float(np.abs(out[0][:, 4:7]
                                             - ref[0].numpy()[:, 4:7]).max())))
        return out

    ba_variants.structure_only_ba = traced_structure_only
    ba_variants.loose_ba = traced_loose
    estimator.solve_problem = traced_solve

    slam_now = [None]
    for s in args.seeds:
        events.clear()
        slam = SlamManager(cfg, device=args.device, seed=s)
        slam_now[0] = slam
        for i in range(len(seq.times)):
            T = slam.process_frame(seq.images_left[i], seq.images_right[i],
                                   float(seq.times[i]))
        end = float(np.linalg.norm(np.asarray(T, np.float64)[4:7]
                                   - seq.gt_poses[-1, 4:7]))
        print(json.dumps(dict(seed=s, device=args.device, end_err_m=end,
                              closures=slam.loop_closer.n_closures,
                              stages=events)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
