#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ov2slam_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build every hand-written kernel from ``ov2slam_torch/csrc`` (nvcc,
     sm_90a), in parallel;
  3. hold each kernel against its plain PyTorch versions on the card at
     the index capacities and on edge cases (atol 0), and time them; time
     one compaction of slice B's index;
  4. slice A: the loop-closure test sequence (376x240, 160 frames) through
     ``SlamManager`` with the loop closer on — gates on closures, resets,
     ATE and endpoint error, and on the scorer and the KLT having run as
     their kernels (and never as a plain version on the card; every SLAM
     slice, A-F and H, is held to the KLT kernel so);
  5. slice B: the same loop at EuRoC resolution (752x480) with the
     ``accurate`` profile and the default 2048-keyframe index — gates on
     ATE and resets, reports fps and the profiler's per-stage times; then
     the KLT kernel (``csrc/klt_track.cu``) against its plain versions on
     the card: the test fixtures (dead rows, a flat block the min-eigenvalue
     gate stops, the split tracker at n_sub 8 and 64, overflowing), slice
     B's frame pair at its slot count (forward klt_track and fb_klt_track)
     and its stereo pair with SAD priors (the mapper's call). Gates:
     status equal on >= 99% of the keypoints, positions within 1e-2 px
     where both track, two launches bit-equal. Times each call (events,
     device, kernels per call, the plain version, the bound at the data's
     steps) and one LK step's latency (one keypoint, iters 1 against 30);
  6. slice C: mono at 752x480, ``accurate`` profile, relocalizer on, full
     BA, results written — gates on mono initialization, post-init frames,
     scale-aligned ATE, resets and the result files;
  7. slice D: stereo relocalization at 752x480 (the blackout script of
     test_relocalization.py), xyz local BA, image rectification, full BA —
     gates on the blackout, the relocalization and the last frame;
  8. slice E: slice B's sequence and config through ``AsyncSlamManager``
     with the device-chained front end (depth 2), fed flat out — keyframe
     processing and the loop closer, with the scorer, on the worker's
     thread and CUDA stream. Gates: 0 worker errors, 0 resets, ATE < 0.15
     m (test_pipeline.py::test_async_stereo_slam's gate), at least one
     scorer launch from the worker's thread and stream, the worker joined;
  9. slice F: test_pipeline.py::test_async_paced_arrival_bench_conditions
     (752x480 arc with photometric realism, ``fast`` profile, chained at
     depth 2, 30 warm frames, then paced at 0.75 x the flat-out rate with
     frames dropped when behind). Gates: <= 10% of the paced frames
     dropped, ATE < 0.05 m, 0 worker errors. Its loop closer is off, so
     the scorer never launches;
 10. entry: ``ov2slam_torch.entry.entry()`` (fb-KLT of 256 keypoints over
     two 4-level 752x480 pyramids): one call launches the KLT kernel once
     and no plain version; ms per call, device ms, CUDA kernels per call
     (torch.profiler), the plain version's ms, and agreement with the same
     call on the CPU (status equal on >= 99% of keypoints, positions within
     1e-2 px where both track);
 11. slice G: RGB-D fusion into a TsdfVolume of 640x640x64 voxels (26.2 M,
     524 MB of state) from the fork's CARLA rig (six 800x600 90-degree
     RGB-D cameras over 30 rig steps of a synthetic street, ray cast on the
     card: 180 integrations), then surface points, the mesh and its PLY,
     and the ESDF. Gates: surface points within 1.5 voxels and mesh
     vertices within 1 voxel of the analytic street at the 99th
     percentile (the largest error: those limits or 1.25 x the JAX
     package's, whichever is larger); the ESDF 0 on occupied voxels and
     <= 5 m; after the first rig step, the card's volume equal to the same
     calls on the CPU (1e-5 relative) except on voxels whose pixel differs
     between the devices, at most 1e-4 of the updated ones. Reports ms per
     integration and per ESDF sweep against their bounds, the mesh's host
     seconds and the peak device memory;
 12. slice H: ``ov2slam_torch.run_slam.main`` in-process on the card over a
     KITTI-layout directory (slice A's loop at 1241x376 with 8000
     points, ``accurate`` profile, loop closer on) and a TartanAir-layout one (640x480, with
     ``--async``), each with a reference-format YAML. Gates: ATE <=
     max(0.09 m, 1.25 x the JAX package's through the root run_slam.py),
     0 resets, the six result files and viewer.html written, the saved
     map reloaded equal, the scorer launched under the KITTI run;
 13. slice I: the distributed Schur bundle adjustment
     (``parallel/dist_ba.py``, no kernel of the repo's own):
     ``entry.dryrun_multichip(8)`` on the card (its two 28-KF windows must
     lower the mean translation error, the skewed one with shard padding
     below 15%), then the 64-KF window of ``parallel/problems.py`` (61704
     observations, 5 LM iterations) at 1, 2, 4 and 8 in-process shards.
     Gates: the mean |t| error below 0.35 x its start and at most max(that,
     1.25 x the JAX package's), the 8-shard cost within 1.05 x the
     single-card ``ba_solve``'s, every shard count's poses within 5e-4 rad
     and m of the 1-shard solve's, and the card's 8-shard poses within
     5e-4 of the same call on the CPU. Reports ms and CUDA kernels per LM
     iteration, the padding and work efficiency of each sharding, the
     bytes a cross-process reduction carries per iteration and the bound;
     with two or more cards, the 8-shard solve again as 2 NCCL ranks (else
     "[I] nccl: skipped, 1 device");
 14. bench: ``ov2slam_torch.bench.main`` with all ten stages at their
     widths, ``--frames 40`` for the e2e stages and fewer timed
     repetitions of the front-end step and of full_ba_pcg, then
     ``ov2slam_torch.protocol_bench.main(["--smoke"])`` (records under
     build/). Gates: both exit 0; no stage or run has an error or worker
     errors; every value finite; the device named is the card;
     ``full_ba_pcg`` took the PCG branch in each of its LM iterations; the
     scorer launched in ``lc_query`` (at (1024, 300, 300)) and in
     ``e2e_loop``. It prints the bench's line and the phase's seconds.
For E and F it also prints the synchronizing CUDA calls that
``torch.cuda.set_sync_debug_mode("warn")`` reports on the front end's
thread during 10 chained dispatches, and the worker stream's handle beside
the (thread, stream) of every scorer launch.
Then the scorer at each slice's main-path shapes (for A and B the
populated prefix of the index, every M it took; for C, D, E and H every
(M, N, Nq) the slice launched, on the loop-closure and the relocalizer
path; the bench's, its lc_query store and every shape e2e_loop launched,
are held in its phase) against its plain versions and timed at the last,
one JSON line of
the plain-torch work with a bound (TSDF integration, the ESDF sweep, an LM
iteration of the distributed BA), one JSON line of kernel records (the KLT
kernel and the scorer), the card's name and power limit, and the final
``{"ok": true, "device": ...}`` line.

Imports nothing of JAX or of ``ov2slam_tpu``. Synthetic data is made from
fixed seeds.
"""

from __future__ import annotations

import json
import os
import sys
import time

# the H100's published peaks and the bounds held against them (see
# ov2slam_torch/roofline.py); run alone, without the package beside it,
# this import fails and the script exits non-zero
from ov2slam_torch.roofline import (  # noqa: F401
    F32_FLOP_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S, KLT_CHAIN_CYCLES,
    SM_CLOCK_HZ, fb_klt_bound, nvidia_smi_line, reduction_bytes)

HERE = os.path.dirname(os.path.abspath(__file__))

# slice B gate: max(0.09 m, 1.25 x the JAX package's ATE on the same
# sequence and config, measured on the CPU by reference_runs.py)
JAX_SLICE_B_ATE = 0.007888328449902924
# slice A gates: test_slam_e2e.py::test_loop_closure_on_circular_trajectory
SLICE_A_MAX_ATE = 0.09
SLICE_A_MAX_END_ERR = 0.07
# slices C and D: the tests' own gates (test_slam_e2e.py::
# test_mono_slam_synthetic, test_relocalization.py::
# test_pipeline_relocalizes_after_blackout), or 1.25 x the JAX package's
# figure on the same slice (reference_runs.py C D, CPU), whichever is larger
JAX_SLICE_C = dict(ate_m=0.011796831972796903, resets=0,
                   fullba_ate_m=0.01188151691832944)
JAX_SLICE_D = dict(reloc_trans_m=0.0359222946076875,
                   reloc_rot_rad=0.033375023721423654,
                   last_err_m=0.052543958350458615,
                   fullba_ate_m=0.001670157967045391)
# slice E gate: test_pipeline.py::test_async_stereo_slam's; the JAX
# package's synchronous manager with the same chained front end on the same
# sequence and config (reference_runs.py E, CPU) is printed beside it
SLICE_E_MAX_ATE = 0.15
JAX_SLICE_E_SYNC_ATE = 0.009868946440764895
# slice F gates: test_pipeline.py::test_async_paced_arrival_bench_conditions
SLICE_F_MAX_ATE = 0.05
SLICE_F_MAX_DROP_SHARE = 0.10
SLICE_F_WARM = 30
SYNC_COUNT_DISPATCHES = 10
# slice G: six RGB-D cameras at CARLA's default 800x600 and 90 degree FOV
# (scripts/talker.py syncs six), yawed 60 degrees apart on a rig moving
# 1 m per step for 30 steps (180 integrations), fused with
# launch/carla.launch's TSDF parameters into a 64 x 64 x 6.4 m grid
SLICE_G = dict(seed=7, width=800, height=600, fov_deg=90.0, n_cams=6,
               steps=30, step_m=1.0, cam_height=1.7, voxel=0.1, trunc=0.3,
               min_ray=0.5, max_ray=10.0, dims=(640, 640, 64),
               origin=(-32.0, -32.0, -0.5), esdf_max=5.0)
# slice H: the stereo loop of slices A and B at KITTI's 1241x376 through
# `run_slam --kitti` (accurate profile, loop closer on), and slice F's arc
# at 640x480 through `run_slam --tartanair --async`. KITTI's aspect halves
# the vertical field of view, so the loop's scene has twice A's and B's
# 4000 points to keep as many in view (with 4000, both packages lose
# track: ATE 1.39 and 1.40 m)
SLICE_H = dict(
    kitti=dict(n_frames=160, stereo=True, width=1241, height=376,
               n_points=8000, seed=6, speed=0.06, kind="loop"),
    tartanair=dict(n_frames=110, stereo=True, width=640, height=480,
                   n_points=8000, seed=0, speed=0.05, kind="arc"))
# slice H gate: max(0.09 m, 1.25 x the JAX package's ATE on the same
# directory through the root run_slam.py, reference_runs.py H, CPU)
JAX_SLICE_H = dict(kitti=0.0098, tartanair=0.0105)
# the JAX package's figures on slice G (reference_runs.py G, CPU)
JAX_SLICE_G = dict(surface_points=65426,
                   surface_max_err_voxels=2.9168471546555486,
                   surface_p99_err_voxels=1.326614595012643,
                   mesh_faces=262338,
                   mesh_max_err_voxels=3.1514662952805628,
                   mesh_p99_err_voxels=0.48445747531946637,
                   occupied_voxels=266339)
# slice I: the distributed Schur BA (parallel/dist_ba.py) on
# parallel/problems.py's windows: the JAX dryrun's two 28-KF problems (3
# LM iterations, through entry.dryrun_multichip) and the 64-KF window, the
# largest realistic_window_problem keeps whole (61704 observations under
# local_ba_max_obs = 65536) and the dense Schur limit of solvers/ba.py, at
# 1, 2, 4 and 8 in-process shards (5 iterations)
SLICE_I_PROBLEMS = (
    ("dryrun", dict(n_kf=28, n_lm=6000, seed=0), 3),
    ("dryrun_skewed", dict(n_kf=28, n_lm=6000, seed=1, skew=0.25), 3),
    ("window64", dict(n_kf=64, n_lm=12000, seed=0), 5))
SLICE_I_SHARDS = (1, 2, 4, 8)
SLICE_I_ROBUST_TH = 5.9915
# slice I gates: test_dist_ba.py's (mean |t| error below 0.35 x its start,
# the cost within 1.05 x the single-device solve's, 5e-4 rad and m between
# reduction orders), and the error at most 1.25 x the JAX package's on the
# same problem (reference_runs.py I, CPU, 8 virtual devices)
SLICE_I_T_SHARE = 0.35
SLICE_I_COST_SHARE = 1.05
SLICE_I_POSE_TOL = 5e-4
JAX_SLICE_I = dict(window64_t_err_after=0.0028474562114035947,
                   window64_cost=8571.26171875)
# the [bench] phase: ov2slam_torch.bench's ten stages at their widths, then
# protocol_bench --smoke; the scorer is held at the lc_query stage's store.
# Its depth is cut so that the script stays well inside its time limit
# (with 60 e2e frames and the bench's own repetitions it took 1025.5 s and
# 1106.5 s on the card): 40 frames for the e2e stages (the bench's default
# is 120), the front-end step timed in one window of 30 steps after a warm
# one (the bench: 3 windows of 120 after one), full_ba_pcg timed once
# (the bench: twice)
BENCH_FRAMES = 40
BENCH_DEPTH = dict(FRONTEND=dict(steps=30, windows=1),
                   FULL_BA_PCG=dict(reps=1))
BENCH_LC_SHAPE = (1024, 300, 300)
RESULT_FILES = ("ov2slam_traj.txt", "ov2slam_kfs_traj.txt",
                "ov2slam_traj_kitti.txt", "ov2slam_fullba_kfs_traj.txt",
                "ov2slam_full_traj_wlc.txt", "ov2slam_full_traj_wlc_opt.txt")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def slice_configs():
    """(sequence kwargs, config overrides, profile) of slices A and B."""
    base = dict(n_frames=160, stereo=True, n_points=4000, seed=6,
                speed=0.06, kind="loop")
    a = (dict(base, width=376, height=240),
         dict(max_keyframes=128, max_landmarks=16384, use_fast=False,
              use_singlescale_detector=True, max_dist=30,
              use_loop_closer=True, lc_recent_mask=10, lc_min_score=0.2,
              use_relocalizer=False),
         None)
    b = (dict(base, width=752, height=480),
         dict(use_relocalizer=False, lc_recent_mask=10),
         "accurate")
    # the accurate profile turns the loop closer on, and with it the
    # relocalizer (the config's default), paced by no wall clock here.
    # Slice C's sequence makes 12 keyframes: with the default recency mask
    # of 30 the loop-closure query would never score one
    c = (dict(n_frames=120, stereo=False, width=752, height=480,
              n_points=4000, seed=4, speed=0.08),
         dict(reloc_min_interval_s=0.0, do_full_ba=True, lc_recent_mask=6),
         "accurate")
    d = (dict(n_frames=40, stereo=True, width=752, height=480,
              n_points=4000, seed=12, speed=0.05),
         dict(reloc_min_interval_s=0.0, use_inv_depth=False,
              do_stereo_rect=True, do_full_ba=True),
         "accurate")
    # slice E: slice B through the asynchronous manager with the chained
    # front end; slice F: the paced-arrival test's stream and profile
    e = (b[0], dict(b[1], pipelined_frontend=True, pipeline_depth=2),
         "accurate")
    f = (dict(n_frames=110, stereo=True, width=752, height=480,
              n_points=8000, seed=0, kind="arc", speed=0.05),
         dict(pipelined_frontend=True, pipeline_depth=2), "fast")
    return {"A": a, "B": b, "C": c, "D": d, "E": e, "F": f}


def slice_config(name: str, seq, profiles_module):
    """Slice ``name``'s config for the sequence ``seq`` (rendered, or a
    stream that renders nothing up front), with the given profiles module
    (the port's, or the JAX package's in reference_runs.py)."""
    _, overrides, profile = slice_configs()[name]
    cfg = seq.make_config()
    if profile is not None:
        profiles_module.apply_profile(cfg, profile)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg.validate()


def make_slice(name: str, synthetic_module, profiles_module):
    """Render slice ``name`` and build its config with the given modules."""
    seq = synthetic_module.generate_sequence(**slice_configs()[name][0])
    return seq, slice_config(name, seq, profiles_module)


def slice_frames(name: str, seq):
    """The frames slice ``name`` feeds, in order, as (left, right or None,
    time, ground-truth index or None). Slice D is the blackout script of
    test_relocalization.py::test_pipeline_relocalizes_after_blackout: 25
    frames, 3 blank frames, the revisit of frame 20, frames 21-29."""
    import numpy as np

    def frame(i, t):
        right = seq.images_right[i] if seq.images_right is not None else None
        return seq.images_left[i], right, t, i

    if name != "D":
        return [frame(i, float(seq.times[i])) for i in range(len(seq.times))]
    t25 = float(seq.times[25])
    blank = np.zeros((seq.height, seq.width), np.float32)
    return ([frame(i, float(seq.times[i])) for i in range(25)]
            + [(blank, blank, t25 + 0.01 * j, None) for j in range(3)]
            + [frame(20, t25 + 0.05)]
            + [frame(i, t25 + 0.05 * (i - 19)) for i in range(21, 30)])


def _write_gray_png(img, path) -> None:
    import numpy as np
    from PIL import Image

    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)


def write_kitti_dir(seq, root: str, sequence: str = "00") -> None:
    """A rendered sequence in the KITTI odometry layout under ``root``:
    ``sequences/<seq>/image_{0,1}/NNNNNN.png`` (8-bit), ``times.txt`` and
    ``poses/<seq>.txt`` (3x4 camera-to-world rows)."""
    import numpy as np

    from ov2slam_torch.utils import lie_np

    d = os.path.join(root, "sequences", sequence)
    for cam, images in (("image_0", seq.images_left),
                        ("image_1", seq.images_right or [])):
        os.makedirs(os.path.join(d, cam), exist_ok=True)
        for i, img in enumerate(images):
            _write_gray_png(img, os.path.join(d, cam, f"{i:06d}.png"))
    with open(os.path.join(d, "times.txt"), "w") as f:
        f.write("".join(f"{float(t):.6e}\n" for t in seq.times))
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    rows = [" ".join(f"{v:.12e}" for v in
                     lie_np.pose_to_matrix(T)[:3].reshape(-1))
            for T in np.asarray(seq.gt_poses, np.float64)]
    with open(os.path.join(root, "poses", sequence + ".txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def write_tartanair_dir(seq, root: str) -> None:
    """A rendered sequence in the TartanAir layout under ``root``:
    ``image_left/NNNNNN_left.png``, ``image_right/NNNNNN_right.png`` and
    ``pose_left.txt`` (x y z qx qy qz qw rows). TartanAir has no
    timestamps: its reader stamps frames at 10 Hz."""
    import numpy as np

    for side, images in (("left", seq.images_left),
                         ("right", seq.images_right or [])):
        os.makedirs(os.path.join(root, f"image_{side}"), exist_ok=True)
        for i, img in enumerate(images):
            _write_gray_png(img, os.path.join(root, f"image_{side}",
                                              f"{i:06d}_{side}.png"))
    P = np.asarray(seq.gt_poses, np.float64)
    rows = [" ".join(f"{v:.12e}" for v in (*T[4:7], *T[1:4], T[0]))
            for T in P]
    with open(os.path.join(root, "pose_left.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def write_reference_yaml(cfg, path: str) -> None:
    """``cfg`` (a ``SlamConfig`` of either package) as a reference-format
    parameter YAML (OpenCV FileStorage): every parameter ``load_config``
    reads, the cameras' intrinsics and ``body_T_cam{0,1}``."""
    import numpy as np

    from ov2slam_torch.utils.config import _PARAM_MAP

    def scalar(v):
        return int(v) if isinstance(v, (bool, np.bool_)) else v

    def matrix(key, M):
        data = ", ".join(repr(float(v)) for v in np.asarray(M).reshape(-1))
        return (f"{key}: !!opencv-matrix\n   rows: 4\n   cols: 4\n"
                f"   dt: d\n   data: [ {data} ]")

    lines = ["%YAML:1.0", "---"]
    lines += [f"{k}: {scalar(getattr(cfg, f))}"
              for k, (f, _) in _PARAM_MAP.items()]
    for s, side, cam in (("left", "l", cfg.cam_left),
                         ("right", "r", cfg.cam_right)):
        if cam is None:
            continue
        lines += [f"Camera.model_{s}: {cam.model}",
                  f"Camera.{s}_nwidth: {cam.width}",
                  f"Camera.{s}_nheight: {cam.height}"]
        lines += [f"Camera.{k}{side}: {v!r}" for k, v in zip(
            ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"),
            (cam.fx, cam.fy, cam.cx, cam.cy, *map(float, cam.dist)))]
        if cam.T_body_cam is not None:
            lines.append(matrix("body_T_cam0" if side == "l"
                                else "body_T_cam1", cam.T_body_cam))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def drive_slice(name: str, slam, seq):
    """Feed slice ``name`` to ``slam`` (either package's SlamManager);
    returns the keyframe and relocalization counts after each frame."""
    n_kfs, n_relocs = [], []
    for left, right, t, _ in slice_frames(name, seq):
        slam.process_frame(left, right, t)
        n_kfs.append(int(slam.map.n_keyframes))
        n_relocs.append(slam.relocalizer.n_relocs
                        if slam.relocalizer is not None else 0)
    return dict(n_kfs=n_kfs, n_relocs=n_relocs)


def slice_outcome(name: str, slam, seq, trace, ate_rmse, lie_np,
                  out_dir=None):
    """The figures slice ``name`` is gated on, from ``drive_slice``'s trace
    and, for slices C and D, the result files ``write_results`` put in
    ``out_dir``; ``ate_rmse`` and ``lie_np`` come from the package that
    ran."""
    import numpy as np

    poses = slam.estimated_trajectory()[1].astype(np.float64)
    res = dict(keyframes=int(slam.map._kf_seq_counter),
               resets=int(slam.n_resets))
    if slam.loop_closer is not None:
        res["closures"] = slam.loop_closer.n_closures
    if slam.relocalizer is not None:
        res["n_relocs"] = slam.relocalizer.n_relocs
    if name in ("A", "B", "E"):
        res["ate_m"] = ate_rmse(poses, seq.gt_poses, align_scale=False)
        res["end_err_m"] = float(np.linalg.norm(poses[-1, 4:7]
                                                - seq.gt_poses[-1, 4:7]))
    elif name == "C":
        # pre-init frames sit at the origin; the initialized segment is
        # evaluated with scale alignment (test_mono_slam_synthetic)
        move = np.nonzero(np.linalg.norm(poses[:, 4:7], axis=1) > 1e-6)[0]
        res["initialized"] = bool(slam.frontend.initialized)
        res["post_init_frames"] = int(len(move))
        res["init_frame"] = int(move[0]) if len(move) else -1
        res["ate_m"] = (ate_rmse(poses[move[0]:], seq.gt_poses[move[0]:],
                                 align_scale=True)
                        if len(move) >= 3 else float("inf"))
    else:
        frames = slice_frames(name, seq)
        revisit = next(k for k, f in enumerate(frames)
                       if f[3] is None) + 3
        res["kfs_added_in_blackout"] = (trace["n_kfs"][revisit - 1]
                                        - trace["n_kfs"][revisit - 4])
        res["relocs_at_revisit"] = trace["n_relocs"][revisit]
        rot, tr = lie_np.pose_distance(poses[revisit],
                                       seq.gt_poses[20].astype(np.float64))
        res["reloc_trans_m"], res["reloc_rot_rad"] = float(tr), float(rot)
        res["last_err_m"] = float(np.linalg.norm(poses[-1, 4:7]
                                                 - seq.gt_poses[29, 4:7]))
    if out_dir is not None:
        import os

        res["result_files"] = sorted(f for f in RESULT_FILES if os.path.exists(
            os.path.join(out_dir, f)))
        kfs = os.path.join(out_dir, "ov2slam_fullba_kfs_traj.txt")
        if os.path.exists(kfs):
            # the full-BA keyframe trajectory against the truth of the frame
            # fed at each keyframe's time (slice D re-times its frames;
            # scale-aligned for mono)
            tum = np.loadtxt(kfs, ndmin=2)
            frames = slice_frames(name, seq)
            fed_t = np.array([f[2] for f in frames])
            idx = [frames[int(np.argmin(np.abs(fed_t - t)))][3]
                   for t in tum[:, 0]]
            if any(i is None for i in idx):
                fail(f"slice {name}: a full-BA keyframe on a blank frame")
            est = np.zeros((len(tum), 7))
            est[:, 4:7] = tum[:, 1:4]
            res["fullba_ate_m"] = ate_rmse(est, seq.gt_poses[idx],
                                           align_scale=not seq.stereo)
    return res


def time_cuda(fn, runs: int):
    """Median ms of ``runs`` calls, each between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def time_cuda_queued(fn, runs: int):
    """Device ms per call of ``runs`` calls queued behind a sleep on the
    card, so that the host's cost of launching them is hidden."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(runs):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / runs


def scorer_inputs(M, N, Nq, seed, dev, p_valid=0.9):
    """Random packed descriptors (int32 words) and valid masks; the query
    is one stored keyframe's rows with 6 bits flipped per row, so scores
    are non-trivial. Unpack with ``hamming.unpack_pm1`` for the kernel."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    store = rng.integers(0, 2**32, (M, N, 8), dtype=np.uint32)
    sv = rng.random((M, N)) < p_valid
    q = store[rng.integers(0, M)][np.arange(Nq) % N].copy()
    for _ in range(6):
        w = rng.integers(0, 8, Nq)
        q[np.arange(Nq), w] ^= np.left_shift(
            np.uint32(1), rng.integers(0, 32, Nq).astype(np.uint32))
    qv = rng.random(Nq) < p_valid
    return [torch.as_tensor(x, device=dev) for x in
            (store.view(np.int32), sv, q.view(np.int32), qv)]


def scorer_bound(store_valid, q_valid, M, N, Nq):
    """Least time (ms) on an H100 for one scoring call, and what sets it:
    the bytes floor (the ±1 cube and the query, 256 + 1 B per row, and
    4 B per score, each moved once) or the int8 tensor-core floor for this
    data's valid pairs (2·256 ops per pair)."""
    n_bytes = (M * N + Nq) * (256 + 1) + M * 4
    pairs = float(store_valid.sum().item()) * float(q_valid.sum().item())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 2.0 * pairs * 256 / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def slice_index_shape(name: str):
    """(M, N) of slice ``name``'s place index: capacity rows of 2·max_kps
    descriptors (tracked plus extra query keypoints)."""
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.utils import profiles

    stream = synthetic.stream_sequence(**slice_configs()[name][0],
                                       realism=None)
    cfg = slice_config(name, stream, profiles)
    m = cfg.max_keyframes
    return ((m + 15) // 16) * 16, 2 * cfg.max_kps


def scorer_equal(label, args, bits):
    """The kernel (on ±1 operands, and through the packed ``match_scores``)
    against the ±1 plain version and the packed XOR + popcount one, atol 0;
    returns the kernel's scores and the largest difference seen."""
    import torch

    from ov2slam_torch.ops import hamming

    store, sv, q, qv = args
    sp, qp = hamming.unpack_pm1(store, sv), hamming.unpack_pm1(q, qv)
    p = hamming.match_scores_plain(store, sv, q, qv, bits)
    outs = [hamming.match_scores_bits(sp, sv, qp, qv, bits),
            hamming.match_scores(store, sv, q, qv, bits),
            hamming.match_scores_bits_plain(sp, sv, qp, qv, bits)]
    torch.cuda.synchronize()
    err = 0.0
    for x in outs:
        if x.shape != p.shape:
            fail(f"hamming kernel != plain at {label} bits={bits}: shape")
        if x.numel():
            err = max(err, float((x - p).abs().max()))
    if err != 0.0:
        fail(f"hamming kernel != plain at {label} bits={bits}: {err}")
    return outs[0], err


def time_scorer(args, runs=20, plain_runs=3):
    """At the packed inputs ``args``, match_bits 48: the kernel's median ms
    per call (events around one call, the host's launch and the counters'
    zeroing included), its device ms per call (calls queued behind a
    sleep), the bound, and the ±1 plain version's median ms."""
    from ov2slam_torch.ops import hamming

    store, sv, q, qv = args
    (M, N), Nq = sv.shape, qv.shape[0]
    sp, qp = hamming.unpack_pm1(store, sv), hamming.unpack_pm1(q, qv)

    def kernel():
        return hamming.match_scores_bits(sp, sv, qp, qv, 48)

    bound, bound_by = scorer_bound(sv, qv, M, N, Nq)
    return dict(
        shape=dict(M=M, N=N, Nq=Nq), ms=time_cuda(kernel, runs),
        device_ms=time_cuda_queued(kernel, runs),
        plain_ms=time_cuda(lambda: hamming.match_scores_bits_plain(
            sp, sv, qp, qv, 48), plain_runs),
        bound_ms=bound, bound_by=bound_by)


def describe(row) -> str:
    return (f"kernel {row['ms']:.4f} ms per call (median of 20), "
            f"{row['device_ms']:.4f} ms on the device, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")


def phase_kernels(dev):
    """Phase 3: the kernel at the index capacities and two more profiles'
    shapes, then on edge cases; returns the timed rows and the largest
    difference from the plain versions."""
    import torch

    rows = []
    err = 0.0
    shapes = []
    for name, what in (("B", "accurate 752x480"), ("A", "376x240")):
        M, N = slice_index_shape(name)
        shapes.append((f"slice {name} index capacity ({what}, max_kps "
                       f"{N // 2})", M, N, N))
    shapes += [("accurate 752x480 at max_kps 384", 2048, 768, 768),
               ("average 752x480", 2048, 512, 512)]
    for label, M, N, Nq in shapes:
        args = scorer_inputs(M, N, Nq, seed=M + N, dev=dev)
        k, e = scorer_equal(label, args, 48)
        err = max(err, e)
        if float(k.max()) <= 0.0:
            fail(f"hamming scores all zero at {label}")
        row = dict(label=label, **time_scorer(args))
        print(f"[kernels] hamming_score {label} M={M} N={N} Nq={Nq}: "
              f"{describe(row)}", flush=True)
        rows.append(row)

    # edge cases: invalid stored rows, an all-invalid keyframe, an
    # all-invalid query, match_bits 0/48/127/128/256, M not a multiple of
    # 8, N and Nq not multiples of the tiles (96 x 80, and 100 x 70, not
    # multiples of 16 either), an empty store
    for M, N, Nq in ((37, 96, 80), (37, 100, 70)):
        store, sv, q, qv = scorer_inputs(M, N, Nq, seed=11, dev=dev)
        sv[5] = False
        label = f"edge M={M} N={N} Nq={Nq}"
        for b in (0, 48, 127, 128, 256):
            k, e = scorer_equal(label, (store, sv, q, qv), b)
            err = max(err, e)
            if float(k[5]) != 0.0:
                fail(f"{label}: all-invalid keyframe scored {float(k[5])}")
        for extra, a in (
                (" all-invalid query", (store, sv, q, torch.zeros_like(qv))),
                (" empty store", (store[:0].contiguous(),
                                  sv[:0].contiguous(), q, qv))):
            err = max(err, scorer_equal(label + extra, a, 48)[1])
    print("[kernels] hamming_score edge cases: equal to both plain versions "
          "(atol 0)", flush=True)
    return rows, err


def main_path_scorer(res, N, dev):
    """The scorer at the shapes slice ``res`` gave it: its index's
    populated prefix, M = 1 ... index_rows - lc_recent_mask keyframes of
    N rows against N query rows. One set of inputs is built at the last M;
    every prefix of it is held against both plain versions (match_bits 48,
    and 0, 127, 256 at the last M), then the last one is timed."""
    M = res["index_rows"] - res["lc_recent_mask"]
    args = scorer_inputs(M, N, N, seed=3, dev=dev)
    store, sv, q, qv = args
    err = 0.0
    label = f"slice {res['slice']} main path"
    for m in range(1, M + 1):
        err = max(err, scorer_equal(
            f"{label} M={m}", (store[:m], sv[:m], q, qv), 48)[1])
    for b in (0, 127, 256):
        err = max(err, scorer_equal(f"{label} M={M}", args, b)[1])
    row = time_scorer(args)
    print(f"[kernels] hamming_score {label}, M = 1..{M} equal to both "
          f"plain versions (atol 0); last query M={M} N={N} Nq={N}: "
          f"{describe(row)}", flush=True)
    return row, err


def time_compaction(dev, capacity=2048, N=1024):
    """ms of the one ``PlaceIndex.add`` that compacts a full index of slice
    B's capacity (the kept seven eighths rewritten, the rest zeroed), and of
    one rewrite of every row of its cube, for comparison."""
    import numpy as np

    from ov2slam_torch.device import synchronize
    from ov2slam_torch.loopclosure.index import PlaceIndex

    rng = np.random.default_rng(5)
    desc = rng.integers(0, 2**32, (capacity + 1, N, 8), dtype=np.uint32)
    valid = rng.random((capacity + 1, N)) < 0.9
    ix = PlaceIndex(capacity, device=dev)
    for i in range(capacity):
        ix.add(i, desc[i], valid[i])
    synchronize(dev)
    t0 = time.perf_counter()
    for c0 in range(0, ix.capacity, 64):
        ix._write_rows(slice(c0, c0 + 64))
    synchronize(dev)
    t_full = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix.add(capacity, desc[capacity], valid[capacity])
    synchronize(dev)
    t_compact = time.perf_counter() - t0
    kept = len(ix.kf_ids)
    print(f"[index] compaction at capacity {capacity} x {N}: "
          f"{1e3 * t_compact:.3f} ms for the add that compacts ({kept} rows "
          f"kept); every row rewritten: {1e3 * t_full:.3f} ms", flush=True)
    return dict(compact_ms=1e3 * t_compact, full_rewrite_ms=1e3 * t_full,
                rows_kept=kept)


def run_slice(name: str, dev, seq=None):
    """Slice ``name`` through the synchronous ``SlamManager`` (``seq``: a
    rendered sequence to reuse); returns its figures and the sequence."""
    import tempfile

    import numpy as np

    from ov2slam_torch.device import synchronize
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.models.slam import SlamManager
    from ov2slam_torch.ops import hamming
    from ov2slam_torch.utils import lie_np, profiles
    from ov2slam_torch.utils.evaluation import ate_rmse
    from ov2slam_torch.utils.profiler import Profiler

    t0 = time.perf_counter()
    if seq is None:
        seq, cfg = make_slice(name, synthetic, profiles)
    else:
        cfg = slice_config(name, seq, profiles)
    t_render = time.perf_counter() - t0
    slam = SlamManager(cfg, device=dev)
    prof = Profiler.instance()
    prof.reset()
    # counts cover exactly this slice's run of the main path
    hamming.match_scores_bits.launches = 0
    hamming.match_scores_bits.shapes.clear()
    hamming.match_scores_bits_plain.cuda_runs = 0
    hamming.match_scores_plain.cuda_runs = 0
    reset_klt_counts()
    synchronize(dev)
    t0 = time.perf_counter()
    trace = drive_slice(name, slam, seq)
    synchronize(dev)
    wall = time.perf_counter() - t0
    klt = klt_counts()
    launches = hamming.match_scores_bits.launches
    shapes = dict(hamming.match_scores_bits.shapes)
    plain_cuda = (hamming.match_scores_bits_plain.cuda_runs
                  + hamming.match_scores_plain.cuda_runs)
    n_frames = len(trace["n_kfs"])
    _, poses = slam.estimated_trajectory()
    if poses.shape != (n_frames, 7) or not np.isfinite(poses).all():
        fail(f"slice {name}: trajectory not finite / wrong shape")
    out_dir, t_write = None, None
    with tempfile.TemporaryDirectory() as tmp:
        if name in ("C", "D"):
            out_dir = tmp
            t0 = time.perf_counter()
            slam.write_results(tmp)
            synchronize(dev)
            t_write = time.perf_counter() - t0
        res = dict(slice=name, width=seq.width, height=seq.height,
                   frames=n_frames, render_s=round(t_render, 3),
                   wall_s=wall, fps=n_frames / wall,
                   **slice_outcome(name, slam, seq, trace, ate_rmse, lie_np,
                                   out_dir))
    res.update(write_results_s=t_write, scorer_launches=launches,
               scorer_shapes=[[*k, v] for k, v in sorted(shapes.items())],
               scorer_plain_runs_on_cuda=plain_cuda,
               index_rows=len(slam.loop_closer.index.kf_ids),
               lc_recent_mask=cfg.lc_recent_mask, max_kps=cfg.max_kps,
               index_cube_bytes=slam.loop_closer.index._cube.numel(), **klt)
    print(f"[slice {name}] " + json.dumps(res), flush=True)
    print(f"[slice {name}] per-stage times (ms):\n" + prof.summary(),
          flush=True)
    gate_klt_launches(name, res)
    if launches <= 0:
        fail(f"slice {name}: the scorer kernel never launched")
    if plain_cuda != 0:
        fail(f"slice {name}: the plain scorer ran on cuda")
    if name in ("A", "B") and slam.n_resets != 0:
        fail(f"slice {name}: {slam.n_resets} tracking resets")
    return res, seq


def paced_arrival(slam, frames, n_warm=SLICE_F_WARM, pace_share=0.75):
    """The paced-arrival protocol of test_pipeline.py::
    test_async_paced_arrival_bench_conditions: ``n_warm`` frames flat out,
    then the rest paced at ``pace_share`` x the measured steady rate (the
    median of the warm frames after the tenth), with
    ``backpressure_wait_s`` = 2 x the interval, and the frames that fall
    more than one interval behind dropped (`force_realtime`). Returns
    (frames dropped, pace fps, flat-out median seconds per frame)."""
    import numpy as np

    from ov2slam_torch.bench import paced_replay

    walls = []
    for left, right, t in frames[:n_warm]:
        t0 = time.perf_counter()
        slam.process_frame(left, right, t)
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls[10:]))
    pace_fps = pace_share / max(med, 1e-6)
    interval = 1.0 / pace_fps
    slam.cfg.backpressure_wait_s = 2.0 * interval
    # this module's clock, looked up now: trace_slice.py replaces it
    arr = paced_replay(frames, lambda f: slam.process_frame(*f), n_warm,
                       pace_fps, clock=time.perf_counter, sleep=time.sleep)
    slam.flush()
    return arr.n_dropped, pace_fps, med


class DispatchSyncCounter:
    """Counts the synchronizing CUDA calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports during chained
    dispatches ``first`` ... ``first + n - 1`` of the front end ``fe``
    (the dispatch only, not the resolve), on the front end's own thread;
    what the worker thread reports in the same windows is counted apart.
    Each report is kept with the source line that made the call."""

    def __init__(self, fe, first: int, n: int = SYNC_COUNT_DISPATCHES):
        import collections
        import threading

        self.first, self.n = first, n
        self.seen = self.counted = 0
        self.syncs = self.worker_syncs = 0
        self.sites = collections.Counter()
        self._orig = fe._dispatch_chained
        self._thread = threading.get_ident()
        fe._dispatch_chained = self._dispatch

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        import threading

        if "synchroniz" not in str(message):
            return
        if threading.get_ident() == self._thread:
            self.syncs += 1
            self.sites[f"{os.path.relpath(filename, HERE)}:{lineno}"] += 1
        else:
            self.worker_syncs += 1

    def _dispatch(self, img, t):
        import warnings

        import torch

        k = self.seen
        self.seen += 1
        if not self.first <= k < self.first + self.n:
            return self._orig(img, t)
        on_card = torch.cuda.is_available()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                return self._orig(img, t)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
                self.counted += 1

    def result(self):
        return dict(dispatches=self.counted, first=self.first,
                    syncs=self.syncs,
                    syncs_per_dispatch=self.syncs / max(1, self.counted),
                    worker_syncs_in_window=self.worker_syncs,
                    sites=dict(self.sites.most_common(8)))


def run_async_slice(name: str, dev, seq=None):
    """Slice E (``seq``: slice B's rendered sequence, else rendered here)
    or F through ``AsyncSlamManager``; returns the slice's figures."""
    import numpy as np
    import torch

    from ov2slam_torch.device import synchronize
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.models.pipeline import AsyncSlamManager
    from ov2slam_torch.ops import hamming
    from ov2slam_torch.utils import profiles
    from ov2slam_torch.utils.evaluation import ate_rmse
    from ov2slam_torch.utils.profiler import Profiler

    t0 = time.perf_counter()
    kw = slice_configs()[name][0]
    if name == "F":
        # rendered up front, as the test does: the pacing times SLAM only
        seq = synthetic.stream_sequence(**kw,
                                        realism=synthetic.DEFAULT_REALISM)
        frames = list(seq)
    else:
        if seq is None:
            seq = synthetic.generate_sequence(**kw)
        frames = [f[:3] for f in slice_frames(name, seq)]
    cfg = slice_config(name, seq, profiles)
    t_render = time.perf_counter() - t0
    slam = AsyncSlamManager(cfg, device=dev)
    worker_stream = getattr(slam.worker_stream, "cuda_stream", None)
    prof = Profiler.instance()
    prof.reset()
    # counts cover exactly this slice's run of the main path
    hamming.match_scores_bits.launches = 0
    hamming.match_scores_bits.shapes.clear()
    hamming.match_scores_bits.origins.clear()
    hamming.match_scores_bits_plain.cuda_runs = 0
    hamming.match_scores_plain.cuda_runs = 0
    reset_klt_counts()
    syncs = DispatchSyncCounter(slam.frontend, first=10 if name == "F"
                                else 20)
    synchronize(dev)
    t0 = time.perf_counter()
    paced = None
    try:
        if name == "F":
            paced = paced_arrival(slam, frames)
        else:
            for left, right, t in frames:
                slam.process_frame(left, right, t)
        # resolves the frames in flight, registers the deferred keyframe
        # and waits for the worker
        times, poses = slam.estimated_trajectory()
        synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        slam.close()
    joined = not slam._worker.is_alive()
    klt = klt_counts()
    launches = hamming.match_scores_bits.launches
    shapes = dict(hamming.match_scores_bits.shapes)
    origins = dict(hamming.match_scores_bits.origins)
    plain_cuda = (hamming.match_scores_bits_plain.cuda_runs
                  + hamming.match_scores_plain.cuda_runs)
    if poses.shape != (len(times), 7) or not np.isfinite(poses).all():
        fail(f"slice {name}: trajectory not finite / wrong shape")
    gt_t, gt = np.asarray(seq.times), np.asarray(seq.gt_poses)
    idx = np.clip(np.searchsorted(gt_t, times), 0, len(gt) - 1)
    poses = poses.astype(np.float64)
    res = dict(slice=name, width=seq.width, height=seq.height,
               frames=len(frames), processed=int(len(times)),
               render_s=round(t_render, 3), wall_s=wall,
               fps=len(times) / wall,
               ate_m=ate_rmse(poses, gt[idx], align_scale=False),
               end_err_m=float(np.linalg.norm(poses[-1, 4:7]
                                              - gt[idx[-1], 4:7])),
               keyframes=int(slam.map._kf_seq_counter),
               resets=int(slam.n_resets),
               closures=(slam.loop_closer.n_closures
                         if slam.loop_closer is not None else None),
               folds=slam.n_folded, deferrals=slam.n_deferred,
               worker_errors=slam.n_worker_errors, worker_joined=joined,
               worker_stream=worker_stream,
               scorer_launches=launches,
               scorer_shapes=[[*k, v] for k, v in sorted(shapes.items())],
               scorer_origins=[[th, st, n] for (th, st), n in
                               sorted(origins.items())],
               worker_scorer_launches=origins.get(("kf-worker",
                                                   worker_stream), 0),
               scorer_plain_runs_on_cuda=plain_cuda,
               sync_debug=syncs.result(), max_kps=cfg.max_kps,
               lc_recent_mask=cfg.lc_recent_mask, **klt)
    if slam.loop_closer is not None:
        res.update(index_rows=len(slam.loop_closer.index.kf_ids),
                   index_cube_bytes=slam.loop_closer.index._cube.numel())
    if paced is not None:
        n_dropped, pace_fps, med = paced
        res.update(dropped=n_dropped, paced_frames=len(frames) - SLICE_F_WARM,
                   pace_fps=pace_fps, flat_out_fps=1.0 / med)
    print(f"[slice {name}] " + json.dumps(res), flush=True)
    print(f"[slice {name}] per-stage times (ms):\n" + prof.summary(),
          flush=True)
    return res


def gate_async(r, b=None) -> None:
    """Slice E's or F's gates (see the module docstring)."""
    name = r["slice"]
    if r["worker_errors"] != 0:
        fail(f"slice {name}: {r['worker_errors']} worker errors")
    if not r["worker_joined"]:
        fail(f"slice {name}: close() did not join the worker")
    if r["scorer_plain_runs_on_cuda"] != 0:
        fail(f"slice {name}: the plain scorer ran on cuda")
    gate_klt_launches(name, r)
    sd = r["sync_debug"]
    print(f"[slice {name}] synchronizing calls reported by "
          f"set_sync_debug_mode('warn') on the front end's thread during "
          f"{sd['dispatches']} chained dispatches: {sd['syncs']} "
          f"({sd['syncs_per_dispatch']:.2f} per dispatch; the worker "
          f"thread's in the same windows: {sd['worker_syncs_in_window']}); "
          f"sites {sd['sites']}", flush=True)
    print(f"[slice {name}] worker stream {r['worker_stream']}; scorer "
          f"launches by (thread, stream): {r['scorer_origins']}; KLT "
          f"launches by (thread, stream): {r['klt_origins']}", flush=True)
    if name == "E":
        if sd["dispatches"] != SYNC_COUNT_DISPATCHES:
            fail(f"slice E: {sd['dispatches']} chained dispatches counted")
        if r["resets"] != 0:
            fail(f"slice E: {r['resets']} tracking resets")
        gate("E", "ATE (m)", r["ate_m"], SLICE_E_MAX_ATE)
        if r["worker_scorer_launches"] < 1:
            fail("slice E: no scorer launch from the worker's thread and "
                 "stream")
        print(f"[slice E] async: {r['fps']:.4f} fps, ATE {r['ate_m']} m "
              f"(gate {SLICE_E_MAX_ATE}; the JAX package's synchronous "
              f"manager with the same chained front end: "
              f"{JAX_SLICE_E_SYNC_ATE} m), {r['keyframes']} keyframes, "
              f"{r['closures']} closures, {r['folds']} folds, "
              f"{r['deferrals']} deferrals | slice B sync: "
              f"{b['fps']:.4f} fps, ATE {b['ate_m']} m, {b['keyframes']} "
              f"keyframes, {b['closures']} closures", flush=True)
    else:
        if r["scorer_launches"] != 0:
            fail(f"slice F: {r['scorer_launches']} scorer launches with the "
                 "loop closer off")
        gate("F", "dropped frames", r["dropped"],
             SLICE_F_MAX_DROP_SHARE * r["paced_frames"])
        gate("F", "ATE (m)", r["ate_m"], SLICE_F_MAX_ATE)
        print(f"[slice F] paced at {r['pace_fps']:.4f} fps (0.75 x the "
              f"flat-out {r['flat_out_fps']:.4f}), {r['dropped']} of "
              f"{r['paced_frames']} paced frames dropped, ATE "
              f"{r['ate_m']} m; {r['klt_launches']} KLT launches; the fast "
              "profile has the loop closer off, so the scorer never "
              "launches", flush=True)


def gate(name: str, what: str, value, limit) -> None:
    """Fail unless ``value`` <= ``limit``."""
    if not value <= limit:
        fail(f"slice {name}: {what} {value} > {limit}")


def gate_slice_c(c) -> None:
    """test_mono_slam_synthetic's gates, or 1.25 x the JAX package's."""
    if not c["initialized"]:
        fail("slice C: mono initialization never fired")
    if c["post_init_frames"] < 15:
        fail(f"slice C: {c['post_init_frames']} post-init frames < 15")
    gate("C", "post-init ATE (m, scale-aligned)", c["ate_m"],
         max(0.08, 1.25 * JAX_SLICE_C["ate_m"]))
    gate("C", "resets", c["resets"], JAX_SLICE_C["resets"])
    if c["result_files"] != sorted(RESULT_FILES):
        fail(f"slice C: result files {c['result_files']}")
    print(f"[slice C] full-BA keyframe ATE {c['fullba_ate_m']} m "
          f"(JAX package {JAX_SLICE_C['fullba_ate_m']} m)", flush=True)


def gate_slice_d(d) -> None:
    """test_pipeline_relocalizes_after_blackout's gates, or 1.25 x the JAX
    package's figures."""
    if d["kfs_added_in_blackout"] != 0:
        fail(f"slice D: {d['kfs_added_in_blackout']} keyframes added "
             "during the blackout")
    if d["relocs_at_revisit"] < 1:
        fail("slice D: the revisit did not relocalize")
    gate("D", "relocalized translation error (m)", d["reloc_trans_m"],
         max(0.05, 1.25 * JAX_SLICE_D["reloc_trans_m"]))
    gate("D", "relocalized rotation error (rad)", d["reloc_rot_rad"],
         max(0.05, 1.25 * JAX_SLICE_D["reloc_rot_rad"]))
    gate("D", "last frame error (m)", d["last_err_m"],
         max(0.1, 1.25 * JAX_SLICE_D["last_err_m"]))
    print(f"[slice D] full-BA keyframe ATE {d['fullba_ate_m']} m "
          f"(JAX package {JAX_SLICE_D['fullba_ate_m']} m)", flush=True)


# ---------------------------------------------------------------------- #
# slice G: RGB-D fusion into the TSDF volume (the fork's CARLA rig)
# ---------------------------------------------------------------------- #

def street_scene(seed: int = SLICE_G["seed"]):
    """A synthetic street: the ground plane z = 0 and 20-40 axis-aligned
    boxes (buildings, parked vehicles) beside a 7 m wide road along x,
    each with a colour. Returns numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 41))
    half = rng.uniform([0.5, 0.5], [3.0, 3.0], (n, 2))
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    cx = rng.uniform(-30.0, 30.0, n)
    cy = side * (3.5 + half[:, 1] + rng.uniform(0.0, 12.0, n))
    h = rng.uniform(1.0, 5.5, n)
    lo = np.stack([cx - half[:, 0], cy - half[:, 1], np.zeros(n)], -1)
    hi = np.stack([cx + half[:, 0], cy + half[:, 1], h], -1)
    return dict(box_lo=lo, box_hi=hi,
                box_rgb=rng.uniform(40.0, 255.0, (n, 3)),
                ground_rgb=np.array([90.0, 90.0, 90.0]))


def rig_intrinsics():
    """CARLA's default camera: (W, H) pixels, 90 degree horizontal FOV."""
    import numpy as np

    w, h = SLICE_G["width"], SLICE_G["height"]
    f = w / (2.0 * np.tan(np.radians(SLICE_G["fov_deg"]) / 2.0))
    return np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])


def rig_poses():
    """T_wc [q, t] of every camera at every rig step, in integration
    order: the rig moves 1 m along x per step at 1.7 m above the ground;
    its six cameras look horizontally, yawed 0, 60, ..., 300 degrees
    (x right, y down, z forward in each camera)."""
    import numpy as np

    from ov2slam_torch.utils import lie_np

    out = []
    for k in range(SLICE_G["steps"]):
        pos = np.array([-15.0 + SLICE_G["step_m"] * k, 0.0,
                        SLICE_G["cam_height"]])
        for c in range(SLICE_G["n_cams"]):
            yaw = 2.0 * np.pi * c / SLICE_G["n_cams"]
            M = np.eye(4)
            M[:3, 0] = [np.sin(yaw), -np.cos(yaw), 0.0]
            M[:3, 1] = [0.0, 0.0, -1.0]
            M[:3, 2] = [np.cos(yaw), np.sin(yaw), 0.0]
            M[:3, 3] = pos
            out.append(lie_np.pose_from_matrix(M))
    return out


def render_rgbd(scene, T_wc, K, device):
    """Depth (H, W) and RGB (H, W, 3) f32 tensors on ``device`` of the
    street seen from ``T_wc``, by analytic ray casting in f64 (depth is
    the z distance; inf where a ray hits nothing)."""
    import torch

    from ov2slam_torch.utils import lie_np

    W, H = SLICE_G["width"], SLICE_G["height"]
    f64 = dict(dtype=torch.float64, device=device)
    M = torch.as_tensor(lie_np.pose_to_matrix(T_wc), **f64)
    vs, us = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                            indexing="ij")
    d_cam = torch.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1],
                         torch.ones_like(us)], -1).reshape(-1, 3)
    d = d_cam @ M[:3, :3].T            # per unit of camera z
    o = M[:3, 3]
    inf = torch.full_like(d[:, 0], float("inf"))
    t = torch.where(d[:, 2] < 0, -o[2] / d[:, 2], inf)
    rgb = torch.as_tensor(scene["ground_rgb"], **f64).expand(len(t), 3)
    rgb = torch.where(torch.isfinite(t)[:, None], rgb, 0.0)
    d_safe = torch.where(d == 0, 1e-30, d)
    for lo, hi, c in zip(scene["box_lo"], scene["box_hi"],
                         scene["box_rgb"]):
        t1 = (torch.as_tensor(lo, **f64) - o) / d_safe
        t2 = (torch.as_tensor(hi, **f64) - o) / d_safe
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        hit = (near <= far) & (near > 0) & (near < t)
        t = torch.where(hit, near, t)
        rgb = torch.where(hit[:, None], torch.as_tensor(c, **f64), rgb)
    return (t.reshape(H, W).to(torch.float32),
            rgb.reshape(H, W, 3).to(torch.float32))


def surface_distance(points, scene, chunk: int = 1 << 18):
    """Distance (m) of each point (N, 3) to the nearest analytic surface:
    the ground plane or a box's boundary."""
    import numpy as np

    p = np.asarray(points, np.float64)
    out = np.empty(len(p))
    c = (scene["box_lo"] + scene["box_hi"]) / 2.0
    half = (scene["box_hi"] - scene["box_lo"]) / 2.0
    for s in range(0, len(p), chunk):
        q = np.abs(p[s:s + chunk, None, :] - c[None]) - half[None]
        sd = (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
              + np.minimum(q.max(-1), 0.0))
        out[s:s + chunk] = np.minimum(np.abs(p[s:s + chunk, 2]),
                                      np.abs(sd).min(-1))
    return out


def slice_g_volume(tsdf_module, device=None):
    """Slice G's empty volume, built with the given package's module."""
    import numpy as np

    g = SLICE_G
    kw = dict(origin=np.asarray(g["origin"], np.float32), dims=g["dims"],
              voxel_size=g["voxel"], truncation=g["trunc"],
              min_ray=g["min_ray"], max_ray=g["max_ray"],
              use_const_weight=False, with_color=True)
    if device is not None:
        kw["device"] = device
    return tsdf_module.TsdfVolume(**kw)


def slice_g_figures(vol, scene, tmp_dir):
    """The host-side figures of a fused volume (either package): surface
    points and mesh against the analytic street, the ESDF, and the host
    seconds of the mesh and of its PLY export."""
    import numpy as np

    voxel = SLICE_G["voxel"]
    pts, cols = vol.extract_surface_points()
    t0 = time.perf_counter()
    verts, faces, _ = vol.extract_mesh()
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_faces = vol.export_mesh_ply(os.path.join(tmp_dir, "mesh.ply"))
    t_ply = time.perf_counter() - t0
    t0 = time.perf_counter()
    esdf = vol.esdf(max_distance=SLICE_G["esdf_max"])
    t_esdf = time.perf_counter() - t0
    t, obs = vol._grids(1e-4)
    occ = (t < 0) & obs
    sd_pts = surface_distance(pts, scene)
    sd_verts = surface_distance(verts, scene)
    return dict(
        surface_points=int(len(pts)), colored=cols is not None,
        surface_max_err_voxels=float(sd_pts.max() / voxel),
        surface_p99_err_voxels=float(np.percentile(sd_pts, 99) / voxel),
        mesh_vertices=int(len(verts)), mesh_faces=int(len(faces)),
        ply_faces=int(n_faces),
        mesh_max_err_voxels=float(sd_verts.max() / voxel),
        mesh_p99_err_voxels=float(np.percentile(sd_verts, 99) / voxel),
        surface_beyond_1p5_voxels=int((sd_pts > 1.5 * voxel).sum()),
        mesh_beyond_1_voxel=int((sd_verts > voxel).sum()),
        mesh_host_s=t_mesh, ply_host_s=t_ply, esdf_host_s=t_esdf,
        occupied_voxels=int(occ.sum()),
        esdf_max_on_occupied=float(esdf[occ].max()) if occ.any() else 0.0,
        esdf_max=float(esdf.max()), esdf_mean=float(esdf.mean()),
        observed_voxels=int(obs.sum()))


def gate_slice_g_figures(r, jax_figs=None) -> None:
    """test_tsdf.py's gates, 1.5 voxels for surface points and 1 voxel for
    mesh vertices, on the 99th percentile; on the largest error, those
    limits or 1.25 x the JAX package's largest error on the same sequence,
    whichever is larger (both packages round the boxes' edges alike). The
    ESDF is 0 on occupied voxels and at most ``esdf_max``."""
    j = jax_figs or JAX_SLICE_G
    gate("G", "surface point error, 99th percentile (voxels)",
         r["surface_p99_err_voxels"], 1.5)
    gate("G", "mesh vertex error, 99th percentile (voxels)",
         r["mesh_p99_err_voxels"], 1.0)
    gate("G", "surface point error, largest (voxels)",
         r["surface_max_err_voxels"],
         max(1.5, 1.25 * j["surface_max_err_voxels"]))
    gate("G", "mesh vertex error, largest (voxels)", r["mesh_max_err_voxels"],
         max(1.0, 1.25 * j["mesh_max_err_voxels"]))
    gate("G", "ESDF on occupied voxels", r["esdf_max_on_occupied"], 0.0)
    gate("G", "ESDF max", r["esdf_max"], SLICE_G["esdf_max"])
    if r["surface_points"] < 1000 or r["mesh_faces"] < 1000:
        fail(f"slice G: {r['surface_points']} surface points, "
             f"{r['mesh_faces']} faces")


def slice_g_cpu_agreement(card_vol, frames, dev):
    """After the first rig step: the same integrations on the CPU at the
    same grid. Returns the count of voxels whose pixel differs between the
    devices in any of the integrations (u or v on a rounding boundary
    within float noise), the updated voxels, and the largest difference of
    tsdf, weight and colour on every other voxel, relative to
    max(1, |value|)."""
    import torch

    from ov2slam_torch.mapping import tsdf as ttsdf
    from ov2slam_torch.utils import lie_np

    cpu = torch.device("cpu")
    cpu_vol = slice_g_volume(ttsdf, cpu)
    K = rig_intrinsics()
    differ = torch.zeros(cpu_vol.tsdf.shape, dtype=torch.bool)
    for depth, rgb, T_wc in frames:
        cpu_vol.integrate(depth.cpu(), K, T_wc, rgb=rgb.cpu())
        T_cw = lie_np.pose_inverse(T_wc).astype("float32")
        pix = [ttsdf._voxel_pixels(
            card_vol.dims, card_vol.origin, card_vol.voxel_size, T_cw,
            K[0, 0], K[1, 1], K[0, 2], K[1, 2], depth.shape, d)[:2]
            for d in (dev, cpu)]
        differ |= ((pix[0][0].cpu() != pix[1][0])
                   | (pix[0][1].cpu() != pix[1][1]))
        del pix
    updated = int((cpu_vol.weight > 0).sum())
    keep = ~differ
    err = {}
    for name in ("tsdf", "weight", "color"):
        a = getattr(card_vol, name).cpu()[keep]
        b = getattr(cpu_vol, name)[keep]
        err[name] = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
    return int(differ.sum()), updated, err


def run_slice_g(dev):
    """Slice G (see the module docstring); returns its figures."""
    import tempfile

    import torch

    from ov2slam_torch.mapping import tsdf as ttsdf

    g = SLICE_G
    V = g["dims"][0] * g["dims"][1] * g["dims"][2]
    scene = street_scene()
    K = rig_intrinsics()
    poses = rig_poses()
    vol = slice_g_volume(ttsdf, dev)
    state_bytes = sum(x.numel() * x.element_size()
                      for x in (vol.tsdf, vol.weight, vol.color))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # each frame is rendered on the card just before it is fused; the
    # events time the integration alone
    ms, first = [], []
    t0 = time.perf_counter()
    for T_wc in poses:
        depth, rgb = render_rgbd(scene, T_wc, K, dev)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        vol.integrate(depth, K, T_wc, rgb=rgb)
        e.record()
        ms.append((s, e))
        if len(first) < g["n_cams"]:
            first.append((depth.cpu(), rgb.cpu(), T_wc))
        if vol.n_integrated == g["n_cams"]:
            n_differ, n_updated, err = slice_g_cpu_agreement(vol, first,
                                                             dev)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    ms = sorted(s.elapsed_time(e) for s, e in ms)
    peak = torch.cuda.max_memory_allocated()
    del first

    # kernels per integration and per sweep: the same calls on an 8^3 grid
    # (the sequence of launches does not depend on the grid's size)
    small = ttsdf.TsdfVolume(origin=g["origin"], dims=(8, 8, 8),
                             device=dev)
    k_int, _, _ = kernel_launches_per_call(
        lambda: small.integrate(depth, K, poses[0], rgb=rgb))
    d_small = torch.zeros((8, 8, 8), device=dev)
    k_esdf, _, _ = kernel_launches_per_call(
        lambda: ttsdf._esdf_sweep(d_small, g["voxel"], 1))
    del small, d_small

    # the ESDF's sweeps alone, on the device (occupancy grid from the host)
    t, obs = vol._grids(1e-4)
    d0 = torch.as_tensor(((t < 0) & obs).astype("float32"), device=dev)
    d0 = torch.where(d0 > 0, 0.0, 1e9)
    n_sweeps = int(round(g["esdf_max"] / g["voxel"]))
    esdf_ms = time_cuda(lambda: ttsdf._esdf_sweep(d0, g["voxel"], n_sweeps),
                        3) / n_sweeps
    del d0, t, obs, depth, rgb
    with tempfile.TemporaryDirectory() as tmp:
        figs = slice_g_figures(vol, scene, tmp)
    bound = 1e3 * 40 * V / HBM_BYTES_PER_S
    esdf_bound = 1e3 * 8 * V / HBM_BYTES_PER_S
    res = dict(
        slice="G", voxels=V, dims=list(g["dims"]), state_bytes=state_bytes,
        integrations=vol.n_integrated, boxes=len(scene["box_lo"]),
        render_and_fuse_s=loop_s, integrate_ms_median=ms[len(ms) // 2],
        integrate_ms_min=ms[0], integrate_ms_max=ms[-1],
        integrate_kernels=k_int, integrate_bound_ms=bound,
        esdf_sweep_ms=esdf_ms, esdf_sweep_kernels=k_esdf,
        esdf_sweep_bound_ms=esdf_bound, esdf_sweeps=n_sweeps,
        max_memory_allocated=peak,
        cpu_check=dict(integrations=g["n_cams"], updated_voxels=n_updated,
                       pixel_differs=n_differ,
                       pixel_differs_share=n_differ / max(n_updated, 1),
                       max_rel_err=err), **figs)
    print("[slice G] " + json.dumps(res), flush=True)
    gate_slice_g_figures(res)
    if n_updated == 0:
        fail("slice G: the first rig step updated no voxel")
    gate("G", "voxels whose pixel differs card vs CPU (share of updated)",
         n_differ / n_updated, 1e-4)
    for name, e in err.items():
        gate("G", f"card vs CPU {name} (relative)", e, 1e-5)
    j = JAX_SLICE_G
    print(f"[slice G] {V} voxels ({state_bytes} B of state), "
          f"{vol.n_integrated} integrations: {res['integrate_ms_median']:.4f}"
          f" ms each (median; bound {bound:.4f} ms at 40 B/voxel), ESDF "
          f"{esdf_ms:.4f} ms per sweep (bound {esdf_bound:.4f} ms), peak "
          f"device memory {peak} B, mesh {figs['mesh_host_s']:.2f} s on the "
          f"host | JAX package (reference_runs.py G, CPU): "
          f"{j['surface_points']} surface points (max "
          f"{j['surface_max_err_voxels']:.4f} voxels), {j['mesh_faces']} "
          f"faces (max {j['mesh_max_err_voxels']:.4f} voxels), "
          f"{j['occupied_voxels']} occupied; port: "
          f"{figs['surface_points']} ({figs['surface_max_err_voxels']:.4f})"
          f", {figs['mesh_faces']} ({figs['mesh_max_err_voxels']:.4f}), "
          f"{figs['occupied_voxels']}", flush=True)
    return res


# ---------------------------------------------------------------------- #
# slice H: the command line over the KITTI and TartanAir layouts
# ---------------------------------------------------------------------- #

def write_slice_h(part: str, root: str):
    """Render slice H's ``part`` ("kitti" or "tartanair"), write it in that
    dataset's layout under ``root`` with a reference-format YAML for its
    camera (full BA on, so every result file is written), and return the
    command line that replays it (without ``--device``)."""
    from ov2slam_torch.io import synthetic

    seq = synthetic.generate_sequence(**SLICE_H[part])
    data = os.path.join(root, part)
    write_reference_yaml(seq.make_config(do_full_ba=True),
                         os.path.join(root, "config.yaml"))
    out = os.path.join(root, "out")
    common = ["--config", os.path.join(root, "config.yaml"), "--out", out,
              "--save-map", os.path.join(out, "map.npz")]
    if part == "kitti":
        write_kitti_dir(seq, data)
        return ["--kitti", data, "--kitti-seq", "00", "--profile",
                "accurate"] + common
    write_tartanair_dir(seq, data)
    return ["--tartanair", data, "--async"] + common


def result_files(argv):
    """The result files and viewer a ``run_slam`` command line ``argv``
    left in its ``--out`` directory."""
    out = argv[argv.index("--out") + 1]
    return sorted(f for f in RESULT_FILES + ("viewer.html",)
                  if os.path.exists(os.path.join(out, f)))


def run_slice_h(part: str, dev):
    """Slice H's ``part`` through ``run_slam.main`` on the card; returns the
    report with its gates' figures and the scorer's launches."""
    import tempfile

    import numpy as np

    from ov2slam_torch import run_slam
    from ov2slam_torch.mapping.checkpoint import _ARRAYS, load_map
    from ov2slam_torch.mapping.store import MapStore
    from ov2slam_torch.ops import hamming

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        argv = write_slice_h(part, tmp)
        t_write = time.perf_counter() - t0
        # counts cover exactly this command line's run of the main path
        hamming.match_scores_bits.launches = 0
        hamming.match_scores_bits.shapes.clear()
        hamming.match_scores_bits_plain.cuda_runs = 0
        hamming.match_scores_plain.cuda_runs = 0
        reset_klt_counts()
        t0 = time.perf_counter()
        report, slam = run_slam.main(argv + ["--device", str(dev)])
        run_s = time.perf_counter() - t0
        klt = klt_counts()
        launches = hamming.match_scores_bits.launches
        shapes = dict(hamming.match_scores_bits.shapes)
        plain_cuda = (hamming.match_scores_bits_plain.cuda_runs
                      + hamming.match_scores_plain.cuda_runs)
        files = result_files(argv)
        fresh = MapStore(slam.cfg)
        load_map(fresh, argv[argv.index("--save-map") + 1])
        same = (all(np.array_equal(getattr(fresh, a), getattr(slam.map, a))
                    for a in _ARRAYS)
                and fresh._free_kf == slam.map._free_kf
                and fresh._free_lm == slam.map._free_lm
                and fresh._kf_seq_counter == slam.map._kf_seq_counter)
    lc = slam.loop_closer
    res = dict(slice="H", part=part, **SLICE_H[part], report=report,
               resets=int(slam.n_resets), files=files, map_reloads_equal=same,
               map_keyframes=int(fresh.n_keyframes), write_s=t_write,
               run_s=run_s, scorer_launches=launches,
               scorer_shapes=[[*k, v] for k, v in sorted(shapes.items())],
               scorer_plain_runs_on_cuda=plain_cuda,
               index_cube_bytes=(lc.index._cube.numel() if lc is not None
                                 else 0),
               worker_errors=getattr(slam, "n_worker_errors", None), **klt)
    print(f"[slice H] {part}: " + json.dumps(res), flush=True)
    return res


def gate_slice_h(r) -> None:
    part, rep = r["part"], r["report"]
    jax_ate = JAX_SLICE_H[part]
    gate("H", f"{part} ATE (m)", rep["ate_m"], max(0.09, 1.25 * jax_ate))
    gate("H", f"{part} resets", r["resets"], 0)
    if r["files"] != sorted(RESULT_FILES + ("viewer.html",)):
        fail(f"slice H {part}: result files {r['files']}")
    if not r["map_reloads_equal"]:
        fail(f"slice H {part}: the saved map did not reload equal")
    if r["scorer_plain_runs_on_cuda"] != 0:
        fail(f"slice H {part}: the plain scorer ran on cuda")
    gate_klt_launches(f"H {part}", r)
    if part == "kitti" and r["scorer_launches"] < 1:
        fail("slice H kitti: the scorer kernel never launched under the CLI")
    if r["worker_errors"]:
        fail(f"slice H {part}: {r['worker_errors']} worker errors")
    print(f"[slice H] {part}: ATE {rep['ate_m']} m (JAX package through "
          f"the root run_slam.py: {jax_ate} m), {rep['keyframes']} "
          f"keyframes, {rep['closures']} closures, {rep['fps']} fps, "
          f"{r['scorer_launches']} scorer launches, map of "
          f"{r['map_keyframes']} keyframes reloaded equal", flush=True)


# ---------------------------------------------------------------------- #
# slice I: distributed Schur bundle adjustment
# ---------------------------------------------------------------------- #

def dist_ba_work(prob, shard_np, iters: int):
    """What ``iters`` LM iterations of the distributed solve need on
    ``prob``'s data, per iteration: f32 operations (2 per multiply-add of
    the solver's contractions, by the data's sparsity: the blocks of each
    observation, of each (landmark, pose) pair of Z, of each pair of poses
    that see one landmark in S_corr, and the LU of the (6 Kw)² system;
    the residual and Jacobian formation, O(observations), left out) and
    bytes (the observations read once: pixels 8 B, pose and landmark
    indices 4 B each, camera 1 B; poses and landmarks read and written
    once, over ``iters``); and the operations of the dense S_corr einsum
    the code runs over ``shard_np``'s padded landmark axis."""
    import numpy as np

    Kw = len(prob.kf_ids)
    v = prob.obs_valid
    kf = prob.obs_kf[v].astype(np.int64)
    lm = prob.obs_lm[v].astype(np.int64)
    pairs = np.unique(lm * Kw + kf)
    per_lm_poses = np.bincount(pairs // Kw)
    n_lm = int((per_lm_poses > 0).sum())
    macs = (len(kf) * (72 + 18 + 12 + 6 + 36)
            + len(pairs) * (54 + 18 + 18)
            + int((per_lm_poses.astype(np.int64) ** 2).sum()) * 108)
    ops = 2.0 * macs + 2.0 * (6 * Kw) ** 3 / 3.0
    nbytes = (len(kf) * 17 + 2 * (Kw * 28 + n_lm * 12)) / iters
    n, per_lm = shard_np["lm_pos"].shape[:2]
    dense = 2.0 * n * per_lm * Kw * Kw * 108
    return dict(ops=ops, bytes=nbytes, dense_ops=dense,
                bound_ms=1e3 * max(ops / F32_FLOP_PER_S,
                                   nbytes / HBM_BYTES_PER_S),
                bound_by=("operations" if ops / F32_FLOP_PER_S
                          >= nbytes / HBM_BYTES_PER_S else "bytes"),
                dense_bound_ms=1e3 * dense / F32_FLOP_PER_S,
                window_landmarks=n_lm, lm_pose_pairs=int(len(pairs)))


def sharded_solve_figures(prob, params, gt, n: int, iters: int, dev):
    """The 64-KF (or any) window solved with ``n`` in-process shards
    through ``distributed_ba_solve``, and its step timed: ms per LM
    iteration (CUDA events around the whole solve, median of 5, over
    ``iters``), CUDA kernels and their device ms per iteration (a
    torch.profiler trace of the solve less one of the same step with 0
    iterations), the padding and
    work efficiency of the sharding (as scaling_bench.py defines them) and
    the work's bound. Returns (figures, poses)."""
    import torch

    from ov2slam_torch.entry import mean_t_err
    from ov2slam_torch.parallel import dist_ba

    th = SLICE_I_ROBUST_TH
    Kw, n_obs = len(prob.kf_ids), int(prob.obs_valid.sum())
    mesh = dist_ba.make_mesh(n)
    shard_np = dist_ba.shard_ba_problem(prob, n)
    shards = dist_ba.put_sharded(mesh, shard_np, Kw, dev)
    step = dist_ba.make_distributed_ba(mesh, params, th, iters)
    step0 = dist_ba.make_distributed_ba(mesh, params, th, 0)
    poses_in = torch.as_tensor(prob.kf_poses, device=dev)
    fixed_in = torch.as_tensor(prob.kf_fixed, device=dev)
    poses, _, cost = dist_ba.distributed_ba_solve(
        mesh, prob, params, robust_th=th, iters=iters, device=dev)
    ms = time_cuda(lambda: step(poses_in, fixed_in, shards), 5) / iters
    k_all, api_all, dev_all = kernel_launches_per_call(
        lambda: step(poses_in, fixed_in, shards))
    k_set, api_set, dev_set = kernel_launches_per_call(
        lambda: step0(poses_in, fixed_in, shards))
    per_shard = int(shard_np["obs_valid"].shape[1])
    return dict(
        keyframes=Kw, obs=n_obs, shards=n, iters=iters, ms_per_iter=ms,
        kernels_per_iter=(k_all - k_set) / iters,
        cuda_launch_calls_per_iter=(api_all - api_set) / iters,
        device_ms_per_iter=(dev_all - dev_set) / iters,
        setup_kernels=k_set,
        padding=dist_ba.shard_padding_overhead(shard_np),
        work_efficiency=(n_obs / n) / per_shard, obs_per_shard=per_shard,
        lm_per_shard=int(shard_np["lm_pos"].shape[1]), cost=cost,
        t_err_after=mean_t_err(poses, prob, gt),
        reduction_bytes_per_iter=reduction_bytes(Kw),
        **dist_ba_work(prob, shard_np, iters)), poses


def run_slice_i(dev):
    """Slice I: ``entry.dryrun_multichip(8)`` on the card (its checks
    raise), the dryrun's 28-KF window timed at 8 shards, then the 64-KF
    window at 1, 2, 4 and 8 in-process shards with its gates (see the
    module docstring). With two or more cards, the 8-shard solve again as
    2 NCCL ranks."""
    import tempfile

    import numpy as np
    import torch

    from ov2slam_torch.entry import dryrun_multichip, mean_t_err
    from ov2slam_torch.ops import hamming
    from ov2slam_torch.parallel import dist_ba, worker
    from ov2slam_torch.parallel.problems import realistic_window_problem
    from ov2slam_torch.solvers.ba import ba_solve
    from ov2slam_torch.utils import lie_np

    t0 = time.perf_counter()
    th = SLICE_I_ROBUST_TH
    # the slice launches no kernel of the repo's own: its count stays 0
    hamming.match_scores_bits.launches = 0
    res = dict(dryrun=dryrun_multichip(8))
    _, kw, iters = SLICE_I_PROBLEMS[0]
    _, prob, params, gt = realistic_window_problem(**kw, device=dev)
    res["dryrun"]["timed"], _ = sharded_solve_figures(
        prob, params, gt, 8, iters, dev)
    print("[slice I] dryrun window, 8 shards: "
          + json.dumps(res["dryrun"]["timed"]), flush=True)

    _, kw, iters = SLICE_I_PROBLEMS[2]
    _, prob, params, gt = realistic_window_problem(**kw, device=dev)
    t_before = mean_t_err(prob.kf_poses, prob, gt)
    jax_t = JAX_SLICE_I["window64_t_err_after"]
    rows, solved = [], {}
    for n in SLICE_I_SHARDS:
        row, solved[n] = sharded_solve_figures(prob, params, gt, n, iters,
                                               dev)
        rot, tr = lie_np.pose_distance(solved[n].astype(np.float64),
                                       solved[1].astype(np.float64))
        row.update(pose_vs_1_shard_m=float(tr.max()),
                   pose_vs_1_shard_rad=float(rot.max()))
        rows.append(row)
        print(f"[slice I] 64-KF window, {n} shards: " + json.dumps(row),
              flush=True)
        gate("I", f"{n}-shard mean |t| error (m)", row["t_err_after"],
             SLICE_I_T_SHARE * t_before)
        gate("I", f"{n}-shard mean |t| error, against the JAX package's "
             "(m)", row["t_err_after"],
             max(SLICE_I_T_SHARE * t_before, 1.25 * jax_t))
        gate("I", f"{n} shards against 1, poses (m and rad)",
             max(tr.max(), rot.max()), SLICE_I_POSE_TOL)
    r8 = rows[-1]
    s_cost = float(ba_solve(
        *(torch.as_tensor(getattr(prob, k), device=dev) for k in (
            "kf_poses", "kf_fixed", "lm_pos", "obs_kf", "obs_lm", "obs_px",
            "obs_cam", "obs_valid")), params, robust_th=th,
        iters=iters)[3])
    gate("I", "8-shard cost against the single-card ba_solve's",
         r8["cost"], SLICE_I_COST_SHARE * s_cost)
    _, cprob, cparams, _ = realistic_window_problem(**kw, device="cpu")
    cpu_poses, _, cpu_cost = dist_ba.distributed_ba_solve(
        8, cprob, cparams, robust_th=th, iters=iters, device="cpu")
    rot, tr = lie_np.pose_distance(solved[8].astype(np.float64),
                                   cpu_poses.astype(np.float64))
    gate("I", "8 shards, card against CPU, poses (m and rad)",
         max(tr.max(), rot.max()), SLICE_I_POSE_TOL)
    res["window64"] = dict(
        t_err_before=t_before, jax_t_err_after=jax_t,
        jax_cost=JAX_SLICE_I["window64_cost"], ba_solve_cost=s_cost,
        cpu_cost=cpu_cost, card_vs_cpu_m=float(tr.max()),
        card_vs_cpu_rad=float(rot.max()), rows=rows)
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory() as tmp:
            nccl = worker.run_ranks(cprob, cparams, tmp, 2, 8, iters=iters,
                                    robust_th=th, timeout=600)
        rot, tr = lie_np.pose_distance(nccl[0].astype(np.float64),
                                       solved[8].astype(np.float64))
        gate("I", "8 shards as 2 NCCL ranks against in-process (m, rad)",
             max(tr.max(), rot.max()), SLICE_I_POSE_TOL)
        res["nccl"] = dict(ranks=2, shards=8, cost=nccl[2],
                           vs_in_process_m=float(tr.max()),
                           vs_in_process_rad=float(rot.max()))
        print(f"[I] nccl: 8 shards over 2 ranks: {json.dumps(res['nccl'])}",
              flush=True)
    else:
        res["nccl"] = "skipped, 1 device"
        print("[I] nccl: skipped, 1 device", flush=True)
    res["wall_s"] = time.perf_counter() - t0
    res["scorer_launches"] = hamming.match_scores_bits.launches
    if res["scorer_launches"]:
        fail(f"slice I: {res['scorer_launches']} scorer launches")
    d8 = res["dryrun"]["timed"]
    print(f"[slice I] 64-KF window, {r8['obs']} observations, {iters} "
          f"iterations: mean |t| error {t_before:.6f} -> "
          f"{r8['t_err_after']:.6f} m at 8 shards (gate {SLICE_I_T_SHARE} "
          f"x; JAX package {jax_t}), cost {r8['cost']} (single-card "
          f"ba_solve {s_cost}; CPU {cpu_cost}); 8 shards, card against "
          f"CPU: {res['window64']['card_vs_cpu_m']:.3g} m, "
          f"{res['window64']['card_vs_cpu_rad']:.3g} rad; ms per LM "
          f"iteration by "
          f"shards { {r['shards']: round(r['ms_per_iter'], 4) for r in rows} }"
          f", kernels per iteration "
          f"{ {r['shards']: r['kernels_per_iter'] for r in rows} } "
          f"taking "
          f"{ {r['shards']: round(r['device_ms_per_iter'], 4) for r in rows} }"
          f" ms on the device; bound "
          f"{r8['bound_ms']:.6f} ms ({r8['bound_by']}; the dense S_corr "
          f"einsum alone {r8['dense_bound_ms']:.4f} ms); 28-KF dryrun "
          f"window at 8 shards {d8['ms_per_iter']:.4f} ms per iteration "
          f"against {d8['bound_ms']:.6f} ms (dense einsum "
          f"{d8['dense_bound_ms']:.4f}); a cross-process reduction carries "
          f"{r8['reduction_bytes_per_iter']} B per iteration "
          f"({d8['reduction_bytes_per_iter']} B at 28 KFs); slice I took "
          f"{res['wall_s']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------- #
# phase klt: the KLT kernel against its plain versions
# ---------------------------------------------------------------------- #

KLT_STATUS_SHARE = 0.99      # status equal on at least this share of rows
KLT_POS_PX = 1e-2            # positions where both track, px
KLT_KERNEL_SYMBOL = "klt_kernel"   # csrc/klt_track.cu's __global__


def klt_pair_case():
    """test_torch_klt.py's pair fixture, built with the port's modules:
    frames 0 and 2 of a 188x120 synthetic sequence (seed 1) and the
    Shi-Tomasi keypoints of frame 0 in 160 slots (dead rows where a cell
    found none). Numpy arrays: prev, cur, kps, valid."""
    import numpy as np
    import torch

    from ov2slam_torch.io.synthetic import generate_sequence
    from ov2slam_torch.ops.detect import detect_single_scale

    seq = generate_sequence(n_frames=3, stereo=False, width=188, height=120,
                            n_points=700, seed=1, speed=0.05)
    a = seq.images_left[0].astype(np.float32)
    b = seq.images_left[2].astype(np.float32)
    kps, _, ok = detect_single_scale(
        torch.as_tensor(a), torch.zeros((1, 2)),
        torch.zeros(1, dtype=torch.bool), 0.001, 12, 160)
    return a, b, kps.numpy().astype(np.float32), ok.numpy()


def klt_split_case():
    """test_torch_klt.py's split-overflow case: a blurred random 160x120
    image and its copy shifted by (5, -3) px, 48 keypoints, the even ones
    3D (``base_only``) with the true shift as prior. Numpy arrays: prev,
    cur, kps, priors, base_only."""
    import numpy as np
    import torch

    from ov2slam_torch.core.camera import bilinear_sample
    from ov2slam_torch.core.image import gaussian_blur

    rng = np.random.default_rng(7)
    base = rng.uniform(0, 255, size=(120, 160)).astype(np.float32)
    base = gaussian_blur(torch.as_tensor(base), 2.0, 4).numpy()
    yy, xx = np.meshgrid(np.arange(120, dtype=np.float32),
                         np.arange(160, dtype=np.float32), indexing="ij")
    cur = bilinear_sample(torch.as_tensor(base), torch.as_tensor(
        np.stack([xx - 5.0, yy + 3.0], -1))).numpy()
    n = 48
    kps = rng.uniform([20, 20], [140, 100], size=(n, 2)).astype(np.float32)
    base_only = np.arange(n) % 2 == 0
    prior = np.where(base_only[:, None], kps + np.float32([5.0, -3.0]), kps)
    return base, cur, kps, prior.astype(np.float32), base_only


def klt_flat_case():
    """The split case's frames with a flat block in both and the even
    keypoints inside it, where G vanishes and the min-eigenvalue gate
    stops them. Numpy arrays: prev, cur, kps, priors."""
    import numpy as np

    base, cur, kps, _, _ = klt_split_case()
    base[30:90, 30:110] = 128.0
    cur[30:90, 30:110] = 128.0
    kps[::2] = np.float32([45, 45]) + (kps[::2] % 20)
    return base, cur, kps, kps + np.float32([1.0, 0.5])


def reset_klt_counts() -> None:
    """Zero the KLT kernel's launch counters and the plain versions' calls
    on CUDA tensors."""
    from ov2slam_torch.ops import klt

    klt.klt_track.launches = 0
    klt.klt_track.shapes.clear()
    klt.klt_track.origins.clear()
    klt.klt_track_plain.cuda_runs = 0
    klt.fb_klt_track_plain.cuda_runs = 0


def klt_counts():
    """The counters :func:`reset_klt_counts` zeroes, as JSON-ready values:
    launches, [N, levels, fb, count] per shape, [thread, stream, count] per
    origin, and the plain versions' calls on CUDA tensors."""
    from ov2slam_torch.ops import klt

    return dict(
        klt_launches=klt.klt_track.launches,
        klt_shapes=[[*k, v] for k, v in sorted(klt.klt_track.shapes.items())],
        klt_origins=[[t, s, v] for (t, s), v in
                     sorted(klt.klt_track.origins.items())],
        klt_plain_runs_on_cuda=(klt.klt_track_plain.cuda_runs
                                + klt.fb_klt_track_plain.cuda_runs))


def gate_klt_launches(name: str, counts) -> None:
    """Every SLAM slice's main path tracks through the kernel, and never
    through a plain version on the card."""
    if counts["klt_launches"] < 1:
        fail(f"slice {name}: the KLT kernel never launched")
    if counts["klt_plain_runs_on_cuda"] != 0:
        fail(f"slice {name}: the plain KLT ran "
             f"{counts['klt_plain_runs_on_cuda']} times on cuda")


class KltSet:
    """One KLT call of the phase: ``mode`` "klt" (``klt_track``), "fb"
    (``fb_klt_track``) or "split" (``fb_klt_track_split`` with ``n_sub``
    and ``base_only``), its inputs on the card and its options."""

    def __init__(self, label, mode, pyr_prev, pyr_cur, kps, priors, valid,
                 **opts):
        self.label, self.mode = label, mode
        self.args = (tuple(pyr_prev), tuple(pyr_cur), kps, priors, valid)
        self.split = {k: opts.pop(k) for k in ("base_only", "n_sub")
                      if k in opts}
        self.opts = opts

    def run(self, plain: bool = False):
        from ov2slam_torch.ops import klt

        if self.mode == "klt":
            fn = klt.klt_track_plain if plain else klt.klt_track
            return fn(*self.args, **self.opts)[:2]
        if self.mode == "fb":
            fn = klt.fb_klt_track_plain if plain else klt.fb_klt_track
            return fn(*self.args, **self.opts)
        if not plain:
            return klt.fb_klt_track_split(
                *self.args, self.split["base_only"], self.split["n_sub"],
                **self.opts)
        # the split's two fb calls through the plain version, on the card
        orig, klt.fb_klt_track = klt.fb_klt_track, klt.fb_klt_track_plain
        try:
            return klt.fb_klt_track_split(
                *self.args, self.split["base_only"], self.split["n_sub"],
                **self.opts)
        finally:
            klt.fb_klt_track = orig


def klt_set_bound(s):
    """The bound of one call of ``s`` (``roofline.fb_klt_bound`` of each
    launch it makes, at the steps this data took), and the launches'
    dependent chains summed."""
    import torch

    from ov2slam_torch.ops import klt

    seen = []
    orig = klt.launch

    def counting(pyr_prev, pyr_cur, kps, priors, valid, back_levels=0,
                 **kw):
        steps = torch.zeros(kps.shape[0], dtype=torch.int32,
                            device=kps.device)
        out = orig(pyr_prev, pyr_cur, kps, priors, valid, back_levels,
                   steps=steps, **kw)
        seen.append((kps.cpu().numpy(), [tuple(p.shape) for p in pyr_prev],
                     back_levels, kw, steps.cpu().numpy()))
        return out

    klt.launch = counting
    try:
        s.run()
    finally:
        klt.launch = orig
    ops = nbytes = steps = 0
    chain = 0.0
    for kps, shapes, back, kw, st in seen:
        b = fb_klt_bound(kps, shapes, win=kw.get("win", 9),
                         iters=kw.get("iters", 30),
                         margin=kw.get("margin", 5), back_levels=back,
                         steps=st)
        ops, nbytes = ops + b["ops"], nbytes + b["bytes"]
        steps += b["steps"]
        chain += b["chain_estimate_ms"]
    t_ops, t_bytes = ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(launches_per_call=len(seen), ops=ops, bytes=nbytes,
                steps=steps, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                chain_ms=chain)


def klt_check(s):
    """The kernel against the plain version on ``s``'s inputs on the card:
    status equal on >= ``KLT_STATUS_SHARE`` of the rows, positions within
    ``KLT_POS_PX`` where both track, and a second launch bit-equal to the
    first. Returns the agreement figures."""
    import numpy as np
    import torch

    got, again, want = s.run(), s.run(), s.run(plain=True)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"klt_track {s.label}: two launches differ")
    gpx, gst = (x.cpu().numpy() for x in got)
    wpx, wst = (x.cpu().numpy() for x in want)
    if not (np.isfinite(gpx).all() and gpx.shape == wpx.shape):
        fail(f"klt_track {s.label}: positions not finite or misshapen")
    share = float((gst == wst).mean())
    both = gst & wst
    err = float(np.abs(gpx[both] - wpx[both]).max()) if both.any() else 0.0
    res = dict(label=s.label, mode=s.mode, keypoints=len(gst),
               tracked_kernel=int(gst.sum()), tracked_plain=int(wst.sum()),
               status_equal_share=share, both_tracked=int(both.sum()),
               max_pos_err=err)
    if share < KLT_STATUS_SHARE or err > KLT_POS_PX or not both.any():
        fail(f"klt_track {s.label}: kernel and plain disagree: {res}")
    return res


def time_klt(s, runs: int = 20, plain_runs: int = 3):
    """``s``'s kernel call: median ms (events around one call), device ms
    (calls queued behind a sleep), CUDA kernels per call
    (:func:`klt_kernels_per_call`), its bound, and the plain version's
    median ms."""
    kernels_per_call, n_klt, seen = klt_kernels_per_call(s.run, 3)
    return dict(ms=time_cuda(s.run, runs),
                device_ms=time_cuda_queued(s.run, runs),
                kernels_per_call=kernels_per_call,
                klt_launches_per_call=n_klt,
                klt_device_events_traced_per_call=seen,
                plain_ms=time_cuda(lambda: s.run(plain=True), plain_runs),
                **klt_set_bound(s))


def klt_fixture_sets(dev):
    """The test fixtures as calls on the card: the pair (klt and fb), the
    flat block (fb) and the split-overflow case at n_sub 8 and 64."""
    import torch

    from ov2slam_torch.core.image import build_pyramid

    def pyr(img, levels):
        return tuple(build_pyramid(torch.as_tensor(img, device=dev), levels))

    def t(x):
        return torch.as_tensor(x, device=dev)

    a, b, kps, ok = klt_pair_case()
    pp, pc = pyr(a, 4), pyr(b, 4)
    out = [KltSet("fixture pair, klt_track", "klt", pp, pc, t(kps), t(kps),
                  t(ok)),
           KltSet("fixture pair, fb_klt_track", "fb", pp, pc, t(kps),
                  t(kps), t(ok))]
    fa, fb, fk, fp = klt_flat_case()
    out.append(KltSet("fixture flat block, fb_klt_track", "fb", pyr(fa, 3),
                      pyr(fb, 3), t(fk), t(fp),
                      torch.ones(len(fk), dtype=torch.bool, device=dev)))
    base, cur, kps, prior, base_only = klt_split_case()
    for n_sub in (8, 64):
        out.append(KltSet(
            f"fixture split, n_sub {n_sub}", "split", pyr(base, 3),
            pyr(cur, 3), t(kps), t(prior),
            torch.ones(len(kps), dtype=torch.bool, device=dev),
            base_only=t(base_only), n_sub=n_sub))
    return out


def klt_slice_sets(seq, cfg, dev, frame: int = 40):
    """Slice B's frames as the front end and the mapper track them: the
    left frames ``frame`` and ``frame + 1`` (CLAHE as configured, the
    config's pyramid) with the keypoints detected in the first at the
    config's slot count, as the front end's default fb tracking (the
    forward klt_track over the pyramid, the backward one on the base
    level) and as one fb_klt_track; and the stereo pair of ``frame`` as
    the mapper tracks it (SAD priors along the row, fb_klt_track)."""
    import torch

    from ov2slam_torch.core.image import build_pyramid, clahe
    from ov2slam_torch.ops.detect import detect_single_scale
    from ov2slam_torch.ops.stereo_sad import line_min_sad

    def pyr(img):
        im = torch.as_tensor(img, device=dev, dtype=torch.float32)
        if cfg.use_clahe:
            im = clahe(im, cfg.clahe_val)
        return tuple(build_pyramid(im, cfg.klt_levels))

    p0, p1 = pyr(seq.images_left[frame]), pyr(seq.images_left[frame + 1])
    pr = pyr(seq.images_right[frame])
    kps, _, ok = detect_single_scale(
        p0[0], torch.zeros((1, 2), device=dev),
        torch.zeros(1, dtype=torch.bool, device=dev), cfg.max_quality,
        cfg.max_dist, cfg.max_kps)
    opts = dict(win=cfg.klt_win_size, iters=cfg.max_iter,
                max_err=cfg.klt_err)
    fb_opts = dict(opts, max_fb_dist=cfg.max_fbklt_dist)
    what = f"{seq.width}x{seq.height}, {cfg.max_kps} slots"
    sad, _, _ = line_min_sad(p0[0], pr[0], kps, ok)
    sad = torch.where(ok[:, None], sad, kps)
    return [
        KltSet(f"slice B frames {frame}->{frame + 1} ({what}), forward "
               "klt_track", "klt", p0, p1, kps, kps, ok, **opts),
        KltSet(f"slice B frames {frame}->{frame + 1} ({what}), fb_klt_track",
               "fb", p0, p1, kps, kps, ok, **fb_opts),
        KltSet(f"slice B stereo pair {frame} ({what}), SAD priors, "
               "fb_klt_track (the mapper's)", "fb", p0, pr, kps, sad, ok,
               **fb_opts)]


def klt_step_latency(dev, runs: int = 200):
    """One LK step's latency on the card: one keypoint of ``entry()``'s
    noise images that takes every step without converging, tracked at the
    base level with ``iters`` 1 and 30, each launch's device time from
    ``runs`` launches queued behind a sleep; the step is the difference
    over 29 steps. Returns ns and SM cycles (at ``SM_CLOCK_HZ``) a step."""
    import numpy as np
    import torch

    from ov2slam_torch.entry import entry_arrays
    from ov2slam_torch.ops import klt

    img0, img1, kps = entry_arrays()
    pp = (torch.as_tensor(img0, device=dev),)
    pc = (torch.as_tensor(img1, device=dev),)
    k = torch.as_tensor(kps, device=dev)
    v = torch.ones(len(kps), dtype=torch.bool, device=dev)
    steps = torch.zeros(len(kps), dtype=torch.int32, device=dev)
    klt.launch(pp, pc, k, k, v, 0, iters=30, steps=steps)
    full = np.nonzero(steps.cpu().numpy() == 30)[0]
    if len(full) == 0:
        fail("klt step latency: no keypoint takes 30 steps")
    one, v1 = k[full[:1]].contiguous(), v[:1].contiguous()
    st1 = torch.zeros(1, dtype=torch.int32, device=dev)
    t = {}
    for it in (1, 30):
        klt.launch(pp, pc, one, one, v1, 0, iters=it, steps=st1)
        if int(st1.item()) != it:
            fail(f"klt step latency: {int(st1.item())} steps of {it}")
        t[it] = time_cuda_queued(
            lambda: klt.launch(pp, pc, one, one, v1, 0, iters=it), runs)
    ns = 1e6 * (t[30] - t[1]) / 29
    return dict(launch_ms_iters1=t[1], launch_ms_iters30=t[30],
                step_ns=ns, step_cycles=ns * 1e-9 * SM_CLOCK_HZ,
                keypoint=int(full[0]))


def phase_klt(dev, seq_b, cfg_b):
    """The KLT kernel held against its plain versions on the card (the
    test fixtures, slice B's frame pair and stereo pair, the split-overflow
    case) and timed at each, and one step's latency. Returns the rows, the
    largest position difference where both tracked, and the latency."""
    t0 = time.perf_counter()
    rows, err = [], 0.0
    for s in klt_fixture_sets(dev) + klt_slice_sets(seq_b, cfg_b, dev):
        agree = klt_check(s)
        err = max(err, agree["max_pos_err"])
        row = dict(**agree, **time_klt(s))
        print(f"[kernels] klt_track {s.label}: status equal on "
              f"{row['status_equal_share']:.4f} of {row['keypoints']}, "
              f"{row['both_tracked']} tracked by both within "
              f"{row['max_pos_err']:.2e} px; {row['ms']:.4f} ms per call, "
              f"{row['device_ms']:.4f} ms on the device, "
              f"{row['kernels_per_call']:.0f} kernels, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}), chain {row['chain_ms']:.5f} ms",
              flush=True)
        rows.append(row)
    lat = klt_step_latency(dev)
    print(f"[kernels] klt_track one LK step: {lat['step_ns']:.1f} ns "
          f"({lat['step_cycles']:.0f} cycles at {SM_CLOCK_HZ / 1e9} GHz; "
          f"launch {lat['launch_ms_iters1']:.5f} ms at iters 1, "
          f"{lat['launch_ms_iters30']:.5f} ms at iters 30); phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows, err, lat


# ---------------------------------------------------------------------- #
# phase entry: the fb-KLT flagship call
# ---------------------------------------------------------------------- #

def kernel_launches_per_call(fn, calls: int = 1):
    """CUDA kernels per call of ``fn``, from a torch.profiler trace: the
    device's kernel events, the ``cudaLaunchKernel`` runtime calls, and
    the kernels' summed device time (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev_us = [e.time_range.elapsed_us() for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_us:
        dev_us = [k.duration for e in events for k in e.kernels]
    api = sum(e.count for e in prof.key_averages()
              if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    return len(dev_us) / calls, api / calls, 1e-3 * sum(dev_us) / calls


def klt_kernels_per_call(fn, calls: int = 3):
    """CUDA kernels per call of ``fn``, a call that launches the KLT
    kernel: torch's kernels from a torch.profiler trace, plus the KLT
    kernel's launches from its wrapper's counter, because the trace holds
    the device events of only some of the kernel's ctypes launches
    (PERF.md §7). Returns (kernels, KLT launches, KLT device events that
    the trace holds), each per call; the KLT's device time comes from
    CUDA events (``time_cuda_queued``), not from the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ov2slam_torch.ops import klt

    fn()
    torch.cuda.synchronize()
    n0 = klt.klt_track.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n_klt = klt.klt_track.launches - n0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = sum(KLT_KERNEL_SYMBOL in e.name for e in dev)
    torch_kernels = len(dev) - seen
    return (torch_kernels + n_klt) / calls, n_klt / calls, seen / calls


def phase_entry(dev):
    """``entry()`` on the card: one call launches the KLT kernel once and
    no plain version; ms per call (CUDA events, warm, median of 20), device
    ms (20 calls queued behind a sleep), kernels per call, the plain
    version's ms, the bound at this data's steps, and agreement with the
    same call on the CPU."""
    import numpy as np
    import torch

    from ov2slam_torch.entry import entry
    from ov2slam_torch.ops.klt import fb_klt_track_plain, klt_track

    fn, args = entry()
    reset_klt_counts()
    fn(*args)
    torch.cuda.synchronize()
    counts = klt_counts()
    if counts["klt_launches"] != 1 or counts["klt_plain_runs_on_cuda"]:
        fail(f"entry: one call made {counts}")
    bound = klt_set_bound(KltSet("entry()", "fb", *args, win=9, iters=30))
    ms = time_cuda(lambda: fn(*args), 20)
    device_ms = time_cuda_queued(lambda: fn(*args), 20)
    kernels, _, seen = klt_kernels_per_call(lambda: fn(*args), 3)
    plain_ms = time_cuda(lambda: fb_klt_track_plain(*args, win=9, iters=30),
                         3)
    gpx, gst = (a.cpu().numpy() for a in fn(*args))
    cfn, cargs = entry(device="cpu")
    cpx, cst = (a.numpy() for a in cfn(*cargs))
    same_status = float((gst == cst).mean())
    both = gst & cst
    pos_err = float(np.abs(gpx[both] - cpx[both]).max()) if both.any() \
        else 0.0
    # on two independent noise images no keypoint passes the residual
    # gate: the forward positions, before the gates, are compared too
    gf = klt_track(*args, win=9, iters=30)[0].cpu().numpy()
    cf = klt_track(*cargs, win=9, iters=30)[0].numpy()
    fwd_differ = float((np.abs(gf - cf).max(1) > 1e-2).mean())
    res = dict(ms_per_call=ms, device_ms_per_call=device_ms,
               kernels_per_call=kernels,
               klt_device_events_traced_per_call=seen, plain_ms=plain_ms,
               klt_launches_per_call=counts["klt_launches"],
               keypoints=len(gst),
               tracked_card=int(gst.sum()), tracked_cpu=int(cst.sum()),
               status_equal_share=same_status, both_tracked=int(both.sum()),
               max_pos_err_both_tracked=pos_err,
               status_differ_share=1.0 - same_status,
               forward_pos_differ_share=fwd_differ, **bound)
    print("[entry] " + json.dumps(res), flush=True)
    gate("entry", "status differ share", 1.0 - same_status, 0.01)
    gate("entry", "position error where both track (px)", pos_err, 1e-2)
    return res


def launched_shapes_scorer(res, dev):
    """The scorer at every (M, N, Nq) slice ``res`` launched, per path
    (loop closure: Nq = N; relocalizer: Nq = max_kps = N / 2): one set of
    inputs at the path's largest M, every launched M held against both
    plain versions (match_bits 48, and 0, 127, 256 at the largest M), and
    the largest timed. Returns the per-path rows and the largest
    difference."""
    by_path = {}
    for M, N, Nq, n in res["scorer_shapes"]:
        by_path.setdefault((N, Nq), []).append((M, n))
    rows, err = [], 0.0
    for (N, Nq), ms in sorted(by_path.items()):
        path = "loop closure" if Nq == N else "relocalizer"
        M = max(m for m, _ in ms)
        args = scorer_inputs(M, N, Nq, seed=M + N + Nq, dev=dev)
        store, sv, q, qv = args
        label = f"slice {res['slice']} {path}"
        for m, _ in ms:
            err = max(err, scorer_equal(
                f"{label} M={m}", (store[:m], sv[:m], q, qv), 48)[1])
        for b in (0, 127, 256):
            err = max(err, scorer_equal(f"{label} M={M}", args, b)[1])
        row = time_scorer(args)
        print(f"[kernels] hamming_score {label}: M = "
              f"{sorted(m for m, _ in ms)} at N={N} Nq={Nq} equal to both "
              f"plain versions (atol 0); largest M={M}: {describe(row)}",
              flush=True)
        rows.append(dict(slice=res["slice"], path=path,
                         launches=sum(n for _, n in ms),
                         shapes_launched=len(ms), **row,
                         index_cube_bytes=res["index_cube_bytes"]))
    return rows, err


# ---------------------------------------------------------------------- #
# phase bench: the port's benchmark entry points
# ---------------------------------------------------------------------- #

def phase_bench(dev):
    """``ov2slam_torch.bench.main`` over all ten stages (``--frames``
    ``BENCH_FRAMES``, the repetitions of ``BENCH_DEPTH``) and
    ``protocol_bench.main(["--smoke"])``, with their
    gates (see the module docstring); then the scorer held against both
    plain versions at the lc_query stage's store and at every shape the
    e2e_loop stage launched. Returns the bench's line, the scorer's
    launches in the bench, the scorer rows and their largest difference."""
    import torch

    from ov2slam_torch import bench, protocol_bench
    from ov2slam_torch.ops import hamming

    t0 = time.perf_counter()
    # counts cover exactly the bench's run of its stages
    hamming.match_scores_bits.launches = 0
    hamming.match_scores_bits.shapes.clear()
    hamming.match_scores_bits_plain.cuda_runs = 0
    hamming.match_scores_plain.cuda_runs = 0
    reset_klt_counts()
    detail = {}
    saved = {k: dict(getattr(bench, k)) for k in BENCH_DEPTH}
    try:
        for k, v in BENCH_DEPTH.items():
            getattr(bench, k).update(v)
        rc = bench.main(["--frames", str(BENCH_FRAMES)], detail=detail)
    finally:
        for k, v in saved.items():
            getattr(bench, k).update(v)
    launches = hamming.match_scores_bits.launches
    plain_cuda = (hamming.match_scores_bits_plain.cuda_runs
                  + hamming.match_scores_plain.cuda_runs)
    klt = klt_counts()
    t_bench = time.perf_counter() - t0
    line, stages = detail["line"], detail["stages"]
    print("[bench] " + json.dumps(line), flush=True)
    if rc != 0:
        fail(f"bench: exit code {rc}, failed stages {detail['failed']}")
    if tuple(stages) != bench.STAGES:
        fail(f"bench: stages {list(stages)}")
    bad = bench.nonfinite(stages)
    if bad:
        fail(f"bench: values not finite at {bad}")
    want = dict(name=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count())
    if not (isinstance(line["device"], dict) and all(
            line["device"][k] == v for k, v in want.items())):
        fail(f"bench: device {line['device']}, not the card {want}")
    pcg = stages["full_ba_pcg"]
    n_iters = (bench.FULL_BA_PCG["iters_robust"]
               + bench.FULL_BA_PCG["iters_l2"])
    if pcg["branch"] != "pcg" or pcg["pcg_steps"] != n_iters:
        fail(f"bench: full_ba_pcg took {pcg['pcg_steps']} PCG steps of "
             f"{n_iters} ({pcg['branch']})")
    for name in ("lc_query", "e2e_loop"):
        if stages[name]["scorer_launches"] < 1:
            fail(f"bench: the scorer never launched in {name}")
    if [s[:3] for s in stages["lc_query"]["scorer_shapes"]] != [
            list(BENCH_LC_SHAPE)]:
        fail(f"bench: lc_query scored {stages['lc_query']['scorer_shapes']}")
    if plain_cuda:
        fail("bench: the plain scorer ran on cuda")
    gate_klt_launches("bench", klt)
    for name in ("e2e_async", "e2e_async20", "e2e_async40"):
        if stages[name].get("n_worker_errors") != 0:
            fail(f"bench: {name} had worker errors")

    t1 = time.perf_counter()
    out = os.path.join(HERE, "build", "protocol_smoke.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    prc = protocol_bench.main(["--smoke", "--out", out])
    with open(out) as f:
        recs = [json.loads(x) for x in f]
    for r in recs:
        print("[bench] protocol_bench --smoke: " + json.dumps(r), flush=True)
    if prc != 0 or [r["mode"] for r in recs] != ["throughput", "online"]:
        fail(f"protocol_bench --smoke: exit code {prc}, {len(recs)} records")
    for r in recs:
        if "error" in r or r["n_worker_errors"] or r["device"] != \
                line["device"] or bench.nonfinite(r):
            fail(f"protocol_bench --smoke: {r['mode']} run failed")
    t_protocol = time.perf_counter() - t1

    # the scorer at the bench's store, and at every shape e2e_loop launched
    M, N, Nq = BENCH_LC_SHAPE
    args = scorer_inputs(M, N, Nq, seed=M + N + Nq, dev=dev, p_valid=1.0)
    err = 0.0
    for b in (0, 48, 127, 256):
        err = max(err, scorer_equal(f"bench lc_query M={M}", args, b)[1])
    row = time_scorer(args)
    print(f"[kernels] hamming_score bench lc_query M={M} N={N} Nq={Nq} "
          f"equal to both plain versions (atol 0): {describe(row)}",
          flush=True)
    rows = [dict(slice="bench", path="lc_query (PlaceIndex, 1024 KFs)",
                 launches=stages["lc_query"]["scorer_launches"], **row,
                 index_cube_bytes=M * N * 256)]
    more, e = launched_shapes_scorer(dict(
        slice="bench e2e_loop", scorer_shapes=stages["e2e_loop"][
            "scorer_shapes"], index_cube_bytes=None), dev)
    rows += more
    err = max(err, e)
    secs = time.perf_counter() - t0
    print(f"[bench] phase passed in {secs:.1f} s (bench {t_bench:.1f} s, "
          f"protocol smoke {t_protocol:.1f} s); line {len(json.dumps(line))}"
          f" bytes; scorer launches {launches}", flush=True)
    return dict(line=line, launches=launches, rows=rows, err=err,
                seconds=secs, protocol=recs,
                klt_launches=klt["klt_launches"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs a GPU",
              file=sys.stderr)
        return 2
    from ov2slam_torch import kernels
    from ov2slam_torch.device import resolve_device
    from ov2slam_torch.utils import profiles

    t_start = time.perf_counter()
    dev = resolve_device(None)
    smi = nvidia_smi_line()
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    build_s = kernels.build_all()
    print(f"[build] kernels {list(kernels.KERNELS)} built in "
          f"{build_s:.2f} s", flush=True)
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    rows, max_err = phase_kernels(dev)
    compaction = time_compaction(dev)

    a, _ = run_slice("A", dev)
    if a["closures"] < 1:
        fail("slice A: loop never closed")
    if not a["ate_m"] < SLICE_A_MAX_ATE:
        fail(f"slice A: ATE {a['ate_m']:.4f} m >= {SLICE_A_MAX_ATE}")
    if not a["end_err_m"] < SLICE_A_MAX_END_ERR:
        fail(f"slice A: endpoint error {a['end_err_m']:.4f} m "
             f">= {SLICE_A_MAX_END_ERR}")

    b, seq_b = run_slice("B", dev)
    gate_b = max(0.09, 1.25 * JAX_SLICE_B_ATE)
    if not b["ate_m"] <= gate_b:
        fail(f"slice B: ATE {b['ate_m']:.4f} m > {gate_b:.4f}")
    klt_rows, klt_err, klt_step = phase_klt(
        dev, seq_b, slice_config("B", seq_b, profiles))

    c, _ = run_slice("C", dev)
    gate_slice_c(c)
    d, _ = run_slice("D", dev)
    gate_slice_d(d)
    e = run_async_slice("E", dev, seq=seq_b)
    del seq_b
    gate_async(e, b)
    f = run_async_slice("F", dev)
    gate_async(f)
    ent = phase_entry(dev)
    g = run_slice_g(dev)
    h = {}
    for part in ("kitti", "tartanair"):
        h[part] = run_slice_h(part, dev)
        gate_slice_h(h[part])
    i = run_slice_i(dev)
    i8 = i["window64"]["rows"][-1]
    bn = phase_bench(dev)
    max_err = max(max_err, bn["err"])

    # each path's figures are at its last main-path query; the record's
    # top-level ones are slice B's, its launches those of all four
    # slices; phase 3's shapes follow in `phase3`
    paths = []
    for res, cap in ((b, rows[0]), (a, rows[1])):
        main, err = main_path_scorer(res, cap["shape"]["N"], dev)
        max_err = max(max_err, err)
        paths.append(dict(slice=res["slice"], path="loop closure",
                          launches=res["scorer_launches"], **main,
                          index_cube_bytes=res["index_cube_bytes"]))
    for res in (c, d, e, h["kitti"], h["tartanair"]):
        if not res["scorer_shapes"]:
            continue
        more, err = launched_shapes_scorer(res, dev)
        max_err = max(max_err, err)
        if res["slice"] == "H":
            for row in more:
                row.update(part=res["part"], via="run_slam.main")
        if res is e:
            for row in more:
                row.update(thread_streams=e["scorer_origins"],
                           worker_stream=e["worker_stream"])
        paths += more
    paths += bn["rows"]
    top = {k: paths[0][k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "shape")}
    # the KLT kernel's top-level figures are slice B's fb_klt_track call
    # (the front end's frame pair); its launches those of every SLAM slice
    # and of the bench
    klt_top = next(r for r in klt_rows if r["label"].startswith(
        "slice B frames") and r["mode"] == "fb")
    klt_line = dict(
        name="klt_track", route="cuda",
        source="ov2slam_torch/csrc/klt_track.cu",
        replaces="ov2slam_tpu/ops/klt.py:40",
        launches=sum(r["klt_launches"] for r in (a, b, c, d, e, f,
                                                 *h.values()))
        + bn["klt_launches"],
        max_abs_err=klt_err, library_ms=None,
        **{k: klt_top[k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "kernels_per_call", "chain_ms", "keypoints")},
        launches_by_slice={r["slice"] + (" " + r["part"] if "part" in r
                                         else ""): r["klt_launches"]
                           for r in (a, b, c, d, e, f, *h.values())},
        bench_launches=bn["klt_launches"], step_latency=klt_step,
        entry={k: ent[k] for k in (
            "ms_per_call", "device_ms_per_call", "kernels_per_call",
            "plain_ms", "bound_ms", "bound_by", "chain_ms")},
        paths=klt_rows)
    kernels_line = {"kernels": [klt_line, dict(
        name="hamming_score", route="cuda",
        source="ov2slam_torch/csrc/hamming_score.cu",
        replaces="ov2slam_tpu/ops/pallas_hamming.py:57",
        launches=sum(r["scorer_launches"] for r in (a, b, c, d, e, f,
                                                    *h.values()))
        + bn["launches"],
        max_abs_err=max_err, library_ms=None, **top, paths=paths,
        phase3=rows, index_compaction=compaction)]}
    # plain-torch work on the main paths, with its bound: candidates for
    # hand kernels (no kernel of the repo's own stands behind them)
    plain = {"plain_torch": [
        dict(name="tsdf_integrate", source="ov2slam_torch/mapping/tsdf.py",
             ms=g["integrate_ms_median"], calls=g["integrations"],
             kernels_per_call=g["integrate_kernels"],
             bound_ms=g["integrate_bound_ms"], bound_by="bytes",
             voxels=g["voxels"]),
        dict(name="esdf_sweep", source="ov2slam_torch/mapping/tsdf.py",
             ms=g["esdf_sweep_ms"], calls=g["esdf_sweeps"],
             kernels_per_call=g["esdf_sweep_kernels"],
             bound_ms=g["esdf_sweep_bound_ms"], bound_by="bytes",
             voxels=g["voxels"]),
        dict(name="dist_ba_iteration",
             source="ov2slam_torch/parallel/dist_ba.py",
             ms=i8["ms_per_iter"], calls=sum(
                 r["iters"] for r in i["window64"]["rows"]),
             kernels_per_call=i8["kernels_per_iter"],
             cuda_launch_calls_per_call=i8["cuda_launch_calls_per_iter"],
             device_ms=i8["device_ms_per_iter"],
             bound_ms=i8["bound_ms"], bound_by=i8["bound_by"],
             dense_einsum_bound_ms=i8["dense_bound_ms"], shards=8,
             keyframes=i8["keyframes"], obs=i8["obs"],
             dryrun_ms=i["dryrun"]["timed"]["ms_per_iter"],
             dryrun_bound_ms=i["dryrun"]["timed"]["bound_ms"])]}
    print(json.dumps(plain), flush=True)
    print(f"[chip_smoke] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
