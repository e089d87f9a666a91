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
     slice, A-F and H, is held to the KLT kernel so, to the undistortion,
     the tracks' tail (its tracking step's and, where it maps in stereo,
     its stereo step's) and filter kernels (the pyramid, BRIEF's blur,
     and Scharr's pair where its detector takes it) and, where its
     profile runs CLAHE,
     CLAHE's (``gate_image_launches``), and to having replayed its keyframe
     detection and, with inverse-depth BA, its local BA as CUDA graphs);
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
     then the pose kernels (``csrc/essential_ransac.cu``,
     ``csrc/pnp_refine.cu``) against their plain versions on the card: the
     test fixtures, slice B's front-end call at frame 40 and its loop
     closer's first call (RANSAC at 1000 iterations), recorded during the
     slice (``PoseCapture``). Gates: one kernel launch a call; two
     launches bit-equal; the front end's and the loop closer's calls
     issued together on two streams each equal to its call alone; RANSAC
     candidates slot by slot (samples of distinct rows): within 1e-3
     relative up to sign of the f64 one where the plain f32 candidate
     keeps 1e-5 of it, every 5-point candidate on its five rows' epipolar
     constraints to 1e-5, every 8-point one an essential matrix to 1e-3,
     and the share within 1e-3 of f64 and the median error to f64 no
     worse than the plain f32's (2 points, 2x); the chosen inlier mask
     equal except on rows within 1e-4 of the threshold, n_inliers within
     that count; PnP's pose within 1e-4 per component, its mask equal
     except within 1e-4 of the chi2 gate. Times each call (ms, device ms,
     the plain version, the bound, the chain); then the graph steps: slice
     B's 10th local BA solve and keyframe detection (``GraphCapture``)
     through fresh CUDA-graph steps, eager, captured and replayed: the
     replays equal the eager call bit for bit; host and device ms of each
     against the eager step;
     every SLAM slice and the bench must launch both and never run a plain
     pose function on the card (``gate_pose_launches``); then local BA's
     kernels (``csrc/ba_normal_eq.cu``, ``csrc/ba_schur_step.cu``) against
     their plain versions on the card (``phase_ba``): fixtures of 2, 32 and
     64 keyframes with padded landmark rows, invalid rows and a row behind
     its camera, and slice B's 10th local BA problem, Huber and L2. Gates:
     each normal-equation sum within 1e-4 of its largest entry of an f64
     plain solve's, or no farther from it than 2x the plain f32 version, the
     cost within 1e-5; the Schur step and one LM iteration: poses within
     1e-4, inverse depths 1e-3 relative; the accept test's decision equal;
     each kernel's second launch bit-equal to its first; the two-pass
     solve within 1e-3 with inlier masks equal and two runs bit-equal.
     Times each kernel (and the Schur product and the LU between the Schur
     step's launches) against its bound and plain version, and splits one
     eager solve's kernels and device ms by stage, through the plain
     versions and through the kernels; every SLAM slice with
     inverse-depth local BA and the bench must launch both kernels, and no
     run may call their plain versions on the card
     (``gate_ba_launches``); then the image and camera kernels
     (``csrc/undistort_points.cu``, ``csrc/separable_filter.cu``,
     ``csrc/clahe.cu``; ``phase_image``) against their plain versions on
     the card, atol 0: at 752x480, 376x240, 1241x376, 640x480 and 377x241
     on a fixture (CLAHE, its pyramid at 4 levels and at 6 (two chained
     launches), one pyramid level, the BRIEF blur, the box filter, both
     Scharr gradients; the undistortion and both distortion modes of
     512 pixels through a radtan and a fisheye camera, the radtan
     undistortion map, ``Camera.undistort_px``) and on slices A's and B's
     frame 40 (CLAHE and the filters); the tracks' tail at 512 and 301
     rows in every option set, and the tracking step's and stereo
     mapping's calls against the eager sequence they replaced
     (``tail_cases``); a second launch equal to the first; one line of
     output digests (``[image] digests``); each kernel timed at slice B's
     call (ms, device ms, plain ms, bound; the undistortion and the tail
     with their 8 steps' chain, the tail beside the eager sequence it
     replaced), the filters beside the cuDNN convolution that computes
     the same function;
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
     between the devices, at most 1e-4 of the updated ones; the
     integration kernel (``csrc/tsdf.cu``) launched once an integration
     and the sweep kernel once a sweep of the ESDF, no plain TSDF function
     on the card. Then the [tsdf] check (``phase_tsdf``): both kernels
     against their plain versions on the card at atol 0 (bits; NaNs by
     position), on copies of the fused grid over the first rig step's six
     integrations and on an odd 37x29x23 grid (depth with NaN, +-inf and
     values outside the ray bounds, principal point at k + 0.5 px), each
     in the four option sets (colour on or off, constant or 1/z^2
     weights), and 50 sweeps of slice G's occupancy (the float4 sweep
     kernel), of the odd grid's (the scalar one) and of a 37x29x24 one
     (the float4 kernel's ragged tiles), and 3 of each of the last two
     with NaN voxels. Reports ms, device ms, plain ms,
     kernels a call and bound of an integration and of a sweep, the
     device memory an integration adds (kernel and plain), the mesh's
     host seconds and the peak device memory;
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
the plain-torch work with a bound (an LM iteration of the distributed
BA), one JSON line of the graph steps' rows, one JSON line of kernel
records (the KLT kernel, the RANSAC and PnP kernels, local BA's two
kernels, the undistortion, tail, filter and CLAHE kernels, the TSDF
integration and ESDF sweep kernels, and the scorer), the card's
name
and power limit, and the final ``{"ok": true, "device": ...}`` line.

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
    KLT_SETUP_CYCLES, SM_CLOCK_HZ, fb_klt_bound, nvidia_smi_line,
    reduction_bytes)

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


def time_after_idle(fn, idle_s: float = 0.1, runs: int = 5):
    """Median ms of ``runs`` calls of ``fn`` (CUDA events around each), each
    issued after the card has had nothing to do for ``idle_s`` seconds, as
    slice G's integrations are (its render is the host's work)."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        time.sleep(idle_s)
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
    reset_pose_counts()
    reset_image_counts()
    reset_graph_counts()
    synchronize(dev)
    t0 = time.perf_counter()
    trace = drive_slice(name, slam, seq)
    synchronize(dev)
    wall = time.perf_counter() - t0
    klt = klt_counts()
    pose = pose_counts()
    image = image_counts()
    graph = graph_counts()
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
               index_cube_bytes=slam.loop_closer.index._cube.numel(),
               **klt, **pose, **image, use_clahe=cfg.use_clahe,
               use_scharr=uses_scharr(cfg), **graph,
               inverse_depth=cfg.use_inv_depth,
               stereo=cfg.stereo)
    print(f"[slice {name}] " + json.dumps(res), flush=True)
    print(f"[slice {name}] per-stage times (ms):\n" + prof.summary(),
          flush=True)
    gate_klt_launches(name, res)
    gate_pose_launches(name, res)
    gate_image_launches(name, res, cfg.use_clahe, res["use_scharr"],
                        cfg.stereo)
    gate_graphs(name, res, cfg.use_inv_depth, cfg.stereo)
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
    (frames dropped, pace fps, flat-out median seconds per frame, and the
    mean seconds per frame of the warm frames after the tenth and of the
    paced frames processed: the pace assumes the median stands for the
    mean)."""
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
    return (arr.n_dropped, pace_fps, med, float(np.mean(walls[10:])),
            float(np.mean(arr.walls)))


class DispatchSyncCounter:
    """Counts the synchronizing CUDA calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports during chained
    dispatches ``first`` ... ``first + n - 1`` of the front end ``fe``
    (the dispatch only, not the resolve), on the front end's own thread;
    what the worker thread reports in the same windows is counted apart.
    Each report is kept with the source line that made the call: the
    innermost line of this repository's code on the call's stack, and the
    library line that synchronized where that is not the repository's."""

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
            import traceback

            self.syncs += 1
            site = f"{os.path.relpath(filename, HERE)}:{lineno}"
            ours = [f for f in traceback.extract_stack()[:-1]
                    if f.filename.startswith(HERE + os.sep)
                    and "site-packages" not in f.filename]
            if ours and ours[-1].filename != filename:
                f = ours[-1]
                site = (f"{os.path.relpath(f.filename, HERE)}:{f.lineno} "
                        f"(via {site})")
            self.sites[site] += 1
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


class LockWaits:
    """The asynchronous manager's map lock with each thread's waits to
    acquire it summed (seconds by thread name), and those inside the loop
    closer's place query (``query_keyframe``, which holds the
    ``4.LC_QueryIndex`` scope) counted apart: ``query`` is [calls,
    seconds waited]. Everything else goes to the lock."""

    def __init__(self, slam):
        import collections

        self._lock = slam.map_lock
        self.wait_s = collections.Counter()
        self.query = [0, 0.0]
        slam.map_lock = self
        if slam.loop_closer is not None:
            orig = slam.loop_closer.query_keyframe

            def query_keyframe(*a, **k):
                import threading

                who = threading.current_thread().name
                w0 = self.wait_s[who]
                try:
                    return orig(*a, **k)
                finally:
                    self.query[0] += 1
                    self.query[1] += self.wait_s[who] - w0

            slam.loop_closer.query_keyframe = query_keyframe

    def acquire(self):
        import threading

        t0 = time.perf_counter()
        got = self._lock.acquire()
        self.wait_s[threading.current_thread().name] += (
            time.perf_counter() - t0)
        return got

    def release(self):
        self._lock.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def __getattr__(self, name):
        return getattr(self._lock, name)


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
    waits = LockWaits(slam)
    prof = Profiler.instance()
    prof.reset()
    # counts cover exactly this slice's run of the main path
    hamming.match_scores_bits.launches = 0
    hamming.match_scores_bits.shapes.clear()
    hamming.match_scores_bits.origins.clear()
    hamming.match_scores_bits_plain.cuda_runs = 0
    hamming.match_scores_plain.cuda_runs = 0
    reset_klt_counts()
    reset_pose_counts()
    reset_image_counts()
    reset_graph_counts()
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
    pose = pose_counts()
    image = image_counts()
    graph = graph_counts()
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
               lc_recent_mask=cfg.lc_recent_mask,
               map_lock_wait_ms={k: 1e3 * v for k, v in
                                 sorted(waits.wait_s.items())},
               map_lock_handoffs=slam.map_lock.handoffs, **klt,
               **pose, **image, use_clahe=cfg.use_clahe,
               use_scharr=uses_scharr(cfg), **graph,
               inverse_depth=cfg.use_inv_depth,
               stereo=cfg.stereo)
    if slam.loop_closer is not None:
        q = prof.stats().get("4.LC_QueryIndex", dict(n=0, mean_ms=0.0))
        res.update(index_rows=len(slam.loop_closer.index.kf_ids),
                   index_cube_bytes=slam.loop_closer.index._cube.numel(),
                   lc_query_index_ms=q["mean_ms"], lc_queries=q["n"],
                   lc_query_lock_wait_ms=(1e3 * waits.query[1]
                                          / max(waits.query[0], 1)))
    if paced is not None:
        n_dropped, pace_fps, med, warm_mean, paced_mean = paced
        res.update(dropped=n_dropped, paced_frames=len(frames) - SLICE_F_WARM,
                   pace_fps=pace_fps, flat_out_fps=1.0 / med,
                   warm_median_ms=1e3 * med, warm_mean_ms=1e3 * warm_mean,
                   paced_mean_ms=1e3 * paced_mean)
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
    gate_pose_launches(name, r)
    gate_image_launches(name, r, r["use_clahe"], r["use_scharr"],
                        r["stereo"])
    gate_graphs(name, r, r["inverse_depth"], r["stereo"])
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
        print(f"[slice E] loop closer's place query: "
              f"{r['lc_query_index_ms']:.3f} ms per keyframe in "
              f"4.LC_QueryIndex ({r['lc_queries']} queries), of which "
              f"{r['lc_query_lock_wait_ms']:.3f} ms waited for the map "
              f"lock; map-lock waits by thread (ms) "
              f"{r['map_lock_wait_ms']}, {r['map_lock_handoffs']} "
              "hand-offs at the worker's yield points", flush=True)
        gate("E", "map-lock wait inside the place query (share of it)",
             r["lc_query_lock_wait_ms"],
             0.1 * max(r["lc_query_index_ms"], 1e-9))
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


# the [tsdf] check: an odd grid (a multiple of no tile) seen by a small
# camera whose principal point sits on pixel boundaries (k + 0.5), its
# depth holding NaN, +-inf and values outside [min_ray, max_ray]; and the
# option sets (colour, use_const_weight) each kernel case runs
TSDF_ODD_DIMS = (37, 29, 23)
# a ragged grid whose nz is a multiple of 4 (the sweep's float4 kernel)
TSDF_QUAD_DIMS = (37, 29, 24)
TSDF_ODD_IMAGE = (64, 48)         # W, H
TSDF_OPTIONS = ((True, False), (True, True), (False, False), (False, True))
TSDF_SWEEPS_NAN = 3               # the sweep case with NaN voxels


def reset_tsdf_counts() -> None:
    """Zeroes the TSDF kernels' wrapper counters and the plain versions'
    calls on CUDA tensors."""
    from ov2slam_torch.mapping import tsdf

    for fn in (tsdf._tsdf_integrate, tsdf._esdf_sweep):
        fn.launches = 0
        fn.shapes.clear()
        fn.origins.clear()
    tsdf._tsdf_integrate_plain.cuda_runs = 0
    tsdf._esdf_sweep_plain.cuda_runs = 0


def tsdf_counts():
    """The counters :func:`reset_tsdf_counts` zeroes."""
    from ov2slam_torch.mapping import tsdf

    return dict(integrate_launches=tsdf._tsdf_integrate.launches,
                sweep_launches=tsdf._esdf_sweep.launches,
                integrate_plain_runs_on_cuda=(
                    tsdf._tsdf_integrate_plain.cuda_runs),
                sweep_plain_runs_on_cuda=tsdf._esdf_sweep_plain.cuda_runs)


def tsdf_odd_case(dev, seed: int = 0):
    """The odd grid's inputs on ``dev``: a state seen before (half its
    voxels with weights and colours), three poses looking into it, and
    per pose a depth image (NaN, +inf, -inf, below min_ray and above
    max_ray on a share of pixels each) and a colour image; the camera's
    principal point at (W/2 + 0.5, H/2 + 0.5). Returns a dict of the
    integration's arguments (``state``, ``frames`` as (depth, rgb, T_cw),
    ``K``, ``origin``, ``params``) and ``dims``."""
    import numpy as np
    import torch

    from ov2slam_torch.utils import lie_np

    rng = np.random.default_rng(seed)
    W, H = TSDF_ODD_IMAGE
    nx, ny, nz = TSDF_ODD_DIMS
    V = nx * ny * nz
    seen = rng.random(V) < 0.5
    state = (np.where(seen, rng.uniform(-1, 1, V), 1.0).astype(np.float32),
             (rng.uniform(0, 4.9, V) * seen).astype(np.float32),
             (rng.uniform(0, 255, (V, 3)) * seen[:, None]).astype(
                 np.float32))
    K = np.array([[50.0, 0, W / 2 + 0.5], [0, 50.0, H / 2 + 0.5],
                  [0, 0, 1]])
    frames = []
    for k in range(3):
        depth = rng.uniform(0.6, 3.5, (H, W)).astype(np.float32)
        for value, share in ((np.nan, 0.05), (np.inf, 0.03),
                             (-np.inf, 0.03), (0.2, 0.05), (12.0, 0.05)):
            depth[rng.random((H, W)) < share] = value
        rgb = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
        q = np.concatenate([[1.0], rng.normal(0, 0.08, 3)])
        T_wc = np.concatenate([q / np.linalg.norm(q),
                               [0.1 * k, -0.05 * k, 0.0]])
        T_cw = np.asarray(lie_np.pose_inverse(T_wc), np.float32)
        frames.append((torch.as_tensor(depth, device=dev),
                       torch.as_tensor(rgb, device=dev), T_cw))
    return dict(state=tuple(torch.as_tensor(a, device=dev) for a in state),
                frames=frames, K=K, origin=np.array([-1.8, -1.4, 0.1],
                                                    np.float32),
                params=dict(voxel=0.1, trunc=0.3, min_ray=0.5, max_ray=10.0,
                            max_weight=5.0), dims=TSDF_ODD_DIMS)


def _tsdf_same(a, b):
    """Bits equal (f32 as int32), NaNs compared by position."""
    return bool(((_bits(a) == _bits(b)) | (a.isnan() & b.isnan())).all())


def _tsdf_err(a, b) -> float:
    """The largest |a - b| where neither is NaN."""
    both = ~(a.isnan() | b.isnan())
    d = (a - b).abs()[both]
    return float(d.max()) if d.numel() else 0.0


def tsdf_integrate_check(label, case, errs):
    """Runs ``case``'s integrations through the kernel and through the
    plain version on copies of its state, in each option set of
    ``TSDF_OPTIONS``; fails unless tsdf, weight and colour are bit-equal
    after every integration (NaNs equal in position). Keeps the largest
    |kernel - plain| in ``errs["tsdf_integrate"]``; returns the outputs
    held and the NaN voxels of the last state."""
    import torch

    from ov2slam_torch.mapping import tsdf

    K, p = case["K"], case["params"]
    held = nan = 0
    for color, const in TSDF_OPTIONS:
        runs = []
        for fn in (tsdf._tsdf_integrate, tsdf._tsdf_integrate_plain):
            st = [x.clone() for x in case["state"]]
            if not color:
                st[2] = None
            runs.append((fn, st))
        for n, (depth, rgb, T_cw) in enumerate(case["frames"]):
            for fn, st in runs:
                fn(*st, depth, rgb if color else None, T_cw, K[0, 0],
                   K[1, 1], K[0, 2], K[1, 2], case["origin"], p["voxel"],
                   p["trunc"], p["min_ray"], p["max_ray"], p["max_weight"],
                   dims=case["dims"], use_const_weight=const)
            torch.cuda.synchronize()
            for name, a, b in zip(("tsdf", "weight", "color"), runs[0][1],
                                  runs[1][1]):
                if a is None:
                    continue
                if not _tsdf_same(a, b):
                    fail(f"tsdf {label} (colour {color}, const weight "
                         f"{const}), integration {n}: {name} not bit-equal "
                         f"to the plain version ({_tsdf_err(a, b):.3e})")
                errs["tsdf_integrate"] = max(errs.get("tsdf_integrate", 0.0),
                                             _tsdf_err(a, b))
                held += 1
        nan = int(runs[0][1][0].isnan().sum())
        del runs
    return held, nan


def tsdf_sweep_check(label, d0, voxel, n_iters, errs):
    """``n_iters`` sweeps of ``d0`` through the kernel and the plain version;
    fails unless bit-equal (NaNs equal in position) and unless ``d0`` is
    left as it was. Returns the NaN voxels of the result."""
    import torch

    from ov2slam_torch.mapping import tsdf

    before = d0.clone()
    a = tsdf._esdf_sweep(d0, voxel, n_iters)
    b = tsdf._esdf_sweep_plain(d0, voxel, n_iters)
    torch.cuda.synchronize()
    if not _tsdf_same(a, b):
        fail(f"tsdf {label}: {n_iters} sweeps not bit-equal to the plain "
             f"version ({_tsdf_err(a, b):.3e})")
    if not _tsdf_same(d0, before):
        fail(f"tsdf {label}: the sweep wrapper changed its input")
    errs["esdf_sweep"] = max(errs.get("esdf_sweep", 0.0), _tsdf_err(a, b))
    return int(a.isnan().sum())


def tsdf_odd_check(dev, errs):
    """The odd grid's cases: the integrations in every option set, then 50
    sweeps of an occupancy grid (2% of voxels) on the odd grid and on
    ``TSDF_QUAD_DIMS`` (the float4 sweep kernel's ragged tiles), and
    ``TSDF_SWEEPS_NAN`` sweeps of each holding two NaN voxels. Returns
    (outputs held, NaN voxels after the integrations, NaN voxels after
    the NaN sweeps)."""
    import numpy as np
    import torch

    case = tsdf_odd_case(dev)
    held, nan = tsdf_integrate_check("odd grid", case, errs)
    rng = np.random.default_rng(1)
    sweep_nan = 0
    for dims in (TSDF_ODD_DIMS, TSDF_QUAD_DIMS):
        occ = rng.random(dims) < 0.02
        d0 = torch.as_tensor(np.where(occ, 0.0, 1e9).astype(np.float32),
                             device=dev)
        tsdf_sweep_check(f"grid {dims}", d0, 0.1, 50, errs)
        d0[1, 2, 3] = d0[-1, -1, -1] = float("nan")
        sweep_nan += tsdf_sweep_check(f"grid {dims}, NaN voxels", d0, 0.1,
                                      TSDF_SWEEPS_NAN, errs)
    return held + 4, nan, sweep_nan


def tsdf_kernels_per_call(fn):
    """CUDA kernels one call of ``fn`` starts: torch's from a
    torch.profiler trace, plus the TSDF kernels' launches from their
    wrappers' counters (a trace may lack a ctypes launch's device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ov2slam_torch.mapping import tsdf

    fn()
    torch.cuda.synchronize()
    n0 = tsdf._tsdf_integrate.launches + tsdf._esdf_sweep.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hand = tsdf._tsdf_integrate.launches + tsdf._esdf_sweep.launches - n0
    others = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and "tsdf_integrate_kernel" not in e.name
              and "esdf_sweep" not in e.name]
    return len(others) + hand


def phase_tsdf(vol, frames, dev):
    """The [tsdf] check after slice G's main path: both kernels against
    their plain versions on the card, bit for bit (NaNs by position), on
    copies of slice G's fused grid over the first rig step's six
    integrations in every option set, on the odd grid, and 50 sweeps of
    slice G's occupancy and of the odd grid's; then each kernel timed at
    slice G's size (ms, device ms, ms after the card idled 0.1 s as it
    does between slice G's integrations, plain ms, kernels a call, bound)
    and the device memory one integration adds, kernel and plain."""
    import torch

    from ov2slam_torch import roofline
    from ov2slam_torch.mapping import tsdf

    g = SLICE_G
    K = rig_intrinsics()
    errs = {}
    case = dict(state=(vol.tsdf, vol.weight, vol.color), K=K,
                origin=vol.origin, dims=vol.dims,
                frames=[(d, c, lie_np_inverse32(T)) for d, c, T in frames],
                params=dict(voxel=g["voxel"], trunc=g["trunc"],
                            min_ray=g["min_ray"], max_ray=g["max_ray"],
                            max_weight=vol.max_weight))
    held, _ = tsdf_integrate_check("slice G grid", case, errs)
    n_sweeps = int(round(g["esdf_max"] / g["voxel"]))
    d0 = vol._occupancy(1e-4)
    tsdf_sweep_check("slice G occupancy", d0, g["voxel"], n_sweeps, errs)
    odd_held, odd_nan, sweep_nan = tsdf_odd_check(dev, errs)
    if odd_nan == 0 or sweep_nan == 0:
        fail(f"tsdf odd grid: the NaN cases made no NaN voxel ({odd_nan}, "
             f"{sweep_nan})")
    held += 1 + odd_held

    # timing at slice G's size, on a copy of its grid: frame 0, slice G's
    # options (colour, 1/z^2 weights)
    depth, rgb, T_cw = case["frames"][0]
    st = [x.clone() for x in case["state"]]
    args = (depth, rgb, T_cw, K[0, 0], K[1, 1], K[0, 2], K[1, 2],
            vol.origin, g["voxel"], g["trunc"], g["min_ray"], g["max_ray"],
            vol.max_weight)
    kw = dict(dims=vol.dims, use_const_weight=False)
    run = lambda: tsdf._tsdf_integrate(*st, *args, **kw)      # noqa: E731
    plain = lambda: tsdf._tsdf_integrate_plain(*st, *args, **kw)  # noqa
    torch.cuda.synchronize()
    mem = []
    for fn in (run, plain):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        mem.append(torch.cuda.max_memory_allocated() - base)
    H, W = depth.shape
    integrate = dict(
        ms=time_cuda(run, 20), device_ms=time_cuda_queued(run, 20),
        ms_after_idle=time_after_idle(run), plain_ms=time_cuda(plain, 3),
        kernels_per_call=tsdf_kernels_per_call(run),
        plain_kernels_per_call=kernel_launches_per_call(plain)[0],
        added_bytes=mem[0], plain_added_bytes=mem[1],
        **roofline.tsdf_integrate_bound(vol.tsdf.numel(), H, W))
    del st
    sweeps = lambda: tsdf._esdf_sweep(d0, g["voxel"], n_sweeps)  # noqa
    sweeps_plain = lambda: tsdf._esdf_sweep_plain(  # noqa: E731
        d0, g["voxel"], n_sweeps)
    sweep = dict(
        ms=time_cuda(sweeps, 5) / n_sweeps,
        device_ms=time_cuda_queued(sweeps, 5) / n_sweeps,
        ms_after_idle=time_after_idle(sweeps) / n_sweeps,
        plain_ms=time_cuda(sweeps_plain, 3) / n_sweeps,
        kernels_per_call=tsdf_kernels_per_call(
            lambda: tsdf._esdf_sweep(d0, g["voxel"], 1)),
        plain_kernels_per_call=kernel_launches_per_call(
            lambda: tsdf._esdf_sweep_plain(d0, g["voxel"], 1))[0],
        sweeps_per_esdf=n_sweeps,
        **roofline.esdf_sweep_bound(vol.tsdf.numel()))
    del d0
    res = dict(outputs_held=held, max_abs_err=errs,
               odd_nan_voxels=odd_nan, odd_sweep_nan_voxels=sweep_nan,
               integrate=integrate, sweep=sweep)
    print("[tsdf] " + json.dumps(res), flush=True)
    print(f"[tsdf] {held} outputs bit-equal to the plain versions; "
          f"integration {integrate['ms']:.4f} ms (device "
          f"{integrate['device_ms']:.4f}, after idling "
          f"{integrate['ms_after_idle']:.4f}, bound "
          f"{integrate['bound_ms']:.4f}, plain {integrate['plain_ms']:.4f}),"
          f" a sweep {sweep['ms']:.4f} "
          f"ms (device {sweep['device_ms']:.4f}, bound "
          f"{sweep['bound_ms']:.4f}, plain {sweep['plain_ms']:.4f})",
          flush=True)
    return res


def tsdf_kernel_rows(g):
    """The kernels line's records of the dense-fusion kernels from slice
    G's figures: launches those of its main path (its 180 integrations and
    its ESDF's sweeps), the rest at its size; ``ms`` of the integration the
    median of slice G's calls, of a sweep its ESDF's sweeps timed together,
    per sweep."""
    tg = g["tsdf"]
    rows = []
    for name, part, launches, ms, replaces in (
            ("tsdf_integrate", "integrate",
             g["tsdf_counts"]["integrate_launches"],
             g["integrate_ms_median"], "ov2slam_tpu/mapping/tsdf.py:33"),
            ("esdf_sweep", "sweep", g["tsdf_counts"]["sweep_launches"],
             tg["sweep"]["ms"], "ov2slam_tpu/mapping/tsdf.py:91")):
        row = tg[part]
        rows.append(dict(
            name=name, route="cuda", source="ov2slam_torch/csrc/tsdf.cu",
            replaces=replaces, launches=launches,
            max_abs_err=tg["max_abs_err"][name], ms=ms,
            device_ms=row["device_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, kernels_per_call=row["kernels_per_call"],
            plain_kernels_per_call=row["plain_kernels_per_call"],
            launches_by_slice={"G": launches}, voxels=g["voxels"],
            isolated_ms=row["ms"]))
    return rows


def lie_np_inverse32(T_wc):
    """``T_wc``'s inverse as the f32 7-vector ``TsdfVolume.integrate``
    hands the integration."""
    import numpy as np

    from ov2slam_torch.utils import lie_np

    return np.asarray(lie_np.pose_inverse(np.asarray(T_wc, np.float64)),
                      np.float32)


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
    reset_tsdf_counts()
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
            first.append((depth, rgb, T_wc))
        if vol.n_integrated == g["n_cams"]:
            n_differ, n_updated, err = slice_g_cpu_agreement(
                vol, [(d.cpu(), c.cpu(), T) for d, c, T in first], dev)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    ms = sorted(s.elapsed_time(e) for s, e in ms)
    peak = torch.cuda.max_memory_allocated()
    counts = tsdf_counts()
    # the slice's host queries, its ESDF's sweeps on the card
    with tempfile.TemporaryDirectory() as tmp:
        figs = slice_g_figures(vol, scene, tmp)
    torch.cuda.synchronize()
    after = tsdf_counts()
    n_sweeps = int(round(g["esdf_max"] / g["voxel"]))
    counts.update(sweep_launches=after["sweep_launches"],
                  sweep_plain_runs_on_cuda=after["sweep_plain_runs_on_cuda"])
    print("[slice G] tsdf kernels " + json.dumps(counts), flush=True)
    if counts["integrate_launches"] != len(poses):
        fail(f"slice G: {counts['integrate_launches']} integration kernel "
             f"launches for {len(poses)} integrations")
    if counts["sweep_launches"] != n_sweeps:
        fail(f"slice G: {counts['sweep_launches']} sweep kernel launches "
             f"for an ESDF of {n_sweeps} sweeps")
    if counts["integrate_plain_runs_on_cuda"] or \
            counts["sweep_plain_runs_on_cuda"]:
        fail(f"slice G: a plain TSDF function ran on the card: {counts}")
    if after["integrate_launches"] != counts["integrate_launches"]:
        fail("slice G: the host queries launched an integration")

    tsdf = phase_tsdf(vol, first, dev)
    del first, depth, rgb
    bound = tsdf["integrate"]["bound_ms"]
    esdf_bound = tsdf["sweep"]["bound_ms"]
    res = dict(
        slice="G", voxels=V, dims=list(g["dims"]), state_bytes=state_bytes,
        integrations=vol.n_integrated, boxes=len(scene["box_lo"]),
        render_and_fuse_s=loop_s, integrate_ms_median=ms[len(ms) // 2],
        integrate_ms_min=ms[0], integrate_ms_max=ms[-1],
        integrate_kernels=tsdf["integrate"]["kernels_per_call"],
        integrate_bound_ms=bound,
        esdf_sweep_ms=tsdf["sweep"]["ms"],
        esdf_sweep_kernels=tsdf["sweep"]["kernels_per_call"],
        esdf_sweep_bound_ms=esdf_bound, esdf_sweeps=n_sweeps,
        max_memory_allocated=peak, tsdf_counts=counts,
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
          f"{res['esdf_sweep_ms']:.4f} ms per sweep (bound "
          f"{esdf_bound:.4f} ms), peak "
          f"device memory {peak} B, mesh {figs['mesh_host_s']:.2f} s on the "
          f"host | JAX package (reference_runs.py G, CPU): "
          f"{j['surface_points']} surface points (max "
          f"{j['surface_max_err_voxels']:.4f} voxels), {j['mesh_faces']} "
          f"faces (max {j['mesh_max_err_voxels']:.4f} voxels), "
          f"{j['occupied_voxels']} occupied; port: "
          f"{figs['surface_points']} ({figs['surface_max_err_voxels']:.4f})"
          f", {figs['mesh_faces']} ({figs['mesh_max_err_voxels']:.4f}), "
          f"{figs['occupied_voxels']}", flush=True)
    res["tsdf"] = tsdf
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
        reset_pose_counts()
        reset_image_counts()
        reset_graph_counts()
        t0 = time.perf_counter()
        report, slam = run_slam.main(argv + ["--device", str(dev)])
        run_s = time.perf_counter() - t0
        klt = klt_counts()
        pose = pose_counts()
        image = image_counts()
        graph = graph_counts()
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
               worker_errors=getattr(slam, "n_worker_errors", None),
               **klt, **pose, **image, use_clahe=slam.cfg.use_clahe,
               use_scharr=uses_scharr(slam.cfg),
               **graph, inverse_depth=slam.cfg.use_inv_depth)
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
    gate_pose_launches(f"H {part}", r)
    gate_image_launches(f"H {part}", r, r["use_clahe"], r["use_scharr"],
                        r["stereo"])
    gate_graphs(f"H {part}", r, r["inverse_depth"], r["stereo"])
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
    """The test fixtures as calls on the card: the pair (klt and fb, and
    fb at two other windows and margins), the flat block (fb) and the
    split-overflow case at n_sub 8 and 64."""
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
    # other windows and margins: win 7 takes the kernel's instantiation
    # for 3 window pixels a lane, win 11 the one for 8
    for win, margin in ((7, 5), (11, 7)):
        out.append(KltSet(f"fixture pair, fb_klt_track, win {win}, margin "
                          f"{margin}", "fb", pp, pc, t(kps), t(kps), t(ok),
                          win=win, margin=margin))
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
    """One LK step's latency and one level's setup on the card: one
    keypoint of ``entry()``'s noise images that takes every step without
    converging, tracked at the base level with ``iters`` 0, 1 and 30, each
    launch's device time from ``runs`` launches queued behind a sleep. The
    step is the difference of iters 30 and 1 over 29 steps; the setup
    (what a level that steps adds before its first step: the correlation
    tables) is iters 1 against 0, less one step. Returns ns and SM cycles
    (at ``SM_CLOCK_HZ``) of each."""
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
    for it in (0, 1, 30):
        klt.launch(pp, pc, one, one, v1, 0, iters=it, steps=st1)
        if int(st1.item()) != it:
            fail(f"klt step latency: {int(st1.item())} steps of {it}")
        t[it] = time_cuda_queued(
            lambda: klt.launch(pp, pc, one, one, v1, 0, iters=it), runs)
    ns = 1e6 * (t[30] - t[1]) / 29
    setup_ns = 1e6 * (t[1] - t[0]) - ns
    return dict(launch_ms_iters0=t[0], launch_ms_iters1=t[1],
                launch_ms_iters30=t[30], step_ns=ns,
                step_cycles=ns * 1e-9 * SM_CLOCK_HZ, setup_ns=setup_ns,
                setup_cycles=setup_ns * 1e-9 * SM_CLOCK_HZ,
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
          f"roofline.KLT_CHAIN_CYCLES {KLT_CHAIN_CYCLES}); one level's "
          f"setup: {lat['setup_ns']:.1f} ns ({lat['setup_cycles']:.0f} "
          f"cycles; roofline.KLT_SETUP_CYCLES {KLT_SETUP_CYCLES}); launch "
          f"{lat['launch_ms_iters0']:.5f} ms at iters 0, "
          f"{lat['launch_ms_iters1']:.5f} ms at iters 1, "
          f"{lat['launch_ms_iters30']:.5f} ms at iters 30; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows, err, lat


# ---------------------------------------------------------------------- #
# phase pose: the RANSAC and PnP kernels against their plain versions
# ---------------------------------------------------------------------- #

POSE_CAND_REL = 1e-3      # candidates per slot, relative, up to sign
POSE_CONDITIONED = 1e-5   # ... on slots the plain f32 keeps to this of f64
POSE_EPI = 1e-5           # a 5-point candidate on its rows (unit-norm E)
POSE_ESS = 1e-3           # an 8-point candidate's essential residual
POSE_SHARE_SLACK = 0.02   # slots within POSE_CAND_REL of f64: the kernel's
POSE_MEDIAN_RATIO = 2.0   # share and median error against the plain's
POSE_TH_BAND = 1e-4       # mask rows may differ this near the threshold
PNP_POSE_TOL = 1e-4       # T_out per component
PNP_GATE_BAND = 1e-4      # mask rows may differ this near the chi2 gate
POSE_FRAME = 40           # slice B's front-end call held and timed
GRAPH_CALL = 10           # slice B's graph steps' call replayed
PREWARM_STEPS = 2         # the pre-warm check's capacity above slice B's


def pose_ransac_case(seed: int = 0, n: int = 120, n_iters: int = 40):
    """test_torch_geometry.py's RANSAC scene, built with numpy: ``n``
    points seen from two views (the right one rotated by (0.05, -0.1,
    0.03) rad and moved (0.3, 0.05, -0.1)), 1e-3 of noise on the right
    view, 20 outliers, the last 8 rows invalid, samples drawn with
    replacement from the valid rows (some repeat a row). Numpy arrays and
    numbers: xl, xr, valid, idx5, idx8, focal, err."""
    import numpy as np

    from ov2slam_torch.utils import lie_np

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 12], size=(n, 3))
    T_lr = np.concatenate([lie_np.so3_exp(np.array([0.05, -0.1, 0.03])),
                           [0.3, 0.05, -0.1]])
    M_rl = lie_np.pose_to_matrix(lie_np.pose_inverse(T_lr))
    pts_r = (M_rl[:3, :3] @ pts.T).T + M_rl[:3, 3]
    xl = pts[:, :2] / pts[:, 2:]
    xr = pts_r[:, :2] / pts_r[:, 2:] + rng.normal(0, 1e-3, (n, 2))
    xr[:20] += rng.normal(0, 0.05, (20, 2))
    valid = np.ones(n, bool)
    valid[-8:] = False
    rows = np.nonzero(valid)[0]
    idx5 = rng.choice(rows, (n_iters, 5))
    idx8 = rng.choice(rows, (max(n_iters // 4, 4), 8))
    return (xl.astype(np.float32), xr.astype(np.float32), valid, idx5,
            idx8, 450.0, 3.0)


def pose_pnp_case(seed: int = 0, n: int = 80):
    """test_torch_geometry.py's PnP scene, built with numpy: ``n`` points
    3-9 m ahead, pixels at f = 400 with 0.5 px of noise and 6 outliers 30
    px off, the last 4 rows invalid, the start 0.01-0.03 off the true pose.
    Numpy arrays and the intrinsics: T0, pts, px, valid, (fx, fy, cx,
    cy)."""
    import numpy as np

    from ov2slam_torch.utils import lie_np

    rng = np.random.default_rng(seed)
    R = lie_np.so3_exp(np.array([0.05, 0.1, -0.02]))
    T_wc = np.concatenate([R, [0.2, 0.1, -0.3]])
    pts = rng.uniform([-2, -2, 3], [2, 2, 9], size=(n, 3))
    pc = lie_np.pose_apply(lie_np.pose_inverse(T_wc), pts)
    px = (np.stack([pc[:, 0] / pc[:, 2], pc[:, 1] / pc[:, 2]], -1) * 400.0
          + 300.0 + rng.normal(0, 0.5, (n, 2)))
    px[:6] += 30.0
    step = lie_np.make_pose(lie_np.so3_exp(np.array([0.01, 0.0, -0.01])),
                            np.array([0.02, -0.01, 0.03]))
    T0 = lie_np.pose_compose(step, T_wc)
    valid = np.ones(n, bool)
    valid[-4:] = False
    return (T0.astype(np.float32), pts.astype(np.float32),
            px.astype(np.float32), valid, (400.0, 400.0, 300.0, 300.0))


class PoseSet:
    """One pose-kernel call of the phase: ``kind`` "ransac"
    (``essential_ransac`` on given samples) or "pnp" (``pnp_refine``),
    its inputs on the card."""

    def __init__(self, label, kind, args, kw=None):
        self.label, self.kind, self.args = label, kind, args
        self.kw = kw or {}

    @classmethod
    def ransac(cls, label, xl, xr, valid, idx5, idx8, focal, err):
        return cls(label, "ransac", (xl, xr, valid, idx5, idx8, focal, err))

    @classmethod
    def pnp(cls, label, T, pts, px, valid, fx, fy, cx, cy,
            robust_th=5.9915, iters=10):
        return cls(label, "pnp", (T, pts, px, valid, fx, fy, cx, cy),
                   dict(robust_th=robust_th, iters=iters))

    @property
    def rows(self) -> int:
        return int(self.args[0 if self.kind == "ransac" else 1].shape[0])

    def call(self, plain: bool = False):
        """The main path's call: the wrapper (the kernel), or the plain
        version on the card."""
        from ov2slam_torch.geometry import essential
        from ov2slam_torch.solvers import pnp_refine

        if self.kind == "ransac":
            xl, xr, v, i5, i8, focal, err = self.args
            fn = (essential.essential_ransac_plain if plain
                  else essential.essential_ransac)
            return fn(None, xl, xr, v, focal, err, i5.shape[0], idx5=i5,
                      idx8=i8)
        fn = pnp_refine.pnp_refine_plain if plain else pnp_refine.pnp_refine
        return fn(*self.args, **self.kw)

    def run(self, plain: bool = False, dtype=None):
        """RANSAC: (E, inlier, n, candidates, quality), from the kernel's
        launch or the plain version's pieces (in ``dtype``: f64 for the
        reference); PnP: (T, inlier, cost)."""
        import torch

        from ov2slam_torch.geometry import essential

        if self.kind == "pnp":
            return self.call(plain)
        xl, xr, v, i5, i8, focal, err = self.args
        if not plain:
            return essential.launch(xl, xr, v, i5, i8, focal, err)
        if dtype is not None:
            xl, xr = xl.to(dtype), xr.to(dtype)
            if isinstance(focal, torch.Tensor):
                focal = focal.to(dtype)
        th = (err / focal) ** 2
        E, q, inl = essential.ransac_candidates_plain(xl, xr, v, i5, i8, th)
        best = torch.argmax(q).reshape(1)
        return E[best][0], inl[best][0], inl[best][0].sum(), E, q


def _bits_equal(a, b) -> bool:
    import torch

    if a.dtype in (torch.float32, torch.float64):
        a, b = a.view(torch.int32 if a.dtype == torch.float32
                      else torch.int64), b.view(
            torch.int32 if b.dtype == torch.float32 else torch.int64)
    return bool(torch.equal(a, b))


def _slot_err(a, b):
    """Relative difference of two 9-vectors up to sign."""
    import numpy as np

    return float(min(np.abs(a - b).max(), np.abs(a + b).max())
                 / max(np.abs(b).max(), 1e-30))


def _unit(e):
    import numpy as np

    e = e.astype(np.float64).reshape(3, 3)
    return e / np.linalg.norm(e)


def ransac_candidate_figures(cand, plain, ref, idx5, idx8, xl, xr):
    """The kernel's candidates (``cand``) against the plain version's in
    f32 (``plain``) and f64 (``ref``), numpy (C, 9) each with non-finite
    rows as NaN or zero, slot by slot (a candidate is compared with the
    one in its own slot only), over the samples of distinct rows (one that
    repeats a row has no unique null space); ``xl``, ``xr`` the rows in
    f64. The f32 5-point loses its digits on close or near-tangent roots,
    and there the plain version is as far from f64 as the kernel, so the
    figures hold the kernel four ways, each gated by :func:`ransac_check`:
    on the slots the plain version keeps to POSE_CONDITIONED of f64, the
    kernel's error to f64 (at most POSE_CAND_REL); on every finite 5-point
    slot, the kernel candidate's epipolar residual on its sample's five
    rows (a wrong null space shows there; at most POSE_EPI); on every
    finite 8-point slot, how far the kernel's candidate is from an
    essential matrix (‖2EEᵀE − tr(EEᵀ)E‖ for unit ‖E‖, at most POSE_ESS);
    and over every slot where all three are finite, the share within
    POSE_CAND_REL of f64 and the median error to f64, beside the plain
    version's (a root search that goes wrong more often than f32's
    rounding moves them)."""
    import numpy as np

    def finite(x):
        return bool(np.isfinite(x).all() and np.abs(x).max() > 0)

    groups = [([10 * s + k for k in range(10)], idx5[s])
              for s in range(len(idx5))]
    groups += [([10 * len(idx5) + s], idx8[s]) for s in range(len(idx8))]
    res = dict(slots=0, kernel_finite=0, plain_finite=0, ref_finite=0,
               conditioned=0, max_err_conditioned=0.0, max_epi_5pt=0.0,
               max_ess_8pt=0.0, repeated_row_samples=0)
    ek, ep = [], []
    for slots, rows in groups:
        rows = np.asarray(rows)
        if len(set(rows.tolist())) < len(rows):
            res["repeated_row_samples"] += 1
            continue
        for i in slots:
            fk, fp, fr = finite(cand[i]), finite(plain[i]), finite(ref[i])
            res["kernel_finite"] += fk
            res["plain_finite"] += fp
            res["ref_finite"] += fr
            if fk and len(rows) == 5:
                E = _unit(cand[i])
                hl = np.c_[xl[rows], np.ones(5)]
                hr = np.c_[xr[rows], np.ones(5)]
                res["max_epi_5pt"] = max(res["max_epi_5pt"], float(np.abs(
                    np.einsum("ni,ij,nj->n", hl, E, hr)).max()))
            elif fk:
                E = _unit(cand[i])
                res["max_ess_8pt"] = max(res["max_ess_8pt"], float(
                    np.linalg.norm(2 * E @ E.T @ E - np.trace(E @ E.T) * E)))
            if fk and fp and fr:
                ek.append(_slot_err(cand[i], ref[i]))
                ep.append(_slot_err(plain[i], ref[i]))
                if ep[-1] <= POSE_CONDITIONED:
                    res["conditioned"] += 1
                    res["max_err_conditioned"] = max(
                        res["max_err_conditioned"], ek[-1])
    ek, ep = np.asarray(ek), np.asarray(ep)
    res.update(slots=len(ek),
               share_within_kernel=float(np.mean(ek <= POSE_CAND_REL)),
               share_within_plain=float(np.mean(ep <= POSE_CAND_REL)),
               median_err_kernel=float(np.median(ek)),
               median_err_plain=float(np.median(ep)),
               max_err_kernel=float(ek.max()), max_err_plain=float(ep.max()))
    return res


def ransac_check(s):
    """The RANSAC kernel against the plain version on ``s``'s inputs on the
    card: two launches bit-equal; candidates per slot (see
    :func:`ransac_candidate_figures`); the chosen inlier mask equal except
    on rows whose squared Sampson distance under either chosen E lies
    within POSE_TH_BAND x th of th, and n_inliers within that count.
    Returns the agreement figures."""
    import numpy as np
    import torch

    from ov2slam_torch.geometry import essential

    got, again = s.run(), s.run()
    torch.cuda.synchronize()
    if not all(_bits_equal(x, y) for x, y in zip(got, again)):
        fail(f"essential_ransac {s.label}: two launches differ")
    want = s.run(plain=True)
    ref = s.run(plain=True, dtype=torch.float64)
    xl, xr, v, i5, i8, focal, err = s.args
    th = float((err / focal) ** 2)
    E, inl, n, cand, q = got
    pE, pinl, pn, pcand, pq = want
    if not (torch.isfinite(E).all() and E.shape == (3, 3)
            and inl.shape == (s.rows,)):
        fail(f"essential_ransac {s.label}: E not finite or misshapen")
    figs = ransac_candidate_figures(
        cand.reshape(-1, 9).cpu().numpy(),
        pcand.reshape(-1, 9).cpu().numpy(),
        ref[3].reshape(-1, 9).cpu().numpy(), i5.cpu().numpy(),
        i8.cpu().numpy(), xl.double().cpu().numpy(),
        xr.double().cpu().numpy())
    d2 = torch.stack([essential.sampson_dist_sq(e, xl, xr) for e in (E, pE)])
    band = ((d2 - th).abs() <= POSE_TH_BAND * th).any(0)
    differ = inl != pinl
    res = dict(label=s.label, rows=s.rows, samples=[int(i5.shape[0]),
                                                     int(i8.shape[0])],
               candidates=int(cand.shape[0]), winner=int(q.argmax()),
               winner_plain=int(pq.argmax()), n_inliers=int(n),
               n_inliers_plain=int(pn), rows_differ=int(differ.sum()),
               rows_in_band=int(band.sum()),
               rows_differ_outside_band=int((differ & ~band).sum()),
               max_quality_diff=float(
                   (q - pq).abs()[(q >= 0) & (pq >= 0)].max())
               if bool(((q >= 0) & (pq >= 0)).any()) else 0.0,
               **{f"cand_{k}": val for k, val in figs.items()})
    if (res["rows_differ_outside_band"] or abs(int(n) - int(pn))
            > res["rows_in_band"]
            or figs["max_err_conditioned"] > POSE_CAND_REL
            or figs["conditioned"] == 0 or figs["slots"] == 0
            or figs["max_epi_5pt"] > POSE_EPI
            or figs["max_ess_8pt"] > POSE_ESS
            or figs["share_within_kernel"]
            < figs["share_within_plain"] - POSE_SHARE_SLACK
            or figs["median_err_kernel"]
            > POSE_MEDIAN_RATIO * figs["median_err_plain"] + 1e-6):
        fail(f"essential_ransac {s.label}: kernel and plain disagree: {res}")
    return res


def pnp_check(s):
    """The PnP kernel against the plain version on ``s``'s inputs on the
    card: two launches bit-equal, T_out within PNP_POSE_TOL per component,
    the inlier mask equal except on rows whose chi2 under either final
    pose lies within PNP_GATE_BAND x the gate of the gate. Returns the
    agreement figures."""
    import torch

    from ov2slam_torch.solvers import pnp_refine
    from ov2slam_torch.utils import lie

    got, again = s.run(), s.run()
    torch.cuda.synchronize()
    if not all(_bits_equal(x, y) for x, y in zip(got, again)):
        fail(f"pnp_refine {s.label}: two launches differ")
    want = s.run(plain=True)
    T, inl, c = got
    pT, pinl, pc = want
    if not (torch.isfinite(T).all() and T.shape == (7,)
            and inl.shape == (s.rows,)):
        fail(f"pnp_refine {s.label}: pose not finite or misshapen")
    _, pts, px, v, fx, fy, cx, cy = s.args
    rob = s.kw["robust_th"]
    gate = rob if rob > 0 else 5.9915
    chi2 = []
    for Tw in (T, pT):
        r, _, _ = pnp_refine._pose_residuals(lie.pose_inverse(Tw), pts, px,
                                             fx, fy, cx, cy)
        chi2.append(torch.sum(r * r, -1))
    band = ((torch.stack(chi2) - gate).abs() <= PNP_GATE_BAND * gate).any(0)
    differ = inl != pinl
    err = float((T - pT).abs().max())
    res = dict(label=s.label, rows=s.rows, iters=s.kw["iters"],
               robust_th=rob, max_pose_err=err, inliers=int(inl.sum()),
               inliers_plain=int(pinl.sum()), rows_differ=int(differ.sum()),
               rows_in_band=int(band.sum()),
               rows_differ_outside_band=int((differ & ~band).sum()),
               cost=float(c), cost_plain=float(pc))
    if err > PNP_POSE_TOL or res["rows_differ_outside_band"]:
        fail(f"pnp_refine {s.label}: kernel and plain disagree: {res}")
    return res


def reset_pose_counts() -> None:
    """Zero the pose kernels' launch counters and the plain versions'
    calls on CUDA tensors."""
    from ov2slam_torch.geometry import essential
    from ov2slam_torch.solvers import pnp_refine

    for fn in (essential.essential_ransac, pnp_refine.pnp_refine):
        fn.launches = 0
        fn.shapes.clear()
    essential.essential_ransac_plain.cuda_runs = 0
    pnp_refine.pnp_refine_plain.cuda_runs = 0


def pose_counts():
    """The counters :func:`reset_pose_counts` zeroes, as JSON-ready
    values: calls of each kernel (a RANSAC call is
    ``essential.KERNELS_PER_LAUNCH`` launches), [N, 5-point samples,
    8-point samples, count] and [N, iters, robust, count] per shape, and
    the plain versions' calls on CUDA tensors."""
    from ov2slam_torch.geometry import essential
    from ov2slam_torch.solvers import pnp_refine

    er, pr = essential.essential_ransac, pnp_refine.pnp_refine
    return dict(
        ransac_launches=er.launches,
        ransac_shapes=[[*k, v] for k, v in sorted(er.shapes.items())],
        pnp_launches=pr.launches,
        pnp_shapes=[[k[0], k[1], int(k[2]), v]
                    for k, v in sorted(pr.shapes.items())],
        pose_plain_runs_on_cuda=(essential.essential_ransac_plain.cuda_runs
                                 + pnp_refine.pnp_refine_plain.cuda_runs))


def graph_steps():
    """(key, counters) of every step the main path replays as CUDA graphs:
    local BA (``GraphedTwoPass``'s counters, packed solves included),
    keyframe detection, and every mapper's stereo mapping and temporal
    triangulation."""
    from ov2slam_torch.models import frontend_step, mapper_step
    from ov2slam_torch.solvers import ba_invdepth

    return (("ba_graph", ba_invdepth.GraphedTwoPass),
            ("detect_graph", frontend_step.detect_describe.counts),
            ("stereo_graph", mapper_step.stereo_step_counts),
            ("temporal_graph", mapper_step.temporal_step_counts))


def ba_kernel_fns():
    """Local BA's hand-kernel wrappers by kernel (``csrc/ba_normal_eq.cu``:
    the normal equations and the cost mode; ``csrc/ba_schur_step.cu``) and
    their plain versions."""
    from ov2slam_torch.solvers import ba_invdepth as bi

    return bi.KERNEL_WRAPPERS, bi.PLAIN_VERSIONS


def reset_graph_counts() -> None:
    """Zero the CUDA-graph steps' call counters, local BA's pre-warm
    counts, and its hand kernels' launch counters and plain versions'
    calls on CUDA tensors."""
    from ov2slam_torch.models.estimator import Estimator

    for _, g in graph_steps():
        g.eager = g.captures = g.replays = 0
    Estimator.prewarms = Estimator.prewarm_failures = 0
    wrappers, plain = ba_kernel_fns()
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0
            fn.shapes.clear()
            fn.origins.clear()
    for fn in plain:
        fn.cuda_runs = 0


def graph_counts():
    """The counters :func:`reset_graph_counts` zeroes: each step's calls
    that ran eagerly (a shape's first), captured (its second; it then
    replays) and replayed, and local BA's pre-warms (each builds the
    graphs of the next landmark capacity) and failed pre-warms."""
    from ov2slam_torch.models.estimator import Estimator

    out = {}
    for key, g in graph_steps():
        out.update({f"{key}_eager": g.eager, f"{key}_captures": g.captures,
                    f"{key}_replays": g.replays})
    out.update(ba_prewarms=Estimator.prewarms,
               ba_prewarm_failures=Estimator.prewarm_failures)
    wrappers, plain = ba_kernel_fns()
    for name, fns in wrappers.items():
        out[f"{name}_launches"] = sum(fn.launches for fn in fns)
    out["ba_plain_runs_on_cuda"] = sum(fn.cuda_runs for fn in plain)
    return out


def gate_graphs(name: str, counts, inverse_depth: bool,
                stereo: bool) -> None:
    """A SLAM slice detects its keyframes, solves its inverse-depth local
    BA windows and (stereo) maps its keyframes through their CUDA graphs:
    each replays at least once (a shape's first call runs eagerly, its
    second captures). Temporal triangulation runs only on keyframes with
    candidates: it must replay once it ran twice. No pre-warm failed."""
    if counts["detect_graph_replays"] < 1:
        fail(f"slice {name}: keyframe detection never replayed its graph "
             f"({counts})")
    if inverse_depth and counts["ba_graph_replays"] < 1:
        fail(f"slice {name}: local BA never replayed its graphs "
             f"({counts})")
    if stereo and counts["stereo_graph_replays"] < 1:
        fail(f"slice {name}: stereo mapping never replayed its graph "
             f"({counts})")
    for key in ("stereo_graph", "temporal_graph"):
        calls = sum(counts[f"{key}_{k}"] for k in ("eager", "replays"))
        if calls >= 2 and counts[f"{key}_replays"] < 1:
            fail(f"slice {name}: {key} ran {calls} times and never "
                 f"replayed ({counts})")
    if counts["ba_prewarm_failures"] != 0:
        fail(f"slice {name}: {counts['ba_prewarm_failures']} local BA "
             f"pre-warms failed")
    gate_ba_launches(name, counts, inverse_depth)


def gate_ba_launches(name: str, counts, inverse_depth: bool) -> None:
    """A run with inverse-depth local BA solves its windows through both
    hand kernels; no run calls their plain versions on the card."""
    if inverse_depth:
        for key in ("ba_normal_eq", "ba_schur_step"):
            if counts[f"{key}_launches"] < 1:
                fail(f"slice {name}: the {key} kernel never launched "
                     f"({counts})")
    if counts["ba_plain_runs_on_cuda"] != 0:
        fail(f"slice {name}: local BA's plain versions ran "
             f"{counts['ba_plain_runs_on_cuda']} times on cuda")


def gate_pose_launches(name: str, counts) -> None:
    """Every SLAM slice's front end gates its tracks by the RANSAC kernel
    and refines its pose by the PnP kernel, and never runs a plain pose
    function on the card."""
    for key, what in (("ransac_launches", "essential_ransac"),
                      ("pnp_launches", "pnp_refine")):
        if counts[key] < 1:
            fail(f"slice {name}: the {what} kernel never launched")
    if counts["pose_plain_runs_on_cuda"] != 0:
        fail(f"slice {name}: the plain pose functions ran "
             f"{counts['pose_plain_runs_on_cuda']} times on cuda")


def pose_sites():
    """Every binding of a pose wrapper (``essential_ransac``,
    ``pnp_refine``) that a caller in the port looks up when it calls it:
    (module, name) pairs."""
    from ov2slam_torch.geometry import essential
    from ov2slam_torch.loopclosure import closer
    from ov2slam_torch.models import frontend, frontend_step, relocalizer
    from ov2slam_torch.solvers import pnp_refine

    return [(frontend_step, "essential_ransac"),
            (frontend_step, "pnp_refine"), (frontend, "pnp_refine"),
            (closer, "essential_ransac"), (closer, "pnp_refine"),
            (relocalizer, "pnp_refine"),
            # relative_pose_ransac's (mono initialisation) and
            # pnp_refine_two_pass's
            (essential, "essential_ransac"), (pnp_refine, "pnp_refine")]


class Swap:
    """Within ``with``, each (module, name) of ``sites`` holds
    ``make(module, name, orig)`` in place of ``orig``; the originals come
    back on exit. ``Swap.plain_pose()`` puts the pose functions' plain
    versions at every site of :func:`pose_sites`."""

    def __init__(self, sites, make):
        self.sites, self.make = sites, make
        self._saved = []

    @classmethod
    def plain_pose(cls):
        from ov2slam_torch.geometry import essential
        from ov2slam_torch.solvers import pnp_refine

        fns = dict(essential_ransac=essential.essential_ransac_plain,
                   pnp_refine=pnp_refine.pnp_refine_plain)
        return cls(pose_sites(), lambda m, name, orig: fns[name])

    @classmethod
    def plain_ba(cls, all_rows: bool = False):
        """Local BA's kernel wrappers replaced by their plain versions
        (``solvers/ba_invdepth.py``: ``_lm_step`` looks them up there);
        with ``all_rows``, the solve's bins also keep the rows that are
        not valid, as they did before the kernels (the step's arithmetic
        of then)."""
        from ov2slam_torch.solvers import ba_invdepth as bi

        def make(m, name, orig):
            if name == "_bins":
                return lambda *a, drop=None: orig(*a)
            return getattr(bi, name + "_plain")

        return cls([(bi, n) for n in ("normal_equations", "schur_step",
                                      "lm_accept")
                    + (("_bins",) if all_rows else ())], make)

    def __enter__(self):
        for module, name in self.sites:
            orig = getattr(module, name)
            self._saved.append((module, name, orig))
            setattr(module, name, self.make(module, name, orig))
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self._saved.clear()


class PoseCapture:
    """Within ``with``, records the inputs of the front end's
    ``POSE_FRAME``-th call of each pose function (``models.frontend_step``)
    and of the loop closer's first (``loopclosure.closer``), as
    :class:`PoseSet`s built later on the card. RANSAC samples are drawn
    here as the wrapper would draw them and passed on, so the run is the
    one it would have been."""

    def __init__(self, frame: int = POSE_FRAME):
        self.frame = frame
        self.calls = {}
        self.inputs = {}

    @staticmethod
    def _keep(x):
        import torch

        return x.detach().clone() if isinstance(x, torch.Tensor) else x

    def _wrap(self, module, name, orig):
        from ov2slam_torch.geometry import essential

        where = ("front end" if module.__name__.endswith("frontend_step")
                 else "loop closure")
        nth = self.frame if where == "front end" else 1

        def record(key, args, kw):
            n = self.calls[key] = self.calls.get(key, 0) + 1
            if n == nth:
                self.inputs[key] = ([self._keep(a) for a in args],
                                    {k: self._keep(v) for k, v in
                                     kw.items()})

        if name == "essential_ransac":
            def wrapped(gen, x_l, x_r, valid_mask, focal, err_th_px,
                        n_iters=100, idx5=None, idx8=None):
                idx5, idx8 = essential.ransac_samples(gen, valid_mask,
                                                      n_iters, idx5, idx8)
                record((where, name), (x_l, x_r, valid_mask, idx5, idx8,
                                       focal, err_th_px), {})
                return orig(gen, x_l, x_r, valid_mask, focal, err_th_px,
                            n_iters, idx5=idx5, idx8=idx8)
        else:
            def wrapped(*args, **kw):
                record((where, name), args, kw)
                return orig(*args, **kw)
        return wrapped

    def __enter__(self):
        self._swap = Swap([(m, n) for m, n in pose_sites()
                               if m.__name__.endswith(("frontend_step",
                                                       "closer"))],
                              self._wrap)
        self._swap.__enter__()
        return self

    def __exit__(self, *exc):
        self._swap.__exit__(*exc)

    def sets(self, what: str):
        """The recorded calls as PoseSets, labelled with ``what``."""
        out = []
        for (where, name), (args, kw) in sorted(self.inputs.items()):
            n = where if where != "front end" else \
                f"front end, call {self.frame}"
            label = f"{what} {n}"
            if name == "essential_ransac":
                out.append(PoseSet.ransac(label, *args))
            else:
                out.append(PoseSet.pnp(label, *args, **kw))
        return out


class GraphCapture:
    """Within ``with``, records the inputs of the run's ``GRAPH_CALL``-th
    call (or its last, where it made fewer) of each step the main path
    replays as CUDA graphs: the local BA solve (``Estimator.solve_packed``,
    with its estimator), keyframe detection (``models.frontend``), stereo
    mapping and temporal triangulation (the steps each mapper makes,
    ``models.mapper.map_steps``), for :func:`phase_graphs`. Only the
    ``GRAPH_CALL``-th call's tensors are copied; an earlier call's are
    kept by reference (they stand for a step that made fewer)."""

    def __init__(self, nth: int = GRAPH_CALL):
        self.nth = nth
        self.calls = {}
        self.inputs = {}

    def _recording(self, name, fn):
        import torch

        def wrapped(*args, **kw):
            n = self.calls[name] = self.calls.get(name, 0) + 1
            if n <= self.nth:
                self.inputs[name] = (
                    [a.detach().clone() if n == self.nth
                     and isinstance(a, torch.Tensor) else a for a in args],
                    {k: v for k, v in kw.items() if k != "between_iters"})
            return fn(*args, **kw)
        return wrapped

    def _wrap(self, module, name, orig):
        if name != "map_steps":
            return self._recording(name, orig)

        def map_steps():
            labels = ("stereo_map_step", "temporal_step")
            return tuple(self._recording(label, step)
                         for label, step in zip(labels, orig()))
        return map_steps

    def __enter__(self):
        from ov2slam_torch.models import estimator, frontend, mapper

        self._swap = Swap([(estimator.Estimator, "solve_packed"),
                           (frontend, "detect_describe"),
                           (mapper, "map_steps")], self._wrap)
        self._swap.__enter__()
        return self

    def __exit__(self, *exc):
        self._swap.__exit__(*exc)


def host_device_ms(fn, runs: int):
    """Medians over ``runs`` calls of ``fn``, each after a synchronize: ms
    until the call returns to the host, and ms between CUDA events around
    it (the call's device work, or its host work where that is longer)."""
    import numpy as np
    import torch

    host, dev = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        e.record()
        torch.cuda.synchronize()
        dev.append(s.elapsed_time(e))
    return float(np.median(host)), float(np.median(dev))


def ba_hand_kernels(fn):
    """Local BA's hand kernels one call of ``fn`` starts, by library, from
    the wrappers' counters (launches times the kernels a launch starts);
    the trace may hold only some of their device events (PERF.md)."""
    from ov2slam_torch.solvers import ba_invdepth as bi

    wrappers, _ = ba_kernel_fns()
    n0 = {k: sum(f.launches for f in fns) for k, fns in wrappers.items()}
    fn()
    return {k: (sum(f.launches for f in fns) - n0[k])
            * bi.KERNELS_PER_LAUNCH[k] for k, fns in wrappers.items()}


def phase_graphs(dev, captured):
    """Slice B's ``GRAPH_CALL``-th local BA solve (unpacked and packed),
    keyframe detection, stereo mapping and temporal triangulation,
    recorded by :class:`GraphCapture`, each through a fresh graph step
    three times: eagerly (a shape's first call), captured and replayed,
    replayed. Both replays must equal the eager call bit for bit, and the
    packed solve the unpacked one. Times (:func:`host_device_ms`) of the
    eager step (the same inputs, padded as the graph pads them) and of a
    replay, and the step's CUDA kernels a call and their summed device
    time (torch.profiler, eagerly: a replay runs the same kernels; the
    stereo step's count adds its KLT launch, which the trace may not
    hold). Then the pre-warm check (:func:`prewarm_check`). Returns the
    rows."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree

    from ov2slam_torch.graphs import GraphedStep
    from ov2slam_torch.models import frontend_step, mapper_step
    from ov2slam_torch.solvers import ba_invdepth as bi

    t0 = time.perf_counter()
    missing = {"solve_packed", "detect_describe", "stereo_map_step",
               "temporal_step"} - set(captured.inputs)
    if missing:
        fail(f"graphs: slice B made no call of {sorted(missing)}")
    (est, prob, rho, ray, valid), _ = captured.inputs["solve_packed"]
    kw = est._solve_kw()
    iters = (kw["iters_robust"], kw["iters_l2"])
    Kw, Lw, O = len(prob.kf_poses), len(rho), len(prob.obs_kf)
    cap = bi.landmark_capacity(Lw, O)
    flat = torch.as_tensor(bi.pack_ba_invdepth(prob, rho, ray, valid),
                           device=dev)
    prm = est.params
    args = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (prob.kf_poses, prob.kf_fixed, rho,
                           prob.lm_anchor, ray, prob.obs_kf, prob.obs_lm,
                           prob.obs_px, prob.obs_cam, valid))
    run = bi.GraphedTwoPass(args, prm, kw["robust_th"], *iters)
    runners = {}         # the packed solve's own: eager, captured, replayed

    def packed(cache):
        return bi.ba_invdepth_packed(flat, prm, Kw, Lw, O, runners=cache,
                                     **kw)
    d_args, d_kw = captured.inputs["detect_describe"]
    step = GraphedStep(frontend_step.fused_detect_describe)
    s_args, s_kw = captured.inputs["stereo_map_step"]
    stereo = GraphedStep(mapper_step._stereo_graph_fn)
    t_args, t_kw = captured.inputs["temporal_step"]
    temporal = GraphedStep(mapper_step.fused_temporal_step)
    ba_shape = dict(keyframes=Kw, landmarks=Lw, landmark_capacity=cap,
                    observations=int(valid.sum()), iterations=sum(iters))
    cases = (
        ("local BA", lambda: run(args), lambda: bi._two_pass(
            run.inputs, prm, kw["robust_th"], *iters, None), ba_shape),
        ("packed local BA", lambda: packed(runners),
         lambda: packed({}), dict(ba_shape, floats=flat.numel())),
        ("keyframe detection", lambda: step(*d_args, **d_kw),
         lambda: frontend_step.fused_detect_describe(*d_args, **d_kw),
         dict(image=list(d_args[0].shape), detector=d_kw["detector"],
              max_out=d_kw["max_out"])),
        ("stereo mapping", lambda: stereo(*s_args, **s_kw),
         lambda: mapper_step._stereo_graph_fn(*s_args, **s_kw),
         dict(image=list(s_args[0].shape), levels=len(s_args) - 2,
              keypoints=int(s_args[-1].shape[0] - 1),
              rectified=bool(s_kw["rectified"]))),
        ("temporal triangulation", lambda: temporal(*t_args, **t_kw),
         lambda: mapper_step.fused_temporal_step(*t_args, **t_kw),
         dict(rows=int(t_args[0].shape[0]),
              candidates=int((t_args[0][:, 18] > 0.5).sum()))))
    rows, outs_by = [], {}
    for label, call, eager, shape in cases:
        outs = [pytree.tree_leaves(call()) for _ in range(3)]
        torch.cuda.synchronize()
        if not all(_bits_equal(x, y) for o in outs[1:]
                   for x, y in zip(o, outs[0])):
            fail(f"graphs: {label}: a replay differs from the eager call")
        outs_by[label] = outs[0]
        e_host, e_ms = host_device_ms(eager, 5)
        r_host, r_ms = host_device_ms(call, 20)
        kernels, _, kernel_ms = kernel_launches_per_call(eager)
        if label.endswith("local BA"):
            shape = dict(shape, hand_kernels_per_call=ba_hand_kernels(eager))
        if label == "stereo mapping":
            kernels, klt_per_call, _ = klt_kernels_per_call(eager)
            shape = dict(shape, klt_launches_per_call=klt_per_call)
        row = dict(step=label, **shape, bit_equal=True,
                   eager_host_ms=e_host, eager_ms=e_ms,
                   replay_host_ms=r_host, replay_ms=r_ms,
                   kernels_per_call=kernels, kernel_ms=kernel_ms)
        print("[graphs] " + json.dumps(row), flush=True)
        rows.append(row)
    poses, pos, _, inlier, cost = outs_by["local BA"]
    want = bi.pack_ba_out(poses, pos, inlier, cost)
    if not _bits_equal(outs_by["packed local BA"][0], want):
        fail("graphs: the packed local BA differs from the unpacked one")
    rows.append(prewarm_check(est, prob, rho, ray, valid, dev))
    print(f"[graphs] phase passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


def prewarm_check(est, prob, rho, ray, valid, dev):
    """Slice B's estimator pre-warms a landmark capacity no slice reaches
    (``PREWARM_STEPS`` steps of 256 above slice B's window's; a slice's
    windows stay far below their capacity, so none queues a pre-warm):
    slice B's window grown by landmark rows no observation names, into
    that capacity. The first
    real solve there must replay — no eager run and no capture —
    bit-equal to an eager solve of the same vector, and no pre-warm may
    have failed. Returns the row."""
    import numpy as np
    import torch

    from ov2slam_torch.models.estimator import Estimator
    from ov2slam_torch.solvers import ba_invdepth as bi

    Kw, O = len(prob.kf_poses), len(prob.obs_kf)
    L = bi.landmark_capacity(len(rho), O) + 256 * PREWARM_STEPS
    Lw = L - 100
    grown, rho2, ray2 = bi.pad_landmarks(prob, rho, ray, Lw)
    before = (Estimator.prewarms, Estimator.prewarm_failures)
    t0 = time.perf_counter()
    est._prewarm_bucket(L, (grown, rho2, ray2, valid))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    g = bi.GraphedTwoPass
    counts0 = (g.eager, g.captures, g.replays)
    t0 = time.perf_counter()
    poses, points, inlier = est.solve_packed(grown, rho2, ray2, valid)
    solve_ms = 1e3 * (time.perf_counter() - t0)
    counts1 = (g.eager, g.captures, g.replays)
    kw = est._solve_kw()
    flat = torch.as_tensor(bi.pack_ba_invdepth(grown, rho2, ray2, valid),
                           device=dev)
    ref = bi.ba_invdepth_packed(      # a new runner's first solve: eager
        flat, est.params, Kw, Lw, O, runners={}, **kw).cpu().numpy()
    equal = (np.array_equal(poses, ref[:Kw * 7].reshape(Kw, 7))
             and np.array_equal(points, ref[Kw * 7:Kw * 7 + Lw * 3]
                                .reshape(Lw, 3))
             and np.array_equal(inlier, ref[Kw * 7 + Lw * 3:-1] > 0.5))
    row = dict(step="pre-warmed local BA", landmarks=Lw,
               landmark_capacity=L, prewarms=Estimator.prewarms - before[0],
               prewarm_failures=Estimator.prewarm_failures,
               prewarm_s=warm_s, first_solve_ms=solve_ms,
               first_solve=dict(zip(("eager", "captures", "replays"),
                                    np.subtract(counts1, counts0).tolist())),
               bit_equal=equal)
    print("[graphs] " + json.dumps(row), flush=True)
    if row["prewarm_failures"] or row["prewarms"] != 1:
        fail(f"graphs: local BA pre-warm: {row}")
    if row["first_solve"] != dict(eager=0, captures=0, replays=1):
        fail(f"graphs: the first solve after the pre-warm did not replay "
             f"({row})")
    if not equal:
        fail("graphs: the pre-warmed solve differs from an eager solve")
    return row


def pose_fixture_sets(dev):
    """The test fixtures as calls on the card: the RANSAC scene (40 5-point
    and 10 8-point samples, the focal length as a number and as a tensor)
    and the PnP scene (Huber and L2, and the two-pass form's second pass
    on a view of a packed state with the intrinsics as tensors)."""
    import torch

    def t(x):
        return torch.as_tensor(x, device=dev)

    xl, xr, v, i5, i8, focal, err = pose_ransac_case()
    args = (t(xl), t(xr), t(v), t(i5), t(i8))
    out = [PoseSet.ransac("fixture scene", *args, focal, err),
           PoseSet.ransac("fixture scene, focal as a tensor", *args,
                          torch.tensor(focal, device=dev), err)]
    T0, pts, px, pv, cal = pose_pnp_case()
    for rob in (5.9915, 0.0):
        out.append(PoseSet.pnp(f"fixture scene, robust_th {rob}", t(T0),
                               t(pts), t(px), t(pv), *cal, robust_th=rob))
    state = torch.zeros((len(pts), 8), device=dev)
    state[:, 2:5] = t(pts)
    fx, fy, cx, cy = (torch.tensor(c, device=dev) for c in cal)
    out.append(PoseSet.pnp("fixture scene, points a state view, "
                           "intrinsics tensors, L2 5 iterations", t(T0),
                           state[:, 2:5], t(px), t(pv), fx, fy, cx, cy,
                           robust_th=0.0, iters=5))
    return out


def pose_chain(s, runs: int = 50):
    """The dependent chain of ``s``'s kernel, measured: for RANSAC a call
    of one 5-point sample on the same rows (one CTA: the QR, LU and det B
    on a warp, the grid, the root searches a warp each, the scoring of its
    10 candidates and the selection); for PnP the call at ``iters`` against
    iters 0, per iteration. Device ms from calls queued behind a sleep."""
    from ov2slam_torch.geometry import essential
    from ov2slam_torch.solvers import pnp_refine

    if s.kind == "ransac":
        xl, xr, v, i5, i8, focal, err = s.args
        one = i5[:1].contiguous()
        none = i8[:0].contiguous()
        ms = time_cuda_queued(lambda: essential.launch(
            xl, xr, v, one, none, focal, err), runs)
        return dict(one_sample_device_ms=ms)
    kw = dict(s.kw)
    full = time_cuda_queued(lambda: pnp_refine.launch(*s.args, **kw), runs)
    zero = time_cuda_queued(lambda: pnp_refine.launch(
        *s.args, **dict(kw, iters=0)), runs)
    return dict(iters0_device_ms=zero,
                iteration_device_ms=(full - zero) / max(kw["iters"], 1))


def pose_bound(s):
    """``roofline``'s bound of ``s``'s call at this data's work (the roots
    the 5-point samples bisected, their bisection steps up to each
    bracket's fixed point and the candidates scored: the kernel's own
    candidates, step counts and qualities)."""
    from ov2slam_torch.geometry import essential
    from ov2slam_torch.roofline import (essential_ransac_bound,
                                        pnp_refine_bound)

    if s.kind == "pnp":
        return pnp_refine_bound(s.rows, s.kw["iters"])
    xl, xr, v, i5, i8, focal, err = s.args
    _, _, _, cand, q, steps = essential.launch(xl, xr, v, i5, i8, focal,
                                               err, steps=True)
    roots = int((steps > 0).sum())
    return dict(**essential_ransac_bound(
        s.rows, int(i5.shape[0]), int(i8.shape[0]), roots,
        int((q >= 0).sum()), steps=int(steps.sum())),
        bisection_steps_per_root=int(steps.sum()) / max(roots, 1),
        bisection_steps_max=int(steps.max()) if steps.numel() else 0)


def time_pose(s, runs: int = 20, plain_runs: int = 3):
    """``s``'s main-path call: median ms (events around one call), device ms
    (``runs`` calls queued behind a sleep), the kernel launches a call
    (from the wrappers' counters), the plain version's median ms, the
    bound and the measured chain."""
    from ov2slam_torch.geometry import essential
    from ov2slam_torch.solvers import pnp_refine

    counter = (essential.essential_ransac if s.kind == "ransac"
               else pnp_refine.pnp_refine)
    per = essential.KERNELS_PER_LAUNCH if s.kind == "ransac" else 1
    n0 = counter.launches
    s.call()
    launches = (counter.launches - n0) * per
    if launches != 1:
        fail(f"pose {s.kind} {s.label}: {launches} kernel launches a call, "
             f"not 1")
    return dict(ms=time_cuda(s.call, runs),
                device_ms=time_cuda_queued(s.call, runs),
                kernel_launches_per_call=launches,
                plain_ms=time_cuda(lambda: s.call(plain=True), plain_runs),
                **pose_bound(s), **pose_chain(s))


def two_stream_rounds(pair, streams, rounds: int = 10):
    """``pair``'s two calls issued together on ``streams``, queued behind
    one sleep, ``rounds`` times. Returns the rounds in which both equal
    their calls alone bit for bit, and those after which every RANSAC
    ticket is back at 0. Each round's outputs are kept until the end, so
    that none lands in memory that holds an earlier round's answer: a
    launch whose selection ran early or not at all then shows."""
    import torch

    from ov2slam_torch.geometry import essential

    alone = [s.run() for s in pair]
    kept, equal, zero = [], 0, 0
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e6))
        outs = []
        for s, st in zip(pair, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(s.run())
        torch.cuda.synchronize()
        kept.append(outs)
        equal += all(_bits_equal(x, y) for o, a in zip(outs, alone)
                     for x, y in zip(o, a))
        zero += all(int(t) == 0 for t in essential._TICKETS.values())
    return equal, zero


def pose_streams(sets, rounds: int = 10):
    """Slice B's front-end call and its loop closer's call of each pose
    kernel issued together on two streams (as the front end and the
    asynchronous worker issue theirs in slice E), each equal bit for bit
    to its call alone, and the RANSAC tickets back at 0 after each round:
    the kernel's selection ticket is kept per stream. Returns a row per
    kernel."""
    import torch

    rows = []
    streams = [torch.cuda.Stream() for _ in range(2)]
    for kind in ("ransac", "pnp"):
        pair = [next(s for s in sets if s.kind == kind
                     and s.label.startswith(f"slice B {where}"))
                for where in ("front end", "loop closure")]
        equal, zero = two_stream_rounds(pair, streams, rounds)
        row = dict(kind=kind, calls=[s.label for s in pair], rounds=rounds,
                   bit_equal_rounds=equal, tickets_at_zero_rounds=zero)
        print("[pose] two streams: " + json.dumps(row), flush=True)
        if equal != rounds or zero != rounds:
            fail(f"pose {kind}: calls on two streams differ from their "
                 f"calls alone or leave a ticket set ({row})")
        rows.append(row)
    return rows


def phase_pose(dev, captured):
    """The RANSAC and PnP kernels held against their plain versions on the
    card (the test fixtures; slice B's front-end call and its loop
    closer's, ``captured`` during slice B by :class:`PoseCapture`), timed
    at each (one kernel launch a call), and slice B's two calls of each
    issued together on two streams (:func:`pose_streams`). Returns the
    rows and the largest differences (the conditioned RANSAC candidates',
    relative; the PnP pose's)."""
    t0 = time.perf_counter()
    rows, err = [], dict(ransac=0.0, pnp=0.0)
    sets = pose_fixture_sets(dev) + captured.sets("slice B")
    for s in sets:
        if s.kind == "ransac":
            agree = ransac_check(s)
            err["ransac"] = max(err["ransac"],
                                agree["cand_max_err_conditioned"])
        else:
            agree = pnp_check(s)
            err["pnp"] = max(err["pnp"], agree["max_pose_err"])
        row = dict(kind=s.kind, **agree, **time_pose(s))
        print(f"[pose] {s.kind} {s.label}: " + json.dumps(
            {k: v for k, v in row.items() if k not in ("kind", "label")}),
            flush=True)
        rows.append(row)
    kinds = {r["kind"] for r in rows if r["label"].startswith("slice B")}
    if kinds != {"ransac", "pnp"}:
        fail(f"pose: slice B's calls were not captured ({kinds})")
    pose_streams(sets)
    print(f"[pose] phase passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows, err


# ---------------------------------------------------------------------- #
# phase ba: local BA's normal equations and Schur step as hand kernels
# ---------------------------------------------------------------------- #

BA_SUM_REL = 1e-4       # each sum: within this of its largest entry, or
BA_SUM_F64_RATIO = 2.0  # no farther from f64 than this x the plain f32's
BA_COST_REL = 1e-5      # the robust cost, relative
BA_POSE_TOL = 1e-4      # one LM iteration: poses per component
BA_RHO_REL = 1e-3       # ... inverse depths, relative
BA_SOLVE_TOL = 1e-3     # the two-pass solve: poses, and points (with as
#                         much relative)
BA_CASE_KFS = (2, 32, 64)   # the card fixtures' windows (slice B's is 32)
BA_ROBUST_TH = 5.9915


def ba_extras(prob, padded: int = 7, invalid: int = 5, behind: bool = True,
              block: int = 128):
    """``prob`` (``bench.synth_ba_problem``'s arrays) with the rows the
    dense branch must take: ``padded`` landmark rows as
    ``GraphedTwoPass`` pads them (anchor -1, inverse depth 1, ray 0, named
    by no observation), ``invalid`` observation rows (indices -1, not
    valid), and with ``behind`` a landmark anchored at the first keyframe
    whose rows from the last keyframe lie behind that camera (depth_ok
    false); then one more invalid row while the rows are a multiple of
    ``block``."""
    import numpy as np

    from ov2slam_torch.bench import BA_INTR
    from ov2slam_torch.utils import lie_np

    p = {k: np.array(v) for k, v in prob.items()}
    f32 = np.float32

    def add_rows(kf, lm, px, cam, valid):
        for k, v in (("obs_kf", kf), ("obs_lm", lm), ("obs_px", px),
                     ("obs_cam", cam), ("obs_valid", valid)):
            p[k] = np.concatenate([p[k], np.asarray(v, p[k].dtype)])

    if behind:
        last = len(p["poses"]) - 1
        p0, pk = (p["poses"][i].astype(np.float64) for i in (0, last))
        for rx in (-1000.0, 1000.0):
            X = lie_np.pose_apply(p0, np.array([2 * rx, 0.0, 2.0]))
            z = lie_np.pose_apply(lie_np.pose_inverse(pk), X)[2]
            if z < -1e-3:
                break
        else:
            fail("ba_extras: no ray puts the landmark behind the last "
                 "keyframe")
        fx, fy, cx, cy = BA_INTR
        lm = len(p["rho"])
        p["rho"] = np.concatenate([p["rho"], [f32(0.5)]])
        p["anchor"] = np.concatenate([p["anchor"], [0]]).astype(np.int32)
        p["ray"] = np.concatenate([p["ray"], [[rx, 0.0]]]).astype(f32)
        add_rows([0, last, last], [lm, lm, lm],
                 [[fx * rx + cx, cy], [cx, cy], [cx + 5.0, cy]],
                 [0, 0, 1], [True, True, True])
    n = padded
    p["rho"] = np.concatenate([p["rho"], np.ones(n, f32)])
    p["anchor"] = np.concatenate([p["anchor"],
                                  -np.ones(n, np.int32)]).astype(np.int32)
    p["ray"] = np.concatenate([p["ray"], np.zeros((n, 2), f32)])
    m = invalid + int((len(p["obs_kf"]) + invalid) % block == 0)
    add_rows(-np.ones(m), -np.ones(m), np.zeros((m, 2)), np.zeros(m),
             np.zeros(m, bool))
    return p


def ba_case(n_kf: int, dev, seed: int = 0, extras: bool = True):
    """A local BA window of ``n_kf`` keyframes (``bench.synth_ba_problem``,
    about 20 landmarks a keyframe, the first two fixed, only the first
    for two keyframes; with ``extras`` :func:`ba_extras`' rows) as
    ``ba_invdepth._two_pass``'s ten inputs on ``dev`` and its
    calibration."""
    from ov2slam_torch import bench

    prob = bench.synth_ba_problem(n_kf, 20 * n_kf + 20, seed=seed)
    if n_kf <= 2:
        prob["fixed"][1:] = False
    if extras:
        prob = dict(ba_extras(prob), T_rl=prob["T_rl"])
    return bench.ba_inputs(prob, dev)


def ba_state(args, params):
    """The solve's state of ``args`` (``ba_invdepth._prepare``) and its
    observation columns as the kernels take them."""
    from ov2slam_torch.solvers import ba_invdepth as bi

    s = bi._prepare(*args[:8], args[9], 1e-3, args[8])
    return s, (s["anchor"], s["lm_ray"], s["obs_kf"], s["obs_lm"],
               s["obs_px"], s["right"])


def _rel_to_max(a, b) -> float:
    """max |a - b| over the largest |b| (0 where b is 0 and a equals it)."""
    d = float((a - b).abs().max()) if a.numel() else 0.0
    m = float(b.abs().max()) if b.numel() else 0.0
    return d / m if m > 0 else (0.0 if d == 0 else float("inf"))


def _rel(a, b) -> float:
    """max |a - b| / max(|b|, 1e-6), elementwise."""
    return float(((a - b).abs() / b.abs().clamp(min=1e-6)).max())


def ba_sums(s, st, params, robust_th):
    """The normal equations of the state ``s`` (:func:`ba_state`) through
    the kernel and through the plain version, in f32 and in f64: returns
    the launch's arguments, the kernel's and the plain f32 version's
    outputs, and for each of Hpp, bp, Z, Hrr and brho its distances to
    the f64 sums, its largest f64 entry, its distance to the plain f32
    sums relative to their largest entry, and ``ok``: within
    ``BA_SUM_REL`` of that largest entry, or no farther from f64 than
    ``BA_SUM_F64_RATIO`` x the plain f32 version."""
    import torch

    from ov2slam_torch.solvers import ba_invdepth as bi

    ne = (s["T_cw"], s["rho"], *st, s["w_valid"], s["free"], s["bins"],
          params, robust_th)
    got = bi.normal_equations(*ne)
    ref = bi.normal_equations_plain(*ne)
    # the plain version in f64 on the same inputs: the sums' own scale of
    # f32 round-off (gradient-like sums cancel near convergence)
    f64 = torch.float64
    prm64 = params._replace(**{k: getattr(params, k).to(f64) for k in (
        "fx", "fy", "cx", "cy", "T_rl")})
    ref64 = bi.normal_equations_plain(
        s["T_cw"].to(f64), s["rho"].to(f64), st[0], st[1].to(f64), st[2],
        st[3], st[4].to(f64), st[5], s["w_valid"].to(f64),
        s["free"].to(f64), s["bins"], prm64, robust_th)
    sums = {}
    for name, g, r, r64 in zip(("Hpp", "bp", "Z", "Hrr", "brho"), got, ref,
                               ref64):
        k_err = float((g.to(f64) - r64).abs().max())
        p_err = float((r.to(f64) - r64).abs().max())
        scale = float(r64.abs().max())
        sums[name] = dict(kernel_to_f64=k_err, plain_to_f64=p_err,
                          largest=scale, kernel_to_plain_rel=_rel_to_max(
                              g, r),
                          ok=k_err <= max(BA_SUM_F64_RATIO * p_err,
                                          BA_SUM_REL * scale))
    return ne, got, ref, sums


def ba_check(label, args, params, robust_th=BA_ROBUST_TH):
    """Both kernels against their plain versions on the card on ``args``:
    the normal equations at the start (each of Hpp, bp, Z, Hrr and brho
    within ``BA_SUM_REL`` of its largest entry of the plain version's sums
    in f64, or no farther from them than ``BA_SUM_F64_RATIO`` x the plain
    f32 version; the cost within ``BA_COST_REL``); the Schur step
    from the plain version's normal equations (poses within
    ``BA_POSE_TOL``, inverse depths ``BA_RHO_REL`` relative); the cost mode
    and the accept test on the plain candidate (cost within
    ``BA_COST_REL``, the same decision, outputs equal); one whole LM
    iteration through the kernels against one through the plain versions
    (``BA_POSE_TOL``, ``BA_RHO_REL``, λ equal); each kernel's second launch
    bit-equal to its first. Returns the figures."""
    import torch

    from ov2slam_torch.solvers import ba_invdepth as bi

    s, st = ba_state(args, params)
    ne, got, ref, sums = ba_sums(s, st, params, robust_th)
    sum_err = max(v["kernel_to_plain_rel"] for v in sums.values())
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got[:5],
                                                             ref[:5]))
    cost_err = _rel(got[5], ref[5])
    sc = (s["T_cw"], s["rho"], s["lam"], *ref[:5], s["free"])
    T_k, rho_k = bi.schur_step(*sc)
    T_p, rho_p = bi.schur_step_plain(*sc)
    step_pose = float((T_k - T_p).abs().max())
    step_rho = _rel(rho_k, rho_p)
    ac = (s["T_cw"], s["rho"], s["lam"], ref[5], T_p, rho_p, *st,
          s["w_valid"], params, robust_th)
    acc_k = bi.lm_accept(*ac)
    acc_p = bi.lm_accept_plain(*ac)
    cost1_err = _rel(acc_k[3], acc_p[3])
    same = bool(acc_k[2] == acc_p[2]) and all(
        torch.equal(x, y) for x, y in zip(acc_k[:2], acc_p[:2]))
    it_k = bi._lm_step(s, params, robust_th)
    with Swap.plain_ba():
        it_p = bi._lm_step(s, params, robust_th)
    iter_pose = float((it_k[0] - it_p[0]).abs().max())
    iter_rho = _rel(it_k[1], it_p[1])
    again = (bi.normal_equations(*ne), bi.schur_step(*sc),
             bi.lm_accept(*ac))
    torch.cuda.synchronize()
    bits = all(_bits_equal(x, y) for x, y in zip(
        (*again[0], *again[1], *again[2]), (*got, T_k, rho_k, *acc_k)))
    res = dict(label=label, keyframes=int(args[0].shape[0]),
               landmarks=int(args[2].shape[0]),
               observations=int(args[5].shape[0]),
               valid=int(args[9].sum()), robust_th=robust_th,
               sums=sums, sums_rel_err=sum_err, sums_max_abs_err=abs_err,
               cost_rel_err=cost_err, step_pose_err=step_pose,
               step_rho_rel_err=step_rho, cost1_rel_err=cost1_err,
               accept_same=same, accepted=bool(acc_p[2] < s["lam"]),
               iter_pose_err=iter_pose, iter_rho_rel_err=iter_rho,
               iter_lam_equal=bool(it_k[2] == it_p[2]),
               bit_equal=bits)
    bad = [f"sums {k}" for k, v in sums.items() if not v["ok"]]
    bad += [k for k, lim in (("cost_rel_err", BA_COST_REL),
                            ("step_pose_err", BA_POSE_TOL),
                            ("step_rho_rel_err", BA_RHO_REL),
                            ("cost1_rel_err", BA_COST_REL),
                            ("iter_pose_err", BA_POSE_TOL),
                            ("iter_rho_rel_err", BA_RHO_REL))
           if not res[k] <= lim]
    bad += [k for k in ("accept_same", "iter_lam_equal", "bit_equal")
            if not res[k]]
    if bad:
        fail(f"ba {label}: kernels and plain versions disagree on {bad}: "
             f"{res}")
    return res


def ba_worst_case(dev, n_kf: int = 32, kf: int = 5):
    """:func:`ba_case`'s ``n_kf``-keyframe window with every valid row
    observed from keyframe ``kf`` and every landmark anchored there: the
    (kf, kf) (pose, pose) bin then holds four entries a valid row (tens of
    thousands), the longest the normal equations can be given for these
    rows. The pose Jacobians of such a row cancel (its point does not move
    with the pose), so the window is for the sums, not for a step."""
    import torch

    args, prm = ba_case(n_kf, dev)
    args = list(args)
    valid = args[9]
    args[5] = torch.where(valid, torch.full_like(args[5], kf), args[5])
    args[3] = torch.where(args[3] >= 0, torch.full_like(args[3], kf),
                          args[3])
    return tuple(args), prm


def ba_sums_check(label, args, params, robust_th=BA_ROBUST_TH):
    """The normal equations' kernel against its plain version on ``args``
    (:func:`ba_sums`: each sum within its gate; the cost within
    ``BA_COST_REL``), the cost mode with the accept test on the state as
    its own candidate against an infinite cost0 (cost within
    ``BA_COST_REL``, both accept, the same outputs; a finite cost0 equal to
    the candidate's cost would leave the decision to round-off), and a
    second launch of each bit-equal to the first. Returns the figures,
    with the busiest bin's entries."""
    import torch

    from ov2slam_torch.solvers import ba_invdepth as bi

    s, st = ba_state(args, params)
    ne, got, ref, sums = ba_sums(s, st, params, robust_th)
    cost_err = _rel(got[5], ref[5])
    inf = torch.full_like(ref[5], float("inf"))
    ac = (s["T_cw"], s["rho"], s["lam"], inf, s["T_cw"], s["rho"], *st,
          s["w_valid"], params, robust_th)
    acc_k = bi.lm_accept(*ac)
    acc_p = bi.lm_accept_plain(*ac)
    cost1_err = _rel(acc_k[3], acc_p[3])
    same = bool(acc_k[2] == acc_p[2]) and all(
        torch.equal(x, y) for x, y in zip(acc_k[:2], acc_p[:2]))
    again = (bi.normal_equations(*ne), bi.lm_accept(*ac))
    torch.cuda.synchronize()
    bits = all(_bits_equal(x, y) for x, y in zip(
        (*again[0], *again[1]), (*got, *acc_k)))
    res = dict(label=label, longest_bin=ba_longest_bin(s["bins"]),
               sums=sums, cost_rel_err=cost_err, cost1_rel_err=cost1_err,
               accept_same=same, bit_equal=bits)
    bad = [f"sums {k}" for k, v in sums.items() if not v["ok"]]
    bad += [k for k in ("cost_rel_err", "cost1_rel_err")
            if not res[k] <= BA_COST_REL]
    bad += [k for k in ("accept_same", "bit_equal") if not res[k]]
    if bad:
        fail(f"ba {label}: the normal equations and their plain version "
             f"disagree on {bad}: {res}")
    return res


def ba_solve_check(label, args, params, iters=(5, 3)):
    """The two-pass solve (robust pass, chi2 cull, L2 pass) eagerly
    through the kernels twice and once through the plain versions on the
    card: the kernels' runs bit-equal, poses within ``BA_SOLVE_TOL``,
    points within it absolute and relative, inlier masks equal."""
    import torch

    from ov2slam_torch.solvers import ba_invdepth as bi

    def run():
        return bi._two_pass(args, params, BA_ROBUST_TH, *iters, None)

    k1, k2 = run(), run()
    with Swap.plain_ba():
        p = run()
    torch.cuda.synchronize()
    bits = all(_bits_equal(x, y) for x, y in zip(k1, k2))
    pose = float((k1[0] - p[0]).abs().max())
    pts = float(((k1[1] - p[1]).abs()
                 - BA_SOLVE_TOL * p[1].abs()).max())
    differ = int((k1[3] != p[3]).sum())
    res = dict(label=label, bit_equal=bits, pose_err=pose,
               point_err_beyond_rel=pts, inlier_rows_differ=differ,
               inliers=int(p[3].sum()), cost=float(k1[4]),
               cost_plain=float(p[4]))
    if not (bits and pose <= BA_SOLVE_TOL and pts <= BA_SOLVE_TOL
            and differ == 0):
        fail(f"ba {label}: the two-pass solve disagrees: {res}")
    return res


BA_DIGEST_OUTPUTS = ("Hpp", "bp", "Z", "Hrr", "brho", "cost", "S", "Zn",
                     "Hrr_d", "b", "T_new", "rho_new", "T_out", "rho_out",
                     "lam_out", "cost1")


def ba_digests(args, params, robust_th=BA_ROBUST_TH):
    """sha1 digests (16 hex digits) of every output of local BA's two
    kernels at the start of the solve of ``args``: the normal equations
    (Hpp, bp, Z, Hrr, brho, cost), the Schur step's prepare launch on them
    (S before the Schur product, Zn, Hrr_d, b) and the whole step (T_new,
    rho_new), and the cost mode with the accept test on its candidate
    (T_out, rho_out, lam_out, cost1), in ``BA_DIGEST_OUTPUTS``' order. Two
    builds of the kernels that print the same digests agree bit for bit
    on these inputs. Only reported, never gated."""
    import hashlib

    import torch

    from ov2slam_torch.solvers import ba_invdepth as bi

    s, st = ba_state(args, params)
    ne = bi.normal_equations(s["T_cw"], s["rho"], *st, s["w_valid"],
                             s["free"], s["bins"], params, robust_th)
    sc = (s["T_cw"], s["rho"], s["lam"], *ne[:5], s["free"])
    prep = bi.schur_prepare(bi.pack_schur_step(*sc), s["T_cw"])
    step = bi.schur_step(*sc)
    acc = bi.lm_accept(s["T_cw"], s["rho"], s["lam"], ne[5], *step, *st,
                       s["w_valid"], params, robust_th)
    torch.cuda.synchronize()
    return {k: hashlib.sha1(t.detach().cpu().contiguous().numpy()
                            .tobytes()).hexdigest()[:16]
            for k, t in zip(BA_DIGEST_OUTPUTS, (*ne, *prep, *step, *acc))}


def ba_longest_bin(bins) -> int:
    """Entries of the busiest bin the normal equations sum one after
    another (a (pose, pose), pose, landmark or (landmark, pose) bin of
    ``_bins``)."""
    return max(int(bins[k].lengths[:bins[k].n].max()) if bins[k].n else 0
               for k in ("pp", "pose", "lm", "lp"))


def ba_timing(args, params, robust_th=BA_ROBUST_TH, runs: int = 20,
              plain_runs: int = 3):
    """Each kernel on ``args`` (ms: events around one call; device ms:
    ``runs`` calls queued behind a sleep; the plain version's ms; the
    bound): the normal equations and the cost mode with the accept test;
    the Schur step whole, and its two launches, the Schur product
    (``torch.addmm``) and the LU (``torch.linalg.solve_ex``, with its
    bound) apart, by their device time in a trace of ``runs`` calls
    (:func:`ba_stage_split`; the kernel's ``ms`` is its two launches'
    device time, each the mean of its events: a trace may lose an event).
    The two kernels' rows also give their longest sequential chain
    (``roofline.ba_normal_eq_chain`` of the busiest bin,
    ``ba_schur_step_chain``)."""
    from ov2slam_torch.roofline import (ba_normal_eq_bound,
                                        ba_normal_eq_chain,
                                        ba_schur_step_bound,
                                        ba_schur_step_chain, lu_solve_bound)
    from ov2slam_torch.solvers import ba_invdepth as bi

    s, st = ba_state(args, params)
    Kw, Lw, O = (int(s["T_cw"].shape[0]), int(s["rho"].shape[0]),
                 int(s["obs_kf"].shape[0]))
    longest = ba_longest_bin(s["bins"])
    ne = (s["T_cw"], s["rho"], *st, s["w_valid"], s["free"], s["bins"],
          params, robust_th)
    Hpp, bp, Z, Hrr, brho, cost0 = bi.normal_equations(*ne)
    sc = (s["T_cw"], s["rho"], s["lam"], Hpp, bp, Z, Hrr, brho, s["free"])
    T_new, rho_new = bi.schur_step(*sc)
    ac = (s["T_cw"], s["rho"], s["lam"], cost0, T_new, rho_new, *st,
          s["w_valid"], params, robust_th)

    def row(fn, plain, bound, launches):
        return dict(ms=time_cuda(fn, runs), device_ms=time_cuda_queued(
            fn, runs), plain_ms=(time_cuda(plain, plain_runs)
                                 if plain is not None else None),
            kernel_launches_per_call=launches, **bound)

    out = dict(
        shape=dict(keyframes=Kw, landmarks=Lw, observations=O),
        normal_eq=row(lambda: bi.normal_equations(*ne),
                      lambda: bi.normal_equations_plain(*ne),
                      ba_normal_eq_bound(Kw, Lw, O), 2),
        cost_accept=row(lambda: bi.lm_accept(*ac),
                        lambda: bi.lm_accept_plain(*ac),
                        ba_normal_eq_bound(Kw, Lw, O, cost=True), 2),
        schur_step=row(lambda: bi.schur_step(*sc),
                       lambda: bi.schur_step_plain(*sc), {}, 2))
    trace = ba_stage_split(lambda: bi.schur_step(*sc), runs)
    stages = trace["stages"]

    def traced(stage, launch=False, **extra):
        # device ms a call, or with ``launch`` a launch: its events' mean
        t = stages.get(stage, dict(kernels=0, device_ms=0.0))
        ms = t["device_ms"]
        if launch:
            if not (t["kernels"] and ms > 0):
                fail(f"ba: the trace of schur_step shows no launch in "
                     f"{stage}: {trace}")
            ms /= t["kernels"]
        return dict(ms=ms, device_ms=ms, kernels=t["kernels"], **extra)

    out.update(schur_prepare=traced("ba.schur_prepare", True),
               schur_update=traced("ba.schur_update", True),
               schur_product=traced("ba.schur_product",
                                    ops=2 * (6 * Kw) ** 2 * Lw),
               lu_solve=traced("ba.solve", **lu_solve_bound(6 * Kw)))
    out["normal_eq"].update(longest_bin=longest,
                            chain_ms=ba_normal_eq_chain(longest))
    launch_ms = out["schur_prepare"]["ms"] + out["schur_update"]["ms"]
    out["schur_kernel"] = dict(
        ms=launch_ms, device_ms=launch_ms,
        plain_ms=out["schur_step"]["plain_ms"],
        kernel_launches_per_call=2,
        chain_ms=ba_schur_step_chain(Lw, bi.SCHUR_B_CHAINS),
        **ba_schur_step_bound(Kw, Lw))
    return out


def ba_stage_split(fn, runs: int = 1):
    """Kernels and device ms a call of ``fn`` (the means of ``runs``) by
    solve stage: each device event of a torch.profiler trace is charged to
    the innermost ``ba.*`` range (``ba_invdepth.STAGES``) around the
    runtime call that launched it (same correlation id); a hand kernel's
    event to the range by its name where the trace has no such call; the
    rest to "(other)". Also the hand kernels' launches from their
    wrappers' counters, which a trace may hold only some of (PERF.md), and
    each hand kernel's events and device ms by its name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ov2slam_torch.solvers.ba_invdepth import STAGES

    fn()
    torch.cuda.synchronize()
    wrappers, _ = ba_kernel_fns()
    n0 = {k: sum(f.launches for f in fns) for k, fns in wrappers.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    hand = {k: (sum(f.launches for f in fns) - n0[k]) / runs
            for k, fns in wrappers.items()}
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    calls = {e.id: e for e in events if e.device_type == cpu
             and e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                                    "cudaMemset"))}
    by_name = {"ba_rows_kernel": "ba.normal_eq|cost_accept",
               "ba_sums_kernel": "ba.normal_eq|cost_accept",
               "schur_prepare_kernel": "ba.schur_prepare|update",
               "schur_step_kernel": "ba.schur_prepare|update"}
    split, by_kernel = {}, {}
    for d in events:
        if d.device_type != cuda or getattr(d, "is_user_annotation", False):
            continue
        stage, e = "(other)", calls.get(d.id)
        while e is not None:
            if e.name in STAGES:
                stage = e.name
                break
            e = e.cpu_parent
        hand_name = next((k for k in by_name if k in d.name), None)
        if stage == "(other)" and hand_name is not None:
            stage = by_name[hand_name]
        us = d.time_range.elapsed_us()
        n, t = split.get(stage, (0, 0.0))
        split[stage] = (n + 1, t + us)
        if hand_name is not None:
            n, t = by_kernel.get(hand_name, (0, 0.0))
            by_kernel[hand_name] = (n + 1, t + us)
    per = 1.0 / runs
    return dict(stages={k: dict(kernels=n * per, device_ms=1e-3 * us * per)
                        for k, (n, us) in sorted(split.items())},
                kernels=sum(n for n, _ in split.values()) * per,
                device_ms=1e-3 * per * sum(us for _, us in split.values()),
                hand_launches=hand,
                hand_kernels={k: dict(kernels=n * per,
                                      device_ms=1e-3 * us * per)
                              for k, (n, us) in sorted(by_kernel.items())})


def phase_ba(dev, captured):
    """Local BA's two hand kernels against their plain versions on the
    card: the fixtures (:func:`ba_case` at ``BA_CASE_KFS`` keyframes, Huber
    and L2; their rows not a multiple of the kernels' blocks) and slice B's
    ``GRAPH_CALL``-th local BA problem (recorded by :class:`GraphCapture`,
    padded as ``GraphedTwoPass`` pads it): :func:`ba_check` on each,
    :func:`ba_solve_check` on slice B's and the 32-keyframe fixture's
    two-pass solve, :func:`ba_sums_check` on :func:`ba_worst_case`'s
    window; one line of :func:`ba_digests` of the fixtures' and slice B's
    outputs (printed, never gated); then each kernel's times on slice B's
    problem (:func:`ba_timing`) and the stage split of its eager two-pass solve
    through the kernels and through the plain versions on bins that keep
    the rows that are not valid (the solve as it was before the kernels,
    :func:`ba_stage_split`). Returns the figures."""
    import numpy as np
    import torch

    from ov2slam_torch.solvers import ba_invdepth as bi

    t0 = time.perf_counter()
    if "solve_packed" not in captured.inputs:
        fail("ba: slice B made no local BA call")
    (est, prob, rho, ray, valid), _ = captured.inputs["solve_packed"]
    kw = est._solve_kw()
    iters = (kw["iters_robust"], kw["iters_l2"])
    prm = est.params
    args = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (prob.kf_poses, prob.kf_fixed, rho,
                           prob.lm_anchor, ray, prob.obs_kf, prob.obs_lm,
                           prob.obs_px, prob.obs_cam, valid))
    run = bi.GraphedTwoPass(args, prm, kw["robust_th"], *iters)
    run._load(args)
    padded = tuple(run.inputs)
    checks, solves, digests = [], [], {}
    for n_kf in BA_CASE_KFS:
        case, cprm = ba_case(n_kf, dev)
        for th in (BA_ROBUST_TH, 0.0):
            checks.append(ba_check(f"fixture {n_kf} KFs", case, cprm, th))
            digests[f"fixture {n_kf} KFs {'huber' if th else 'l2'}"] = \
                ba_digests(case, cprm, th)
        if n_kf == 32:
            solves.append(ba_solve_check("fixture 32 KFs", case, cprm))
    worst, wprm = ba_worst_case(dev)
    solves.append(ba_sums_check("worst case, 32 KFs", worst, wprm))
    for th in (kw["robust_th"], 0.0):
        checks.append(ba_check("slice B", padded, prm, th))
        digests[f"slice B {'huber' if th else 'l2'}"] = ba_digests(
            padded, prm, th)
    solves.append(ba_solve_check("slice B", padded, prm, iters))
    for r in checks + solves:
        print("[ba] " + json.dumps(r), flush=True)
    print("[ba] digests " + json.dumps(digests), flush=True)
    timing = ba_timing(padded, prm, kw["robust_th"])
    print("[ba] slice B times " + json.dumps(timing), flush=True)

    def solve():
        return bi._two_pass(padded, prm, kw["robust_th"], *iters, None)

    # the plain versions on bins that keep every row: the parent's solve
    with Swap.plain_ba(all_rows=True):
        split_plain = ba_stage_split(solve)
    split = ba_stage_split(solve)
    n_it = sum(iters)
    for name, sp in (("plain", split_plain), ("kernels", split)):
        print(f"[ba] stage split, one eager solve through the {name} "
              f"versions ({n_it} LM iterations): " + json.dumps(sp),
              flush=True)
    print(f"[ba] phase passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    err_sums = max(r["sums_max_abs_err"] for r in checks
                   if r["label"] == "slice B")
    err_step = max(max(r["step_pose_err"], r["iter_pose_err"])
                   for r in checks)
    return dict(checks=checks, solves=solves, timing=timing,
                split=dict(plain=split_plain, kernels=split,
                           iterations=n_it),
                err=dict(ba_normal_eq=err_sums, ba_schur_step=err_step))


# ---------------------------------------------------------------------- #
# phase image: the undistortion, separable-filter (one image, the
# pyramid, Scharr's pair) and CLAHE kernels
# ---------------------------------------------------------------------- #

# (W, H): slice B and E-F, slice A, slice H's KITTI (CLAHE's ragged
# tiles), its TartanAir, and an odd size (ragged tiles, odd levels)
IMAGE_SIZES = ((752, 480), (376, 240), (1241, 376), (640, 480), (377, 241))
IMAGE_POINTS = 512        # points a call (the front end's slots)
IMAGE_FRAME = 40          # slices A's and B's frame held and timed
# a clip limit whose f32 limit has many fractional bits at 1241x376 and
# 377x241 (7332 and 1488 pixels a tile), where the order of CLAHE's excess
# sum decides its bits
IMAGE_ODD_CLIP = 2.7
# EuRoC's cam0 (radtan) and a Kannala-Brandt fixture, as
# tests/test_torch_image_camera.py's CAMS: (fx, fy, cx, cy), coefficients
IMAGE_CAMS = dict(
    radtan=((458.654, 457.296, 367.215, 248.375),
            (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)),
    fisheye=((380.0, 380.0, 320.0, 240.0), (-0.013, 0.021, -0.017, 0.0045)))


def reset_image_counts() -> None:
    """Zero the image and camera kernels' launch counters and their plain
    versions' calls on CUDA tensors."""
    from ov2slam_torch.core import camera, image

    for fn in image_wrappers():
        fn.launches = 0
        fn.shapes.clear()
        fn.origins.clear()
    for fn in image_plain_versions():
        fn.cuda_runs = 0


def image_wrappers():
    """The image and camera kernels' wrappers, each counting its launches:
    the undistortion, the tracks' tail, the one-image filter, the pyramid,
    Scharr's pair and CLAHE."""
    from ov2slam_torch.core import camera, image

    return (camera.undistort_points, camera.undistort_normalize,
            image.separable_filter, image.build_pyramid,
            image.scharr_gradients, image.clahe)


def image_plain_versions():
    from ov2slam_torch.core import camera, image

    return (camera.undistort_points_plain, camera.distort_points_plain,
            camera.undistort_normalize_plain, image.separable_filter_plain,
            image.clahe_plain)


def image_counts():
    """The counters :func:`reset_image_counts` zeroes: each wrapper's
    launches (one kernel each; a launch inside a CUDA graph counts at each
    replay), the tail's split into the tracking step's (with the select)
    and stereo mapping's (reference rows alone), and the plain versions'
    calls on CUDA tensors."""
    from ov2slam_torch.core import camera, image

    tail = camera.undistort_normalize
    return dict(undistort_launches=camera.undistort_points.launches,
                tail_launches=tail.launches,
                tail_track_launches=sum(
                    n for (opts, _), n in tail.shapes.items()
                    if "select" in opts.split("+")),
                tail_stereo_launches=sum(
                    n for (opts, _), n in tail.shapes.items()
                    if opts == "ref"),
                filter_launches=image.separable_filter.launches,
                pyramid_launches=image.build_pyramid.launches,
                scharr_launches=image.scharr_gradients.launches,
                clahe_launches=image.clahe.launches,
                image_plain_runs_on_cuda=sum(
                    fn.cuda_runs for fn in image_plain_versions()))


def uses_scharr(cfg) -> bool:
    """Whether a config's keyframe detector takes Scharr's gradients (the
    Shi-Tomasi and single-scale detectors; FAST does not)."""
    return bool(cfg.use_shi_tomasi or cfg.use_singlescale_detector)


def gate_image_launches(name: str, counts, use_clahe: bool,
                        use_scharr: bool, stereo: bool = False) -> None:
    """Every SLAM slice undistorts its keyframes' detections with the
    undistortion kernel and ends its tracking step with the tail kernel
    (and, where it maps in stereo, its stereo step too), builds its
    pyramids with the pyramid kernel and blurs for BRIEF with the one-image
    filter kernel, takes Scharr's gradients with the pair kernel where its
    detector needs them, and runs CLAHE's kernel where its profile turns
    CLAHE on; no run calls a plain version of the image and camera
    functions on the card."""
    for key, what, needed in (
            ("undistort_launches", "undistort_points", True),
            ("tail_track_launches", "tracking step's undistort_normalize",
             True),
            ("tail_stereo_launches", "stereo step's undistort_normalize",
             stereo),
            ("filter_launches", "separable_filter", True),
            ("pyramid_launches", "build_pyramid", True),
            ("scharr_launches", "scharr_gradients", use_scharr),
            ("clahe_launches", "clahe", use_clahe)):
        if needed and counts[key] < 1:
            fail(f"slice {name}: the {what} kernel never launched")
    if counts["image_plain_runs_on_cuda"] != 0:
        fail(f"slice {name}: the plain image and camera functions ran "
             f"{counts['image_plain_runs_on_cuda']} times on cuda")


def image_fixture(W: int, H: int, seed: int = 0):
    """A smooth f32 image of (H, W) with noise, in [0, 255] but for three
    pixels outside it (CLAHE's clamp to its bins)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = (128.0 + 90.0 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
           + rng.normal(0.0, 12.0, (H, W)))
    img = np.clip(img, 0.0, 255.0).astype(np.float32)
    img[0, :3] = (-3.5, 255.7, 300.0)
    return img


def image_camera(kind: str, dev):
    """(fx, fy, cx, cy, dist) of ``IMAGE_CAMS[kind]`` as the front end's
    ``CalibArrays`` holds them: 0-d f32 tensors and a (4,) one."""
    import torch

    k, d = IMAGE_CAMS[kind]
    return (*(torch.tensor(v, dtype=torch.float32, device=dev) for v in k),
            torch.tensor(d, dtype=torch.float32, device=dev))


def image_points(W: int, H: int, n: int, seed: int, dev):
    """``n`` f32 pixels over the (H, W) image and 20 px beyond its edges."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    px = rng.uniform((-20.0, -20.0), (W + 20.0, H + 20.0), (n, 2))
    return torch.as_tensor(px.astype(np.float32), device=dev)


def image_cases(label: str, img, dev, clip: float = 3.0, levels: int = 4,
                cams: bool = True):
    """(kernel, name, kernel call, plain call) of every output the image
    and camera kernels give on ``img``: CLAHE (at ``clip`` and, with
    ``cams``, at ``IMAGE_ODD_CLIP``), the pyramid of its output (at
    ``levels`` and at 6 levels, two chained launches) and one level of it
    (the one-image filter at stride 2), the blur, the box filter, two
    filters of tap counts the kernel takes in its generic form (x first;
    stride 2) and both Scharr gradients (each pass order), and, with
    ``cams``, the undistortion and both distortion modes of
    ``IMAGE_POINTS`` pixels through each fixture camera and the image's
    undistortion map through the radtan one, and ``Camera.undistort_px``
    (the intrinsics read as views of K)."""
    import torch

    from ov2slam_torch.core import camera as cm
    from ov2slam_torch.core import image as im

    from ov2slam_torch.utils.config import CameraConfig

    H, W = img.shape
    eq = im.clahe(img, clip)

    def plain_filters(fn):
        def run():
            with Swap([(im, "separable_filter")],
                      lambda m, n, o: im.separable_filter_plain):
                return fn()
        return run

    sf, bp = "separable_filter", "build_pyramid"
    cases = [
        ("clahe", f"{label} clahe", lambda: im.clahe(img, clip),
         lambda: im.clahe_plain(img, clip)),
        (bp, f"{label} pyramid", lambda: im.build_pyramid(eq, levels)[1:],
         lambda: im.build_pyramid_plain(eq, levels)[1:]),
        (bp, f"{label} pyramid 6", lambda: im.build_pyramid(eq, 6)[1:],
         lambda: im.build_pyramid_plain(eq, 6)[1:]),
        (sf, f"{label} pyr_down", lambda: im.pyr_down(eq),
         plain_filters(lambda: im.pyr_down(eq))),
        (sf, f"{label} gaussian_blur", lambda: im.gaussian_blur(img, 2.0, 4),
         plain_filters(lambda: im.gaussian_blur(img, 2.0, 4))),
        (sf, f"{label} box_filter", lambda: im.box_filter(img, 3),
         plain_filters(lambda: im.box_filter(img, 3))),
        # tap counts the kernel has no instance of its own for
        (sf, f"{label} x_first", lambda: im.separable_filter(
            img, im.SCHARR_DIFF, im.SCHARR_SMOOTH, x_first=True),
         lambda: im.separable_filter_plain(
            img, im.SCHARR_DIFF, im.SCHARR_SMOOTH, x_first=True)),
        (sf, f"{label} box_filter stride 2",
         lambda: im.separable_filter(img, [1 / 3] * 3, [1 / 3] * 3,
                                     stride=2),
         lambda: im.separable_filter_plain(img, [1 / 3] * 3, [1 / 3] * 3,
                                           stride=2)),
        ("scharr_gradients", f"{label} scharr",
         lambda: im.scharr_gradients(img),
         lambda: im.scharr_gradients_plain(img))]
    if not cams:
        return cases
    odd = IMAGE_ODD_CLIP
    cases.append(("clahe", f"{label} clahe clip {odd}",
                  lambda: im.clahe(img, odd),
                  lambda: im.clahe_plain(img, odd)))
    up = "undistort_points"
    px = image_points(W, H, IMAGE_POINTS, W * H, dev)
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([xs, ys], dim=-1)
    for kind in IMAGE_CAMS:
        c = image_camera(kind, dev)
        fe = kind == "fisheye"
        xn = (px - torch.stack(c[2:4])) / torch.stack(c[0:2])
        cases += [
            (up, f"{label} undistort {kind}",
             lambda c=c, fe=fe: cm.undistort_points(px, *c, fe),
             lambda c=c, fe=fe: cm.undistort_points_plain(px, *c, fe)),
            (up, f"{label} distort {kind} pixels",
             lambda c=c, fe=fe: cm.distort_points(px, *c, fe),
             lambda c=c, fe=fe: cm.distort_points_plain(px, *c, fe)),
            (up, f"{label} distort {kind} normalised",
             lambda c=c, fe=fe, xn=xn: cm.distort_points(xn, *c, fe, True),
             lambda c=c, fe=fe, xn=xn: cm.distort_points_plain(xn, *c, fe,
                                                                True))]
    c = image_camera("radtan", dev)
    (fx, fy, cx, cy), dist = IMAGE_CAMS["radtan"]
    cam = cm.build_camera(CameraConfig(
        model="pinhole", width=W, height=H, fx=fx, fy=fy, cx=cx, cy=cy,
        dist=dist), device=dev)
    cases += [
        (up, f"{label} undistortion map radtan",
         lambda: cm.distort_points(grid, *c),
         lambda: cm.distort_points_plain(grid, *c)),
        (up, f"{label} Camera.undistort_px radtan",
         lambda: cam.undistort_px(px),
         lambda: cm.undistort_points_plain(px, *cam._intrinsics(),
                                           cam.dist))]
    return cases


# the tail's rows a call: the front end's slots, and an odd count (a
# ragged last CTA)
TAIL_ROWS = (IMAGE_POINTS, 301)
# the option sets the tail's kernel runs: none, the select alone, the
# reference rows alone (stereo mapping's), both, and both with the pair
# mask (the tracking step's, its reference rows under its own calibration)
TAIL_OPTIONS = ("", "select", "ref", "select+ref", "select+ref+pair")
TAIL_TRACKING, TAIL_STEREO = "select+ref+pair", "ref"


def tail_inputs(n: int, seed: int, dev):
    """Inputs of the tracks' tail over ``n`` rows, as a frame gives them:
    the packed (n+2, 8) f32 state whose column views ``px`` (columns 0:2,
    the slots' pixels) and ``ref`` (5:7, the reference keyframe's
    undistorted pixels, at an offset no 8-byte load takes) the kernel reads
    in place; ``rows``, the tracked pixels (``px`` moved by up to 3 px);
    ``status`` and ``ref_valid`` (about 70% true each); and
    ``ref_intrinsics``, a calibration of their own (the fisheye
    fixture's)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    state = rng.normal(size=(n + 2, 8)).astype(np.float32)
    state[:n, 0:2] = rng.uniform((-20.0, -20.0), (772.0, 500.0), (n, 2))
    state[:n, 5:7] = rng.uniform((-20.0, -20.0), (772.0, 500.0), (n, 2))
    rows = state[:n, 0:2] + rng.uniform(-3.0, 3.0, (n, 2))
    st = torch.as_tensor(state, device=dev)
    return dict(rows=torch.as_tensor(rows.astype(np.float32), device=dev),
                px=st[:n, 0:2], ref=st[:n, 5:7],
                status=torch.as_tensor(rng.random(n) < 0.7, device=dev),
                ref_valid=torch.as_tensor(rng.random(n) < 0.7, device=dev),
                ref_intrinsics=image_camera("fisheye", dev)[:4])


def tail_kwargs(inputs, opts: str):
    """The keyword arguments of a tail call with options ``opts`` (one of
    ``TAIL_OPTIONS``) on ``inputs``: the tracking step's reference rows are
    under the tracks' own calibration, every other set's under
    ``ref_intrinsics``."""
    parts = opts.split("+")
    kw = {}
    if "select" in parts:
        kw.update(px=inputs["px"], status=inputs["status"])
    if "ref" in parts:
        kw.update(ref=inputs["ref"], ref_intrinsics=(
            None if opts == TAIL_TRACKING else inputs["ref_intrinsics"]))
    if "pair" in parts:
        kw.update(ref_valid=inputs["ref_valid"])
    return kw


def tail_call(fn, inputs, cam, fisheye: bool, opts: str, iters: int = 8):
    """``fn`` (``undistort_normalize`` or its plain version) on ``inputs``
    through camera ``cam`` ((fx, fy, cx, cy, dist)); returns the outputs
    the options give, in order (tracked, und, xr, xl, pair)."""
    out = fn(inputs["rows"], *cam, fisheye, iters,
             **tail_kwargs(inputs, opts))
    return [t for t in out if t is not None]


def tail_eager_sequence(inputs, cam, fisheye: bool, opts: str, fc=None):
    """The eager sequence the tail replaced on the card, as the tracking
    step (``models/frontend_step.py``) and stereo mapping
    (``models/mapper_step.py``) ran it before: ``torch.where``, the
    undistortion kernel (``undistort_points``), the normalisations as a
    torch subtraction and division each (stereo mapping stacked each
    camera's f and c for them; the tracking step had stacked its own once
    a frame for the priors, ``fc``: (f, c), then not counted here), and the
    pair mask as a torch ``&``; its outputs in the tail's order."""
    import torch

    from ov2slam_torch.core import camera as cm

    kw = tail_kwargs(inputs, opts)
    fx, fy, cx, cy, _ = cam
    f, c = fc or (torch.stack([fx, fy]), torch.stack([cx, cy]))
    rows, out = inputs["rows"], []
    if "px" in kw:
        rows = torch.where(kw["status"][:, None], rows, kw["px"])
        out.append(rows)
    und = cm.undistort_points(rows, *cam, fisheye)
    out += [und, (und - c) / f]
    if "ref" in kw:
        if kw["ref_intrinsics"] is None:
            rf, rc = f, c
        else:
            rfx, rfy, rcx, rcy = kw["ref_intrinsics"]
            rf, rc = torch.stack([rfx, rfy]), torch.stack([rcx, rcy])
        out.append((kw["ref"] - rc) / rf)
    if "ref_valid" in kw:
        out.append(kw["status"] & kw["ref_valid"])
    return out


def tail_cases(label: str, n: int, dev):
    """(kernel, name, kernel call, plain call) of the tracks' tail on
    ``n`` rows (``tail_inputs``): every option set of ``TAIL_OPTIONS``
    through each fixture camera against the plain version; and the
    tracking step's
    and stereo mapping's calls against the eager sequence they replaced
    (``tail_eager_sequence``)."""
    from ov2slam_torch.core import camera as cm

    k = "undistort_normalize"
    inputs = tail_inputs(n, n, dev)
    cases = []
    for kind in IMAGE_CAMS:
        c = image_camera(kind, dev)
        fe = kind == "fisheye"
        for opts in TAIL_OPTIONS:
            cases.append((
                k, f"{label} tail {kind} {opts or 'none'}",
                lambda c=c, fe=fe, opts=opts: tail_call(
                    cm.undistort_normalize, inputs, c, fe, opts),
                lambda c=c, fe=fe, opts=opts: tail_call(
                    cm.undistort_normalize_plain, inputs, c, fe, opts)))
        for opts in (TAIL_TRACKING, TAIL_STEREO):
            cases.append((
                k, f"{label} tail {kind} {opts} against the eager sequence",
                lambda c=c, fe=fe, opts=opts: tail_call(
                    cm.undistort_normalize, inputs, c, fe, opts),
                lambda c=c, fe=fe, opts=opts: tail_eager_sequence(
                    inputs, c, fe, opts)))
    return cases


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _bits(t):
    """``t``'s bits as integers to compare (f32 as int32; bool as is)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def image_check(cases, digests, errs):
    """Runs each case's kernel call twice and its plain call once on the
    card; fails unless all three agree bit for bit (NaNs where the plain
    version has them). Adds each case's sha1 (over its outputs' bytes) to
    ``digests`` and keeps in ``errs``, by kernel, the largest |kernel -
    plain| over the positions where neither is NaN; returns the number of
    outputs held."""
    import hashlib

    import torch

    held = 0
    for kernel, name, run, plain in cases:
        k1, k2, ref = _flat(run()), _flat(run()), _flat(plain())
        torch.cuda.synchronize()
        h = hashlib.sha1()
        for a, b, r in zip(k1, k2, ref, strict=True):
            if a.shape != r.shape or a.dtype != r.dtype:
                fail(f"image {name}: {tuple(a.shape)} {a.dtype} against "
                     f"the plain {tuple(r.shape)} {r.dtype}")
            for other, what in ((r, "the plain version"),
                                (b, "a second launch")):
                bits = _bits(a) != _bits(other)
                if bool(bits.any()):
                    d = (a.float() - other.float()).abs().nan_to_num(
                        float("inf"))
                    fail(f"image {name}: not bit-equal to {what} "
                         f"({int(bits.sum())} values differ, largest "
                         f"{float(d.max()):.3e})")
            af, rf = a.float(), r.float()
            both = ~(af.isnan() | rf.isnan())
            d = torch.where(af == rf, 0.0, (af - rf).abs())[both]
            errs[kernel] = max(errs.get(kernel, 0.0),
                               float(d.max()) if d.numel() else 0.0)
            h.update(a.contiguous().cpu().numpy().tobytes())
            held += 1
        digests[name] = h.hexdigest()[:12]
    return held


def image_launches_per_call(fn):
    """The image and camera kernels' launches one call of ``fn`` makes
    (from the wrappers' counters)."""
    fns = image_wrappers()
    n0 = [f.launches for f in fns]
    fn()
    return sum(f.launches - n for f, n in zip(fns, n0))


def time_image(label, run, plain, bound, library=None, runs: int = 20,
               plain_runs: int = 3):
    """One main-path call: median ms (events around one call), device ms
    (``runs`` calls queued behind a sleep), the wrappers' launches a call
    (1 expected), its bound and the plain version's median ms; with
    ``library`` ((conv, pad): the cuDNN convolution that computes the same
    function on the padded input, and the pad, a call of its own), the
    convolution's median ms (``library_ms``) and device ms, and the pad's
    device ms (``library_pad_device_ms``); else ``library_ms`` None."""
    launches = image_launches_per_call(run)
    if launches != 1:
        fail(f"image {label}: {launches} launches a call, not 1")
    row = dict(label=label, ms=time_cuda(run, runs),
               device_ms=time_cuda_queued(run, runs),
               launches_per_call=launches,
               plain_ms=time_cuda(plain, plain_runs), **bound,
               library_ms=None)
    if library is not None:
        conv, pad = library
        row.update(library_ms=time_cuda(conv, runs),
                   library_device_ms=time_cuda_queued(conv, runs),
                   library_pad_device_ms=time_cuda_queued(pad, runs))
    return row


def undistort_chain(run_iters, extra: int = 64, runs: int = 50):
    """The dependent chain of the undistortion's 8 fixed-point steps on the
    card: ``run_iters(k)`` is a call at k steps; the device ms of ``runs``
    such calls queued at 8 + ``extra`` steps less those at 8, over
    ``extra``, is one step (``step_us``, in µs), and 8 of them the chain
    (``chain_ms``). A call's threads run their steps side by side, so the
    difference is their latency, not their work."""
    t8 = time_cuda_queued(run_iters(8), runs)
    tk = time_cuda_queued(run_iters(8 + extra), runs)
    step = (tk - t8) / extra
    return dict(step_us=1e3 * step, chain_ms=8 * step)


def time_tail(label, inputs, cam, opts: str, runs: int = 20):
    """The tail's timing row at one call (``time_image``'s), with its
    bound, its chain (``undistort_chain``) and the eager sequence it
    replaced as the yardstick (``parent_sequence``: ms, device ms, the
    undistortion kernel's launches a call)."""
    import torch

    from ov2slam_torch import roofline
    from ov2slam_torch.core import camera as cm

    parts = opts.split("+")
    n = inputs["rows"].shape[0]

    def run(iters=8):
        return lambda: tail_call(cm.undistort_normalize, inputs, cam,
                                 False, opts, iters)

    row = time_image(
        label, run(), lambda: tail_call(cm.undistort_normalize_plain,
                                        inputs, cam, False, opts),
        roofline.undistort_normalize_bound(
            n, "select" in parts, "ref" in parts, "pair" in parts),
        runs=runs)
    row.update(undistort_chain(run), options=opts)
    fc = None
    if opts == TAIL_TRACKING:
        fc = (torch.stack(cam[0:2]), torch.stack(cam[2:4]))
    seq = lambda: tail_eager_sequence(inputs, cam, False, opts,  # noqa: E731
                                      fc)
    row["parent_sequence"] = dict(
        ms=time_cuda(seq, runs), device_ms=time_cuda_queued(seq, runs),
        launches_per_call=image_launches_per_call(seq))
    return row


def conv2d_yardstick(img, taps_y, taps_x, stride: int = 1):
    """(conv, pad): ``F.conv2d`` of ``img`` padded by replication with the
    outer products of the taps (one output channel a pair; TF32 off, as
    the port runs), at ``stride``, and the pad. A yardstick for the filter
    kernels' times; the port never calls it."""
    import torch
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    w = torch.stack([torch.outer(torch.as_tensor(ty, dtype=torch.float32),
                                 torch.as_tensor(tx, dtype=torch.float32))
                     for ty, tx in zip(taps_y, taps_x)])[:, None]
    w = w.to(img.device)
    r = w.shape[-1] // 2
    padded = F.pad(img[None, None], (r, r, r, r), mode="replicate")
    return (lambda: F.conv2d(padded, w, stride=stride),
            lambda: F.pad(img[None, None], (r, r, r, r), mode="replicate"))


def phase_image(dev, frames):
    """The image and camera kernels (the undistortion, the tracks' tail,
    the one-image filter, the pyramid, Scharr's pair, CLAHE) against their
    plain versions on the card, bit for bit: at each of ``IMAGE_SIZES`` on
    a fixture
    (``image_cases``: CLAHE, its pyramid, a level, the blur, box filter
    and Scharr gradients; the undistortion and distortion
    of pixels through a radtan and a fisheye camera, the radtan image's
    undistortion map) and on ``frames`` ({slice: (frame, clip limit)}:
    slices A's and B's frame ``IMAGE_FRAME`` as the front end uploads it,
    in uint8, with the config's clip limit), and the tracks' tail at each
    of ``TAIL_ROWS`` (``tail_cases``); then each kernel timed at slice B's
    main-path call, the filters beside their cuDNN yardstick
    (``conv2d_yardstick``), the tail beside the eager sequence it replaced
    (``time_tail``).
    Returns the timing rows by kernel, the largest difference by kernel
    (``image_check``'s) and the digests."""
    import torch

    from ov2slam_torch import roofline
    from ov2slam_torch.core import camera as cm
    from ov2slam_torch.core import image as im
    from ov2slam_torch.models.frontend import to_u8

    t0 = time.perf_counter()
    digests, errs, held = {}, {}, 0
    for W, H in IMAGE_SIZES:
        img = torch.as_tensor(image_fixture(W, H), device=dev)
        held += image_check(image_cases(f"{W}x{H}", img, dev), digests,
                            errs)
    for name, (frame, clip) in frames.items():
        img = torch.as_tensor(to_u8(frame), device=dev).to(torch.float32)
        held += image_check(image_cases(f"slice {name} frame {IMAGE_FRAME}",
                                        img, dev, clip, cams=False),
                            digests, errs)
    for n in TAIL_ROWS:
        held += image_check(tail_cases(f"{n} rows", n, dev), digests, errs)
    print(f"[image] {held} outputs bit-equal to the plain versions on the "
          f"card ({len(digests)} cases; two launches each equal)",
          flush=True)
    print("[image] digests " + json.dumps(digests), flush=True)

    frame_b, clip_b = frames["B"]
    img = torch.as_tensor(to_u8(frame_b), device=dev).to(torch.float32)
    H, W = img.shape
    eq = im.clahe(img, clip_b)
    k = im.PYR_TAPS
    g = im.gaussian_kernel1d(2.0, 4)
    sm, df = im.SCHARR_SMOOTH, im.SCHARR_DIFF
    px = image_points(W, H, IMAGE_POINTS, 1, dev)
    c = image_camera("radtan", dev)
    plain_sf = im.separable_filter_plain
    tail_in = tail_inputs(IMAGE_POINTS, 1, dev)
    rows = dict(
        undistort_points=[dict(time_image(
            f"{IMAGE_POINTS} points, radtan, 8 iterations",
            lambda: cm.undistort_points(px, *c),
            lambda: cm.undistort_points_plain(px, *c),
            roofline.undistort_points_bound(IMAGE_POINTS)),
            **undistort_chain(lambda k: lambda: cm.undistort_points(
                px, *c, iters=k)))],
        undistort_normalize=[
            time_tail(f"{IMAGE_POINTS} rows, radtan, the tracking step's "
                      f"({TAIL_TRACKING})", tail_in, c, TAIL_TRACKING),
            time_tail(f"{IMAGE_POINTS} rows, radtan, stereo mapping's "
                      f"({TAIL_STEREO})", tail_in, c, TAIL_STEREO)],
        separable_filter=[
            time_image(f"9-tap blur {W}x{H} (BRIEF's)",
                       lambda: im.gaussian_blur(img, 2.0, 4),
                       lambda: plain_sf(img, g, g),
                       roofline.separable_filter_bound(H, W, 9, 9, 1),
                       conv2d_yardstick(img, [g], [g])),
            time_image(f"pyramid level {W}x{H} -> {W // 2}x{H // 2}",
                       lambda: im.pyr_down(eq),
                       lambda: plain_sf(eq, k, k, stride=2),
                       roofline.separable_filter_bound(H, W, 5, 5, 2),
                       conv2d_yardstick(eq, [k], [k], stride=2))],
        build_pyramid=[time_image(
            f"4 levels of {W}x{H} after CLAHE",
            lambda: im.build_pyramid(eq, 4),
            lambda: im.build_pyramid_plain(eq, 4),
            roofline.pyramid_bound(H, W, 4))],
        scharr_gradients=[time_image(
            f"both gradients of {W}x{H}", lambda: im.scharr_gradients(img),
            lambda: im.scharr_gradients_plain(img),
            roofline.scharr_pair_bound(H, W),
            conv2d_yardstick(img, [sm, df], [df, sm]))],
        clahe=[time_image(f"slice B frame {IMAGE_FRAME}, {W}x{H}, clip "
                          f"{clip_b}", lambda: im.clahe(img, clip_b),
                          lambda: im.clahe_plain(img, clip_b),
                          roofline.clahe_bound(H, W))])
    for name, rs in rows.items():
        for r in rs:
            lib = ("" if r["library_ms"] is None else
                   f", conv2d {r['library_device_ms']:.5f} ms on the device "
                   f"(+ pad {r['library_pad_device_ms']:.5f})")
            if "chain_ms" in r:
                lib += f", chain {r['chain_ms']:.6f} ms"
            if "parent_sequence" in r:
                q = r["parent_sequence"]
                lib += (f"; the eager sequence it replaced "
                        f"{q['ms']:.4f} ms, {q['device_ms']:.5f} on the "
                        f"device")
            print(f"[image] {name} {r['label']}: {r['ms']:.4f} ms per call, "
                  f"{r['device_ms']:.5f} ms on the device, plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms "
                  f"({r['bound_by']}){lib}", flush=True)
    print(f"[image] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, errs, digests


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
    # a record_function range also shows on the device's timeline; it is
    # not a kernel
    dev_us = [e.time_range.elapsed_us() for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
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
    reset_pose_counts()
    reset_image_counts()
    reset_graph_counts()
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
    pose = pose_counts()
    image = image_counts()
    graph = graph_counts()
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
    gate_pose_launches("bench", pose)
    gate_image_launches("bench", image, False, False)
    gate_ba_launches("bench", graph, True)
    print("[bench] CUDA-graph steps' calls: " + json.dumps(graph),
          flush=True)
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
                klt_launches=klt["klt_launches"], pose=pose, graph=graph,
                image=image)


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

    a, seq_a = run_slice("A", dev)
    image_frames = {"A": (seq_a.images_left[IMAGE_FRAME],
                          slice_config("A", seq_a, profiles).clahe_val)}
    del seq_a
    if a["closures"] < 1:
        fail("slice A: loop never closed")
    if not a["ate_m"] < SLICE_A_MAX_ATE:
        fail(f"slice A: ATE {a['ate_m']:.4f} m >= {SLICE_A_MAX_ATE}")
    if not a["end_err_m"] < SLICE_A_MAX_END_ERR:
        fail(f"slice A: endpoint error {a['end_err_m']:.4f} m "
             f">= {SLICE_A_MAX_END_ERR}")

    with PoseCapture() as captured, GraphCapture() as graph_calls:
        b, seq_b = run_slice("B", dev)
    gate_b = max(0.09, 1.25 * JAX_SLICE_B_ATE)
    if not b["ate_m"] <= gate_b:
        fail(f"slice B: ATE {b['ate_m']:.4f} m > {gate_b:.4f}")
    klt_rows, klt_err, klt_step = phase_klt(
        dev, seq_b, slice_config("B", seq_b, profiles))
    pose_rows, pose_err = phase_pose(dev, captured)
    graph_rows = phase_graphs(dev, graph_calls)
    ba = phase_ba(dev, graph_calls)
    image_frames["B"] = (seq_b.images_left[IMAGE_FRAME],
                         slice_config("B", seq_b, profiles).clahe_val)
    image_rows, image_err, _ = phase_image(dev, image_frames)

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
    # the pose kernels' top-level figures are slice B's front-end call;
    # their launches those of every SLAM slice and of the bench
    slices = (a, b, c, d, e, f, *h.values())
    pose_line = []
    for kind, name, source, replaces, key in (
            ("ransac", "essential_ransac",
             "ov2slam_torch/csrc/essential_ransac.cu",
             "ov2slam_tpu/geometry/essential.py:385", "ransac_launches"),
            ("pnp", "pnp_refine", "ov2slam_torch/csrc/pnp_refine.cu",
             "ov2slam_tpu/solvers/pnp_refine.py:45", "pnp_launches")):
        pose_top = next(r for r in pose_rows if r["kind"] == kind
                        and r["label"].startswith("slice B front end"))
        pose_line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(r[key] for r in slices) + bn["pose"][key],
            max_abs_err=pose_err[kind], library_ms=None,
            **{k: pose_top[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "kernel_launches_per_call", "rows")},
            launches_by_slice={r["slice"] + (" " + r["part"] if "part" in r
                                             else ""): r[key]
                               for r in slices},
            bench_launches=bn["pose"][key],
            paths=[r for r in pose_rows if r["kind"] == kind]))
    # local BA's kernels: slice B's problem's figures; launches those of
    # every SLAM slice and of the bench
    t = ba["timing"]
    ba_line = []
    for name, source, replaces, ba_top, ba_paths in (
            ("ba_normal_eq", "ov2slam_torch/csrc/ba_normal_eq.cu",
             "ov2slam_tpu/solvers/ba_invdepth.py:385", t["normal_eq"],
             dict(cost_accept=t["cost_accept"])),
            ("ba_schur_step", "ov2slam_torch/csrc/ba_schur_step.cu",
             "ov2slam_tpu/solvers/ba_invdepth.py:421", t["schur_kernel"],
             {k: t[k] for k in ("schur_prepare", "schur_update",
                                "schur_product", "lu_solve",
                                "schur_step")})):
        key = f"{name}_launches"
        ba_line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(r[key] for r in slices) + bn["graph"][key],
            max_abs_err=ba["err"][name], library_ms=None,
            **{k: ba_top[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "kernel_launches_per_call")},
            shape=t["shape"],
            launches_by_slice={r["slice"] + (" " + r["part"] if "part" in r
                                             else ""): r[key]
                               for r in slices},
            bench_launches=bn["graph"][key], paths=ba_paths))
    # the image and camera kernels: slice B's main-path calls' figures;
    # launches those of every SLAM slice and of the bench
    image_line = []
    for name, key, source, replaces in (
            ("undistort_points", "undistort_launches", "undistort_points",
             "ov2slam_tpu/models/frontend_step.py:53"),
            ("undistort_normalize", "tail_launches", "undistort_points",
             "ov2slam_tpu/models/frontend_step.py:264"),
            ("separable_filter", "filter_launches", "separable_filter",
             "ov2slam_tpu/core/image.py:24"),
            ("build_pyramid", "pyramid_launches", "separable_filter",
             "ov2slam_tpu/core/image.py:84"),
            ("scharr_gradients", "scharr_launches", "separable_filter",
             "ov2slam_tpu/core/image.py:68"),
            ("clahe", "clahe_launches", "clahe",
             "ov2slam_tpu/core/image.py:98")):
        call = image_rows[name][0]
        image_line.append(dict(
            name=name, route="cuda",
            source=f"ov2slam_torch/csrc/{source}.cu", replaces=replaces,
            launches=sum(r[key] for r in slices) + bn["image"][key],
            max_abs_err=image_err[name],
            **{k: call[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "label")},
            **{k: call[k] for k in ("chain_ms", "parent_sequence")
               if k in call},
            launches_by_slice={r["slice"] + (" " + r["part"] if "part" in r
                                             else ""): r[key]
                               for r in slices},
            bench_launches=bn["image"][key], paths=image_rows[name]))
    tsdf_line = tsdf_kernel_rows(g)
    kernels_line = {"kernels": [klt_line, *pose_line, *ba_line,
                                *image_line, *tsdf_line, dict(
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
    print(json.dumps({"graphs": graph_rows}), flush=True)
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
