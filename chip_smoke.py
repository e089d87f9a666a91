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
     ATE and endpoint error, and on the scorer having run as the kernel
     (and never as a plain version on the card);
  5. slice B: the same loop at EuRoC resolution (752x480) with the
     ``accurate`` profile and the default 2048-keyframe index — gates on
     ATE and resets, reports fps and the profiler's per-stage times;
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
     dropped, ATE < 0.05 m, 0 worker errors. Its loop closer is off, so it
     launches no kernel.
For E and F it also prints the synchronizing CUDA calls that
``torch.cuda.set_sync_debug_mode("warn")`` reports on the front end's
thread during 10 chained dispatches, and the worker stream's handle beside
the (thread, stream) of every scorer launch.
Then the scorer at each slice's main-path shapes (for A and B the
populated prefix of the index, every M it took; for C, D and E every
(M, N, Nq) the slice launched, on the loop-closure and the relocalizer
path) against its plain versions and timed at the last, one JSON line of
kernel records, the card's name and power limit, and the final
``{"ok": true, "device": ...}`` line.

Imports nothing of JAX or of ``ov2slam_tpu``. Synthetic data is made from
fixed seeds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM rate and int8 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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
    synchronize(dev)
    t0 = time.perf_counter()
    trace = drive_slice(name, slam, seq)
    synchronize(dev)
    wall = time.perf_counter() - t0
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
               index_cube_bytes=slam.loop_closer.index._cube.numel())
    print(f"[slice {name}] " + json.dumps(res), flush=True)
    print(f"[slice {name}] per-stage times (ms):\n" + prof.summary(),
          flush=True)
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

    walls = []
    for left, right, t in frames[:n_warm]:
        t0 = time.perf_counter()
        slam.process_frame(left, right, t)
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls[10:]))
    pace_fps = pace_share / max(med, 1e-6)
    interval = 1.0 / pace_fps
    slam.cfg.backpressure_wait_s = 2.0 * interval
    n_dropped = 0
    t_all0 = time.perf_counter()
    i = n_warm
    while i < len(frames):
        t_sched = t_all0 + (i - n_warm) * interval
        now = time.perf_counter()
        if now < t_sched:
            time.sleep(t_sched - now)
        elif now > t_sched + interval and i < len(frames) - 1:
            n_behind = min(int((now - t_sched) / interval),
                           len(frames) - 1 - i)
            i += n_behind
            n_dropped += n_behind
        left, right, t = frames[i]
        slam.process_frame(left, right, t)
        i += 1
    slam.flush()
    return n_dropped, pace_fps, med


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
               lc_recent_mask=cfg.lc_recent_mask)
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
    sd = r["sync_debug"]
    print(f"[slice {name}] synchronizing calls reported by "
          f"set_sync_debug_mode('warn') on the front end's thread during "
          f"{sd['dispatches']} chained dispatches: {sd['syncs']} "
          f"({sd['syncs_per_dispatch']:.2f} per dispatch; the worker "
          f"thread's in the same windows: {sd['worker_syncs_in_window']}); "
          f"sites {sd['sites']}", flush=True)
    print(f"[slice {name}] worker stream {r['worker_stream']}; scorer "
          f"launches by (thread, stream): {r['scorer_origins']}",
          flush=True)
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
              f"{r['ate_m']} m; the fast profile has the loop closer off, "
              "so this slice launches no kernel", flush=True)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ov2slam_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(ov2slam_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ov2slam_torch import kernels
    from ov2slam_torch.device import resolve_device

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

    c, _ = run_slice("C", dev)
    gate_slice_c(c)
    d, _ = run_slice("D", dev)
    gate_slice_d(d)
    e = run_async_slice("E", dev, seq=seq_b)
    del seq_b
    gate_async(e, b)
    f = run_async_slice("F", dev)
    gate_async(f)

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
    for res in (c, d, e):
        more, err = launched_shapes_scorer(res, dev)
        max_err = max(max_err, err)
        if res is e:
            for row in more:
                row.update(thread_streams=e["scorer_origins"],
                           worker_stream=e["worker_stream"])
        paths += more
    top = {k: paths[0][k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "shape")}
    kernels_line = {"kernels": [dict(
        name="hamming_score", route="cuda",
        source="ov2slam_torch/csrc/hamming_score.cu",
        replaces="ov2slam_tpu/ops/pallas_hamming.py:57",
        launches=sum(r["scorer_launches"] for r in (a, b, c, d, e, f)),
        max_abs_err=max_err, library_ms=None, **top, paths=paths,
        phase3=rows, index_compaction=compaction)]}
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
