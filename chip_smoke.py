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
     ATE and resets, reports fps and the profiler's per-stage times.
Then the scorer at each slice's main-path shapes (the populated prefix of
the index, every M it took) against its plain versions and timed at the
last, one JSON line of kernel records, the card's name and power limit,
and the final ``{"ok": true, "device": ...}`` line.

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
    return {"A": a, "B": b}


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


def run_slice(name: str, dev):
    import numpy as np

    from ov2slam_torch.device import synchronize
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.models.slam import SlamManager
    from ov2slam_torch.ops import hamming
    from ov2slam_torch.utils import profiles
    from ov2slam_torch.utils.evaluation import ate_rmse
    from ov2slam_torch.utils.profiler import Profiler

    t0 = time.perf_counter()
    seq, cfg = make_slice(name, synthetic, profiles)
    t_render = time.perf_counter() - t0
    slam = SlamManager(cfg, device=dev)
    prof = Profiler.instance()
    prof.reset()
    # counts cover exactly this slice's run of the main path
    hamming.match_scores_bits.launches = 0
    hamming.match_scores_bits_plain.cuda_runs = 0
    hamming.match_scores_plain.cuda_runs = 0
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(len(seq.times)):
        slam.process_frame(seq.images_left[i], seq.images_right[i],
                           float(seq.times[i]))
    synchronize(dev)
    wall = time.perf_counter() - t0
    launches = hamming.match_scores_bits.launches
    plain_cuda = (hamming.match_scores_bits_plain.cuda_runs
                  + hamming.match_scores_plain.cuda_runs)
    _, poses = slam.estimated_trajectory()
    if poses.shape != seq.gt_poses.shape or not np.isfinite(poses).all():
        fail(f"slice {name}: trajectory not finite / wrong shape")
    ate = ate_rmse(poses, seq.gt_poses, align_scale=False)
    end_err = float(np.linalg.norm(poses[-1, 4:7] - seq.gt_poses[-1, 4:7]))
    res = dict(slice=name, width=seq.width, height=seq.height,
               frames=len(seq.times), render_s=round(t_render, 3),
               wall_s=wall, fps=len(seq.times) / wall, ate_m=ate,
               end_err_m=end_err, keyframes=int(slam.map._kf_seq_counter),
               closures=slam.loop_closer.n_closures,
               resets=slam.n_resets, scorer_launches=launches,
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
    if slam.n_resets != 0:
        fail(f"slice {name}: {slam.n_resets} tracking resets")
    return res


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

    a = run_slice("A", dev)
    if a["closures"] < 1:
        fail("slice A: loop never closed")
    if not a["ate_m"] < SLICE_A_MAX_ATE:
        fail(f"slice A: ATE {a['ate_m']:.4f} m >= {SLICE_A_MAX_ATE}")
    if not a["end_err_m"] < SLICE_A_MAX_END_ERR:
        fail(f"slice A: endpoint error {a['end_err_m']:.4f} m "
             f">= {SLICE_A_MAX_END_ERR}")

    b = run_slice("B", dev)
    gate_b = max(0.09, 1.25 * JAX_SLICE_B_ATE)
    if not b["ate_m"] <= gate_b:
        fail(f"slice B: ATE {b['ate_m']:.4f} m > {gate_b:.4f}")

    # each path's figures are at its last main-path query; the record's
    # top-level ones are slice B's; phase 3's shapes follow in `phase3`
    paths = []
    for res, cap in ((b, rows[0]), (a, rows[1])):
        main, err = main_path_scorer(res, cap["shape"]["N"], dev)
        max_err = max(max_err, err)
        paths.append(dict(slice=res["slice"],
                          launches=res["scorer_launches"], **main,
                          index_cube_bytes=res["index_cube_bytes"]))
    top = {k: paths[0][k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "shape")}
    kernels_line = {"kernels": [dict(
        name="hamming_score", route="cuda",
        source="ov2slam_torch/csrc/hamming_score.cu",
        replaces="ov2slam_tpu/ops/pallas_hamming.py:57",
        launches=b["scorer_launches"], max_abs_err=max_err,
        library_ms=None, **top, paths=paths, phase3=rows,
        index_compaction=compaction)]}
    print(json.dumps(kernels_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
