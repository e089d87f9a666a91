#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ov2slam_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build every hand-written kernel from ``ov2slam_torch/csrc`` (nvcc,
     sm_90a), in parallel;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it (atol 0), and time both;
  4. slice A: the loop-closure test sequence (376x240, 160 frames) through
     ``SlamManager`` with the loop closer on — gates on closures, resets,
     ATE and endpoint error, and on the scorer having run as the kernel;
  5. slice B: the same loop at EuRoC resolution (752x480) with the
     ``accurate`` profile and the default 2048-keyframe index — gates on
     ATE and resets, reports fps and the profiler's per-stage times.
Then one JSON line of kernel records, the card's name and power limit, and
the final ``{"ok": true, "device": ...}`` line.

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


def scorer_inputs(M, N, Nq, seed, dev, p_valid=0.9):
    """Random packed descriptors (int32 words) and valid masks; the query
    is one stored keyframe's rows with 6 bits flipped per row, so scores
    are non-trivial."""
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
    the bytes floor (store 33 B/row, query 33 B/row, 4 B/score, each moved
    once) or the int8 tensor-core floor for this data's valid pairs
    (2·256 ops per pair)."""
    n_bytes = M * N * 33 + Nq * 33 + M * 4
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


def phase_kernels(dev):
    import torch

    from ov2slam_torch.ops import hamming

    rows = []
    max_err = 0.0
    shapes = []
    for name, what in (("B", "accurate 752x480"), ("A", "376x240")):
        M, N = slice_index_shape(name)
        shapes.append((f"slice {name} main path ({what}, max_kps {N // 2})",
                       M, N, N))
    shapes += [("accurate 752x480 at max_kps 384", 2048, 768, 768),
               ("average 752x480", 2048, 512, 512)]
    for label, M, N, Nq in shapes:
        store, sv, q, qv = scorer_inputs(M, N, Nq, seed=M + N, dev=dev)
        k = hamming.match_scores(store, sv, q, qv, 48)
        p = hamming.match_scores_plain(store, sv, q, qv, 48)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        if err != 0.0:
            fail(f"hamming kernel != plain at {label}: {err}")
        max_err = max(max_err, err)
        if float(k.max()) <= 0.0:
            fail(f"hamming scores all zero at {label}")
        ms = time_cuda(lambda: hamming.match_scores(store, sv, q, qv, 48), 20)
        plain_ms = time_cuda(
            lambda: hamming.match_scores_plain(store, sv, q, qv, 48), 3)
        bound, bound_by = scorer_bound(sv, qv, M, N, Nq)
        print(f"[kernels] hamming_score {label} M={M} N={N} Nq={Nq}: "
              f"kernel {ms:.4f} ms (median of 20), plain {plain_ms:.3f} ms, "
              f"bound {bound:.4f} ms", flush=True)
        rows.append(dict(shape=(M, N, Nq), ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by))

    # edge cases: invalid stored rows, an all-invalid query, a keyframe
    # with no valid row, match_bits 0/48/127, M not a multiple of 8
    store, sv, q, qv = scorer_inputs(37, 96, 80, seed=11, dev=dev)
    sv[5] = False
    cases = [(store, sv, q, qv, b) for b in (0, 48, 127)]
    cases.append((store, sv, q, torch.zeros_like(qv), 48))
    cases.append((store[:0].contiguous(), sv[:0].contiguous(), q, qv, 48))
    for s_, v_, q_, qv_, b in cases:
        k = hamming.match_scores(s_, v_, q_, qv_, b)
        p = hamming.match_scores_plain(s_, v_, q_, qv_, b)
        torch.cuda.synchronize()
        if k.shape != p.shape or (k.numel() and
                                  float((k - p).abs().max()) != 0.0):
            fail(f"hamming kernel != plain on edge case bits={b}")
    print("[kernels] hamming_score edge cases: equal to plain (atol 0)",
          flush=True)
    return rows, max_err


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
    hamming.match_scores.launches = 0
    hamming.match_scores_plain.cuda_runs = 0
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(len(seq.times)):
        slam.process_frame(seq.images_left[i], seq.images_right[i],
                           float(seq.times[i]))
    synchronize(dev)
    wall = time.perf_counter() - t0
    launches = hamming.match_scores.launches
    plain_cuda = hamming.match_scores_plain.cuda_runs
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
               max_kps=cfg.max_kps)
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
    from ov2slam_torch.ops import hamming

    dev = resolve_device(None)
    smi = nvidia_smi_line()
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    build_s = kernels.build_all()
    print(f"[build] kernels {list(kernels.KERNELS)} built in "
          f"{build_s:.2f} s", flush=True)

    rows, max_err = phase_kernels(dev)

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

    # rows[0] and rows[1] are slices B and A at their own index shapes;
    # the record's top-level figures are slice B's
    shape_keys = ("M", "N", "Nq")
    paths = [dict(slice=res["slice"], launches=res["scorer_launches"],
                  shape=dict(zip(shape_keys, row["shape"])),
                  ms=row["ms"], plain_ms=row["plain_ms"],
                  bound_ms=row["bound_ms"], bound_by=row["bound_by"])
             for res, row in ((b, rows[0]), (a, rows[1]))]
    kernels_line = {"kernels": [dict(
        name="hamming_score", route="cuda",
        source="ov2slam_torch/csrc/hamming_score.cu",
        replaces="ov2slam_tpu/ops/pallas_hamming.py:57",
        launches=b["scorer_launches"], max_abs_err=max_err,
        ms=rows[0]["ms"], plain_ms=rows[0]["plain_ms"],
        bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"],
        library_ms=None, shape=paths[0]["shape"], paths=paths)]}
    print(json.dumps(kernels_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
