"""Multi-stage benchmark of the port: every hot path of the pipeline on one
GPU, reported against the same reference denominators as the root
``bench.py`` (the JAX package's), stage for stage.

Stages (each self-contained; a stage that fails is recorded in the line as
``{"error": ...}`` so that the other stages' figures survive, and the run
then exits non-zero):

  frontend      fused per-frame tracking step (the 20 Hz hot path)
  local_ba      25-KF anchored-invdepth two-pass windowed BA
  full_ba_pcg   200-KF matrix-free PCG Schur BA (fullBA scale)
  lc_query      place-recognition query against 1,024 stored keyframes
  e2e_sync      streaming SLAM over a photometrically-realistic rendered
                sequence, synchronous (reference single-run protocol)
  e2e_async     same with mapping/BA on the worker thread
  e2e_async20   the asynchronous manager with frames arriving at 20 fps,
  e2e_async40   and at 40 fps (dropped to the newest when a frame behind)
  e2e_loop      the loop sequence, loop closure off and then on
  dist_scaling  the distributed-BA sweep (``scaling_bench``) and the
                compute time of one shard's load

Prints ONE JSON line (head order and dropped keys as the root bench's,
under ~2 KB; the full detail goes to stderr) carrying the device it ran
on: the card's name, power limit and count, or ``"cpu"``. Roofline
shares are against the H100 SXM's published peaks (``roofline.py``),
reported beside the power limit; on the CPU no device metric is given.

Usage: python -m ov2slam_torch.bench [--stage frontend,e2e_sync]
       [--frames N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device, synchronize
from .roofline import (F32_FLOP_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S,
                       device_record, fb_klt_bound)

STAGES = ("e2e_sync", "e2e_async", "e2e_async20", "e2e_async40",
          "frontend", "local_ba", "full_ba_pcg", "lc_query", "e2e_loop",
          "dist_scaling")

# the root bench's sizes, seeds and repetitions
FRONTEND = dict(width=752, height=480, n_points=6000, n_frames=8,
                keypoints=256, levels=4, win=9, iters=30, ransac_iters=100,
                pnp_iters=10, steps=120, windows=3)
LOCAL_BA = dict(n_kf=25, n_lm=1200, iters_robust=5, iters_l2=3, reps=3,
                baseline_iters_s=25.0, max_terr=0.05)
FULL_BA_PCG = dict(n_kf=200, n_lm=8000, iters_robust=4, iters_l2=2, reps=2,
                   baseline_iters_s=0.5, max_terr=0.10)
LC_QUERY = dict(n_store=1024, n_kp=300, target=100, reps=20, queries=20,
                rounds=3)
E2E_LOOP = dict(n_frames=160, width=376, height=240, n_points=4000, seed=6,
                speed=0.06, warm=24)
ROBUST_TH = 5.9915

# per-stage keys left out of the recorded line (kept on stderr): the root
# bench's, the stage's seconds and scorer launches, the lc_query bounds'
# parts and the skewed shard row
VERBOSE = {"baseline", "roofline", "problem", "seq", "store", "note",
           "first_dispatch_s", "bytes_per_frame", "qps_blocking",
           "scorer_shapes", "render_s", "stage_s", "scorer_launches",
           "device_ms", "bytes_share", "ops_bound_ms", "bytes_bound_ms",
           "bound_by", "skew", "sweep_rows"}


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


class Bench(NamedTuple):
    """What every stage gets: the device, the e2e stages' frame count and
    the rendered sequences they share (by frame count)."""
    dev: torch.device
    frames: int
    sequences: dict


def _timer_start(dev):
    """A start mark: a CUDA event on the card, the host clock elsewhere."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _timer_s(dev, start) -> float:
    """Seconds since ``start`` (events on the card; the host clock after a
    synchronize elsewhere)."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        return start.elapsed_time(ev) / 1e3
    return time.perf_counter() - start


# --------------------------------------------------------------------- #
# the arrival loop shared with protocol_bench
# --------------------------------------------------------------------- #

class Arrival(NamedTuple):
    walls: list        # seconds each processed frame took
    processed: list    # indices of the frames processed
    n_dropped: int
    t_start: float     # the clock when the first paced frame was due


def paced_replay(frames, process, n_warm: int, pace_fps=None,
                 clock=time.perf_counter, sleep=time.sleep) -> Arrival:
    """Feed ``frames[n_warm:]`` to ``process(frame)``, flat out or, with
    ``pace_fps``, as a camera would deliver them: frame i is due at
    ``t_start + (i - n_warm) / pace_fps``; a frame early waits for its
    time; when the loop is more than one interval behind the due time, the
    arrival queue drops to the newest frame that has arrived (never past
    the last; `force_realtime`, `ov2slam.cpp:292-299`). ``clock`` and
    ``sleep`` are the time source (a test passes a fake one)."""
    walls, processed = [], []
    n_dropped = 0
    interval = 1.0 / pace_fps if pace_fps else 0.0
    t_start = clock()
    i = n_warm
    while i < len(frames):
        if pace_fps:
            t_sched = t_start + (i - n_warm) * interval
            now = clock()
            if now < t_sched:
                sleep(t_sched - now)
            elif now > t_sched + interval and i < len(frames) - 1:
                n_behind = min(int((now - t_sched) / interval),
                               len(frames) - 1 - i)
                i += n_behind
                n_dropped += n_behind
        t0 = clock()
        process(frames[i])
        walls.append(clock() - t0)
        processed.append(i)
        i += 1
    return Arrival(walls, processed, n_dropped, t_start)


def timestamp_errors(seq, times, poses):
    """ATE (no scale alignment) and endpoint error of an estimated
    trajectory against ``seq``'s ground truth, each estimate matched to
    the ground-truth pose at its timestamp (dropped frames leave gaps)."""
    from .utils.evaluation import ate_rmse

    gt = np.asarray(seq.gt_poses)
    idx = np.clip(np.searchsorted(np.asarray(seq.times), times), 0,
                  len(gt) - 1)
    ate = float(ate_rmse(poses, gt[idx], align_scale=False))
    return ate, float(np.linalg.norm(poses[-1, 4:7] - gt[idx[-1], 4:7]))


# --------------------------------------------------------------------- #
# stage: fused front-end tracking step
# --------------------------------------------------------------------- #

def bench_frontend(b: Bench):
    from .core.image import build_pyramid
    from .io.synthetic import generate_sequence
    from .models.frontend_step import (CalibArrays, fused_track_step,
                                       pack_track_out, pack_track_state,
                                       unpack_track_state)
    from .utils import lie_np

    c, dev, f32 = FRONTEND, b.dev, torch.float32
    n_frames = c["n_frames"]
    seq = generate_sequence(n_frames=n_frames, stereo=False,
                            width=c["width"], height=c["height"],
                            n_points=c["n_points"], seed=0, speed=0.05)
    K = seq.K

    def scalar(x):
        return torch.tensor(float(x), dtype=f32, device=dev)

    calib = CalibArrays(fx=scalar(K[0, 0]), fy=scalar(K[1, 1]),
                        cx=scalar(K[0, 2]), cy=scalar(K[1, 2]),
                        dist=torch.zeros(4, dtype=f32, device=dev))

    # keypoints + their true 3D landmarks, visible in frame 0
    rng = np.random.default_rng(1)
    N = c["keypoints"]
    T0 = seq.gt_poses[0]
    pc = lie_np.pose_apply(lie_np.pose_inverse(T0), seq.points)
    u = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
    v = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
    vis = (pc[:, 2] > 1) & (u > 30) & (u < 720) & (v > 30) & (v < 450)
    pick = rng.choice(np.nonzero(vis)[0], N, replace=False)
    px_np = np.stack([u[pick], v[pick]], -1).astype(np.float32)
    lm_np = seq.points[pick].astype(np.float32)
    ones = np.ones(N, bool)
    T0f = T0.astype(np.float32)
    state = torch.as_tensor(pack_track_state(
        px_np, lm_np, px_np, ones, ones, ones, T0f, T0f), device=dev)
    kw = unpack_track_state(state)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    imgs = [torch.as_tensor(im, dtype=f32, device=dev)
            for im in seq.images_left]
    prev_pyr = tuple(build_pyramid(imgs[0], c["levels"]))
    synchronize(dev)

    def step(img, pyr):
        return fused_track_step(
            img, pyr, gen=gen, calib=calib, **kw,
            clahe_val=3.0, max_fbklt_dist=0.5, klt_err=30.0,
            ransac_err_px=3.0, robust_th=ROBUST_TH, levels=c["levels"],
            win=c["win"], iters=c["iters"], use_clahe=False,
            do_epipolar=True, do_pose=True,
            ransac_iters=c["ransac_iters"], pnp_iters=c["pnp_iters"])

    t0 = time.perf_counter()
    step(imgs[1], prev_pyr)
    synchronize(dev)
    first_s = time.perf_counter() - t0

    def run_window():
        t0 = time.perf_counter()
        p, out = prev_pyr, None
        for i in range(c["steps"]):
            p, out = step(imgs[1 + i % (n_frames - 1)], p)
        synchronize(dev)
        return c["steps"] / (time.perf_counter() - t0), out

    # one warm-up window, then the best of the timed windows
    run_window()
    fps, last_out = 0.0, None
    for _ in range(c["windows"]):
        f, o = run_window()
        if f > fps:
            fps, last_out = f, o
    last = pack_track_out(last_out).cpu().numpy()
    check(bool(np.isfinite(last).all()), "non-finite tracking output")

    # the root bench's byte count of one step (the KLT window samples and
    # the pyramid's build and read), and the fb-KLT call's own bound
    lv, it, win = c["levels"], c["iters"], c["win"]
    klt_bytes = (lv + 1) * it * N * win * win * 4 * 4
    pyr_bytes = int(c["width"] * c["height"] * 4 * 4.0)
    out = {
        "value": fps, "unit": "frames/s",
        "vs_baseline": fps / 60.0,
        "baseline": "60 fps (~3x real-time reference front-end, CPU)",
        "first_dispatch_s": first_s,
    }
    if dev.type == "cuda":
        kb = fb_klt_bound(px_np, [tuple(p.shape) for p in prev_pyr],
                          win=win, iters=it)
        t_mem = (klt_bytes + pyr_bytes) / HBM_BYTES_PER_S
        out["frac_hbm_bw"] = t_mem * fps
        out["roofline"] = {
            "bytes_per_frame": klt_bytes + pyr_bytes,
            "frac_hbm_bw": t_mem * fps,
            "peak": "3.35 TB/s HBM (H100 SXM)",
            "fb_klt_bound_ms": kb["bound_ms"],
            "fb_klt_bound_by": kb["bound_by"],
            "fb_klt_chain_estimate_ms": kb["chain_estimate_ms"],
            "bound": "serial-iteration latency (30-step KLT recurrence) "
                     "and the host's launch rate, not bandwidth"}
    return out


# --------------------------------------------------------------------- #
# stage: windowed / full BA
# --------------------------------------------------------------------- #

BA_INTR = (458.0, 458.0, 376.0, 240.0)     # fx, fy, cx, cy
BA_BASELINE = 0.11


def synth_ba_problem(n_kf, n_lm, seed=0, noise_px=0.4, pose_sigma=0.02,
                     rho_sigma=0.05, covis=15):
    """Ground-truth stereo BA problem on an arc + perturbed initial state,
    in the anchored-inverse-depth parameterization the estimator uses —
    the root bench's ``_synth_ba_problem``, the same draws in the same
    order, as host numpy arrays (f32 where the solver takes f32).

    Landmarks are strewn a few metres ahead of a home keyframe and only
    observed by KFs within ``covis`` indices of it — the sliding
    covisibility a real map has."""
    from .utils import lie_np

    rng = np.random.default_rng(seed)
    FX, FY, CX, CY = BA_INTR
    base = BA_BASELINE

    gt = []
    for i in range(n_kf):
        t = np.array([0.25 * i, 0.05 * np.sin(0.3 * i), 0.02 * i])
        q = lie_np.so3_exp(np.array([0.0, 0.02 * i, 0.005 * i]))
        gt.append(np.concatenate([q, t]))
    gt = np.stack(gt).astype(np.float64)

    # landmarks 2-10 m in front of a home KF, lateral/vertical spread
    home = rng.integers(0, n_kf, n_lm)
    cam_pts = np.stack([rng.uniform(-4.0, 4.0, n_lm),
                        rng.uniform(-2.5, 2.5, n_lm),
                        rng.uniform(2.0, 10.0, n_lm)], -1)
    lms = lie_np.pose_apply(gt[home], cam_pts)
    T_rl = np.concatenate([[1, 0, 0, 0], [-base, 0, 0]]).astype(np.float64)

    # observations: each landmark seen by in-bounds KFs near its home
    rows_kf, rows_lm, rows_px, rows_cam = [], [], [], []
    anchor = np.full(n_lm, -1, np.int64)
    anchor_px = np.zeros((n_lm, 2))
    for k in range(n_kf):
        T_cw = lie_np.pose_inverse(gt[k])
        pc = lie_np.pose_apply(T_cw, lms)
        u = FX * pc[:, 0] / np.maximum(pc[:, 2], 1e-6) + CX
        v = FY * pc[:, 1] / np.maximum(pc[:, 2], 1e-6) + CY
        vis = ((pc[:, 2] > 0.5) & (u > 10) & (u < 742) & (v > 10)
               & (v < 470) & (np.abs(home - k) <= covis))
        ids = np.nonzero(vis)[0]
        px_l = (np.stack([u[ids], v[ids]], -1)
                + rng.normal(0, noise_px, (len(ids), 2)))
        pr = lie_np.pose_apply(T_rl, pc[ids])
        px_r = np.stack([FX * pr[:, 0] / pr[:, 2] + CX,
                         FY * pr[:, 1] / pr[:, 2] + CY], -1)
        fresh = anchor[ids] < 0
        anchor[ids[fresh]] = k
        anchor_px[ids[fresh]] = px_l[fresh]
        # interleave left/right rows for this KF
        rows_kf.append(np.repeat(k, 2 * len(ids)))
        rows_lm.append(np.repeat(ids, 2))
        rows_px.append(np.stack([px_l, px_r], 1).reshape(-1, 2))
        rows_cam.append(np.tile([0, 1], len(ids)))

    ok = np.concatenate(rows_kf)
    ol = np.concatenate(rows_lm)
    opx = np.concatenate(rows_px)
    oc = np.concatenate(rows_cam)
    seen = anchor >= 0
    anchor = np.maximum(anchor, 0)
    ray = np.stack([(anchor_px[:, 0] - CX) / FX,
                    (anchor_px[:, 1] - CY) / FY], -1)
    z = np.maximum(lie_np.pose_apply(
        lie_np.pose_inverse(gt[anchor]), lms)[:, 2], 1e-3)
    rho = 1.0 / z

    # perturb initial state (first two poses gauge-fixed); right-composed,
    # so the error is in each camera's local frame
    poses = gt.copy()
    for k in range(2, n_kf):
        xi = rng.normal(0, pose_sigma, 6)
        poses[k] = lie_np.pose_compose(
            poses[k], np.concatenate([lie_np.so3_exp(xi[3:]), xi[:3]]))
    rho_p = rho * (1 + rng.normal(0, rho_sigma, n_lm))
    fixed = np.zeros(n_kf, bool)
    fixed[:2] = True

    f32 = np.float32
    return dict(
        poses=poses.astype(f32), fixed=fixed,
        rho=np.where(seen, rho_p, 1.0).astype(f32),
        anchor=anchor.astype(np.int32), ray=ray.astype(f32),
        obs_kf=np.array(ok, np.int32), obs_lm=np.array(ol, np.int32),
        obs_px=np.array(opx, f32), obs_cam=np.array(oc, np.int8),
        obs_valid=np.ones(len(ok), bool), T_rl=T_rl, gt=gt, n_obs=len(ok))


BA_ARGS = ("poses", "fixed", "rho", "anchor", "ray", "obs_kf", "obs_lm",
           "obs_px", "obs_cam", "obs_valid")


def ba_inputs(prob, dev):
    """``synth_ba_problem``'s arrays as the solver's tensors on ``dev``,
    and its calibration."""
    from .solvers.ba import BAParams

    def t(a):
        return torch.as_tensor(a, device=dev)

    fx, fy, cx, cy = (t(np.float32(x)) for x in BA_INTR)
    params = BAParams(fx=fx, fy=fy, cx=cx, cy=cy,
                      T_rl=t(prob["T_rl"].astype(np.float32)),
                      intr=BA_INTR)
    return tuple(t(prob[k]) for k in BA_ARGS), params


def ba_solve(args, params, iters_robust, iters_l2):
    """The stage's solve: ``ba_solve_invdepth_two_pass`` at the root
    bench's robust threshold."""
    from .solvers.ba_invdepth import ba_solve_invdepth_two_pass

    return ba_solve_invdepth_two_pass(
        *args, params, robust_th=ROBUST_TH, iters_robust=iters_robust,
        iters_l2=iters_l2)


def _bench_ba(dev, n_kf, n_lm, iters_robust, iters_l2, reps,
              baseline_iters_s, max_terr, label):
    from .solvers import ba_invdepth
    from .utils import lie_np

    prob = synth_ba_problem(n_kf, n_lm)
    log(f"{label}: {n_kf} KFs, {n_lm} lms, {prob['n_obs']} obs")
    args, params = ba_inputs(prob, dev)
    n_iters = iters_robust + iters_l2
    pcg = n_kf > ba_invdepth.DENSE_SCHUR_MAX_KFS

    def solve():
        return ba_solve(args, params, iters_robust, iters_l2)

    calls0 = ba_invdepth._solve_iteration_inv_cg.calls
    t0 = time.perf_counter()
    solve()
    synchronize(dev)
    first_s = time.perf_counter() - t0
    # which branch ran, counted where it runs
    pcg_steps = ba_invdepth._solve_iteration_inv_cg.calls - calls0
    check(pcg_steps == (n_iters if pcg else 0),
          f"{label}: {pcg_steps} PCG steps in {n_iters} LM iterations "
          f"(Kw {n_kf}, dense up to {ba_invdepth.DENSE_SCHUR_MAX_KFS})")

    # each window ends with a synchronize (the device finished both solves)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [solve() for _ in range(2)]
        synchronize(dev)
        best = min(best, (time.perf_counter() - t0) / 2)

    # correctness: solved poses must approach ground truth
    est = outs[-1][0].cpu().numpy().astype(np.float64)
    _, tr = lie_np.pose_distance(est, prob["gt"])
    check(tr.max() < max_terr, f"BA did not converge: max terr "
          f"{tr.max():.3f}")

    iters_s = n_iters / best
    out = {
        "value": iters_s, "unit": "LM iters/s",
        "vs_baseline": iters_s / baseline_iters_s,
        "baseline": baseline_note(baseline_iters_s),
        "solve_ms": best * 1e3,
        "problem": f"{n_kf} KFs / {n_lm} lms / {prob['n_obs']} obs",
        "first_dispatch_s": first_s,
        "branch": "pcg" if pcg else "dense", "pcg_steps": pcg_steps,
        "max_terr_m": float(tr.max()),
    }
    if dev.type == "cuda":
        # per LM iteration ~650 flops/obs (residual + Jacobian + scalar-
        # Hessian blocks) + the reduced pose system (6Kw)^3/3, against the
        # f32 rate outside the tensor cores (the solvers run TF32 off)
        flops_iter = 650.0 * prob["n_obs"] + (6 * n_kf) ** 3 / 3
        share = flops_iter * n_iters / best / F32_FLOP_PER_S
        out["f32_share"] = share
        out["roofline"] = {"flops_per_iter": int(flops_iter),
                           "f32_share": share,
                           "peak": "67 TFLOP/s f32 (H100 SXM)",
                           "bound": "launch and sequential-step latency, "
                                    "not flops"}
    return out


def baseline_note(iters_s):
    if iters_s >= 25.0:
        return (f"{iters_s} iters/s (reference local-BA budget: <=5 "
                "iters in <=0.2 s, optimizer.cpp:439-468)")
    return (f"{iters_s} iters/s (Ceres SPARSE_SCHUR single-thread "
            "throughput on a ~350k-residual fullBA, ~2 s/iteration "
            "on desktop CPU)")


def bench_local_ba(b: Bench):
    return _bench_ba(b.dev, label="local_ba", **LOCAL_BA)


def bench_full_ba_pcg(b: Bench):
    # Kw = 200 > DENSE_SCHUR_MAX_KFS routes through the matrix-free PCG
    # Schur path (Ceres ITERATIVE_SCHUR's counterpart); the far end of a
    # gauge-fixed 200-KF chain has cm-scale ML uncertainty, hence 0.10 m
    return _bench_ba(b.dev, label="full_ba_pcg", **FULL_BA_PCG)


# --------------------------------------------------------------------- #
# stage: loop-closure query at 1k stored keyframes
# --------------------------------------------------------------------- #

def lc_problem(n_store, n_kp, target, seed=3):
    """The root bench's store (random descriptors) and query (keyframe
    ``target``'s descriptors with 15% of bits flipped); returns the
    generator too, for the device-rate queries drawn after them."""
    rng = np.random.default_rng(seed)
    descs = rng.integers(0, 2 ** 32, size=(n_store, n_kp, 8),
                         dtype=np.uint32)
    q = descs[target].copy()
    flip = rng.integers(0, 2 ** 32, q.shape, dtype=np.uint32)
    q = np.where(rng.random(q.shape) < 0.15, q ^ flip, q)
    return rng, descs, q, np.ones(n_kp, bool)


def lc_index(descs, dev):
    from .loopclosure.index import PlaceIndex

    n_store, n_kp = descs.shape[:2]
    idx = PlaceIndex(capacity=n_store, recent_mask=30, device=dev)
    for i in range(n_store):
        idx.add(i, descs[i], np.ones(n_kp, bool))
    return idx


def bench_lc_query(b: Bench):
    from .ops.hamming import match_scores_bits, unpack_pm1

    c, dev = LC_QUERY, b.dev
    n_store, n_kp = c["n_store"], c["n_kp"]
    rng, descs, q, qv = lc_problem(n_store, n_kp, c["target"])
    idx = lc_index(descs, dev)

    hits = idx.query_best(q, qv, top_k=3)       # warm-up
    check(bool(hits) and hits[0][0] == c["target"],
          f"wrong best match: {hits}")

    # (a) the blocking rate: each query reads its scores back
    t0 = time.perf_counter()
    for _ in range(c["reps"]):
        hits = idx.query_best(q, qv, top_k=3)
    qps_block = c["reps"] / (time.perf_counter() - t0)

    # (b) the device rate: distinct queries scored back to back on the
    # index's populated cube, timed with CUDA events
    n = len(idx.kf_ids)
    cube, valid = idx._cube[:n], idx._dev_valid[:n]
    qvd = torch.as_tensor(qv, device=dev)
    qs = [unpack_pm1(torch.as_tensor(rng.integers(
        0, 2 ** 32, q.shape, dtype=np.uint32).view(np.int32), device=dev),
        qvd) for _ in range(c["queries"])]

    def burst():
        return [match_scores_bits(cube, valid, qb, qvd, idx.match_bits)
                for qb in qs]

    burst()
    synchronize(dev)
    out = {"value": qps_block, "unit": "queries/s",
           "baseline": "100 q/s (iBoW-LCD at EuRoC map size)",
           "qps_blocking": qps_block,
           "store": f"{n_store} KFs x {n_kp} kps", "best": hits[0][0]}
    if dev.type == "cuda":
        start = _timer_start(dev)
        for _ in range(c["rounds"]):
            burst()
        dt = _timer_s(dev, start) / (c["rounds"] * len(qs))
        qps_dev = 1.0 / dt
        # Hamming as an int8 product: 2·256 ops per valid (stored, query)
        # row pair; bytes: the ±1 cube and flags read once, the query in,
        # the scores out
        pairs = float(valid.sum()) * float(qvd.sum())
        t_ops = 2.0 * 256 * pairs / INT8_OPS_PER_S
        t_bytes = ((n * n_kp + n_kp) * 257 + n * 4) / HBM_BYTES_PER_S
        out.update(value=max(qps_block, qps_dev), qps_device=qps_dev,
                   device_ms=dt * 1e3, int8_share=t_ops / dt,
                   bytes_share=t_bytes / dt,
                   bound_ms=1e3 * max(t_ops, t_bytes),
                   ops_bound_ms=1e3 * t_ops, bytes_bound_ms=1e3 * t_bytes,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
    else:
        out["qps_device"] = "not measured (cpu)"
    out["vs_baseline"] = out["value"] / 100.0
    return out


# --------------------------------------------------------------------- #
# stage: end-to-end streaming SLAM on a realistic rendered sequence
# --------------------------------------------------------------------- #

def _e2e_sequence(b: Bench):
    """The 752x480 stereo arc with photometric realism, rendered on the
    host once per frame count and shared across the e2e stages; the
    second value is the render's seconds (0 when it was shared)."""
    from .io.synthetic import DEFAULT_REALISM, stream_sequence

    if b.frames in b.sequences:
        return b.sequences[b.frames], 0.0
    t0 = time.perf_counter()
    s = stream_sequence(n_frames=b.frames, stereo=True, width=752,
                        height=480, n_points=8000, seed=0, kind="arc",
                        speed=0.05, realism=DEFAULT_REALISM)
    b.sequences[b.frames] = (s, list(s))
    return b.sequences[b.frames], time.perf_counter() - t0


def _bench_e2e(b: Bench, use_async, pace_fps=None):
    """End-to-end streaming SLAM.

    sync: flat-out feeding (throughput mode — how fast CAN it go).
    async (``pace_fps``): frames ARRIVE on a schedule like the
    reference's protocol (`rosbag play -r 1.0` = camera rate,
    `euroc_bench.sh:9`); when processing falls a full frame behind, the
    arrival queue drops to the newest frame (`force_realtime`,
    `ov2slam.cpp:292-299`).
    """
    from .models.pipeline import AsyncSlamManager
    from .models.slam import SlamManager
    from .utils.profiles import apply_profile

    dev = b.dev
    (seq, frames), render_s = _e2e_sequence(b)
    cfg = seq.make_config()
    apply_profile(cfg, "fast")
    cfg.pipelined_frontend = True
    cfg.pipeline_depth = 2
    if pace_fps:
        # real-time source: shed load at the INPUT (arrival dropping),
        # never by blocking the camera thread on the mapper
        cfg.backpressure_wait_s = 2.0 / pace_fps
    cfg.validate()
    mgr = (AsyncSlamManager if use_async else SlamManager)(cfg, device=dev)
    try:
        # warm the caches on the first frames so that the arrival pacing
        # measures the steady state
        n_warm = min(30, len(frames) // 4)
        for left, right, t in frames[:n_warm]:
            mgr.process_frame(left, right, t)
        arr = paced_replay(frames, lambda f: mgr.process_frame(*f), n_warm,
                           pace_fps)
        synchronize(dev)
        wall_total = time.perf_counter() - arr.t_start
        est_times, est_poses = mgr.estimated_trajectory()
        n_kf = int(mgr.map.n_keyframes)
        worker_errors = int(getattr(mgr, "n_worker_errors", 0))
    finally:
        if use_async:
            mgr.close()

    ate, _ = timestamp_errors(seq, est_times, est_poses)
    walls = np.array(arr.walls)
    fps_median = 1.0 / max(float(np.median(walls)), 1e-9)
    fps_net = len(walls) / wall_total
    p95 = float(np.percentile(walls, 95)) * 1e3
    log(f"e2e {'async' if use_async else 'sync'}"
        f"{f' pace={pace_fps}' if pace_fps else ''}: fps_net "
        f"{fps_net:.2f} median {fps_median:.2f} ate {ate:.4f} "
        f"p95 {p95:.0f}ms kfs {n_kf} seq=752x480 stereo arc + realism")
    out = {
        "value": fps_net,
        "unit": ("frames/s (sustained at paced arrival)" if pace_fps
                 else "frames/s (net)"),
        "vs_baseline": fps_net / 20.0,
        "ate_m": ate, "fps_median": fps_median, "p95_ms": p95,
        "n_kf": n_kf,
    }
    if render_s:
        out["render_s"] = render_s
    if use_async:
        out["n_worker_errors"] = worker_errors
    if pace_fps:
        out.update(pace_fps=pace_fps, n_dropped=arr.n_dropped,
                   n_frames=len(walls))
    return out


def bench_e2e_sync(b: Bench):
    return _bench_e2e(b, use_async=False)


def bench_e2e_async(b: Bench):
    # flat-out async (mapper/BA/LC overlapped on the worker)
    return _bench_e2e(b, use_async=True)


def bench_e2e_async20(b: Bench):
    # frames arrive at the camera rate of the reference's protocol
    return _bench_e2e(b, use_async=True, pace_fps=20.0)


def bench_e2e_async40(b: Bench):
    # the 2x tier
    return _bench_e2e(b, use_async=True, pace_fps=40.0)


def bench_e2e_loop(b: Bench):
    """Loop closure end-to-end: revisit sequence, LC on, pose graph —
    reports closures fired and the ATE they buy."""
    from .io.synthetic import generate_sequence
    from .models.slam import SlamManager
    from .utils.evaluation import ate_rmse

    c, dev = E2E_LOOP, b.dev
    seq = generate_sequence(n_frames=c["n_frames"], stereo=True,
                            width=c["width"], height=c["height"],
                            n_points=c["n_points"], seed=c["seed"],
                            speed=c["speed"], kind="loop")
    n_warm = c["warm"]       # steady-state fps: skip the first frames
    results = {}
    for lc in (False, True):
        cfg = seq.make_config(max_keyframes=128, max_landmarks=16384,
                              use_fast=False, use_singlescale_detector=True,
                              max_dist=30, use_loop_closer=lc,
                              lc_recent_mask=10, lc_min_score=0.2)
        cfg.pipelined_frontend = True
        slam = SlamManager(cfg, device=dev)
        t0 = 0.0
        for i in range(len(seq.times)):
            if i == n_warm:
                synchronize(dev)
                t0 = time.perf_counter()
            slam.process_frame(seq.images_left[i], seq.images_right[i],
                               float(seq.times[i]))
        synchronize(dev)
        wall_w = time.perf_counter() - t0
        _, poses = slam.estimated_trajectory()
        ate = float(ate_rmse(poses, seq.gt_poses[:len(poses)],
                             align_scale=False))
        end_err = float(np.linalg.norm(
            poses[-1, 4:7] - seq.gt_poses[len(poses) - 1, 4:7]))
        results[lc] = (ate, end_err, wall_w,
                       slam.loop_closer.n_closures if lc else 0)
    ate_off, end_off = results[False][0], results[False][1]
    ate_on, end_on, wall_on, n_closures = results[True]
    log(f"e2e_loop: {n_closures} closures, ate {ate_off:.4f} -> "
        f"{ate_on:.4f} end {end_off:.4f} -> {end_on:.4f} (376x240 stereo "
        "circle revisit, 160 frames, chained frontend)")
    return {
        "value": int(n_closures), "unit": "closures",
        "vs_baseline": ate_off / max(ate_on, 1e-9),
        "ate_with_lc_m": ate_on, "ate_no_lc_m": ate_off,
        "end_with_lc_m": end_on, "end_no_lc_m": end_off,
        "fps": (len(seq.times) - n_warm) / max(wall_on, 1e-9),
    }


# --------------------------------------------------------------------- #
# stage: distributed-BA scaling sweep
# --------------------------------------------------------------------- #

def bench_dist_scaling(b: Bench):
    from . import scaling_bench

    res = scaling_bench.run(b.dev)
    # the recorded line keeps only the essentials of each row
    res["sweep_rows"] = res["sweep"]
    res["sweep"] = [
        {k: v for k, v in row.items()
         if k in ("n_shards", "efficiency", "lm_iter_ms")}
        for row in res["sweep_rows"]]
    res.update(comm_anchor(b.dev, res))
    return res


def comm_anchor(dev, res, n_shards=8, iters=5):
    """The compute time of one distributed-BA LM iteration at 8-shard
    member load (one shard's rows on one card, CUDA events, best of 3),
    and, with two or more cards, a timed NCCL ``all_reduce`` of the
    iteration's reduction payload between two of them, giving
    ``comm_frac_est = t_reduce / (t_reduce + t_compute)``. No link rate
    is modelled: with one card the fraction is not measured."""
    if dev.type != "cuda":
        return {"member_compute_ms_iter": "not measured (cpu)"}
    import tempfile

    from .parallel import dist_ba, worker
    from .parallel.problems import realistic_window_problem

    _, prob, params, _ = realistic_window_problem(n_kf=28, n_lm=6000,
                                                  device=dev)
    shard_np = dist_ba.shard_ba_problem(prob, n_shards)
    # member load: ONE shard's rows on the single device
    member = {k: v[:1] for k, v in shard_np.items()}
    mesh = dist_ba.make_mesh(1)
    shards = dist_ba.put_sharded(mesh, member, len(prob.kf_ids), dev)
    step = dist_ba.make_distributed_ba(mesh, params, ROBUST_TH, iters)
    poses = torch.as_tensor(prob.kf_poses, device=dev)
    fixed = torch.as_tensor(prob.kf_fixed, device=dev)
    step(poses, fixed, shards)
    synchronize(dev)
    best = float("inf")
    for _ in range(3):
        start = _timer_start(dev)
        step(poses, fixed, shards)
        best = min(best, _timer_s(dev, start) / iters)
    out = {"member_compute_ms_iter": best * 1e3}
    if torch.cuda.device_count() >= 2:
        payload = next(r["reduction_bytes"] for r in res["sweep_rows"]
                       if r["n_shards"] == n_shards)
        with tempfile.TemporaryDirectory() as tmp:
            t_red = worker.time_all_reduce(payload, tmp, 2) / 1e3
        out.update(nccl_all_reduce_ms=t_red * 1e3,
                   comm_frac_est=t_red / (t_red + best))
    else:
        out["comm_frac_est"] = "not measured, 1 device"
    return out


RUNNERS = {
    "frontend": bench_frontend,
    "local_ba": bench_local_ba,
    "full_ba_pcg": bench_full_ba_pcg,
    "lc_query": bench_lc_query,
    "e2e_sync": bench_e2e_sync,
    "e2e_async": bench_e2e_async,
    "e2e_async20": bench_e2e_async20,
    "e2e_async40": bench_e2e_async40,
    "e2e_loop": bench_e2e_loop,
    "dist_scaling": bench_dist_scaling,
}


# --------------------------------------------------------------------- #

def run_stage(name, b: Bench):
    """One stage's figures, with its seconds and the scorer's launches in
    it (by shape), or ``{"error": ...}`` if it raised. An asynchronous
    stage whose worker raised is a failed stage, its figures kept."""
    import traceback

    from .ops import hamming

    launches0 = hamming.match_scores_bits.launches
    shapes0 = dict(hamming.match_scores_bits.shapes)
    t0 = time.perf_counter()
    try:
        st = RUNNERS[name](b)
    except Exception as e:      # recorded; the run exits non-zero
        traceback.print_exc()
        st = {"error": f"{type(e).__name__}: {e}"[:200]}
    st["stage_s"] = time.perf_counter() - t0
    if st.get("n_worker_errors"):
        st["error"] = f"{st['n_worker_errors']} worker errors"
    st["scorer_launches"] = hamming.match_scores_bits.launches - launches0
    st["scorer_shapes"] = [
        [*k, n - shapes0.get(k, 0)] for k, n in
        sorted(hamming.match_scores_bits.shapes.items())
        if n > shapes0.get(k, 0)]
    return st


def main(argv=None, detail=None) -> int:
    """Run the stages, print the line; 0 when every stage passed.
    ``detail``, a dict, receives the line and every stage's full figures
    (``chip_smoke.py`` reads the scorer's launch shapes there)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", default="all",
                    help="comma list of " + ",".join(STAGES))
    ap.add_argument("--frames", type=int, default=120,
                    help="frames for the e2e stages")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the GPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    device = device_record(dev)
    log(f"device: {json.dumps(device)} | torch {torch.__version__}")
    wanted = list(STAGES) if args.stage == "all" else args.stage.split(",")
    unknown = [w for w in wanted if w not in RUNNERS]
    if unknown:
        ap.error(f"unknown stage(s) {unknown}")

    b = Bench(dev, args.frames, {})
    stages = {}
    for name in wanted:
        log(f"stage {name} ...")
        stages[name] = st = run_stage(name, b)
        log(f"stage {name}: {st.get('value', st.get('error'))} "
            f"{st.get('unit', '')} ({st['stage_s']:.0f}s)")
    failed = [n for n, st in stages.items() if "error" in st]

    # headline: full-system overlapped net throughput if measured
    for head_name, key in (("e2e_async_net_fps", "e2e_async"),
                           ("e2e_sync_net_fps", "e2e_sync"),
                           ("frontend_tracking_fps", "frontend")):
        if "value" in stages.get(key, {}):
            head = stages[key]
            break
    else:
        head_name, head = "failed", {"value": 0.0, "unit": "",
                                     "vs_baseline": 0.0}

    log("full stage detail: " + json.dumps(stages))
    compact = {name: {k: _short(v) for k, v in st.items()
                      if k not in VERBOSE}
               for name, st in stages.items()}
    result = {
        "metric": head_name,
        "value": _short(head["value"]),
        "unit": head.get("unit", ""),
        "vs_baseline": _short(head.get("vs_baseline", 0.0)),
        "stages": compact,
        "device": device,
    }
    line = json.dumps(result)
    log(f"recorded line: {len(line)} bytes; failed stages: {failed}")
    print(line, flush=True)
    if detail is not None:
        detail.update(line=result, stages=stages, failed=failed)
    return 1 if failed else 0


def _short(obj):
    """``obj`` with its floats to 5 significant digits (the recorded line
    stays under ~2 KB; stderr and ``detail`` keep every digit)."""
    if isinstance(obj, float) and math.isfinite(obj):
        return float(f"{obj:.5g}")
    if isinstance(obj, dict):
        return {k: _short(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_short(v) for v in obj]
    return obj


def nonfinite(obj, path=""):
    """The paths of the numbers in ``obj`` (nested dicts and lists) that
    are not finite."""
    if isinstance(obj, bool):
        return []
    if isinstance(obj, (int, float)):
        return [] if math.isfinite(obj) else [path]
    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in nonfinite(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in nonfinite(v, f"{path}[{i}]")]
    return []


if __name__ == "__main__":
    sys.exit(main())
