"""A fleet of independent stereo SLAM sessions on one card, closed loop,
flat out: one process a session, as an evaluation farm or a multi-robot
server runs them.

Each session runs in its own process, renders its own sequence from
``seed * K + i`` (``scenes/stereo_seq.py``: a long path with no revisit,
rendered on the device, kept as 8-bit frames on the host), builds a
synchronous ``SlamManager`` with the configuration's profile, warms it on
its first ``warmup_frames`` frames (graph captures, the local BA's
pre-warm, the loop closer's index), and reports ready. The parent
releases every session at one instant; each then feeds its next frames
through ``process_frame`` until the window's end, stamping each call with
``time.monotonic()``. A frame counts if it ended inside the window.

``correct``: each session's trajectory over the window against the
renderer's ground truth (ATE after a rigid alignment; the configuration
states the limit), and, on frames drawn from the seed, the front end's
image and tracking layers against the plain reference
(``reference/frontend.py``): the CLAHE'd frame and its pyramid as the
program left them, and the keypoints the program tracked into the frame,
tracked again by the reference from the program's previous positions
(its search seeded at the program's answer, which it has to confirm). The
session compares once its window has closed, its memory peak has been read
and its ``SlamManager`` freed. A session that fails, or never reports,
counts its frames as failed; no wait is without a deadline.
"""

from __future__ import annotations

import gc
import os
import queue
import random
import sys
import threading
import time
import traceback
from typing import Dict, List

from .. import common

# seconds a session may take to get ready, and past the window's end to
# report (its reference included)
READY_S, REPORT_S = 900.0, 300.0


def sessions(cell: dict, seed: int) -> List[dict]:
    """The parameters of each session of a run (pickled to its process)."""
    tr, cfg = cell["traffic"], cell["config_file"]
    K = tr["sessions"]
    rng_base = seed * K
    out = []
    for i in range(K):
        s = rng_base + i
        # window ordinals of the frames the comparison samples, from the seed
        r = random.Random(s)
        samples = sorted(r.sample(range(1, tr["sample_within"]),
                                  tr["samples_per_session"]))
        out.append(dict(index=i, seed=s, sequence=cfg["sequence"],
                        profile=cfg["profile"], overrides=cfg["overrides"],
                        warmup=tr["warmup_frames"], samples=samples,
                        check=cell["check"]))
    return out


def build_config(p: dict, scene):
    """The program's configuration of a session: the stereo pair as
    rendered, then the profile, then the configuration's overrides."""
    import numpy as np

    from ov2slam_torch.utils.config import CameraConfig, SlamConfig
    from ov2slam_torch.utils.profiles import apply_profile

    from ..scenes import lie

    K = scene.K
    cam = dict(model="pinhole", width=scene.width, height=scene.height,
               fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
               cy=float(K[1, 2]), dist=(0.0, 0.0, 0.0, 0.0))
    left = CameraConfig(T_body_cam=np.eye(4), **cam)
    right = CameraConfig(T_body_cam=np.array(lie.pose_to_matrix(scene.T_lr)),
                         **cam)
    cfg = SlamConfig(mono=False, stereo=True, cam_left=left, cam_right=right)
    apply_profile(cfg, p["profile"])
    for k, v in p["overrides"].items():
        setattr(cfg, k, v)
    return cfg.validate()


def _snapshot(fe) -> dict:
    f = fe.frame
    return dict(px=f.px.copy(), valid=f.valid.copy(), lmids=f.lmids.copy())


def _session(conn, p: dict, seconds: float, trace: bool, device: str,
             control: bool, progress: dict) -> dict:
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from ov2slam_torch.models.slam import SlamManager
    from ov2slam_torch.utils.profiler import Profiler

    from ..reference import ate as ref_ate
    from ..reference import frontend as ref_fe
    from ..scenes import stereo_seq

    cuda = device == "cuda"
    parts = [("start", time.monotonic())]
    scene = stereo_seq.StereoSequence(p["sequence"], p["seed"], device)
    parts.append(("render", time.monotonic()))
    cfg = build_config(p, scene)
    slam = SlamManager(cfg, device=device, seed=p["seed"] % (1 << 62))
    n, fps = len(scene.left), p["sequence"]["fps"]

    def feed(j):
        # past the last frame the sequence starts again (a revisit)
        i = j % n
        return slam.process_frame(scene.left[i], scene.right[i], j / fps)

    parts.append(("build", time.monotonic()))
    for j in range(p["warmup"]):
        feed(j)
    kf0 = int(slam.map._kf_seq_counter)
    if cuda:
        torch.cuda.synchronize()
    prof = common.profiler(cuda) if trace else None
    parts.append(("warm", time.monotonic()))
    conn.send(("ready", dict(index=p["index"], setup=[
        (b[0], b[1] - a[1]) for a, b in zip(parts, parts[1:])])))
    t0 = conn.recv()[1]
    end = t0 + seconds
    while time.monotonic() < t0:
        time.sleep(0.0005)
    Profiler.instance().reset()
    tracing = prof is not None
    if tracing:
        prof.start()
        w0 = time.time_ns() / 1e3
    trace_frames, w1 = 0, None
    samples = set(p["samples"])
    stamps, poses, loop_idx, caps = [], [], [], {}
    j, k = p["warmup"], 0
    while True:
        now = time.monotonic()
        if tracing and now - t0 >= p["trace_seconds"]:
            w1 = time.time_ns() / 1e3
            prof.stop()
            tracing = False
            trace_frames = k
            Profiler.instance().reset()
        if now >= end:
            break
        prev = _snapshot(slam.frontend) if k in samples else None
        progress["frames"] = k + 1
        a = time.monotonic()
        T = feed(j)
        b = time.monotonic()
        if prev is not None:
            caps[k] = dict(prev=prev, cur=_snapshot(slam.frontend), j=j,
                           pyr=[t.clone() for t in slam.frontend.cur_pyr])
        stamps.append((a, b))
        poses.append(np.asarray(T, np.float64))
        loop_idx.append(j % n)
        j += 1
        k += 1
    if tracing:
        w1 = time.time_ns() / 1e3
        prof.stop()
        trace_frames = k
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = Profiler.instance().stats()
    keyframes = int(slam.map._kf_seq_counter) - kf0
    events = None
    if prof is not None:
        events = common.read_trace(prof)
        del prof
    del slam
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the comparison, once the window is over and the program freed
    chk = p["check"]
    inside = [m for m, (a, b) in enumerate(stamps) if b <= end]
    ate = ref_ate.segment_ate(
        np.stack([poses[m] for m in inside]) if inside
        else np.zeros((0, 7)), scene.gt[[loop_idx[m] for m in inside]],
        chk["ate_segment_frames"])
    kp = dict(win=cfg.klt_win_size, iters=cfg.max_iter,
              max_err=cfg.klt_err, max_fb_dist=cfg.max_fbklt_dist)
    nums = dict(clahe_max_err=0.0, pyramid_max_err=0.0)
    tracks, ctrl_tracks = [], []
    ctrl = dict(clahe_max_err=0.0, pyramid_max_err=0.0)
    dev = torch.device(device)
    for c in caps.values():
        pyrs = {}
        for dt in ([torch.float32, torch.bfloat16] if control
                   else [torch.float32]):
            pyrs[dt] = [ref_fe.preprocess(
                img, dt, cfg.use_clahe, cfg.clahe_val, cfg.klt_levels, dev)
                for img in (scene.left[(c["j"] - 1) % n],
                            scene.left[c["j"] % n])]
        ref_prev, ref_cur = pyrs[torch.float32]
        for key, v in ref_fe.compare_images(c["pyr"], ref_cur).items():
            nums[key] = max(nums[key], v)
        tracks.append(ref_fe.compare_tracks(
            c["prev"], c["cur"], ref_prev, ref_cur, kp, chk["track_tol_px"]))
        if control:
            low_prev, low_cur = pyrs[torch.bfloat16]
            for key, v in ref_fe.compare_images(low_cur, ref_cur).items():
                ctrl[key] = max(ctrl[key], v)
            fwd, st = ref_fe.fb_klt(
                low_prev, low_cur,
                torch.as_tensor(c["prev"]["px"], device=dev).to(
                    torch.bfloat16),
                torch.as_tensor(c["cur"]["px"], device=dev).to(
                    torch.bfloat16),
                torch.as_tensor(c["prev"]["valid"], device=dev), **kp)
            low = dict(px=fwd.float().cpu().numpy(),
                       valid=c["cur"]["valid"] & st.cpu().numpy(),
                       lmids=c["cur"]["lmids"])
            ctrl_tracks.append(ref_fe.compare_tracks(
                c["prev"], low, ref_prev, ref_cur, kp, chk["track_tol_px"]))
    nums.update(ate_rmse_m=ate, tracks=tracks)
    ctrl["tracks"] = ctrl_tracks
    return dict(index=p["index"], stamps=stamps, end=end, peak=peak,
                stats=stats, keyframes=keyframes, frames=k,
                trace_frames=trace_frames, events=events,
                w=(w0, w1) if events is not None else None, numbers=nums,
                control=ctrl if control else None,
                forbidden=common.forbidden_loaded())


def session_main(conn, p: dict, seconds: float, trace: bool, device: str,
                 control: bool = False) -> None:
    """A session's process: set-up, ``ready``, the window on ``start``,
    then ``result``, or ``error`` with the traceback and the frames the
    window had fed it."""
    progress = dict(frames=0)
    try:
        common.set_environment()
        conn.send(("result", _session(conn, p, seconds, trace, device,
                                      control, progress)))
    except Exception:
        conn.send(("error", (traceback.format_exc(), progress["frames"])))
    finally:
        conn.close()


class LocalConn:
    """One end of an in-process pipe (the tests run sessions on threads)."""

    def __init__(self, inbox: "queue.Queue", outbox: "queue.Queue"):
        self._in, self._out = inbox, outbox
        self._held = []

    def send(self, msg):
        self._out.put(msg)

    def recv(self):
        return self._held.pop() if self._held else self._in.get()

    def poll(self, timeout: float) -> bool:
        if not self._held:
            try:
                self._held.append(self._in.get(timeout=timeout))
            except queue.Empty:
                return False
        return True

    def close(self):
        pass


def _recv(conn, deadline: float):
    """The next message of a session before ``deadline``, or None."""
    left = deadline - time.monotonic()
    try:
        if left <= 0 or not conn.poll(left):
            return None
        return conn.recv()
    except (EOFError, OSError):
        return None


def _start(params, seconds, trace, device, control, inproc):
    """Starts every session; returns (connections, handles)."""
    conns, handles = [], []
    if inproc:
        for p in params:
            a, b = queue.Queue(), queue.Queue()
            th = threading.Thread(
                target=session_main, daemon=True,
                args=(LocalConn(a, b), p, seconds, trace, device, control))
            th.start()
            conns.append(LocalConn(b, a))
            handles.append(th)
        return conns, handles
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for p in params:
        mine, theirs = ctx.Pipe()
        proc = ctx.Process(target=session_main, daemon=True,
                           args=(theirs, p, seconds, trace, device,
                                 control))
        proc.start()
        theirs.close()
        conns.append(mine)
        handles.append(proc)
    return conns, handles


def _stop(handles) -> None:
    for h in handles:
        h.join(timeout=30)
        if getattr(h, "is_alive", lambda: False)() and hasattr(h, "kill"):
            h.kill()
            h.join(timeout=30)


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, inproc: bool = False, control: bool = False) -> dict:
    """One run of a fleet cell; ``inproc`` runs the sessions on threads of
    this process (the tests), ``control`` adds each session's control
    numbers (``benchmark/controls.py``)."""
    params = sessions(cell, seed)
    for p in params:
        p["trace_seconds"] = cell["traffic"]["trace_seconds"]
    if device == "cuda":
        from ov2slam_torch import kernels

        kernels.build_all()
    conns, handles = _start(params, seconds, trace, device, control, inproc)
    errors: Dict[int, tuple] = {}
    results: Dict[int, dict] = {}
    setup_parts: List[list] = []
    try:
        deadline = time.monotonic() + READY_S
        ready = set()
        for i, c in enumerate(conns):
            msg = _recv(c, deadline)
            if msg is None or msg[0] != "ready":
                errors[i] = msg[1] if msg else ("never got ready", 0)
            else:
                ready.add(i)
                setup_parts.append(msg[1]["setup"])
        t0 = time.monotonic() + 0.5
        setup_s = time.perf_counter() - t_start + 0.5
        for i in ready:
            conns[i].send(("start", t0))
        deadline = t0 + seconds + REPORT_S
        for i in ready:
            msg = _recv(conns[i], deadline)
            if msg is None or msg[0] != "result":
                errors[i] = msg[1] if msg else ("never reported", None)
            else:
                results[i] = msg[1]
    finally:
        for c in conns:
            c.close()
        _stop(handles)
    for i, (text, _) in sorted(errors.items()):
        print(f"benchmark: session {i} failed: {text}", file=sys.stderr)
    out = aggregate(cell, results, errors, seconds, setup_s, t0, trace)
    out["setup_parts"] = setup_parts
    return out


def aggregate(cell, results, errors, seconds, setup_s, t0, trace):
    """The pieces of the result line from the sessions' reports."""
    end = t0 + seconds
    lat = [1e3 * (b - a) for r in results.values() for a, b in r["stamps"]
           if b <= end]
    # a failed session's frames fail: those the window fed it, or, where it
    # never reported, as many as a sound session completed (at least one)
    mean = len(lat) // len(results) if results else 0
    failed = sum(max(1, mean if n is None else n)
                 for _, n in errors.values())
    attempted = len(lat) + failed
    chk = cell["check"]
    nums = [r["numbers"] for r in results.values()]
    tracks = [t for x in nums for t in x["tracks"]]
    checks = {
        "failed_sessions": (float(len(errors)), 0, "<="),
        "ate_rmse_m": (max([x["ate_rmse_m"] for x in nums] or [float("inf")]),
                       chk["limits"]["ate_rmse_m"], "<="),
        "clahe_max_err": (max([x["clahe_max_err"] for x in nums] or [0.0]),
                          chk["limits"]["clahe_max_err"], "<="),
        "pyramid_max_err": (max([x["pyramid_max_err"] for x in nums]
                                or [0.0]),
                            chk["limits"]["pyramid_max_err"], "<="),
        "klt_mismatch_share": (mismatch_share(tracks),
                               chk["limits"]["klt_mismatch_share"], "<="),
    }
    tr = None
    if trace and results and all(r["events"] is not None
                                 for r in results.values()):
        w0 = max(r["w"][0] for r in results.values())
        w1 = min(r["w"][1] for r in results.values())
        tr = common.reduce_traces([r["events"] for r in results.values()],
                                  w0, w1)
        tr["frames"] = sum(r["trace_frames"] for r in results.values())
    after = [1e3 * (b - a) for r in results.values()
             for m, (a, b) in enumerate(r["stamps"])
             if b <= end and m >= r["trace_frames"]]
    obs = dict(trace=tr, frame_ms=after,
               scopes=merge_stats([r["stats"] for r in results.values()]))
    e2e = {"slam_frames_per_s": (len(lat) / seconds, "frames/s"),
           "slam_frame_ms_p95": (common.quantile(lat, 0.95) if lat
                                 else float("inf"), "ms")}
    return dict(
        setup_s=setup_s, attempted=attempted, failed=failed, e2e=e2e,
        obs=obs, checks=checks,
        memory_peak=sum(r["peak"] for r in results.values()), chips=1,
        trace=tr,
        per_session=[dict(index=r["index"], frames=r["frames"],
                          keyframes=r["keyframes"],
                          ate_rmse_m=r["numbers"]["ate_rmse_m"],
                          tracks=r["numbers"]["tracks"],
                          control=r["control"])
                     for r in results.values()],
        forbidden=sorted({m for r in results.values()
                          for m in r["forbidden"]}))


def mismatch_share(tracks: List[dict]) -> float:
    """The share of the compared tracks that the reference lost or lands
    away from the program's; 1 with none compared."""
    n = sum(t["tracked"] for t in tracks)
    return sum(t["lost"] + t["far"] for t in tracks) / n if n else 1.0


def merge_stats(stats: List[dict]) -> dict:
    """The sessions' ``Profiler`` scopes pooled: calls and mean ms."""
    out: Dict[str, dict] = {}
    for s in stats:
        for name, st in s.items():
            o = out.setdefault(name, dict(n=0, total_ms=0.0))
            o["n"] += st["n"]
            o["total_ms"] += st["n"] * st["mean_ms"]
    return {k: dict(n=v["n"], mean_ms=v["total_ms"] / v["n"])
            for k, v in out.items() if v["n"]}
