"""The port's online pipeline on the CPU: AsyncSlamManager, the replay
runner and the EuRoC reader.

- a short asynchronous run with the loop closer on (tier 1): no worker
  error, keyframes made, bounded ATE, the worker joined by ``close()``;
- the counterparts of tests/test_pipeline.py's asynchronous tests and of
  test_slam_e2e.py::test_loop_closure_chained_frontend, with the JAX
  tests' gates and their ``slow`` mark;
- the counterparts of tests/test_io.py's runner and EuRoC tests.

Asynchronous runs depend on thread timing, so they are held to gates, not
to the JAX package's digits (test_torch_chained.py holds the synchronous
pipelined manager to those).
"""

import threading
import time as _t

import numpy as np
import pytest
import torch

from ov2slam_torch.io.euroc import EurocDataset, write_asl_sequence
from ov2slam_torch.io.runner import run_sequence
from ov2slam_torch.io.synthetic import generate_sequence
from ov2slam_torch.models.pipeline import AsyncSlamManager, TurnLock
from ov2slam_torch.models.slam import SlamManager
from ov2slam_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)


def _feed(slam, seq):
    for i in range(len(seq.times)):
        slam.process_frame(seq.images_left[i], seq.images_right[i],
                           float(seq.times[i]))


def _close(slam):
    slam.close()
    assert not slam._worker.is_alive(), "worker not joined"


@pytest.mark.parametrize("chained", [False, True])
def test_async_short_run_with_loop_closer(chained):
    seq = generate_sequence(n_frames=20, stereo=True, width=376, height=240,
                            n_points=3000, seed=3, speed=0.06)
    cfg = seq.make_config(max_keyframes=64, max_landmarks=8192,
                          use_fast=False, use_singlescale_detector=True,
                          max_dist=30, use_loop_closer=True,
                          use_relocalizer=False, lc_recent_mask=1,
                          pipelined_frontend=chained, pipeline_depth=2)
    slam = AsyncSlamManager(cfg, device="cpu")
    try:
        _feed(slam, seq)
        _, poses = slam.estimated_trajectory()
        assert slam.n_worker_errors == 0
        assert slam.map.n_keyframes >= 2
        # the loop closer ran on the worker (it skips a keyframe drained
        # together with a newer one, as the reference does under pressure)
        assert len(slam.loop_closer.index.kf_ids) >= 1
        assert poses.shape == seq.gt_poses.shape
        ate = ate_rmse(poses, seq.gt_poses, align_scale=False)
        assert ate < 0.15, f"async ATE {ate:.3f} m"
    finally:
        _close(slam)


def test_async_worker_holds_the_map_lock_through_a_keyframe():
    # the worker maps a keyframe, runs its local BA and the loop closer's
    # place query and add under the map lock (taken again inside, as it
    # is reentrant), yielding it to a waiting frame between LM
    # iterations; the closer's verification cascade runs without it, so
    # it never blocks the front end
    seq = generate_sequence(n_frames=20, stereo=True, width=376, height=240,
                            n_points=3000, seed=3, speed=0.06)
    cfg = seq.make_config(max_keyframes=64, max_landmarks=8192,
                          use_fast=False, use_singlescale_detector=True,
                          max_dist=30, use_loop_closer=True,
                          use_relocalizer=False, lc_recent_mask=1,
                          pipelined_frontend=True, pipeline_depth=2)
    slam = AsyncSlamManager(cfg, device="cpu")
    held = {"map": [], "ba": [], "query": [], "cascade": []}

    def watch(obj, name, key, result=None):
        orig = getattr(obj, name)

        def wrapped(*a, **k):
            held[key].append(slam.map_lock.owned())
            out = orig(*a, **k)
            return out if result is None else result(a, k, out)
        setattr(obj, name, wrapped)

    watch(slam.mapper, "process_keyframe", "map")
    watch(slam.estimator, "local_ba", "ba",
          lambda a, k, out: held["ba"].append(
              k["between_iters"] == slam.map_lock.yield_turn) or out)
    # every query hands the cascade a candidate (the keyframe itself),
    # which the cascade's watch records and rejects
    watch(slam.loop_closer, "query_keyframe", "query",
          lambda a, k, out: out or (a[0], a[0], 0, 0))
    watch(slam.loop_closer, "close_candidate", "cascade")
    slam.loop_closer._process_candidate = lambda *a, **k: False
    try:
        _feed(slam, seq)
        slam.flush()
        assert slam.n_worker_errors == 0
        assert all(held.values()), held
        assert all(held["map"]) and all(held["ba"]), held
        assert all(held["query"]), held
        assert not any(held["cascade"]), held
        assert len(held["cascade"]) == len(held["query"])
        _, poses = slam.estimated_trajectory()
        ate = ate_rmse(poses, seq.gt_poses, align_scale=False)
        assert ate < 0.15, f"async ATE {ate:.3f} m"
    finally:
        _close(slam)


def _blocked(lock, n=1, timeout=5.0):
    """Wait until ``n`` threads wait for ``lock``."""
    t_end = _t.time() + timeout
    while lock._waiting < n:
        assert _t.time() < t_end, "no thread came to wait for the lock"
        _t.sleep(0.001)


def test_turn_lock_hands_over_at_a_yield_point():
    # the worker's yield point: with no frame waiting it keeps the lock;
    # with one waiting, that frame runs its turn at once and the worker
    # takes the lock back after it, at the depth it held, before a frame
    # that came to wait during the turn
    lock = TurnLock()
    order = []

    def frame(name):
        with lock:
            order.append(name)
            if name == "frame 1":
                threading.Thread(target=frame, args=("frame 2",),
                                 daemon=True).start()
                _blocked(lock)

    with lock:
        with lock:
            assert not lock.yield_turn()
            first = threading.Thread(target=frame, args=("frame 1",),
                                     daemon=True)
            first.start()
            _blocked(lock)
            order.append("worker before")
            assert lock.yield_turn()
            order.append("worker after")
            assert lock.owned() and lock.handoffs == 1
        assert lock.owned()
    first.join(5.0)
    assert not first.is_alive()
    t_end = _t.time() + 5.0
    while len(order) < 4:
        assert _t.time() < t_end, order
        _t.sleep(0.001)
    assert order == ["worker before", "frame 1", "worker after", "frame 2"]
    assert not lock.owned()
    with pytest.raises(RuntimeError):
        lock.release()
    with pytest.raises(RuntimeError):
        lock.yield_turn()


def test_async_manager_requires_gpu_by_default(monkeypatch):
    cfg = generate_sequence(n_frames=2, width=96, height=64,
                            n_points=50).make_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncSlamManager(cfg)


def test_worker_error_is_counted_and_worker_survives():
    # the worker keeps the JAX package's catch-and-count: a failing
    # keyframe is counted, the backpressure count recovers, and the next
    # keyframes are processed
    seq = generate_sequence(n_frames=14, stereo=True, width=188, height=120,
                            n_points=1500, seed=3, speed=0.08)
    cfg = seq.make_config(max_keyframes=32, max_landmarks=4096,
                          use_fast=False, use_singlescale_detector=True,
                          max_dist=20)
    slam = AsyncSlamManager(cfg, device="cpu")
    orig = slam.mapper.process_keyframe
    calls = []

    def fail_once(*a, **kw):
        calls.append(a[0])
        if len(calls) == 1:
            raise RuntimeError("injected")
        return orig(*a, **kw)

    slam.mapper.process_keyframe = fail_once
    try:
        _feed(slam, seq)
        slam.flush()
        assert slam.n_worker_errors == 1
        assert len(calls) >= 2
        assert slam._unmapped == 0 and slam._pending == 0
    finally:
        _close(slam)


# ---------------------------------------------------------------------- #
# counterparts of tests/test_pipeline.py (slow)
# ---------------------------------------------------------------------- #

@pytest.mark.slow
def test_async_stereo_slam():
    seq = generate_sequence(n_frames=40, stereo=True, width=376, height=240,
                            n_points=3000, seed=3, speed=0.06)
    cfg = seq.make_config(max_keyframes=64, max_landmarks=8192,
                          use_fast=False, use_singlescale_detector=True,
                          max_dist=30)
    slam = AsyncSlamManager(cfg, device="cpu")
    try:
        _feed(slam, seq)
        slam.flush()
        _, poses = slam.estimated_trajectory()
        assert slam.map.n_keyframes >= 2
        assert slam.n_worker_errors == 0
        ate = ate_rmse(poses, seq.gt_poses, align_scale=False)
        assert ate < 0.15, f"async stereo ATE {ate:.3f} m"
    finally:
        _close(slam)


@pytest.mark.slow
def test_async_stress_backlog_and_fold():
    """Forced backlog (tiny queue + randomized worker delays) over a long
    sequence with tight capacities: no worker errors, no capacity
    violations, skipped KFs folded into the BA window, bounded ATE."""
    seq = generate_sequence(n_frames=120, stereo=True, width=376,
                            height=240, n_points=3000, seed=8, speed=0.06)
    cfg = seq.make_config(max_keyframes=24, max_landmarks=4096,
                          use_fast=False, use_singlescale_detector=True,
                          max_dist=30)
    cfg.kf_filtering_ratio = 0.7   # culling active → recycling under async
    # the port's front end waits for each keyframe's mapping up to
    # backpressure_wait_s (the JAX package's waits only past one unmapped
    # keyframe); not waiting lets the stalled mapper backlog, as here
    cfg.backpressure_wait_s = 0.0
    slam = AsyncSlamManager(cfg, queue_size=2, device="cpu")

    folded = []
    orig_ba = slam.estimator.local_ba

    def spy_ba(kfid, lock=None, extra_window=(), between_iters=None):
        folded.extend(int(k) for k in extra_window)
        return orig_ba(kfid, lock=lock, extra_window=extra_window,
                       between_iters=between_iters)

    slam.estimator.local_ba = spy_ba
    rng = np.random.default_rng(0)
    orig_pk = slam.mapper.process_keyframe

    def slow_pk(*a, **kw):
        _t.sleep(float(rng.uniform(0.0, 0.08)))
        return orig_pk(*a, **kw)

    slam.mapper.process_keyframe = slow_pk
    try:
        _feed(slam, seq)
        slam.flush()
        assert slam.n_worker_errors == 0
        assert slam.map.n_keyframes >= 2
        m = slam.map
        with slam.map_lock:
            for k in np.nonzero(m.kf_valid)[0]:
                lm = m.obs_lmid[k]
                for slot in np.nonzero(lm >= 0)[0]:
                    l = int(lm[slot])
                    assert m.lm_valid[l], (k, slot, l)
                    assert (m.lm_obs_kf[l] == k).any(), (k, l)
        _, poses = slam.estimated_trajectory()
        ate = ate_rmse(poses, seq.gt_poses, align_scale=False)
        assert ate < 0.45, f"stressed async ATE {ate:.3f} m"
    finally:
        _close(slam)
    assert len(folded) >= 1, "backlog never happened — stress ineffective"


@pytest.mark.slow
def test_async_paced_arrival_bench_conditions():
    """752x480 stereo with full photometric realism and paced arrival with
    force_realtime dropping, chained front end at depth 2, `fast` profile
    (the protocol is chip_smoke.paced_arrival, which slice F runs on the
    card): <= 10% of the paced frames dropped, ATE < 0.05 m."""
    from chip_smoke import paced_arrival
    from ov2slam_torch.io.synthetic import DEFAULT_REALISM, stream_sequence
    from ov2slam_torch.utils.profiles import apply_profile

    n_frames, n_warm = 110, 30
    seq = stream_sequence(n_frames=n_frames, stereo=True, width=752,
                          height=480, n_points=8000, seed=0, kind="arc",
                          speed=0.05, realism=DEFAULT_REALISM)
    frames = list(seq)
    cfg = seq.make_config()
    apply_profile(cfg, "fast")
    cfg.pipelined_frontend = True
    cfg.pipeline_depth = 2
    cfg.validate()
    slam = AsyncSlamManager(cfg, device="cpu")
    try:
        n_dropped, pace_fps, *_ = paced_arrival(slam, frames, n_warm)
        assert slam.n_worker_errors == 0
        times, poses = slam.estimated_trajectory()
        gt_t = np.asarray(seq.times)
        gt = np.asarray(seq.gt_poses)
        idx = np.clip(np.searchsorted(gt_t, times), 0, len(gt) - 1)
        ate = ate_rmse(poses, gt[idx], align_scale=False)
        assert n_dropped <= 0.10 * (n_frames - n_warm), \
            f"dropped {n_dropped}/{n_frames - n_warm} at 75% pacing"
        assert ate < 0.05, \
            f"paced async ATE {ate:.3f} m ({len(times)} frames, " \
            f"{n_dropped} dropped, pace {pace_fps:.1f} fps)"
    finally:
        _close(slam)


@pytest.mark.slow
def test_loop_closure_chained_frontend():
    """test_slam_e2e.py::test_loop_closure_chained_frontend on the port:
    the device-chained front end on the rotation-heavy loop."""
    seq = generate_sequence(n_frames=160, stereo=True, width=376, height=240,
                            n_points=4000, seed=6, speed=0.06, kind="loop")
    cfg = seq.make_config(max_keyframes=128, max_landmarks=16384,
                          use_fast=False, use_singlescale_detector=True,
                          max_dist=30, use_loop_closer=True,
                          lc_recent_mask=10, lc_min_score=0.2,
                          use_relocalizer=False)
    cfg.pipelined_frontend = True
    cfg.pipeline_depth = 2
    slam = SlamManager(cfg, device="cpu")
    _feed(slam, seq)
    _, poses = slam.estimated_trajectory()
    assert slam.loop_closer.n_closures >= 1, "loop never closed (chained)"
    assert slam.n_resets == 0
    ate = ate_rmse(poses, seq.gt_poses, align_scale=False)
    assert ate < 0.10, f"chained loop ATE {ate:.3f} m"
    end_err = np.linalg.norm(poses[-1, 4:7] - seq.gt_poses[-1, 4:7])
    assert end_err < 0.08, f"chained endpoint error {end_err:.3f} m"


# ---------------------------------------------------------------------- #
# counterparts of tests/test_io.py
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def asl_dir(tmp_path_factory):
    seq = generate_sequence(n_frames=6, stereo=True, width=200, height=160,
                            n_points=800, seed=10)
    root = tmp_path_factory.mktemp("euroc")
    write_asl_sequence(seq, str(root))
    return str(root), seq


def test_euroc_reader_roundtrip(asl_dir):
    root, seq = asl_dir
    ds = EurocDataset(root)
    assert ds.stereo
    assert len(ds) == 6
    frames = list(ds)
    left0, right0, t0 = frames[0]
    assert left0.shape == (160, 200)
    assert right0.shape == (160, 200)
    assert abs(t0 - seq.times[0]) < 1e-6
    assert np.abs(left0 - seq.images_left[0]).max() <= 1.0
    times, poses = ds.ground_truth()
    np.testing.assert_allclose(times, seq.times, atol=1e-6)
    np.testing.assert_allclose(poses[:, 4:], seq.gt_poses[:, 4:], atol=1e-9)


def test_euroc_reader_mono(asl_dir):
    root, _ = asl_dir
    ds = EurocDataset(root, stereo=False)
    assert not ds.stereo
    _, right, _ = next(iter(ds))
    assert right is None


def _runner_cfg(seq, **over):
    return seq.make_config(max_keyframes=32, max_landmarks=4096,
                           use_fast=False, use_singlescale_detector=True,
                           max_dist=30, **over)


def test_runner_on_synthetic(tmp_path):
    seq = generate_sequence(n_frames=12, stereo=True, width=376, height=240,
                            n_points=2500, seed=11, speed=0.05)
    cfg = _runner_cfg(seq)
    res = run_sequence(cfg, seq, slam=SlamManager(cfg, device="cpu"),
                       out_dir=str(tmp_path))
    assert res.n_processed == 12
    assert res.n_keyframes >= 1
    assert res.ate is not None and res.ate < 0.1
    assert (tmp_path / "ov2slam_traj.txt").exists()
    assert (tmp_path / "viewer.html").exists()


def test_runner_drives_the_async_manager():
    seq = generate_sequence(n_frames=12, stereo=True, width=376, height=240,
                            n_points=2500, seed=11, speed=0.05)
    cfg = _runner_cfg(seq)
    slam = AsyncSlamManager(cfg, device="cpu")
    try:
        res = run_sequence(cfg, seq, slam=slam)
        assert slam.n_worker_errors == 0
    finally:
        _close(slam)
    assert res.n_processed == 12
    assert res.ate is not None and res.ate < 0.1


def test_euroc_e2e_dense_body_frame_gt(tmp_path):
    """200 Hz GT in the body frame: the runner associates by timestamp
    and applies body_T_cam0."""
    from ov2slam_torch.utils import lie_np

    seq = generate_sequence(n_frames=14, stereo=True, width=376, height=240,
                            n_points=2500, seed=13, speed=0.05)
    T_bc = lie_np.make_pose(lie_np.so3_exp([0.1, -0.2, 0.3]),
                            np.array([0.05, -0.02, 0.1]))
    root = tmp_path / "mh"
    write_asl_sequence(seq, str(root), gt_rate_hz=200.0, T_body_cam=T_bc)
    ds = EurocDataset(str(root))
    gt_times, gt_body = ds.ground_truth()
    assert len(gt_times) > 5 * len(ds)
    cfg = _runner_cfg(seq)
    res = run_sequence(cfg, iter(ds), gt_poses=gt_body, gt_times=gt_times,
                       T_body_cam=T_bc, slam=SlamManager(cfg, device="cpu"))
    assert res.n_processed == 14
    assert res.ate is not None and res.ate < 0.1


def test_runner_realtime_drops_frames():
    seq = generate_sequence(n_frames=12, stereo=True, width=376, height=240,
                            n_points=2500, seed=12, speed=0.05,
                            fps=1e6)  # absurd rate: forces drops
    cfg = _runner_cfg(seq, force_realtime=True)
    res = run_sequence(cfg, seq, slam=SlamManager(cfg, device="cpu"))
    assert res.n_dropped > 0
    assert res.n_processed + res.n_dropped == 12


def test_runner_builds_its_manager_on_the_gpu(monkeypatch):
    seq = generate_sequence(n_frames=2, width=96, height=64, n_points=50)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sequence(seq.make_config(), seq)
