"""End-to-end parity of the port's SlamManager against the JAX package's,
both on the CPU: stereo, synchronous, loop closer on (relocalizer off).

The sequence is the first 30 frames of a 120-frame circular stereo loop at
188x120 (so the camera turns 3° per frame, as on the chip-smoke slices),
with ``lc_recent_mask`` = 3 so the place index scores every keyframe from
the fourth on. RANSAC streams differ between the two packages, so the
trajectories are compared by outcome: equal keyframe counts, equal numbers
of index queries, both ATEs finite and within 0.01 m of each other.

From the JAX run's final state, the map and place index are carried over
(ov2slam_torch.interop) and one local BA and one index query are compared
from the same state.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ov2slam_torch import interop
from ov2slam_torch.models.estimator import Estimator as TEstimator
from ov2slam_torch.models.slam import SlamManager as TSlam
from ov2slam_torch.utils import config as tconfig
from ov2slam_tpu.io.synthetic import SyntheticSequence, stream_sequence
from ov2slam_tpu.models.slam import SlamManager as JSlam
from ov2slam_tpu.utils.evaluation import ate_rmse

torch.set_num_threads(1)


def port_config(cfg):
    """The same configuration values in the port's own config classes."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for k in ("cam_left", "cam_right"):
        if d[k] is not None:
            d[k] = tconfig.CameraConfig(**{
                f.name: getattr(d[k], f.name)
                for f in dataclasses.fields(d[k])})
    return tconfig.SlamConfig(**d)


def partial_loop(width, height, n_loop, n_run, n_points, seed=6):
    st = stream_sequence(n_frames=n_loop, stereo=True, width=width,
                         height=height, n_points=n_points, seed=seed,
                         speed=0.06, kind="loop", realism=None)
    frames = [st.frame(i) for i in range(n_run)]
    return SyntheticSequence(
        times=st.times[:n_run], gt_poses=st.gt_poses[:n_run],
        images_left=[f[0] for f in frames],
        images_right=[f[1] for f in frames], K=st.K, T_lr=st.T_lr,
        points=st.points, width=width, height=height)


def run(slam, seq):
    for i in range(len(seq.times)):
        slam.process_frame(seq.images_left[i], seq.images_right[i],
                           float(seq.times[i]))
    _, poses = slam.estimated_trajectory()
    return poses


@pytest.fixture(scope="module")
def runs():
    seq = partial_loop(188, 120, 120, 30, 3000)
    cfg = seq.make_config(
        max_keyframes=64, max_landmarks=8192, use_fast=False,
        use_singlescale_detector=True, max_dist=20, use_loop_closer=True,
        use_relocalizer=False, lc_recent_mask=3, lc_min_score=0.2)
    j = JSlam(cfg)
    jp = run(j, seq)
    t = TSlam(port_config(cfg), device="cpu")
    tp = run(t, seq)
    return seq, cfg, j, jp, t, tp


def test_slam_trajectories_agree(runs):
    seq, _, j, jp, t, tp = runs
    assert tp.shape == jp.shape == seq.gt_poses.shape
    assert np.isfinite(tp).all() and np.isfinite(jp).all()
    assert t.map._kf_seq_counter == j.map._kf_seq_counter >= 8
    assert t.n_resets == j.n_resets == 0
    # every keyframe queried, then entered, the place index
    assert len(t.loop_closer.index.kf_ids) == len(j.loop_closer.index.kf_ids)
    ate_t = ate_rmse(tp, seq.gt_poses, align_scale=False)
    ate_j = ate_rmse(jp, seq.gt_poses, align_scale=False)
    assert abs(ate_t - ate_j) < 0.01, (ate_t, ate_j)
    assert ate_t < 0.15


def test_write_results(runs, tmp_path):
    seq, _, _, _, t, tp = runs
    t.write_results(str(tmp_path))
    traj = np.loadtxt(tmp_path / "ov2slam_traj.txt")
    assert traj.shape == (len(seq.times), 8)
    np.testing.assert_allclose(traj[:, 1:4], tp[:, 4:7], atol=1e-5)
    for name in ("ov2slam_kfs_traj.txt", "ov2slam_traj_kitti.txt",
                 "ov2slam_full_traj_wlc.txt"):
        assert (tmp_path / name).stat().st_size > 0


def test_index_query_from_carried_state(runs):
    # scores are integer counts over one f32 division: exact
    _, _, j, _, _, _ = runs
    jx = j.loop_closer.index
    n = len(jx.kf_ids)
    tx = interop.place_index(jx._desc[:n], jx._valid[:n], jx.kf_ids,
                             jx.kf_seqs, jx.capacity, device="cpu",
                             recent_mask=jx.recent_mask,
                             island_radius=jx.island_radius,
                             min_score=jx.min_score,
                             match_bits=jx.match_bits)
    q, qv = jx._desc[n - 2], jx._valid[n - 2]
    np.testing.assert_array_equal(tx._raw_scores(q, qv, n),
                                  jx._raw_scores(q, qv, n))
    assert tx.query(q, qv) == jx.query(q, qv)


def test_local_ba_from_carried_state(runs):
    # same map, same window: f32 solves with differently ordered sums
    # agree to 1e-3 on poses and landmark positions
    _, cfg, j, _, t, _ = runs
    m = interop.map_store(vars(j.map), port_config(cfg))
    est = TEstimator(port_config(cfg), t.cam_l, t.cam_r, m)
    kf = int(np.nonzero(j.map.kf_valid)[0][
        np.argmax(j.map.kf_seq[j.map.kf_valid])])
    n_t = est.local_ba(kf)
    n_j = j.estimator.local_ba(kf)
    assert n_t == n_j > 20
    np.testing.assert_allclose(m.kf_poses[m.kf_valid],
                               j.map.kf_poses[j.map.kf_valid], atol=1e-3)
    live = j.map.lm_valid & j.map.lm_is3d
    np.testing.assert_array_equal(m.lm_valid & m.lm_is3d, live)
    np.testing.assert_allclose(m.lm_pos[live], j.map.lm_pos[live],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["stereo", "loop"])
def test_port_meets_e2e_gates(case):
    """The gates of test_slam_e2e.py::test_stereo_slam_synthetic and
    ::test_loop_closure_on_circular_trajectory, met by the port with the
    loop closer on and the relocalizer off."""
    from ov2slam_torch.io.synthetic import generate_sequence

    if case == "stereo":
        seq = generate_sequence(n_frames=40, stereo=True, width=376,
                                height=240, n_points=3000, seed=3,
                                speed=0.06)
        cfg = seq.make_config(max_keyframes=64, max_landmarks=8192,
                              use_fast=False, use_singlescale_detector=True,
                              max_dist=30, use_loop_closer=True,
                              use_relocalizer=False)
    else:
        seq = generate_sequence(n_frames=160, stereo=True, width=376,
                                height=240, n_points=4000, seed=6,
                                speed=0.06, kind="loop")
        cfg = seq.make_config(max_keyframes=128, max_landmarks=16384,
                              use_fast=False, use_singlescale_detector=True,
                              max_dist=30, use_loop_closer=True,
                              lc_recent_mask=10, lc_min_score=0.2,
                              use_relocalizer=False)
    slam = TSlam(cfg, device="cpu")
    poses = run(slam, seq)
    ate = ate_rmse(poses, seq.gt_poses, align_scale=False)
    if case == "stereo":
        assert slam.map.n_keyframes >= 2
        assert slam.map.n_landmarks_3d > 50
        assert ate < 0.05, f"stereo ATE {ate:.3f} m"
    else:
        assert slam.loop_closer.n_closures >= 1, "loop never closed"
        assert slam.n_resets == 0
        assert ate < 0.09, f"loop ATE {ate:.3f} m"
        end_err = np.linalg.norm(poses[-1, 4:7] - seq.gt_poses[-1, 4:7])
        assert end_err < 0.07, f"endpoint error {end_err:.3f} m"
