"""End-to-end parity of the port's monocular SlamManager against the JAX
package's, both on the CPU: 40 frames of tests/test_slam_e2e.py::
test_mono_slam_synthetic's sequence at 188x120, loop closer, relocalizer
and full BA on, results written.

RANSAC streams differ between the packages, so the runs are compared by
outcome: the same initialization frame, keyframe count and resets, and
post-init ATEs (scale-aligned) within 0.01 m of each other. The port's
``write_results`` writes all six result files, its full-BA keyframe
trajectory no further from the truth (scale-aligned) than the logged
keyframes, to 0.01 m.
"""

import numpy as np
import pytest
import torch

import ov2slam_torch.models.slam as tslam
import ov2slam_tpu.models.slam as jslam
from ov2slam_tpu.io.synthetic import generate_sequence
from ov2slam_tpu.utils.evaluation import ate_rmse
from tests.test_torch_slam import port_config

torch.set_num_threads(1)


def small_mono(n_frames=40):
    seq = generate_sequence(n_frames=n_frames, stereo=False, width=188,
                            height=120, n_points=3000, seed=4, speed=0.08)
    # a finer grid and a shallower pyramid than make_config's defaults:
    # at 188x120 the default 60-cell grid tracks fewer than the 30
    # keypoints mono initialization needs
    cfg = seq.make_config(use_loop_closer=True, reloc_min_interval_s=0.0,
                          do_full_ba=True, klt_pyr_lvl=2, max_dist=12)
    return seq, cfg


def post_init_ate(poses, gt):
    move = np.nonzero(np.linalg.norm(poses[:, 4:7], axis=1) > 1e-6)[0]
    return int(move[0]), len(move), ate_rmse(poses[move[0]:], gt[move[0]:],
                                             align_scale=True)


@pytest.fixture(scope="module")
def mono_runs(tmp_path_factory):
    seq, cfg = small_mono()
    out = {}
    for name, slam in (("jax", jslam.SlamManager(cfg)),
                       ("torch", tslam.SlamManager(port_config(cfg),
                                                   device="cpu"))):
        for i in range(len(seq.times)):
            slam.process_frame(seq.images_left[i], None, float(seq.times[i]))
        out[name] = (slam, slam.estimated_trajectory()[1])
    return seq, out


def test_mono_slam_agrees_with_reference(mono_runs):
    seq, out = mono_runs
    (j, jp), (t, tp) = out["jax"], out["torch"]
    assert t.frontend.initialized and j.frontend.initialized
    assert t.relocalizer is not None and t.cam_r is None
    s_t, n_t, ate_t = post_init_ate(tp, seq.gt_poses)
    s_j, n_j, ate_j = post_init_ate(jp, seq.gt_poses)
    assert s_t == s_j and n_t == n_j >= 15
    assert t.map._kf_seq_counter == j.map._kf_seq_counter
    assert t.n_resets == j.n_resets
    assert abs(ate_t - ate_j) < 0.01 and ate_t < 0.08, (ate_t, ate_j)


def test_mono_write_results(mono_runs, tmp_path):
    """All six result files (`writeResults`); the full-BA keyframe
    trajectory at the logged keyframes' times, as close to the truth
    (scale-aligned) as the logged keyframe poses, to 0.01 m."""
    seq, out = mono_runs
    out["torch"][0].write_results(str(tmp_path))
    names = ("ov2slam_traj.txt", "ov2slam_kfs_traj.txt",
             "ov2slam_traj_kitti.txt", "ov2slam_fullba_kfs_traj.txt",
             "ov2slam_full_traj_wlc.txt", "ov2slam_full_traj_wlc_opt.txt")
    for name in names:
        assert (tmp_path / name).stat().st_size > 0, name
    logged = np.loadtxt(tmp_path / "ov2slam_kfs_traj.txt")
    after = np.loadtxt(tmp_path / "ov2slam_fullba_kfs_traj.txt")
    np.testing.assert_array_equal(after[:, 0], logged[:, 0])
    opt = np.loadtxt(tmp_path / "ov2slam_full_traj_wlc_opt.txt")
    assert opt.shape == (len(seq.times), 8) and np.isfinite(opt).all()

    def kf_ate(tum):
        idx = [int(np.argmin(np.abs(seq.times - x))) for x in tum[:, 0]]
        est = np.zeros((len(tum), 7))
        est[:, 4:7] = tum[:, 1:4]
        return ate_rmse(est, seq.gt_poses[idx], align_scale=True)

    assert kf_ate(after) < kf_ate(logged) + 0.01
