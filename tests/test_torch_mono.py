"""Parity: the port's monocular initialization
(``SlamManager._check_mono_init``) against
``ov2slam_tpu``; the end-to-end run is in test_torch_mono_e2e.py.

``_check_mono_init`` runs on the same synthetic two-view state in both
packages with the same injected RANSAC samples (the JAX side composed from
its own five_point / eight_point / decompose_essential on those samples):
the same inlier set, the initialized pose to 1e-5 and the triangulated
landmarks to 1e-4 m (f32 on both sides).

The full-size gate of tests/test_slam_e2e.py::test_mono_slam_synthetic runs
on the port under ``slow``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ov2slam_torch.models.slam as tslam
import ov2slam_tpu.models.slam as jslam
from ov2slam_torch.geometry import essential as te
from ov2slam_tpu.geometry import essential as je
from ov2slam_tpu.io.synthetic import generate_sequence
from ov2slam_tpu.utils import lie_np
from tests.test_torch_slam import port_config

torch.set_num_threads(1)


def jax_relative_pose_ransac(idx5, idx8):
    """The JAX package's relative_pose_ransac on given samples."""
    import jax

    def fn(key, x_l, x_r, valid, focal, err_th_px, n_iters=100):
        E5, v5 = jax.vmap(je.five_point)(x_l[idx5], x_r[idx5])
        ok5 = (valid[idx5].all(-1)[:, None] & v5).reshape(-1)
        E8 = je.eight_point(x_l[idx8], x_r[idx8])
        E = jnp.concatenate([E5.reshape(-1, 3, 3), E8])
        ok = jnp.concatenate([ok5, valid[idx8].all(-1)])
        finite = jnp.isfinite(E).all((-2, -1))
        ok = ok & finite
        E = jnp.where(finite[:, None, None], E, 0.0)
        th = (err_th_px / focal) ** 2
        d2 = je.sampson_dist_sq(E, x_l[None], x_r[None])
        inl = (d2 < th) & valid[None]
        q = jnp.where(ok, jnp.where(inl, 1.0 - d2 / th, 0.0).sum(-1), -1.0)
        best = jnp.argmax(q)
        T, _ = je.decompose_essential(E[best], x_l, x_r, inl[best])
        return T, inl[best], inl[best].sum()

    return fn


def two_view_state(slam, rng, n=80):
    """KF0 at the origin observing n landmarks, and a current frame after a
    0.8 m move whose tracks see them with 0.3 px noise (4 outliers)."""
    cfg = slam.cfg
    fx, fy, cx, cy = (cfg.cam_left.fx, cfg.cam_left.fy, cfg.cam_left.cx,
                      cfg.cam_left.cy)
    pts = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 7.0], size=(n, 3))
    T_rel = np.concatenate([lie_np.so3_exp(np.array([0.01, -0.03, 0.02])),
                            [0.8, 0.05, 0.1]])

    def px(T_wc):
        pc = lie_np.pose_apply(lie_np.pose_inverse(T_wc), pts)
        return np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                         fy * pc[:, 1] / pc[:, 2] + cy], -1)

    N = cfg.max_kps
    kf_px = np.zeros((N, 2), np.float32)
    kf_px[:n] = px(lie_np.pose_identity())
    cur = np.zeros((N, 2), np.float32)
    cur[:n] = px(T_rel) + rng.normal(0, 0.3, (n, 2))
    cur[:4] += 25.0
    m = slam.map
    lmids = np.full(N, -1, np.int32)
    lmids[:n] = m.new_landmarks(n)
    kf = m.add_keyframe(0.0, lie_np.pose_identity().astype(np.float32),
                        lmids, kf_px, np.zeros((N, 8), np.uint32))
    f = slam.frontend.frame
    f.px[:], f.px_und[:] = cur, cur
    f.lmids[:] = lmids
    f.valid[:] = lmids >= 0
    f.kf_id = kf
    f.time = 0.1
    f.T_wc = lie_np.pose_identity().astype(np.float32)
    return T_rel


def test_check_mono_init_with_injected_samples(rng, monkeypatch):
    seq = generate_sequence(n_frames=2, stereo=False, width=188, height=120,
                            n_points=50)
    cfg = seq.make_config(use_loop_closer=False)
    j = jslam.SlamManager(cfg)
    t = tslam.SlamManager(port_config(cfg), device="cpu")
    T_rel = two_view_state(j, np.random.default_rng(3))
    two_view_state(t, np.random.default_rng(3))
    n = 80
    idx5 = rng.integers(0, n, (cfg.ransac_iter, 5))
    idx8 = rng.integers(0, n, (max(cfg.ransac_iter // 4, 4), 8))
    monkeypatch.setattr(jslam, "relative_pose_ransac",
                        jax_relative_pose_ransac(idx5, idx8))
    monkeypatch.setattr(tslam, "relative_pose_ransac", functools.partial(
        te.relative_pose_ransac, idx5=torch.as_tensor(idx5),
        idx8=torch.as_tensor(idx8)))

    assert j._check_mono_init() and t._check_mono_init()
    assert j.frontend.initialized and t.frontend.initialized
    Tj = j.frontend.frame.T_wc.astype(np.float64)
    Tt = t.frontend.frame.T_wc.astype(np.float64)
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    # the scale is fixed to 0.25 along the true direction of motion
    assert np.linalg.norm(Tt[4:]) == pytest.approx(0.25, abs=1e-5)
    np.testing.assert_allclose(Tt[4:] / 0.25, T_rel[4:] / np.linalg.norm(
        T_rel[4:]), atol=0.02)
    lj = np.nonzero(j.map.lm_is3d & j.map.lm_valid)[0]
    lt = np.nonzero(t.map.lm_is3d & t.map.lm_valid)[0]
    np.testing.assert_array_equal(lt, lj)
    assert len(lt) >= 60 and not np.isin(np.arange(4), lt).any()
    np.testing.assert_allclose(t.map.lm_pos[lt], j.map.lm_pos[lj],
                               atol=1e-4)


def test_check_mono_init_waits_for_parallax(rng):
    """Below the parallax gate nothing happens (no RANSAC drawn)."""
    seq = generate_sequence(n_frames=2, stereo=False, width=188, height=120,
                            n_points=50)
    t = tslam.SlamManager(port_config(seq.make_config(
        use_loop_closer=False)), device="cpu")
    two_view_state(t, np.random.default_rng(3))
    f = t.frontend.frame
    f.px_und[:] = t.map.obs_px[f.kf_id] + 0.5
    state = t.gen.get_state()
    assert not t._check_mono_init() and not t.frontend.initialized
    assert torch.equal(state, t.gen.get_state())


@pytest.mark.slow
def test_port_meets_mono_gate():
    """tests/test_slam_e2e.py::test_mono_slam_synthetic on the port."""
    from ov2slam_torch.io.synthetic import generate_sequence as tgen
    from ov2slam_torch.utils.evaluation import ate_rmse as tate

    seq = tgen(n_frames=50, stereo=False, width=376, height=240,
               n_points=3000, seed=4, speed=0.08)
    slam = tslam.SlamManager(seq.make_config(reloc_min_interval_s=0.0),
                             device="cpu")
    for i in range(len(seq.times)):
        slam.process_frame(seq.images_left[i], None, float(seq.times[i]))
    _, poses = slam.estimated_trajectory()
    assert slam.frontend.initialized, "mono init never triggered"
    move = np.nonzero(np.linalg.norm(poses[:, 4:7], axis=1) > 1e-6)[0]
    assert len(move) >= 15, "too few initialized frames"
    s = move[0]
    ate = tate(poses[s:], seq.gt_poses[s:], align_scale=True)
    assert ate < 0.08, f"mono post-init ATE {ate:.3f} m"
