"""Parity of the port's device-chained front end with ov2slam_tpu's.

Same inputs, made from numpy seeds at a small size, through both packages
on the CPU:

- the host packers (``pack_lm_static``, ``pack_chain_state``) and the chain
  patches (``patch_chain_rows`` with its out-of-range padding,
  ``patch_chain_pose_delta``): exact, except the corrected poses, within
  1e-6 (f32 round-off: XLA's CPU code contracts the pose product's
  multiply-adds, a quaternion's sum of squares among them, into fused
  multiply-adds, PyTorch's does not; the port's ``utils/lie.py`` stays as
  it is, since every earlier slice's digits rest on it);
- ``advance_chain_patch``: positions within 1e-3 px, statuses equal;
- ``fused_track_step_chained`` without the epipolar gate (no RANSAC, so
  no random draw): the new chain state's pose rows within 1e-4, the
  tracked pixels within 1e-3 px, statuses equal;
- the synchronous ``SlamManager`` with ``pipelined_frontend`` at depth 2
  (device-chained) and depth 1 (host-packed, resolved one frame late) on a
  376x240 stereo sequence: ATE within 0.01 m of the JAX package's on the
  same frames, equal resets. RANSAC streams differ between the packages,
  so the trajectories are compared by outcome, as in test_torch_slam.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch.core.image import build_pyramid as t_pyr
from ov2slam_torch.models import frontend_step as tfs
from ov2slam_torch.models.slam import SlamManager as TSlam
from ov2slam_tpu.core.image import build_pyramid as j_pyr
from ov2slam_tpu.io.synthetic import generate_sequence
from ov2slam_tpu.models import frontend_step as jfs
from ov2slam_tpu.models.slam import SlamManager as JSlam
from ov2slam_tpu.utils import lie_np
from ov2slam_tpu.utils.evaluation import ate_rmse

from test_torch_slam import partial_loop, port_config

torch.set_num_threads(1)

N = 96
LEVELS = 3


def _random_poses(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([q, rng.normal(size=(n, 3))], 1).astype(np.float32)


def test_pack_lm_static_and_chain_state_exact(rng):
    lm_pos = rng.normal(size=(N, 3)).astype(np.float32)
    kf_px = rng.uniform(0, 300, (N, 2)).astype(np.float32)
    valid, is3d, pair = (rng.random((3, N)) < 0.6)
    T_kf, T_cur, T_prev = _random_poses(rng, 3)
    np.testing.assert_array_equal(
        tfs.pack_lm_static(lm_pos, kf_px, valid, is3d, pair, T_kf),
        jfs.pack_lm_static(lm_pos, kf_px, valid, is3d, pair, T_kf))
    px = rng.uniform(0, 300, (N, 2)).astype(np.float32)
    und = px + rng.normal(size=(N, 2)).astype(np.float32)
    st = valid.astype(np.float32)
    out = np.full((N + 2, 8), 7.0, np.float32)    # a reused buffer
    np.testing.assert_array_equal(
        tfs.pack_chain_state(px, und, st, T_cur, T_prev, out=out.copy()),
        jfs.pack_chain_state(px, und, st, T_cur, T_prev, out=out.copy()))
    state = tfs.pack_track_state(px, lm_pos, kf_px, valid, is3d, pair,
                                 T_cur, T_kf)
    np.testing.assert_array_equal(state, jfs.pack_track_state(
        px, lm_pos, kf_px, valid, is3d, pair, T_cur, T_kf))
    back = tfs.unpack_track_state(torch.as_tensor(state))
    np.testing.assert_array_equal(back["valid"].numpy(), valid)
    np.testing.assert_array_equal(back["lm_is3d"].numpy(), is3d)
    np.testing.assert_array_equal(back["kf_pair_valid"].numpy(), pair)
    np.testing.assert_array_equal(back["T_kf"].numpy(), T_kf)


@pytest.mark.parametrize("n_new", [0, 5, N])
def test_patch_chain_rows_exact_with_padding(rng, n_new):
    S = rng.normal(size=(N + 2, 8)).astype(np.float32)
    rows = np.full(N, 1 << 20, np.int32)       # the JAX package's padding
    rows[:n_new] = rng.permutation(N)[:n_new]
    px, und = rng.normal(size=(2, N, 2)).astype(np.float32)
    st = (rng.random(N) < 0.7).astype(np.float32)
    j = np.asarray(jfs.patch_chain_rows(
        jnp.asarray(S), jnp.asarray(rows), jnp.asarray(px), jnp.asarray(und),
        jnp.asarray(st)))
    t = tfs.patch_chain_rows(*(torch.as_tensor(a) for a in
                               (S, rows, px, und, st))).numpy()
    np.testing.assert_array_equal(t, j)
    # negative and just-past-the-slots indices never reach the pose rows
    bad = rows.copy()
    bad[n_new:] = -1 if n_new % 2 else N
    t2 = tfs.patch_chain_rows(*(torch.as_tensor(a) for a in
                                (S, bad, px, und, st))).numpy()
    np.testing.assert_array_equal(t2, j)


def test_patch_chain_pose_delta_exact(rng):
    S = rng.normal(size=(N + 2, 8)).astype(np.float32)
    S[N:, :7] = _random_poses(rng, 2)
    delta = _random_poses(rng, 1)[0]
    j = np.asarray(jfs.patch_chain_pose_delta(jnp.asarray(S),
                                              jnp.asarray(delta)))
    t = tfs.patch_chain_pose_delta(torch.as_tensor(S),
                                   torch.as_tensor(delta)).numpy()
    np.testing.assert_array_equal(t[:N], j[:N])
    np.testing.assert_array_equal(t[N:, 7], j[N:, 7])
    np.testing.assert_allclose(t[N:, :7], j[N:, :7], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def scene():
    """Three consecutive frames of a 188x120 stereo arc, and up to N
    landmarks of the scene visible in the middle frame with their pixels."""
    seq = generate_sequence(n_frames=4, stereo=True, width=188, height=120,
                            n_points=1500, seed=5, speed=0.05)
    T1 = seq.gt_poses[1].astype(np.float64)
    pc = lie_np.pose_apply(lie_np.pose_inverse(T1),
                           seq.points.astype(np.float64))
    K = seq.K
    uv = pc[:, :2] / pc[:, 2:] * (K[0, 0], K[1, 1]) + (K[0, 2], K[1, 2])
    ok = ((pc[:, 2] > 0.5) & (uv[:, 0] > 12) & (uv[:, 0] < 188 - 12)
          & (uv[:, 1] > 12) & (uv[:, 1] < 120 - 12))
    idx = np.nonzero(ok)[0][:N]
    assert len(idx) >= 40
    px = np.zeros((N, 2), np.float32)
    lm = np.zeros((N, 3), np.float32)
    px[:len(idx)] = uv[idx]
    lm[:len(idx)] = seq.points[idx]
    valid = np.zeros(N, bool)
    valid[:len(idx)] = True
    return seq, px, lm, valid


def _calibs(seq):
    K = seq.K.astype(np.float32)
    vals = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    j = jfs.CalibArrays(*(jnp.asarray(v, jnp.float32) for v in vals),
                        dist=jnp.zeros(4, jnp.float32))
    t = tfs.CalibArrays(*(torch.tensor(v, dtype=torch.float32)
                          for v in vals), dist=torch.zeros(4))
    return j, t


def _pyrs(img):
    img = np.asarray(img, np.float32)
    return (tuple(j_pyr(jnp.asarray(img), LEVELS)),
            tuple(t_pyr(torch.as_tensor(img), LEVELS)))


def test_advance_chain_patch(scene):
    seq, px, _, valid = scene
    jc, tc = _calibs(seq)
    ja, ta = _pyrs(seq.images_left[1])
    jb, tb = _pyrs(seq.images_left[2])
    st = valid.astype(np.float32)
    jpx, jund, jst = (np.asarray(a) for a in jfs.advance_chain_patch(
        ja, jb, jnp.asarray(px), jnp.asarray(st), jc))
    tpx, tund, tst = (a.numpy() for a in tfs.advance_chain_patch(
        ta, tb, torch.as_tensor(px), torch.as_tensor(st), tc))
    np.testing.assert_array_equal(tst, jst)
    live = jst > 0.5
    assert live.sum() >= 0.6 * valid.sum()
    np.testing.assert_allclose(tpx[live], jpx[live], atol=1e-3)
    np.testing.assert_allclose(tund[live], jund[live], atol=1e-3)


@pytest.mark.parametrize("split_sub", [0, 32])
def test_fused_track_step_chained_without_epipolar(scene, split_sub):
    seq, px, lm, valid = scene
    jc, tc = _calibs(seq)
    jprev, tprev = _pyrs(seq.images_left[1])
    img = np.clip(np.round(seq.images_left[2]), 0, 255).astype(np.uint8)
    T_prev, T_cur = seq.gt_poses[0], seq.gt_poses[1]
    S = jfs.pack_chain_state(px, px, valid.astype(np.float32),
                             T_cur.astype(np.float32),
                             T_prev.astype(np.float32))
    lm_st = jfs.pack_lm_static(lm, np.zeros_like(px), valid, valid,
                               np.zeros_like(valid),
                               T_cur.astype(np.float32))
    kw = dict(levels=LEVELS, win=9, iters=30, do_epipolar=False,
              do_pose=True, split_sub=split_sub)
    _, jS, jpk, _ = jfs.fused_track_step_chained(
        jnp.asarray(img), jprev, jnp.asarray(S), jnp.asarray(lm_st),
        jnp.asarray([1.25], jnp.float32), jax.random.PRNGKey(0), jc, **kw)
    _, tS, tpk = tfs.fused_track_step_chained(
        torch.as_tensor(img), tprev, torch.as_tensor(S),
        torch.as_tensor(lm_st), torch.tensor([1.25]), None, tc, **kw)
    jS, jpk, tS, tpk = (np.asarray(jS), np.asarray(jpk), tS.numpy(),
                        tpk.numpy())
    assert tpk.shape == jpk.shape == (N + 3, 5)
    assert tpk[N, 2] == jpk[N, 2] == 1.0           # the chained marker
    assert tpk[N, 0] == jpk[N, 0] == 1.0           # pose solved
    np.testing.assert_allclose(tS[N:, :7], jS[N:, :7], atol=1e-4)
    np.testing.assert_array_equal(tS[N + 1], jS[N + 1])   # T_cur carried
    st_t, st_j = tS[:N, 4] > 0.5, jS[:N, 4] > 0.5
    np.testing.assert_array_equal(st_t, st_j)
    assert st_j.sum() >= 0.6 * valid.sum()
    np.testing.assert_allclose(tS[:N, :4][st_j], jS[:N, :4][st_j], atol=1e-3)
    np.testing.assert_allclose(tpk[:N], tS[:N, :5])
    # the pose moved from the device prior toward the truth of frame 2
    err = np.linalg.norm(tS[N, 4:7] - seq.gt_poses[2, 4:7])
    assert err < 0.01, err


def test_chained_prior_matches_motion_model(rng):
    # the device prior is the host motion model's prediction at the same
    # interval ratio; with no history (zero T_prev row) it is T_cur
    T_prev, T_cur = _random_poses(rng, 2).astype(np.float64)
    T_cur[:4] = lie_np.quat_mul(T_prev[:4], lie_np.so3_exp(
        np.array([0.02, -0.01, 0.03])))
    T_cur[4:] = T_prev[4:] + (0.05, 0.0, 0.01)
    for r in (1.0, 2.0, 0.5):
        want = lie_np.pose_compose(T_cur, np.concatenate([
            lie_np.so3_exp(lie_np.so3_log(lie_np.pose_relative(
                T_prev, T_cur)[:4]) * r),
            lie_np.pose_relative(T_prev, T_cur)[4:] * r]))
        got = tfs.chained_prior(torch.as_tensor(T_cur, dtype=torch.float32),
                                torch.as_tensor(T_prev, dtype=torch.float32),
                                torch.tensor([r])).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5)
    got = tfs.chained_prior(torch.as_tensor(T_cur, dtype=torch.float32),
                            torch.zeros(7), torch.tensor([1.0])).numpy()
    np.testing.assert_array_equal(got, T_cur.astype(np.float32))


# ---------------------------------------------------------------------- #
# the synchronous manager with the pipelined front end, against JAX's
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def loop_seq():
    # the first 24 frames of a 120-frame circular loop at 376x240: the
    # camera turns 3 degrees per frame, so keyframes come every few frames
    # and the chain is patched and corrected while frames are in flight
    return partial_loop(376, 240, 120, 24, 3000)


def _run(slam, seq):
    for i in range(len(seq.times)):
        slam.process_frame(seq.images_left[i], seq.images_right[i],
                           float(seq.times[i]))
    return slam.estimated_trajectory()[1]


@pytest.mark.parametrize("depth", [2, 1])
def test_pipelined_manager_matches_jax(loop_seq, depth):
    seq = loop_seq
    cfg = seq.make_config(max_keyframes=64, max_landmarks=8192,
                          use_fast=False, use_singlescale_detector=True,
                          max_dist=30, pipelined_frontend=True,
                          pipeline_depth=depth)
    j = JSlam(cfg)
    jp = _run(j, seq)
    t = TSlam(port_config(cfg), device="cpu")
    tp = _run(t, seq)
    assert not t.frontend.has_pending
    assert tp.shape == jp.shape == seq.gt_poses.shape
    assert np.isfinite(tp).all()
    assert t.n_resets == j.n_resets == 0
    assert t.map._kf_seq_counter >= 4
    ate_t = ate_rmse(tp, seq.gt_poses, align_scale=False)
    ate_j = ate_rmse(jp, seq.gt_poses, align_scale=False)
    assert abs(ate_t - ate_j) < 0.01, (ate_t, ate_j)


def test_keyframe_skips_slots_born_after_the_resolved_frame():
    # with frames in flight, a keyframe's fresh detections join the chain
    # at the next dispatch; until a frame dispatched after that is
    # resolved, their host positions are still the detection frame's, and
    # a keyframe made in between must not observe them
    from ov2slam_torch.io.synthetic import generate_sequence as tgen

    seq = tgen(n_frames=2, width=96, height=64, n_points=50)
    slam = TSlam(seq.make_config(pipelined_frontend=True, pipeline_depth=2),
                 device="cpu")
    fe = slam.frontend
    n = len(fe.frame.valid)
    fe.frame.valid[:] = True
    fe._resolved_seq = 7
    fe._slot_birth[:] = 0
    fe._slot_birth[: n // 2] = 8          # patched in after frame 7
    np.testing.assert_array_equal(fe.measured(),
                                  np.arange(n) >= n // 2)
    fe._resolved_seq = 8
    assert fe.measured().all()
