"""Parity: ov2slam_torch ops/stereo_sad.py, ops/matching.py and
models/mapper_step.py against ov2slam_tpu.

Descriptor matching is integer Hamming arithmetic: exact equality. The SAD
scan and the stereo step run f32 on both sides: disparities must agree
exactly away from ties. At this 188 px width stereo disparities are only
2-5 px, so the two rays are nearly parallel and the midpoint solve
amplifies f32 round-off (and the 0.01 px KLT stop tolerance) into up to
~0.5% of depth: landmarks are compared at rtol 5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch.core.image import build_pyramid as t_pyr
from ov2slam_torch.geometry.essential import essential_from_pose as t_efp
from ov2slam_torch.models import mapper_step as tms
from ov2slam_torch.models.frontend_step import CalibArrays as TCalib
from ov2slam_torch.ops import matching as tm
from ov2slam_torch.ops import stereo_sad as tsad
from ov2slam_tpu.core.image import build_pyramid as j_pyr
from ov2slam_tpu.geometry.essential import essential_from_pose as j_efp
from ov2slam_tpu.io.synthetic import generate_sequence
from ov2slam_tpu.models import mapper_step as jms
from ov2slam_tpu.models.frontend_step import CalibArrays as JCalib
from ov2slam_tpu.ops import matching as jm
from ov2slam_tpu.ops import stereo_sad as jsad
from ov2slam_tpu.ops.detect import detect_single_scale

torch.set_num_threads(1)


def T(x):
    return torch.as_tensor(np.array(x))


def _descs(rng, n, m):
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    b[:n // 2] = a[:n // 2] ^ (rng.random((n // 2, 8)) < 0.05).astype(
        np.uint32)
    return a, b


def test_hamming_and_matchers_equal(rng):
    a, b = _descs(rng, 64, 80)
    va = rng.random(64) < 0.9
    vb = rng.random(80) < 0.9
    ta, tb = T(a.view(np.int32)), T(b.view(np.int32))
    np.testing.assert_array_equal(
        tm.hamming_matrix(ta, tb).numpy(),
        np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    j = jm.knn_match_2nn(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                         jnp.asarray(vb), 64, ratio=0.85)
    t = tm.knn_match_2nn(ta, T(va), tb, T(vb), 64, ratio=0.85)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    assert (t[0].numpy() >= 0).sum() > 20
    j = jm.mutual_match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                        jnp.asarray(vb), 64)
    t = tm.mutual_match(ta, T(va), tb, T(vb), 64)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    pp = rng.uniform(0, 100, (64, 2)).astype(np.float32)
    kp = np.concatenate([pp + rng.normal(0, 1, (64, 2)),
                         rng.uniform(0, 100, (16, 2))]).astype(np.float32)
    j = jm.projection_match(jnp.asarray(pp), jnp.asarray(va), jnp.asarray(a),
                            jnp.asarray(kp), jnp.asarray(vb), jnp.asarray(b),
                            5.0, 64)
    t = tm.projection_match(T(pp), T(va), ta, T(kp), T(vb), tb, 5.0, 64)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))


@pytest.fixture(scope="module")
def stereo():
    seq = generate_sequence(n_frames=1, stereo=True, width=188, height=120,
                            n_points=800, seed=2)
    left = seq.images_left[0].astype(np.float32)
    right = seq.images_right[0].astype(np.float32)
    kps, _, ok = detect_single_scale(jnp.asarray(left), jnp.zeros((1, 2)),
                                     jnp.zeros(1, bool), 0.01, 12, 128)
    return seq, left, right, np.array(kps, np.float32), np.array(ok)


def test_line_min_sad_matches(stereo):
    _, left, right, kps, ok = stereo
    j = jsad.line_min_sad(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(kps),
        jnp.asarray(ok), win=7, max_disp=40)
    t = tsad.line_min_sad(T(left), T(right), T(kps), T(ok), win=7,
                          max_disp=40)
    agree = (t[2].numpy() == np.asarray(j[2]))
    assert agree[ok].mean() >= 0.97
    np.testing.assert_allclose(t[1].numpy()[agree], np.asarray(j[1])[agree],
                               atol=1e-3)


def test_fused_stereo_map_step_landmarks(stereo):
    seq, left, right, kps, ok = stereo
    K = seq.K.astype(np.float32)
    T_lr = np.asarray(seq.T_lr, np.float32)
    d0 = np.zeros(4, np.float32)
    jc = JCalib(*[jnp.asarray(v, jnp.float32)
                  for v in (K[0, 0], K[1, 1], K[0, 2], K[1, 2])],
                dist=jnp.asarray(d0))
    tc = TCalib(*[torch.tensor(float(v)) for v in
                  (K[0, 0], K[1, 1], K[0, 2], K[1, 2])], dist=T(d0))
    T_wc = np.array([1, 0, 0, 0, 0.1, -0.2, 0.3], np.float32)
    N = len(kps)
    lm_pos = np.zeros((N, 3), np.float32)
    is3d = np.zeros(N, bool)
    state = jms.pack_stereo_state(kps, lm_pos, ok, is3d, T_wc)
    j = np.asarray(jms.fused_stereo_map_step(
        tuple(j_pyr(jnp.asarray(left), 3)), jnp.asarray(right),
        jnp.asarray(state), jnp.asarray(T_lr),
        j_efp(jnp.asarray(T_lr)), jc, jc, levels=3))
    t = tms.fused_stereo_map_step(
        tuple(t_pyr(T(left), 3)), T(right), T(kps), T(lm_pos), T(ok),
        T(is3d), T(T_wc), T(T_lr), t_efp(T(T_lr)), tc, tc, levels=3)
    j_tri = j[:, 6] > 0.5
    t_tri = t["tri_ok"].numpy()
    assert j_tri.sum() > 20
    assert (j_tri == t_tri).mean() >= 0.97
    both = j_tri & t_tri
    np.testing.assert_allclose(t["pts_w"].numpy()[both], j[both, 2:5],
                               rtol=5e-3, atol=1e-3)
    np.testing.assert_allclose(t["rpx"].numpy()[both], j[both, 0:2],
                               atol=0.01)
    # temporal triangulation on the same rows (anchor = this left view)
    T_rel = np.broadcast_to(T_lr, (N, 7)).copy()
    T_a = np.broadcast_to(T_wc, (N, 7)).copy()
    px_c = j[:, 0:2].astype(np.float32)
    jt = np.asarray(jms.fused_temporal_step(
        jnp.asarray(jms.pack_temporal_state(kps, px_c, T_a, T_rel, both)),
        jc))
    tp, tok = tms.fused_temporal_step(T(kps), T(px_c), T(T_a), T(T_rel),
                                      T(both), tc)
    np.testing.assert_array_equal(tok.numpy(), jt[:, 3] > 0.5)
    np.testing.assert_allclose(tp.numpy()[both], jt[both, 0:3], rtol=5e-3,
                               atol=1e-3)
