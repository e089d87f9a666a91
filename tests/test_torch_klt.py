"""Parity: ov2slam_torch.ops.klt against ov2slam_tpu.ops.klt.

Same synthetic frames and keypoints on both sides (f32, CPU). Tracked
positions must agree within the 0.01 px Gauss-Newton stop tolerance on
rows both sides track, and the status masks must agree (a handful of
borderline rows may flip where a gate sits within f32 round-off of its
threshold, so agreement is required on ≥ 97% of rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch.core.image import build_pyramid as t_pyr
from ov2slam_torch.ops import klt as tklt
from ov2slam_tpu.core.image import build_pyramid as j_pyr, gaussian_blur
from ov2slam_tpu.core.camera import bilinear_sample
from ov2slam_tpu.io.synthetic import generate_sequence
from ov2slam_tpu.ops import klt as jklt
from ov2slam_tpu.ops.detect import detect_single_scale

torch.set_num_threads(1)

EPS_PX = 0.01


@pytest.fixture(scope="module")
def pair():
    seq = generate_sequence(n_frames=3, stereo=False, width=188, height=120,
                            n_points=700, seed=1, speed=0.05)
    a = seq.images_left[0].astype(np.float32)
    b = seq.images_left[2].astype(np.float32)
    kps, _, ok = detect_single_scale(jnp.asarray(a), jnp.zeros((1, 2)),
                                     jnp.zeros(1, bool), 0.001, 12, 160)
    return a, b, np.array(kps, np.float32), np.array(ok)


def _both(a, b, levels):
    jp = (tuple(j_pyr(jnp.asarray(a), levels)),
          tuple(j_pyr(jnp.asarray(b), levels)))
    tp = (tuple(t_pyr(torch.as_tensor(a), levels)),
          tuple(t_pyr(torch.as_tensor(b), levels)))
    return jp, tp


def _agree(jpx, jst, tpx, tst):
    jpx, jst = np.asarray(jpx), np.asarray(jst)
    tpx, tst = tpx.numpy(), tst.numpy()
    assert (jst == tst).mean() >= 0.97, (jst.sum(), tst.sum())
    both = jst & tst
    assert both.sum() >= 10
    np.testing.assert_allclose(tpx[both], jpx[both], atol=EPS_PX)


def test_klt_forward_and_fb_parity(pair):
    a, b, kps, ok = pair
    (jpp, jpc), (tpp, tpc) = _both(a, b, 4)
    jk, tk = jnp.asarray(kps), torch.as_tensor(kps)
    jv, tv = jnp.asarray(ok), torch.as_tensor(ok)
    j = jklt.klt_track(jpp, jpc, jk, jk, jv)
    t = tklt.klt_track(tpp, tpc, tk, tk, tv)
    _agree(j[0], j[1], t[0], t[1])
    np.testing.assert_allclose(t[2].numpy()[np.asarray(j[1])],
                               np.asarray(j[2])[np.asarray(j[1])], atol=0.05)
    j = jklt.fb_klt_track(jpp, jpc, jk, jk, jv)
    t = tklt.fb_klt_track(tpp, tpc, tk, tk, tv)
    _agree(j[0], j[1], t[0], t[1])


@pytest.mark.parametrize("n_sub", [8, 64])
def test_fb_klt_split_parity_including_overflow(n_sub):
    """n_sub = 8 < rows needing pass 2 reproduces the overflow behaviour of
    the JAX version: extra rows keep their pass-1 (base-level) result."""
    rng = np.random.default_rng(7)
    base = rng.uniform(0, 255, size=(120, 160)).astype(np.float32)
    base = np.array(gaussian_blur(jnp.asarray(base), 2.0, 4))
    shift = (5.0, -3.0)
    yy, xx = np.meshgrid(np.arange(120, dtype=np.float32),
                         np.arange(160, dtype=np.float32), indexing="ij")
    cur = np.array(bilinear_sample(
        jnp.asarray(base),
        jnp.asarray(np.stack([xx - shift[0], yy - shift[1]], -1))))
    N = 48
    kps = rng.uniform([20, 20], [140, 100], size=(N, 2)).astype(np.float32)
    base_only = np.arange(N) % 2 == 0
    prior = np.where(base_only[:, None], kps + np.float32(shift), kps)
    (jpp, jpc), (tpp, tpc) = _both(base, cur, 3)
    j = jklt.fb_klt_track_split(
        jpp, jpc, jnp.asarray(kps), jnp.asarray(prior), jnp.ones(N, bool),
        jnp.asarray(base_only), n_sub=n_sub)
    t = tklt.fb_klt_track_split(
        tpp, tpc, torch.as_tensor(kps), torch.as_tensor(prior),
        torch.ones(N, dtype=torch.bool), torch.as_tensor(base_only),
        n_sub=n_sub)
    _agree(j[0], j[1], t[0], t[1])
    # rows beyond n_sub that pass 2 never saw keep the pass-1 position
    if n_sub < N // 2:
        not_seen = ~base_only
        not_seen[np.nonzero(~base_only)[0][:n_sub]] = False
        tpx = t[0].numpy()
        assert np.all(np.isfinite(tpx[not_seen]))
