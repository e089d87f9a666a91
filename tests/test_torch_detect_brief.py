"""Parity: ov2slam_torch.ops.detect and ops.brief against ov2slam_tpu.

Same synthetic frame on both sides (f32, CPU). Detectors must select the
same cells and agree on keypoint positions to 1e-3 px (the response maps
differ by f32 round-off only). BRIEF uses the same pattern (seed 7) and
must agree bit for bit on keypoints away from sampling ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch.ops import brief as tbrief
from ov2slam_torch.ops import detect as tdet
from ov2slam_tpu.io.synthetic import generate_sequence
from ov2slam_tpu.ops import brief as jbrief
from ov2slam_tpu.ops import detect as jdet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frame():
    seq = generate_sequence(n_frames=1, stereo=False, width=188, height=120,
                            n_points=800, seed=5)
    return seq.images_left[0].astype(np.float32)


def _existing(rng):
    ex = rng.uniform([10, 10], [170, 110], size=(12, 2)).astype(np.float32)
    ok = np.ones(12, bool)
    ok[-3:] = False
    return ex, ok


DETECTORS = {
    "single": (jdet.detect_single_scale, tdet.detect_single_scale, 0.01),
    "gftt": (jdet.detect_gftt, tdet.detect_gftt, 0.01),
    "fast": (jdet.detect_grid_fast, tdet.detect_grid_fast, 20.0),
}


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detectors_match(frame, rng, name):
    jf, tf, th = DETECTORS[name]
    ex, ok = _existing(rng)
    a = jf(jnp.asarray(frame), jnp.asarray(ex), jnp.asarray(ok), th,
           cell_size=16, max_out=128)
    b = tf(torch.as_tensor(frame), torch.as_tensor(ex), torch.as_tensor(ok),
           th, cell_size=16, max_out=128)
    ja, ta = np.asarray(a[2]), b[2].numpy()
    assert ja.sum() > 10
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(b[0].numpy()[ja], np.asarray(a[0])[ja],
                               atol=1e-3)
    np.testing.assert_allclose(b[1].numpy()[ja], np.asarray(a[1])[ja],
                               rtol=1e-4, atol=1e-4)


def test_responses_match(frame):
    np.testing.assert_allclose(
        tdet.shi_tomasi_response(torch.as_tensor(frame)).numpy(),
        np.asarray(jdet.shi_tomasi_response(jnp.asarray(frame))),
        rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(
        tdet.fast_response(torch.as_tensor(frame), 20.0).numpy() > 0,
        np.asarray(jdet.fast_response(jnp.asarray(frame), 20.0)) > 0)


def test_brief_pattern_and_bits_match(frame, rng):
    np.testing.assert_array_equal(tbrief._PATTERN, jbrief._PATTERN)
    kps, _, ok = jdet.detect_single_scale(
        jnp.asarray(frame), jnp.zeros((1, 2)), jnp.zeros(1, bool), 0.01,
        cell_size=12, max_out=128)
    kps = np.array(kps, np.float32)
    # integer, half-pixel and fractional positions, some near the border
    kps[:8] = np.round(kps[:8])
    kps[8:16] = np.round(kps[8:16]) + 0.5
    kps[-4:] = [[5, 5], [180, 60], [100, 117], [17.5, 17.5]]
    ok = np.array(ok)
    ok[-4:] = True
    a, aok = jbrief.describe_brief(jnp.asarray(frame), jnp.asarray(kps),
                                   jnp.asarray(ok))
    b, bok = tbrief.describe_brief(torch.as_tensor(frame),
                                   torch.as_tensor(kps), torch.as_tensor(ok))
    np.testing.assert_array_equal(bok.numpy(), np.asarray(aok))
    a = np.asarray(a).view(np.uint32)
    b = b.numpy().view(np.uint32)
    assert b.dtype == np.uint32 and np.asarray(aok).sum() > 20
    np.testing.assert_array_equal(b, a)
