"""Parity: ov2slam_torch core/image.py, core/camera.py and ops/patch.py
against ov2slam_tpu.

Inputs are synthetic frames from ov2slam_tpu.io.synthetic and numpy draws
from a seed; both sides run f32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch.core import camera as tcam
from ov2slam_torch.core import image as timg
from ov2slam_torch.ops import patch as tpatch
from ov2slam_torch.utils.config import CameraConfig as TCameraConfig
from ov2slam_tpu.core import camera as jcam
from ov2slam_tpu.core import image as jimg
from ov2slam_tpu.io.synthetic import generate_sequence
from ov2slam_tpu.ops import patch as jpatch
from ov2slam_tpu.utils.config import CameraConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def frame():
    seq = generate_sequence(n_frames=1, stereo=False, width=188, height=120,
                            n_points=600, seed=3)
    return seq.images_left[0].astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_filters_and_pyramid_match(frame):
    # same taps in the same order: f32 round-off only (1e-4 on 0..255)
    jp = jimg.build_pyramid(jnp.asarray(frame), 4)
    tp = timg.build_pyramid(_t(frame), 4)
    assert [p.shape for p in jp] == [tuple(p.shape) for p in tp]
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    for fj, ft in ((lambda x: jimg.gaussian_blur(x, 2.0, 4),
                    lambda x: timg.gaussian_blur(x, 2.0, 4)),
                   (lambda x: jimg.box_filter(x, 3),
                    lambda x: timg.box_filter(x, 3))):
        np.testing.assert_allclose(ft(_t(frame)).numpy(),
                                   np.asarray(fj(jnp.asarray(frame))),
                                   atol=1e-4)
    jgx, jgy = jimg.scharr_gradients(jnp.asarray(frame))
    tgx, tgy = timg.scharr_gradients(_t(frame))
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-4)
    np.testing.assert_allclose(tgy.numpy(), np.asarray(jgy), atol=1e-4)


@pytest.mark.parametrize("clip", [2.0, 3.0])
def test_clahe_matches(frame, clip):
    # histogram counts are exact integers on both sides; the LUT blend is
    # the same f32 arithmetic — 1e-3 intensity (of 255) covers round-off
    a = np.asarray(jimg.clahe(jnp.asarray(frame), clip_limit=clip))
    b = timg.clahe(_t(frame), clip_limit=clip).numpy()
    np.testing.assert_allclose(b, a, atol=1e-3)


def test_patches_and_windows_match(frame, rng):
    # direct gathers vs hat-weight GEMMs: same two-tap sums, 1e-3 of 255
    tl = rng.uniform([-5, -5], [180, 115], size=(64, 2)).astype(np.float32)
    a = np.asarray(jpatch.extract_patches(jnp.asarray(frame),
                                          jnp.asarray(tl), 11, 17))
    b = tpatch.extract_patches(_t(frame), _t(tl), 11, 17).numpy()
    np.testing.assert_allclose(b, a, atol=1e-3)
    S = np.asarray(jpatch.extract_patches(jnp.asarray(frame),
                                          jnp.asarray(np.floor(tl)), 19))
    off = rng.uniform(-1, 12, size=(64, 2)).astype(np.float32)
    off[0] = (10.0, 10.0)
    a = np.asarray(jpatch.sample_window(jnp.asarray(S), jnp.asarray(off), 9))
    b = tpatch.sample_window(_t(S), _t(off), 9).numpy()
    np.testing.assert_allclose(b, a, atol=1e-3)


def test_bilinear_sample_matches_and_oob_zero(frame, rng):
    c = rng.uniform(-10, 200, size=(500, 2)).astype(np.float32)
    a = np.asarray(jcam.bilinear_sample(jnp.asarray(frame), jnp.asarray(c)))
    b = tcam.bilinear_sample(_t(frame), _t(c)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-3)
    oob = (c[:, 0] < 0) | (c[:, 0] > 187) | (c[:, 1] < 0) | (c[:, 1] > 119)
    assert oob.any() and np.all(b[oob] == 0.0)


CAMS = {
    "radtan": dict(model="pinhole", width=752, height=480, fx=458.654,
                   fy=457.296, cx=367.215, cy=248.375,
                   dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)),
    "kb4": dict(model="fisheye", width=640, height=480, fx=380.0, fy=380.0,
                cx=320.0, cy=240.0,
                dist=(-0.013, 0.021, -0.017, 0.0045)),
}


@pytest.mark.parametrize("name", sorted(CAMS))
def test_camera_project_distort_undistort(name, rng):
    # f32 on both sides, same formulas: 1e-3 px
    kw = CAMS[name]
    T = np.eye(4)
    T[:3, 3] = (0.11, 0.0, 0.0)
    jc = jcam.build_camera(CameraConfig(**kw, T_body_cam=T),
                           CameraConfig(**kw, T_body_cam=np.eye(4)))
    tc = tcam.build_camera(TCameraConfig(**kw, T_body_cam=T),
                           TCameraConfig(**kw, T_body_cam=np.eye(4)),
                           device=CPU)
    np.testing.assert_allclose(tc.T_c0_ci.numpy(), np.asarray(jc.T_c0_ci),
                               atol=1e-6)
    pts = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-0.7, 0.7, 200),
                    rng.uniform(1.5, 6, 200)], -1).astype(np.float32)
    for fn in ("project_cam_to_image", "project_cam_to_image_dist"):
        a = np.asarray(getattr(jc, fn)(jnp.asarray(pts)))
        b = getattr(tc, fn)(_t(pts)).numpy()
        np.testing.assert_allclose(b, a, atol=1e-3)
    px = np.asarray(jc.project_cam_to_image_dist(jnp.asarray(pts)))
    a = np.asarray(jc.undistort_px(jnp.asarray(px)))
    b = tc.undistort_px(_t(px)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-3)
    # round trip on the port side alone: undistort(distort(x)) ≈ x
    np.testing.assert_allclose(
        b, tc.project_cam_to_image(_t(pts)).numpy(), atol=0.05)
    np.testing.assert_allclose(
        tc.bearing(_t(b)).numpy(), np.asarray(jc.bearing(jnp.asarray(a))),
        atol=1e-5)
