"""Parity: the port's image-level rectification and undistortion
(``ov2slam_torch/core/camera.py::stereo_rectify``, ``compute_rectify_map``
and their wiring in ``SlamManager``) against ``ov2slam_tpu``.

The cameras are built here from a ``CameraConfig`` with EuRoC-like
intrinsics and radtan distortion and a right camera rotated by a few
hundredths of a radian. ``stereo_rectify`` is host float64 on both sides
and agrees to 1e-12; the remap LUTs agree to 1e-9 px in float64 and 1e-3 px
in float32, the remapped images to 1e-2 grey levels (float32 bilinear
sampling at the same coordinates).
"""

import numpy as np
import pytest
import torch

from ov2slam_torch.core import camera as tcam
from ov2slam_torch.models.slam import SlamManager as TSlam
from ov2slam_tpu.core import camera as jcam
from ov2slam_tpu.utils import config as jconfig
from ov2slam_tpu.utils import lie_np
from tests.test_torch_slam import port_config

torch.set_num_threads(1)


def T_body(rotvec, t):
    M = np.eye(4)
    M[:3, :3] = lie_np.quat_to_matrix(lie_np.so3_exp(np.asarray(rotvec)))
    M[:3, 3] = t
    return M


def cam_configs():
    left = jconfig.CameraConfig(
        width=188, height=120, fx=114.66, fy=114.32, cx=91.8, cy=62.1,
        dist=(-0.283, 0.0739, 0.0002, 0.00002),
        T_body_cam=T_body([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]))
    right = jconfig.CameraConfig(
        width=188, height=120, fx=114.4, fy=114.03, cx=95.0, cy=63.8,
        dist=(-0.284, 0.0745, -0.0001, -0.00004),
        T_body_cam=T_body([0.01, -0.02, 0.005], [0.11, 0.003, -0.002]))
    return left, right


def cameras(dtype):
    left, right = cam_configs()
    jd = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    j = (jcam.build_camera(left, other=left, dtype=jd),
         jcam.build_camera(right, other=left, dtype=jd))
    t = (tcam.build_camera(port_config_cam(left), other=port_config_cam(left),
                           dtype=dtype, device="cpu"),
         tcam.build_camera(port_config_cam(right),
                           other=port_config_cam(left), dtype=dtype,
                           device="cpu"))
    return j, t


def port_config_cam(c):
    from ov2slam_torch.utils import config as tconfig

    return tconfig.CameraConfig(model=c.model, width=c.width,
                                height=c.height, fx=c.fx, fy=c.fy, cx=c.cx,
                                cy=c.cy, dist=c.dist, T_body_cam=c.T_body_cam)


def test_stereo_rectify_matches():
    (jl, jr), (tl, tr) = cameras(torch.float64)
    a = jcam.stereo_rectify(jl, jr)
    b = tcam.stereo_rectify(tl, tr)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(y, np.asarray(x), atol=1e-12)
    assert b[3] == pytest.approx(a[3], abs=1e-12)
    R_l, R_r, K, base = b
    np.testing.assert_allclose(R_l @ R_l.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(R_r @ R_r.T, np.eye(3), atol=1e-12)
    assert K[0, 1] == 0.0 and base == pytest.approx(
        np.linalg.norm([0.11, 0.003, -0.002]), abs=1e-9)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-3)])
def test_compute_rectify_map_matches(dtype, tol):
    (jl, jr), (tl, tr) = cameras(dtype)
    R_l, R_r, K, _ = tcam.stereo_rectify(tl, tr)
    for jc, tc, R in ((jl, tl, R_l), (jr, tr, R_r)):
        a = np.asarray(jcam.compute_rectify_map(jc, R, K))
        b = tcam.compute_rectify_map(tc, R, K)
        assert b.shape == (120, 188, 2) and b.dtype == dtype
        np.testing.assert_allclose(b.numpy(), a, atol=tol)


def _stereo_cfg():
    from ov2slam_tpu.io.synthetic import generate_sequence

    left, right = cam_configs()
    cfg = generate_sequence(n_frames=2, width=188, height=120,
                            n_points=50).make_config(use_loop_closer=False)
    cfg.cam_left, cfg.cam_right = left, right
    cfg.do_stereo_rect = True
    return cfg


def test_manager_rectifies_the_stereo_pair(rng):
    """``do_stereo_rect``: both cameras become the same ideal pinhole, the
    right one a pure +x baseline away; epipolar lines are rows; the
    remapped images equal the JAX package's."""
    from ov2slam_tpu.models.slam import SlamManager as JSlam

    cfg = _stereo_cfg()
    t = TSlam(port_config(cfg), device="cpu")
    j = JSlam(cfg)
    np.testing.assert_array_equal(t.cam_l.dist.numpy(), 0.0)
    np.testing.assert_array_equal(t.cam_r.dist.numpy(), 0.0)
    np.testing.assert_array_equal(t.cam_l.K.numpy(), t.cam_r.K.numpy())
    np.testing.assert_allclose(t.cam_r.K.numpy(), np.asarray(j.cam_r.K),
                               atol=1e-5)
    T_lr = t.cam_r.T_c0_ci.numpy().astype(np.float64)
    np.testing.assert_allclose(T_lr, np.asarray(j.cam_r.T_c0_ci), atol=1e-7)
    np.testing.assert_allclose(T_lr[:4], [1, 0, 0, 0], atol=1e-12)
    np.testing.assert_allclose(T_lr[5:], 0.0, atol=1e-12)
    # the mapper sees a rectified pair (the epipolar SAD prior engages)
    assert t.mapper._rectified

    pts = rng.uniform([-1.0, -0.6, 2.0], [1.0, 0.6, 8.0], size=(200, 3))
    pts_r = lie_np.pose_apply(lie_np.pose_inverse(T_lr), pts)
    uv_l = t.cam_l.project_cam_to_image(torch.as_tensor(pts)).numpy()
    uv_r = t.cam_r.project_cam_to_image(torch.as_tensor(pts_r)).numpy()
    np.testing.assert_allclose(uv_l[:, 1], uv_r[:, 1], atol=1e-4)
    assert np.all(uv_l[:, 0] > uv_r[:, 0])

    img = rng.uniform(0, 255, (120, 188)).astype(np.float32)
    for tm, jm in ((t._remap_l, j._remap_l), (t._remap_r, j._remap_r)):
        a = np.asarray(jm(img))
        b = t._remap(tm, img).numpy()
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=1e-2)


def test_manager_undistorts_a_mono_camera(rng):
    """``do_undist`` on a distorted camera: the image goes through the
    undistortion LUT and the camera's distortion is zeroed."""
    from ov2slam_tpu.io.synthetic import generate_sequence
    from ov2slam_tpu.models.slam import SlamManager as JSlam

    left, _ = cam_configs()
    cfg = generate_sequence(n_frames=2, stereo=False, width=188, height=120,
                            n_points=50).make_config(use_loop_closer=False)
    cfg.cam_left = left
    cfg.do_undist = True
    t = TSlam(port_config(cfg), device="cpu")
    j = JSlam(cfg)
    assert t._remap_l is not None and t._remap_r is None
    np.testing.assert_array_equal(t.cam_l.dist.numpy(), 0.0)
    img = rng.uniform(0, 255, (120, 188)).astype(np.float32)
    np.testing.assert_allclose(t._remap(t._remap_l, img).numpy(),
                               np.asarray(j._remap_l(img)), atol=1e-2)
