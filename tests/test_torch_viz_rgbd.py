"""The port's io/rgbd.py and io/viz.py: test_viz_rgbd.py's cases on the
port (``device="cpu"``), and ``depth_to_points`` against the JAX function
on the same depth image at strides 1 and 2 (rtol 1e-6)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch.io.rgbd import (
    depth_to_points, fuse_rgbd_frames, sync_streams, voxel_downsample,
)
from ov2slam_torch.io.viz import (
    draw_tracks, export_html_viewer, export_ply, export_trajectory_ply,
)
from ov2slam_tpu.io import rgbd as jrgbd

torch.set_num_threads(1)


def test_depth_to_points_roundtrip():
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    depth = np.full((240, 320), 5.0, np.float32)
    pts, valid = depth_to_points(torch.as_tensor(depth), torch.as_tensor(K))
    pts, valid = pts.numpy(), valid.numpy()
    assert valid.all()
    np.testing.assert_allclose(pts[:, 2], 5.0)
    u = pts[:, 0] / pts[:, 2] * 400 + 160
    v = pts[:, 1] / pts[:, 2] * 400 + 120
    ys, xs = np.meshgrid(np.arange(240), np.arange(320), indexing="ij")
    np.testing.assert_allclose(u, xs.reshape(-1), atol=1e-3)
    np.testing.assert_allclose(v, ys.reshape(-1), atol=1e-3)


@pytest.mark.parametrize("stride", [1, 2])
def test_depth_to_points_matches_jax(stride):
    rng = np.random.default_rng(stride)
    K = np.array([[380.0, 0, 161.3], [0, 377.0, 119.6], [0, 0, 1]],
                 np.float32)
    depth = rng.uniform(0.0, 90.0, (120, 160)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.05] = np.nan
    depth[rng.random(depth.shape) < 0.05] = np.inf
    jp, jv = jrgbd.depth_to_points(jnp.asarray(depth), jnp.asarray(K),
                                   stride=stride)
    tp, tv = depth_to_points(torch.as_tensor(depth), K, stride=stride)
    jp, jv = np.asarray(jp), np.asarray(jv)
    assert tp.shape == jp.shape == ((120 // stride) * (160 // stride), 3)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert 0 < jv.sum() < len(jv)
    np.testing.assert_allclose(tp.numpy()[jv], jp[jv], rtol=1e-6)


def test_fuse_rgbd_world_frame():
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    depth = np.full((120, 160), 2.0, np.float32)
    rgb = np.full((120, 160, 3), 128, np.uint8)
    T = np.concatenate([[1, 0, 0, 0], [1.0, 0, 0]])
    pts, cols = fuse_rgbd_frames([(depth, rgb, K, T)], stride=4,
                                 device="cpu")
    assert len(pts) == (120 // 4) * (160 // 4)
    np.testing.assert_allclose(pts[:, 2], 2.0, atol=1e-5)
    us = np.arange(0, 160, 4, dtype=np.float64)
    expected_x = ((us - 160) / 400 * 2.0).mean() + 1.0
    assert abs(pts[:, 0].mean() - expected_x) < 1e-3
    assert cols.shape == pts.shape


def test_fuse_rgbd_matches_jax():
    rng = np.random.default_rng(4)
    K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)
    frames = []
    for k in range(3):
        depth = rng.uniform(0.5, 12.0, (120, 160)).astype(np.float32)
        rgb = rng.integers(0, 255, (120, 160, 3)).astype(np.uint8)
        q = np.concatenate([[1.0], rng.normal(0, 0.2, 3)])
        T = np.concatenate([q / np.linalg.norm(q), rng.normal(0, 1, 3)])
        frames.append((depth, rgb, K, T))
    jp, jc = jrgbd.fuse_rgbd_frames(frames, stride=2)
    tp, tc = fuse_rgbd_frames(frames, stride=2, device="cpu")
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tc, jc)


def test_sync_streams():
    a = np.array([0.0, 0.1, 0.2, 0.3])
    b = np.array([0.001, 0.102, 0.35])
    c = np.array([0.0, 0.1, 0.2, 0.301])
    m = sync_streams([a, b, c], tol=0.01)
    assert (0, 0, 0) in m and (1, 1, 1) in m
    assert all(len(t) == 3 for t in m)
    assert len(m) == 2


def test_voxel_downsample(rng):
    pts = rng.uniform(0, 1, (1000, 3)).astype(np.float32)
    out, _ = voxel_downsample(pts, voxel=0.5)
    assert len(out) <= 8
    assert len(out) >= 4


def test_draw_tracks_and_ply(tmp_path, rng):
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    kps = rng.uniform([10, 10], [150, 110], (20, 2)).astype(np.float32)
    valid = np.ones(20, bool)
    is3d = np.zeros(20, bool)
    is3d[:10] = True
    out = draw_tracks(img, kps, valid, is3d)
    assert out.shape == (120, 160, 3) and out.dtype == np.uint8
    assert (out == np.array([0, 255, 0])).all(-1).any()
    assert (out == np.array([80, 130, 255])).all(-1).any()

    p = tmp_path / "cloud.ply"
    export_ply(rng.uniform(size=(50, 3)), str(p),
               colors=rng.integers(0, 255, (50, 3)))
    txt = p.read_text()
    assert "element vertex 50" in txt and "property uchar red" in txt

    poses = [np.concatenate([[1, 0, 0, 0], [0.1 * i, 0, 0]])
             for i in range(10)]
    p2 = tmp_path / "traj.ply"
    export_trajectory_ply(poses, str(p2), frustum_every=3)
    assert "element edge" in p2.read_text()


def test_export_html_viewer(tmp_path, rng):
    n = 40
    poses = np.zeros((n, 7), np.float64)
    poses[:, 0] = 1.0
    poses[:, 4] = np.linspace(0, 3, n)
    pts = rng.normal(0, 1, (500, 3))
    out = tmp_path / "viewer.html"
    export_html_viewer(poses, pts, str(out), lc_pairs=[(0, n - 1)])
    html = out.read_text()
    assert html.startswith("<!doctype html>")
    assert "SLAM_DATA" in html and "frusta" in html
    data = json.loads(html.split("window.SLAM_DATA=")[1]
                      .split(";</script>")[0])
    assert len(data["traj"]) == n
    assert len(data["points"]) == 500
    assert data["lc"] == [[0, n - 1]]
    assert len(data["frusta"][0]) == 5
    assert "http" not in html.split("</title>")[1]
