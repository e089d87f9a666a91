"""Parity: ov2slam_torch.mapping.tsdf against ov2slam_tpu.mapping.tsdf.

- test_tsdf.py's cases on the port (``device="cpu"``);
- ``_tsdf_integrate`` against the JAX function on the same grid, depth,
  colour and pose (colour on and off, constant and 1/z^2 weights): values
  agree within atol 1e-5 (colour, up to 255, also within rtol 1e-6: one f32
  ulp at 255 is 1.5e-5) on every voxel except those whose pixel differs
  between the packages; each of those is shown to lie within 1e-4 px of a
  rounding boundary (u or v at k + 0.5, recomputed in f64);
- ``_esdf_sweep`` exactly (min and add on the same f32 values);
- ``extract_mesh``, ``extract_surface_points`` and ``esdf`` exactly, from a
  JAX volume's state carried across with ``interop.tsdf_volume``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch import interop
from ov2slam_torch.mapping import tsdf as ttsdf
from ov2slam_torch.mapping.tsdf import TsdfVolume
from ov2slam_torch.utils import lie_np
from ov2slam_tpu.mapping import tsdf as jtsdf

torch.set_num_threads(1)

K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
H, W = 96, 128


# ---------------------------------------------------------------------- #
# test_tsdf.py's cases on the port
# ---------------------------------------------------------------------- #

def _wall_volume(**kw):
    """Camera at origin looking +z; wall plane at z = 2.0."""
    vol = TsdfVolume(origin=np.array([-1.5, -1.5, 0.0]),
                     dims=(30, 30, 30), voxel_size=0.1,
                     truncation=0.3, device="cpu", **kw)
    depth = np.full((H, W), 2.0, np.float32)
    rgb = np.zeros((H, W, 3), np.float32)
    rgb[:] = (200, 50, 10)
    vol.integrate(depth, K, lie_np.pose_identity(), rgb=rgb)
    return vol


def test_integrate_zero_crossing_at_surface():
    vol = _wall_volume()
    t = vol.tsdf.numpy().reshape(vol.dims)
    w = vol.weight.numpy().reshape(vol.dims)
    col_t, col_w = t[15, 15], w[15, 15]
    zs = vol.origin[2] + (np.arange(30) + 0.5) * vol.voxel_size
    seen = col_w > 0
    near = seen & (np.abs(zs - 2.0) < 0.25)
    assert near.sum() >= 3
    assert np.all(np.sign(col_t[near]) == np.sign(2.0 - zs[near]))
    assert col_t[seen & (zs < 1.6)].min() > 0.9


def test_surface_points_and_color():
    vol = _wall_volume()
    pts, cols = vol.extract_surface_points()
    assert len(pts) > 50
    assert np.abs(pts[:, 2] - 2.0).max() < 1.5 * vol.voxel_size
    assert cols is not None
    assert np.all(np.abs(cols.astype(int) - [200, 50, 10]) <= 2)


def test_mesh_lies_on_surface(tmp_path):
    vol = _wall_volume()
    verts, faces, cols = vol.extract_mesh()
    assert len(verts) > 50 and len(faces) > 50
    assert np.abs(verts[:, 2] - 2.0).max() < vol.voxel_size
    assert faces.min() >= 0 and faces.max() < len(verts)
    n = vol.export_mesh_ply(str(tmp_path / "mesh.ply"))
    assert n == len(faces)
    head = (tmp_path / "mesh.ply").read_text().splitlines()[:12]
    assert head[0] == "ply" and any("element face" in l for l in head)


def test_multi_view_weighted_fusion():
    vol = _wall_volume()
    w1 = vol.weight.sum().item()
    T2 = lie_np.make_pose(np.array([1.0, 0, 0, 0]),
                          np.array([0.2, 0.0, 0.0]))
    depth = np.full((H, W), 2.0, np.float32)
    vol.integrate(depth, K, T2)
    assert vol.weight.sum().item() > w1
    pts, _ = vol.extract_surface_points()
    assert np.abs(pts[:, 2] - 2.0).max() < 1.5 * vol.voxel_size
    assert vol.n_integrated == 2


def test_esdf_distances():
    vol = _wall_volume()
    d = vol.esdf(max_distance=1.0)
    t = vol.tsdf.numpy().reshape(vol.dims)
    w = vol.weight.numpy().reshape(vol.dims)
    occ = (t < 0) & (w > 0)
    assert d[occ].max() == 0.0
    zs = vol.origin[2] + (np.arange(30) + 0.5) * vol.voxel_size
    iz = int(np.argmin(np.abs(zs - 1.45)))
    true = 2.05 - zs[iz]
    assert abs(d[15, 15, iz] - true) < 0.12
    assert d.max() <= 1.0 + 1e-6


def test_rays_outside_bounds_ignored():
    vol = TsdfVolume(origin=np.array([-1.5, -1.5, 0.0]),
                     dims=(16, 16, 16), voxel_size=0.1,
                     min_ray=0.5, max_ray=10.0, with_color=False,
                     device="cpu")
    depth = np.full((H, W), 0.3, np.float32)
    depth[:10] = np.inf
    vol.integrate(depth, K, lie_np.pose_identity())
    assert vol.weight.sum().item() == 0.0
    assert vol.color is None


# ---------------------------------------------------------------------- #
# _tsdf_integrate and _esdf_sweep against the JAX functions
# ---------------------------------------------------------------------- #

DIMS = (24, 20, 16)
HS, WS = 48, 64
KS = np.array([[60.0, 0, 31.7], [0, 60.0, 23.9], [0, 0, 1]])
ORIGIN = np.array([-1.2, -1.0, 0.2], np.float32)
PARAMS = dict(voxel=0.1, trunc=0.3, min_ray=0.5, max_ray=10.0,
              max_weight=5.0)


def _integrate_inputs(seed=0):
    """A state with some voxels seen before (weights near max_weight, so
    the clamp acts), a noisy depth image (with a few invalid pixels), an
    RGB image and a random pose looking into the grid."""
    rng = np.random.default_rng(seed)
    V = int(np.prod(DIMS))
    seen = rng.random(V) < 0.5
    tsdf = np.where(seen, rng.uniform(-1, 1, V), 1.0).astype(np.float32)
    weight = (rng.uniform(0, 4.9, V) * seen).astype(np.float32)
    color = (rng.uniform(0, 255, (V, 3)) * seen[:, None]).astype(np.float32)
    depth = (1.5 + 0.3 * rng.standard_normal((HS, WS))).astype(np.float32)
    depth[rng.random((HS, WS)) < 0.02] = np.inf
    depth[rng.random((HS, WS)) < 0.02] = 0.2
    rgb = rng.uniform(0, 255, (HS, WS, 3)).astype(np.float32)
    q = np.concatenate([[1.0], rng.normal(0, 0.05, 3)])
    T_wc = np.concatenate([q / np.linalg.norm(q), rng.normal(0, 0.05, 3)])
    return tsdf, weight, color, depth, rgb, T_wc


def _jax_integrate(tsdf, weight, color, depth, rgb, T_cw, const_w, K=KS):
    f = jnp.float32
    p = PARAMS
    out = jtsdf._tsdf_integrate(
        jnp.asarray(tsdf), jnp.asarray(weight),
        None if color is None else jnp.asarray(color), jnp.asarray(depth),
        None if rgb is None else jnp.asarray(rgb),
        jnp.asarray(T_cw, jnp.float32), f(K[0, 0]), f(K[1, 1]),
        f(K[0, 2]), f(K[1, 2]), jnp.asarray(ORIGIN), f(p["voxel"]),
        f(p["trunc"]), f(p["min_ray"]), f(p["max_ray"]),
        f(p["max_weight"]), dims=DIMS, use_const_weight=const_w)
    return [None if o is None else np.asarray(o) for o in out]


def _torch_integrate(tsdf, weight, color, depth, rgb, T_cw, const_w,
                     K=KS):
    p = PARAMS
    state = [torch.tensor(tsdf), torch.tensor(weight),
             None if color is None else torch.tensor(color)]
    ttsdf._tsdf_integrate(
        *state, torch.tensor(depth), None if rgb is None else
        torch.tensor(rgb), np.asarray(T_cw, np.float32), K[0, 0], K[1, 1],
        K[0, 2], K[1, 2], ORIGIN, p["voxel"], p["trunc"], p["min_ray"],
        p["max_ray"], p["max_weight"], dims=DIMS, use_const_weight=const_w)
    return [None if s is None else s.numpy() for s in state]


def _boundary_distance_f64(T_cw, K=KS):
    """Per voxel, the distance in px of its (u, v), computed in f64, to
    the nearest rounding boundary k + 0.5 in either coordinate."""
    nx, ny, nz = DIMS
    idx = np.arange(nx * ny * nz)
    g = np.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz], -1)
    pw = ORIGIN.astype(np.float64) + (g + 0.5) * PARAMS["voxel"]
    pc = lie_np.pose_apply(np.asarray(T_cw, np.float64), pw)
    u = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
    v = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
    return np.minimum(np.abs(u - np.floor(u) - 0.5),
                      np.abs(v - np.floor(v) - 0.5))


@pytest.mark.parametrize("with_color", [True, False])
@pytest.mark.parametrize("const_w", [False, True])
def test_integrate_matches_jax(with_color, const_w):
    tsdf, weight, color, depth, rgb, T_wc = _integrate_inputs()
    if not with_color:
        color = rgb = None
    T_cw = lie_np.pose_inverse(T_wc)
    j = _jax_integrate(tsdf, weight, color, depth, rgb, T_cw, const_w)
    t = _torch_integrate(tsdf, weight, color, depth, rgb, T_cw, const_w)
    assert (j[2] is None) == (t[2] is None) == (not with_color)
    # the update touched voxels, and the clamp to max_weight acted
    assert (t[1] != weight).sum() > 500
    assert (t[1] == PARAMS["max_weight"]).sum() > 0

    bad = np.zeros(len(tsdf), bool)
    bad |= ~np.isclose(t[0], j[0], rtol=0, atol=1e-5)
    bad |= ~np.isclose(t[1], j[1], rtol=0, atol=1e-5)
    if with_color:
        bad |= ~np.isclose(t[2], j[2], rtol=1e-6, atol=1e-5).all(1)
    # every mismatch is a voxel that projects onto a rounding boundary
    near = _boundary_distance_f64(T_cw)
    assert np.all(near[bad] < 1e-4), (bad.sum(), near[bad].max())


def test_integrate_matches_jax_on_rounding_boundaries():
    """An axis-aligned camera whose principal point sits at k + 0.5 px and
    whose translation puts a plane of voxel centres at x = 0 and another
    at y = 0: those centres project onto rounding boundaries, within f32
    noise. Any voxel on which the packages disagree is one of them."""
    K = np.array([[60.0, 0, 31.5], [0, 60.0, 23.5], [0, 0, 1]])
    tsdf, weight, color, depth, rgb, _ = _integrate_inputs(seed=1)
    T_cw = np.array([1.0, 0, 0, 0, 0.05, 0.05, 0.0])
    j = _jax_integrate(tsdf, weight, color, depth, rgb, T_cw, False, K)
    t = _torch_integrate(tsdf, weight, color, depth, rgb, T_cw, False, K)
    bad = (~np.isclose(t[0], j[0], rtol=0, atol=1e-5)
           | ~np.isclose(t[1], j[1], rtol=0, atol=1e-5)
           | ~np.isclose(t[2], j[2], rtol=1e-6, atol=1e-5).all(1))
    near = _boundary_distance_f64(T_cw, K)
    assert (near < 1e-4).sum() >= 100       # the boundaries are exercised
    assert np.all(near[bad] < 1e-4)


def test_esdf_sweep_matches_jax_exactly():
    rng = np.random.default_rng(3)
    occ = rng.random(DIMS) < 0.01
    d0 = np.where(occ, 0.0, 1e9).astype(np.float32)
    j = np.asarray(jtsdf._esdf_sweep(jnp.asarray(d0), jnp.float32(0.1), 9))
    t = ttsdf._esdf_sweep(torch.tensor(d0), 0.1, 9).numpy()
    assert (t < 1e9).sum() > occ.sum()
    np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------- #
# host queries from a state carried across
# ---------------------------------------------------------------------- #

def _jax_street_volume(with_color):
    """A JAX volume that fused three views of a wall and a floor."""
    vol = jtsdf.TsdfVolume(origin=np.array([-1.5, -1.5, 0.0]),
                           dims=(30, 30, 30), with_color=with_color)
    rng = np.random.default_rng(5)
    for k in range(3):
        depth = np.full((H, W), 2.0, np.float32)
        depth[60:] = np.linspace(1.2, 1.9, 36)[:, None]   # a floor
        depth += rng.normal(0, 0.01, depth.shape).astype(np.float32)
        rgb = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
        T = lie_np.make_pose(np.array([1.0, 0, 0, 0]),
                             np.array([0.1 * k, 0.05 * k, 0.0]))
        vol.integrate(depth, K, T, rgb=rgb)
    return vol


def _state(vol):
    return dict(tsdf=np.asarray(vol.tsdf), weight=np.asarray(vol.weight),
                color=None if vol.color is None else np.asarray(vol.color),
                origin=vol.origin, dims=vol.dims,
                voxel_size=vol.voxel_size, truncation=vol.truncation,
                min_ray=vol.min_ray, max_ray=vol.max_ray,
                use_const_weight=vol.use_const_weight,
                max_weight=vol.max_weight, n_integrated=vol.n_integrated)


@pytest.mark.parametrize("with_color", [True, False])
def test_mesh_surface_and_esdf_equal_from_carried_state(with_color):
    jvol = _jax_street_volume(with_color)
    tvol = interop.tsdf_volume(_state(jvol), device="cpu")
    assert tvol.n_integrated == 3 and tvol.dims == (30, 30, 30)
    assert (tvol.color is None) == (not with_color)
    jv, jf, jc = jvol.extract_mesh()
    tv, tf, tc = tvol.extract_mesh()
    assert len(jv) > 100 and len(jf) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    if with_color:
        np.testing.assert_array_equal(tc, jc)
    else:
        assert tc is None and jc is None
    jp, jcol = jvol.extract_surface_points()
    tp, tcol = tvol.extract_surface_points()
    np.testing.assert_array_equal(tp, jp)
    if with_color:
        np.testing.assert_array_equal(tcol, jcol)
    np.testing.assert_array_equal(tvol.esdf(max_distance=0.8),
                                  jvol.esdf(max_distance=0.8))


def test_interop_rejects_a_state_of_the_wrong_size():
    state = _state(_jax_street_volume(False))
    state["tsdf"] = state["tsdf"][:-1]
    with pytest.raises(ValueError):
        interop.tsdf_volume(state, device="cpu")
