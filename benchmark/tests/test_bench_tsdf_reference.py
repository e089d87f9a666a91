"""The plain TSDF reference: a hand-computed 4x4x4 case, bit-equality with
the program's plain path on the CPU, and its bfloat16 control refused."""

import numpy as np
import torch

from benchmark.reference import tsdf as ref_tsdf


def _grid(**kw):
    g = dict(dims=[4, 4, 4], voxel=1.0, origin=[-2.0, -2.0, 0.0], trunc=0.5,
             min_ray=0.1, max_ray=10.0, const_weight=False,
             max_weight=1e4, color=True)
    g.update(kw)
    return g


def test_one_integration_of_a_flat_wall_by_hand():
    # a camera at the origin looking along +z at a wall 2.2 m away; the
    # voxel centres lie at z = 0.5, 1.5, 2.5, 3.5 on x, y = -1.5 .. 1.5
    K = np.array([[0.5, 0, 2.0], [0, 0.5, 2.0], [0, 0, 1.0]])
    depth = torch.full((5, 5), 2.2)
    rgb = torch.full((5, 5, 3), 100.0)
    T_wc = np.array([1.0, 0, 0, 0, 0, 0, 0])
    grid = _grid()
    idx = torch.arange(64)
    out = ref_tsdf.fuse(idx, [(depth, rgb, T_wc)], [0], K, grid)
    t = out["tsdf"].view(4, 4, 4)
    w = out["weight"].view(4, 4, 4)
    c = out["color"].view(4, 4, 4, 3)
    # every centre projects inside the 5x5 image: u = 0.5 x / z + 2
    for k, z in enumerate((0.5, 1.5, 2.5, 3.5)):
        sdf = 2.2 - z
        if sdf > -0.5:      # in front of the wall or within the band
            expect = min(max(sdf / 0.5, -1.0), 1.0)
            assert torch.allclose(t[:, :, k], torch.tensor(expect),
                                  atol=1e-6)
            assert torch.allclose(w[:, :, k], torch.tensor(1 / 2.2 ** 2))
            assert torch.allclose(c[:, :, k], torch.tensor(100.0))
        else:               # beyond the band behind it: no weight
            assert (w[:, :, k] == 0).all() and (t[:, :, k] == 0).all()


def _program_plain(frames, order, K, grid, dims):
    from ov2slam_torch.mapping import tsdf as prog

    vol = prog.TsdfVolume(origin=np.asarray(grid["origin"], np.float32),
                          dims=tuple(dims), voxel_size=grid["voxel"],
                          truncation=grid["trunc"], min_ray=grid["min_ray"],
                          max_ray=grid["max_ray"],
                          use_const_weight=grid["const_weight"],
                          max_weight=grid["max_weight"],
                          with_color=grid["color"], device="cpu")
    for f in order:
        d, c, T = frames[f]
        vol.integrate(d, K, T, rgb=c)
    return dict(tsdf=vol.tsdf, weight=vol.weight, color=vol.color)


def _frames(rng, n, H=12, W=16):
    out = []
    for _ in range(n):
        d = torch.as_tensor(rng.uniform(0.3, 12.0, (H, W)), dtype=torch.float32)
        d[rng.random((H, W)) < 0.05] = float("nan")
        d[rng.random((H, W)) < 0.05] = float("inf")
        c = torch.as_tensor(rng.uniform(0, 255, (H, W, 3)), dtype=torch.float32)
        ang = rng.uniform(-0.5, 0.5)
        q = np.array([np.cos(ang / 2), 0, np.sin(ang / 2), 0])
        t = rng.uniform(-1, 1, 3)
        out.append((d, c, np.concatenate([q, t])))
    return out


def test_the_reference_rounds_as_the_program_plain_path(one_thread):
    rng = np.random.default_rng(11)
    dims = [10, 9, 8]
    grid = _grid(dims=dims, voxel=0.7, origin=[-3.0, -3.0, -1.0], trunc=0.6,
                 max_weight=3.0)
    K = np.array([[9.0, 0, 7.5], [0, 9.0, 5.5], [0, 0, 1.0]])
    frames = _frames(rng, 4)
    order = [0, 1, 2, 3, 2, 1, 0, 1, 3, 3]
    prog = _program_plain(frames, order, K, grid, dims)
    idx = ref_tsdf.sample_voxels(10 * 9 * 8, 300, seed=2 ** 40 + 3)
    ref = ref_tsdf.fuse(idx, frames, order, K, grid)
    got = {k: v[idx] for k, v in prog.items()}
    nums = ref_tsdf.compare(got, ref)
    assert nums == dict(tsdf_nan_mismatch=0.0, tsdf_max_err=0.0,
                        weight_max_rel_err=0.0, color_max_err=0.0)
    assert torch.isnan(ref["tsdf"]).any() and (ref["weight"] > 0).any()


def test_the_bfloat16_control_is_refused_at_the_cells_limits(one_thread):
    from benchmark import common, controls

    from .small import fuse_cell

    cell = fuse_cell()
    out = controls.fuse_control(cell, 2 ** 33 + 1, 240, "cpu")
    assert out["refused"], out
    lim = common.workload("carla_rig.fuse")["check"]["limits"]
    assert out["numbers"]["tsdf_max_err"] > 10 * lim["tsdf_max_err"]
