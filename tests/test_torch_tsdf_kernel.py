"""The dense-fusion kernels (``csrc/tsdf.cu``: the TSDF integration and the
ESDF sweep), their wrappers and plain versions (``mapping/tsdf.py``:
``_tsdf_integrate`` and ``_esdf_sweep``, each with its ``_plain`` form).

On the CPU, on grids and images made from a numpy seed:
- the wrappers take the plain versions and equal them bit for bit, the
  integration in all four option sets (colour on or off x
  ``use_const_weight``), the sweep at 0, 1 and 9 sweeps, leaving its input
  as it was; ``TsdfVolume.esdf`` equal to the field the host-built
  occupancy grid gave;
- the launch packing: the f32 constants the kernel gets (the reciprocal of
  ``trunc`` as ATen forms it for a CPU-scalar divisor, ``-trunc``, the
  clamps' 1e-3 and 1e-9, ``max_weight``, the f32 pose and intrinsics),
  the colour pointers (both or neither), the sweep's voxel and padding;
  and the refusals: a wrong dtype, a tensor that is not contiguous, a V
  or colour shape that does not match the grid or the image, a depth
  that is not 2-D, a pose given as a tensor, 2^31 voxels or more, a
  sweep grid that is not 3-D or beyond one launch, a negative count;
- both launch functions against the exported C functions' parameters in
  ``csrc/tsdf.cu`` (``kernels.entry_points``), and the bounds;
- the device-built occupancy grid (``TsdfVolume._occupancy``) equal to
  the one ``_grids`` gives on the host, weights at f32(1e-4) and just
  below it, -0.0 and NaN included;
- the two behaviours of the reference the kernel keeps, pinned against
  the JAX ``TsdfVolume``: a NaN depth poisons the voxels whose (clipped)
  pixel it is, in the frustum or not, with the same NaN mask in both
  packages; a voxel no integration observed gets tsdf 0.

On the card (skipped without one, decided inside the test; the fixtures
are ``chip_smoke``'s): each kernel against its plain version at atol 0
(bits, NaNs by position), the integration in every option set on the odd
37x29x23 grid and the sweeps on its occupancy (the scalar sweep kernel)
and on a 37x29x24 one (the float4 kernel). The file imports no JAX at
module level: on the card ``python -m pytest --noconftest
tests/test_torch_tsdf_kernel.py`` runs it (the tests that hold the JAX
package skip there).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from ov2slam_torch import kernels, roofline
from ov2slam_torch.mapping import tsdf as T
from ov2slam_torch.mapping.tsdf import TsdfVolume
from ov2slam_torch.utils import lie_np

torch.set_num_threads(1)

CPU = torch.device("cpu")
DIMS = (11, 9, 7)
HS, WS = 24, 32
KS = np.array([[30.0, 0, 16.5], [0, 30.0, 12.5], [0, 0, 1]])
ORIGIN = np.array([-0.55, -0.45, 0.3], np.float32)
PARAMS = dict(voxel=0.1, trunc=0.3, min_ray=0.5, max_ray=10.0,
              max_weight=5.0)
OPTIONS = [(c, w) for c in (True, False) for w in (False, True)]
OPTION_IDS = [f"{'color' if c else 'nocolor'}-{'const' if w else 'invz2'}"
              for c, w in OPTIONS]


def _jax():
    """JAX as tests/conftest.py sets it up (f64, the CPU), also where a run
    goes without it (on the card); skips where there is no JAX."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    return jax


def _inputs(seed=0):
    """A state seen before in half its voxels, a depth image holding NaN,
    +-inf and values outside the ray bounds, a colour image and a pose
    looking into the grid (T_cw, f32)."""
    rng = np.random.default_rng(seed)
    V = int(np.prod(DIMS))
    seen = rng.random(V) < 0.5
    tsdf = np.where(seen, rng.uniform(-1, 1, V), 1.0).astype(np.float32)
    weight = (rng.uniform(0, 4.9, V) * seen).astype(np.float32)
    color = (rng.uniform(0, 255, (V, 3)) * seen[:, None]).astype(np.float32)
    depth = rng.uniform(0.6, 2.0, (HS, WS)).astype(np.float32)
    for value, share in ((np.nan, 0.05), (np.inf, 0.03), (-np.inf, 0.03),
                         (0.2, 0.05), (12.0, 0.05)):
        depth[rng.random((HS, WS)) < share] = value
    rgb = rng.uniform(0, 255, (HS, WS, 3)).astype(np.float32)
    q = np.concatenate([[1.0], rng.normal(0, 0.05, 3)])
    T_wc = np.concatenate([q / np.linalg.norm(q), rng.normal(0, 0.05, 3)])
    T_cw = np.asarray(lie_np.pose_inverse(T_wc), np.float32)
    return [torch.tensor(a) for a in (tsdf, weight, color, depth, rgb)], T_cw


def _args(depth, rgb, T_cw):
    p = PARAMS
    return (depth, rgb, T_cw, KS[0, 0], KS[1, 1], KS[0, 2], KS[1, 2],
            ORIGIN, p["voxel"], p["trunc"], p["min_ray"], p["max_ray"],
            p["max_weight"])


def _bits_equal(a, b):
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


# ------------------------------------------------------- CPU wrappers #

@pytest.mark.parametrize("color,const", OPTIONS, ids=OPTION_IDS)
def test_cpu_integrate_is_the_plain_version(color, const):
    (tsdf, weight, col, depth, rgb), T_cw = _inputs()
    if not color:
        col = rgb = None
    runs = []
    for fn in (T._tsdf_integrate, T._tsdf_integrate_plain):
        st = [tsdf.clone(), weight.clone(),
              None if col is None else col.clone()]
        for k in range(2):
            fn(*st, *_args(depth, rgb, T_cw), dims=DIMS,
               use_const_weight=const)
        runs.append(st)
    launches = T._tsdf_integrate.launches
    for a, b in zip(*runs):
        if a is not None:
            assert _bits_equal(a, b)
    assert T._tsdf_integrate.launches == launches
    assert (runs[0][1] != weight).sum() > 20        # voxels were updated
    assert runs[0][0].isnan().any()                 # and some poisoned


@pytest.mark.parametrize("n_iters", [0, 1, 9])
def test_cpu_sweep_is_the_plain_version_and_keeps_its_input(n_iters):
    rng = np.random.default_rng(3)
    d0 = torch.tensor(np.where(rng.random(DIMS) < 0.03, 0.0, 1e9)
                      .astype(np.float32))
    d0[2, 3, 4] = float("nan")
    before = d0.clone()
    out = T._esdf_sweep(d0, 0.1, n_iters)
    assert _bits_equal(out, T._esdf_sweep_plain(d0, 0.1, n_iters))
    assert _bits_equal(d0, before) and out.data_ptr() != d0.data_ptr()


def test_esdf_equals_the_host_built_field():
    vol = TsdfVolume(origin=ORIGIN, dims=DIMS, voxel_size=0.1,
                     truncation=0.3, device="cpu")
    (_, _, _, depth, rgb), T_cw = _inputs(seed=2)
    vol.integrate(depth, KS, lie_np.pose_inverse(T_cw.astype(np.float64)),
                  rgb=rgb)
    t, obs = vol._grids(1e-4)
    d0 = np.where((t < 0) & obs, 0.0, 1e9).astype(np.float32)
    ref = T._esdf_sweep_plain(torch.tensor(d0), 0.1, 8).numpy()
    np.testing.assert_array_equal(vol.esdf(max_distance=0.8),
                                  np.minimum(ref, 0.8))


# ------------------------------------------------------------ packing #

def test_pack_integrate_gives_the_plain_versions_f32_constants():
    (tsdf, weight, col, depth, rgb), T_cw = _inputs()
    a = T.pack_integrate(tsdf, weight, col, depth, rgb,
                         *_args(depth, rgb, T_cw)[2:], DIMS, False)
    f32 = np.float32
    # sdf / trunc on the card: a * (1 / b) with the reciprocal in f32
    assert a.inv_trunc == f32(1.0) / f32(0.3)
    assert a.neg_trunc == -f32(0.3)
    assert (a.z_min, a.min_depth, a.min_denom) == (
        f32(1e-6), f32(1e-3), f32(1e-9))
    assert (a.min_ray, a.max_ray, a.max_weight) == (f32(0.5), f32(10.0),
                                                     f32(5.0))
    assert [a.qw, a.qx, a.qy, a.qz, a.tx, a.ty, a.tz] == T_cw.tolist()
    assert (a.fx, a.fy, a.cx, a.cy) == (30.0, 30.0, 16.5, 12.5)
    assert (a.ox, a.oy, a.oz) == tuple(ORIGIN.tolist())
    assert a.voxel == f32(0.1)
    assert (a.nx, a.ny, a.nz, a.H, a.W) == (*DIMS, HS, WS)
    assert (a.tsdf, a.weight, a.color, a.depth, a.rgb) == tuple(
        x.data_ptr() for x in (tsdf, weight, col, depth, rgb))
    assert a.const_weight == 0
    # every value is exact in f32, as the kernel takes it
    for name in T.IntegrateLaunch._fields[10:33]:
        v = getattr(a, name)
        assert v == float(f32(v)), name
    # colour needs both the state's and the image's: else neither goes
    for c, r in ((col, None), (None, rgb)):
        b = T.pack_integrate(tsdf, weight, c, depth, r,
                             *_args(depth, rgb, T_cw)[2:], DIMS, True)
        assert b.color == b.rgb == 0 and b.const_weight == 1


def test_inv_trunc_is_atens_cpu_scalar_reciprocal():
    # the product with the f32 reciprocal differs from the division on
    # some values: the kernel follows the card's product
    a = T.pack_integrate(*[torch.zeros(1), torch.zeros(1), None,
                           torch.zeros((1, 1)), None],
                         np.array([1, 0, 0, 0, 0, 0, 0]), 1, 1, 0, 0,
                         np.zeros(3), 0.1, 0.3, 0.5, 10.0, 1e4, (1, 1, 1),
                         False)
    sdf = torch.linspace(-0.4, 0.4, 20001)
    prod = sdf * torch.tensor(a.inv_trunc, dtype=torch.float32)
    assert (prod != sdf / T._f32(0.3)).any()
    assert a.inv_trunc == float(torch.tensor(1.0) / torch.tensor(T._f32(0.3)))


def _refusal_inputs():
    (tsdf, weight, col, depth, rgb), T_cw = _inputs()
    return dict(tsdf=tsdf, weight=weight, color=col, depth=depth, rgb=rgb,
                T_cw=T_cw)


@pytest.mark.parametrize("change,err", [
    (dict(tsdf=lambda x: x.double()), TypeError),
    (dict(weight=lambda x: x.to(torch.float16)), TypeError),
    (dict(depth=lambda x: x.double()), TypeError),
    (dict(tsdf=lambda x: torch.zeros(2 * x.numel())[::2]), ValueError),
    (dict(depth=lambda x: x.t().contiguous().t()), ValueError),
    (dict(tsdf=lambda x: torch.zeros(x.numel() + 1)), ValueError),
    (dict(weight=lambda x: torch.zeros(x.numel() - 1)), ValueError),
    (dict(color=lambda x: torch.zeros((x.shape[0], 4))), ValueError),
    (dict(rgb=lambda x: torch.zeros((HS, WS, 4))), ValueError),
    (dict(rgb=lambda x: torch.zeros((HS + 1, WS, 3))), ValueError),
    (dict(depth=lambda x: x.reshape(-1)), ValueError),
    (dict(depth=lambda x: x[None]), ValueError),
    (dict(T_cw=lambda x: torch.tensor(x)), TypeError),
    (dict(T_cw=lambda x: x[:6]), ValueError)],
    ids=["tsdf-f64", "weight-f16", "depth-f64", "tsdf-strided",
         "depth-transposed", "V-plus-1", "weight-V-minus-1", "color-4",
         "rgb-4", "rgb-rows", "depth-1d", "depth-3d", "pose-tensor",
         "pose-6"])
def test_pack_integrate_refuses(change, err):
    x = _refusal_inputs()
    for k, f in change.items():
        x[k] = f(x[k])
    with pytest.raises(err):
        T.pack_integrate(x["tsdf"], x["weight"], x["color"], x["depth"],
                         x["rgb"], *_args(x["depth"], x["rgb"],
                                          x["T_cw"])[2:], DIMS, False)


def test_pack_refuses_2_to_the_31_voxels():
    x = _refusal_inputs()
    for dims in ((2048, 1024, 1024), (1 << 31, 1, 1)):
        with pytest.raises(ValueError, match="2\\^31"):
            T.pack_integrate(x["tsdf"], x["weight"], x["color"], x["depth"],
                             x["rgb"], *_args(x["depth"], x["rgb"],
                                              x["T_cw"])[2:], dims, False)
    a = T.pack_integrate(x["tsdf"][:1], x["weight"][:1], None, x["depth"],
                         None, *_args(x["depth"], None, x["T_cw"])[2:],
                         (1, 1, 1), False)
    assert a.nx * a.ny * a.nz == 1


def test_pack_sweep_and_its_refusals():
    d = torch.zeros(DIMS)
    dims, vox, pad = T.pack_sweep(d, 0.1, 50)
    assert dims == DIMS and vox == np.float32(0.1) and pad == 1e9
    for bad, err in ((d.double(), TypeError), (d[0], ValueError),
                     (d.transpose(0, 2), ValueError),
                     (torch.zeros((1, 8 * 65535 + 1, 1)), ValueError)):
        with pytest.raises(err):
            T.pack_sweep(bad, 0.1, 3)
    for n in (-1, 2.0):
        with pytest.raises(ValueError):
            T.pack_sweep(d, 0.1, n)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float}


def _c_params(fn):
    with open(os.path.join(kernels.CSRC, "tsdf.cu")) as f:
        text = f.read()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, fn
    out = []
    for p in m.group(1).split(","):
        decl = " ".join(p.split())
        t = decl.rsplit(" ", 1)[0].replace(" *", "*")
        if decl.rsplit(" ", 1)[1].startswith("*"):
            t += "*"
        out.append(_C_TYPES[t])
    return out


@pytest.mark.parametrize("fn", list(kernels.entry_points("tsdf")))
def test_signatures_match_the_c_source(fn):
    restype, argtypes = kernels.entry_points("tsdf")[fn]
    assert restype is ctypes.c_int and "tsdf" in kernels.KERNELS
    assert argtypes == _c_params(fn)
    if fn == "tsdf_integrate_launch":
        # the packed launch, then the stream
        assert len(argtypes) == len(T.IntegrateLaunch._fields) + 1


def test_every_launch_function_is_registered():
    with open(os.path.join(kernels.CSRC, "tsdf.cu")) as f:
        text = f.read()
    assert set(re.findall(r'extern "C" int (\w+)\(', text)) == set(
        kernels.entry_points("tsdf"))
    assert "tsdf" not in kernels._INIT


@pytest.mark.parametrize("fn,figures", [
    # slice G: 40 bytes a voxel, the depth and colour images once, 92
    # operations a voxel
    (lambda r: r.tsdf_integrate_bound(640 * 640 * 64, 600, 800),
     (26214400 * 92, 26214400 * 40 + 480000 * 16, "bytes")),
    (lambda r: r.tsdf_integrate_bound(1000, 10, 10, color=False,
                                      const_weight=True),
     (1000 * 76, 16000 + 400, "bytes")),
    (lambda r: r.esdf_sweep_bound(640 * 640 * 64),
     (26214400 * 12, 26214400 * 8, "bytes")),
    (lambda r: r.esdf_sweep_bound(1000, sweeps=50),
     (50 * 12000, 50 * 8000, "bytes"))],
    ids=["integrate-slice-g", "integrate-plain-options", "sweep-slice-g",
         "sweeps"])
def test_roofline_bounds(fn, figures):
    b = fn(roofline)
    assert (b["ops"], b["bytes"], b["bound_by"]) == figures
    assert b["bound_ms"] == pytest.approx(1e3 * figures[1]
                                          / roofline.HBM_BYTES_PER_S)


# ------------------------------------------- the occupancy on the device #

def test_occupancy_on_the_device_equals_the_hosts():
    vol = TsdfVolume(origin=ORIGIN, dims=DIMS, device="cpu")
    rng = np.random.default_rng(4)
    V = vol.tsdf.numel()
    t = rng.uniform(-1, 1, V).astype(np.float32)
    t[:10] = [-0.0, 0.0, np.nan, -1e-30, 1e-30, -np.inf, np.inf, -1, 1, -0.5]
    w = rng.choice(np.array([0.0, 1e-4, 2e-4, 5e-5, 1.0], np.float32), V)
    w[:5] = [np.float32(1e-4), np.nextafter(np.float32(1e-4), np.float32(0)),
             np.nextafter(np.float32(1e-4), np.float32(1)), 0.0, np.nan]
    t[10:15] = -0.25
    w[10:15] = [1e-4, 5e-5, 1.0, 0.0, 2e-4]
    vol.tsdf.copy_(torch.tensor(t))
    vol.weight.copy_(torch.tensor(w))
    for min_weight in (1e-4, 0.0, 1.0):
        tt, obs = vol._grids(min_weight)
        host = np.where((tt < 0) & obs, 0.0, 1e9).astype(np.float32)
        dev = vol._occupancy(min_weight)
        assert dev.dtype == torch.float32 and tuple(dev.shape) == DIMS
        np.testing.assert_array_equal(dev.numpy(), host)
    assert (vol._occupancy(1e-4).reshape(-1)[10:15] == 0).tolist() == [
        True, False, True, False, True]


# ------------------------- behaviours of the reference the kernel keeps #

def _both_volumes(**kw):
    from ov2slam_tpu.mapping import tsdf as jtsdf

    args = dict(origin=np.array([-0.8, -0.8, 0.2]), dims=(16, 16, 16),
                voxel_size=0.1, truncation=0.3, **kw)
    return jtsdf.TsdfVolume(**args), TsdfVolume(device="cpu", **args)


def test_nan_depth_poisons_the_same_voxels_as_the_reference():
    _jax()
    jvol, tvol = _both_volumes(with_color=False)
    K = np.array([[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1]])
    depth = np.full((48, 64), 1.0, np.float32)
    depth[:, 32:] = np.nan
    pose = lie_np.pose_identity()
    jvol.integrate(depth, K, pose)
    tvol.integrate(depth, K, pose)
    jn = np.isnan(np.asarray(jvol.tsdf))
    tn = tvol.tsdf.isnan().numpy()
    np.testing.assert_array_equal(tn, jn)
    # half the image NaN: half the grid poisoned, inside the frustum and
    # out of it (a voxel whose clipped pixel lies in the NaN half)
    _, in_img, _ = T._voxel_pixels(tvol.dims, tvol.origin, 0.1,
                                   np.asarray(pose, np.float32), 40.0, 40.0,
                                   32.0, 24.0, depth.shape, CPU)
    assert jn.sum() >= jn.size // 2
    assert (jn & in_img.numpy()).any() and (jn & ~in_img.numpy()).any()
    w = np.asarray(jvol.weight)
    assert (w[jn] == 0).all()
    np.testing.assert_array_equal(tvol.weight.numpy(), w)


def test_never_observed_voxels_get_tsdf_zero_as_in_the_reference():
    _jax()
    jvol, tvol = _both_volumes(with_color=True)
    K = np.array([[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1]])
    depth = np.full((48, 64), 1.0, np.float32)
    pose = lie_np.pose_identity()
    rng = np.random.default_rng(6)
    rgb = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    jvol.integrate(depth, K, pose, rgb=rgb)
    tvol.integrate(depth, K, pose, rgb=rgb)
    jt, jw = np.asarray(jvol.tsdf), np.asarray(jvol.weight)
    unseen = jw == 0
    assert 0 < unseen.sum() < unseen.size
    assert (jt[unseen] == 0).all() and (tvol.tsdf.numpy()[unseen] == 0).all()
    np.testing.assert_array_equal(tvol.weight.numpy() == 0, unseen)
    assert (tvol.color.numpy()[unseen] == 0).all()


# --------------------------------------------------------------- card #

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cuda_integrate_bit_equal_to_plain_on_the_odd_grid():
    dev = _card()
    errs = {}
    case = chip_smoke.tsdf_odd_case(dev)
    n0 = T._tsdf_integrate.launches
    held, nan = chip_smoke.tsdf_integrate_check("odd grid", case, errs)
    assert held == 3 * 10 and nan > 0
    assert errs == dict(tsdf_integrate=0.0)
    assert T._tsdf_integrate.launches - n0 == 3 * len(chip_smoke.TSDF_OPTIONS)


def test_cuda_sweeps_bit_equal_to_plain_on_the_odd_grid():
    dev = _card()
    errs = {}
    n0 = T._esdf_sweep.launches
    held, nan, sweep_nan = chip_smoke.tsdf_odd_check(dev, errs)
    assert held == 34 and nan > 0 and sweep_nan > 0
    assert errs == dict(tsdf_integrate=0.0, esdf_sweep=0.0)
    assert T._esdf_sweep.launches - n0 == 2 * (
        50 + chip_smoke.TSDF_SWEEPS_NAN)


def test_cuda_wrappers_refuse_f64():
    dev = _card()
    d = torch.zeros(DIMS, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        T._esdf_sweep(d, 0.1, 2)
    (tsdf, weight, col, depth, rgb), T_cw = _inputs()
    with pytest.raises(TypeError):
        T._tsdf_integrate(tsdf.double().to(dev), weight.to(dev), None,
                          depth.to(dev), None, *_args(depth, None, T_cw)[2:],
                          dims=DIMS, use_const_weight=False)
