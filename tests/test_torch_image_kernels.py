"""The front end's image and camera kernels (``csrc/undistort_points.cu``,
``csrc/separable_filter.cu``: one image, the pyramid, Scharr's pair;
``csrc/clahe.cu``), their wrappers and plain versions (``core/camera.py``:
``undistort_points``, ``distort_points``, the tracks' tail
``undistort_normalize``; ``core/image.py``:
``separable_filter`` and the filters built on it, ``build_pyramid``,
``scharr_gradients``, ``clahe``; each with its ``_plain`` form).

On the CPU, on images and points made from a numpy seed at 376x240 and at
an odd 377x241 (ragged CLAHE tiles, odd pyramid levels):
- the plain versions compute what the code they replaced computed, bit
  for bit: the front end's fixed-point undistortion and distortion, and
  the pyramid level at stride 2 against the filter, then every other row
  and column; the callers that route through the wrappers
  (``_undistort_px``, ``Camera.undistort_px``,
  ``project_cam_to_image_dist``) get the plain versions' outputs on the
  CPU;
- the plain versions agree with the JAX package's functions within
  tests/test_torch_image_camera.py's tolerances (f32 on both sides: the
  filters and the pyramid 1e-4 of 255, CLAHE 1e-3, points 1e-3 px): the
  pyramid, the blur, the box filter, Scharr's gradients (each pass
  order), a filter run along x first, CLAHE, and the undistortion and
  both distortion modes through a radtan and a fisheye camera;
- the plain 4-level pyramid and Scharr pair against the JAX package's
  ``build_pyramid`` and ``scharr_gradients`` at 376x240, 377x241 and
  752x480 (1e-4 of 255), and the CPU wrappers equal to them bit for bit;
- the launch packing: the taps the kernel gets (non-zero ones, in order,
  with their offsets), the clip limit in f32, the scan's threads a row as
  ATen computes them, the pyramid's launches (three levels a launch, each
  from the deepest level the one before wrote) and ceil level shapes; and
  its refusals: more than 9 taps, a stride other than 1 or 2, an image
  that is not contiguous or not f32, CLAHE shapes whose excess torch.sum
  adds in another order, pyramid levels that are not a positive int,
  points whose values are not adjacent, intrinsics that are not one
  element;
- every launch function of the three libraries (``kernels.entry_points``)
  against the exported C function's parameters in the ``.cu`` source;
- the tracks' tail: its plain version against the JAX package's own
  expressions (``jnp.where``, ``frontend_step._undistort_px``, the
  ``(. - c) / f`` of its tracking and stereo steps) in every option set,
  at 1, 127, 300 and 512 rows, the slots' pixels and the reference rows
  as column views of a packed state (1e-3 px, 1e-5 normalised; the select
  and the pair mask exact), the CPU wrapper equal to it bit for bit; the
  tracking step on the CPU equal to the code the tail replaced, in every
  output, with and without the epipolar gate; the stereo step's bearings
  equal to those it computed again before; the tail's packing (column
  views read in place) and its refusals.

On the card (skipped without one, decided inside the test; the fixtures are
``chip_smoke.image_cases``'): every output of the kernels bit-equal to its
plain version on the card, and a second launch to the first, at 752x480,
376x240, 1241x376, 640x480 and 377x241 (radtan and fisheye points; CLAHE
at clip 3 and at 2.7, whose limit's fractional bits make the excess sum's
order count at 1241x376 and 377x241; the pyramid at 4 levels, one launch,
and at 6, two; two filters in the kernel's generic form); a CUDA-graph
replay of CLAHE, the pyramid, Scharr's gradients and the undistortion
bit-equal to the eager call, its launches counted at each replay (one a
call each); the tail bit-equal to its plain version in every option set
and to the eager sequence it replaced (``chip_smoke.tail_cases``, 512 and
301 rows), and in a CUDA-graph replay; an f64 CUDA tensor refused with
TypeError by each wrapper. The file
imports no JAX at module level: on the card ``python -m pytest
--noconftest tests/test_torch_image_kernels.py`` runs it (the tests that
hold the JAX package skip there).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from ov2slam_torch import kernels
from ov2slam_torch.core import camera as cm
from ov2slam_torch.core import image as im

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = ((376, 240), (377, 241))
PYR = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
SMOOTH = [3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0]
DIFF = [-0.5, 0.0, 0.5]


def _jax():
    """JAX as tests/conftest.py sets it up (f64, the CPU), also where a run
    goes without it (on the card); skips where there is no JAX."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    return jax


def _img(size, seed=0):
    W, H = size
    return torch.as_tensor(chip_smoke.image_fixture(W, H, seed))


def _bits_equal(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _cam(kind, dev=CPU):
    return chip_smoke.image_camera(kind, dev)


# ----------------------------------------------------------------- CPU #

@pytest.mark.parametrize("size", SIZES, ids=["376x240", "377x241"])
def test_pyr_down_at_stride_two_equals_filter_then_decimate(size):
    # the kernel's stride 2 computes only the kept rows and columns; the
    # plain version at stride 2 is the old filter, then every other one
    img = _img(size)
    assert _bits_equal(im.pyr_down(img), im._filter_x(
        im._filter_y(img, PYR), PYR)[::2, ::2].contiguous())


@pytest.mark.parametrize("kind", ["radtan", "fisheye"])
def test_point_wrappers_and_their_callers_on_cpu(kind):
    from ov2slam_torch.models.frontend_step import CalibArrays, _undistort_px

    c = _cam(kind)
    fe = kind == "fisheye"
    px = chip_smoke.image_points(752, 480, 300, 5, CPU)
    und = cm.undistort_points_plain(px, *c, fe)
    assert _bits_equal(cm.undistort_points(px, *c, fe), und)
    assert _bits_equal(_undistort_px(px, CalibArrays(*c), fe), und)
    # the plain version is the front end's arithmetic as it was
    f, cc = torch.stack(c[0:2]), torch.stack(c[2:4])
    fn = cm.distort_fisheye if fe else cm.distort_radtan
    xn = (px - cc) / f
    xu = xn
    for _ in range(8):
        xu = xn - (fn(xu, c[4]) - xu)
    assert _bits_equal(und, xu * f + cc)
    assert _bits_equal(cm.distort_points(px, *c, fe),
                       fn((px - cc) / f, c[4]) * f + cc)
    assert _bits_equal(cm.distort_points(xn, *c, fe, normalized=True),
                       fn(xn, c[4]) * f + cc)
    assert cm.undistort_points_plain.cuda_runs == 0
    assert cm.distort_points_plain.cuda_runs == 0


def test_camera_methods_route_through_the_wrappers():
    from ov2slam_torch.utils.config import CameraConfig

    (fx, fy, cx, cy), dist = chip_smoke.IMAGE_CAMS["radtan"]
    cam = cm.build_camera(CameraConfig(model="pinhole", width=188,
                                       height=120, fx=fx, fy=fy, cx=cx,
                                       cy=cy, dist=dist), device=CPU)
    px = chip_smoke.image_points(188, 120, 50, 2, CPU)
    assert _bits_equal(cam.undistort_px(px), cm.undistort_points_plain(
        px, *cam._intrinsics(), cam.dist))
    pts = torch.tensor([[0.1, -0.2, 2.0], [-0.5, 0.3, 4.0]])
    xn = pts[:, 0:2] / pts[:, 2:3]
    assert _bits_equal(cam.project_cam_to_image_dist(pts),
                       cm.distort_points_plain(xn, *cam._intrinsics(),
                                               cam.dist, normalized=True))
    lut = cm.compute_undist_map(cam)
    assert lut.shape == (120, 188, 2)


FILTERS = ["pyramid", "gaussian_blur", "box_filter", "scharr",
           "x_first"]


@pytest.mark.parametrize("what", FILTERS)
@pytest.mark.parametrize("size", SIZES, ids=["376x240", "377x241"])
def test_filters_match_jax(size, what):
    # same taps in the same order: f32 round-off only (1e-4 on 0..255)
    _jax()
    import jax.numpy as jnp

    from ov2slam_tpu.core import image as jimg

    x = chip_smoke.image_fixture(*size)
    j, t = jnp.asarray(x), torch.as_tensor(x)
    if what == "pyramid":
        pairs = list(zip(jimg.build_pyramid(j, 4), im.build_pyramid(t, 4)))
        assert [p.shape for p, _ in pairs] == [
            tuple(q.shape) for _, q in pairs]
    elif what == "gaussian_blur":
        pairs = [(jimg.gaussian_blur(j, 2.0, 4), im.gaussian_blur(t, 2.0,
                                                                  4))]
    elif what == "box_filter":
        pairs = [(jimg.box_filter(j, 3), im.box_filter(t, 3))]
    elif what == "scharr":
        pairs = list(zip(jimg.scharr_gradients(j), im.scharr_gradients(t)))
    else:
        g = im.gaussian_kernel1d(1.0, 2)
        pairs = [(jimg._filter_y(jimg._filter_x(j, PYR), g),
                  im.separable_filter_plain(t, g, PYR, x_first=True))]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


PLAIN_SIZES = ((376, 240), (377, 241), (752, 480))


@pytest.mark.parametrize("what", ["pyramid", "scharr"])
@pytest.mark.parametrize("size", PLAIN_SIZES,
                         ids=[f"{w}x{h}" for w, h in PLAIN_SIZES])
def test_pyramid_and_scharr_plain_match_jax(size, what):
    # the plain versions the kernels are held to on the card: the same
    # taps in the same order as the JAX package's, f32 round-off only
    # (1e-4 on 0..255); the CPU wrappers are the plain versions
    _jax()
    import jax.numpy as jnp

    from ov2slam_tpu.core import image as jimg

    x = chip_smoke.image_fixture(*size, seed=2)
    j, t = jnp.asarray(x), torch.as_tensor(x)
    if what == "pyramid":
        ours = im.build_pyramid_plain(t, 4)
        theirs = jimg.build_pyramid(j, 4)
        assert [tuple(p.shape) for p in ours] == im.pyramid_shapes(
            size[1], size[0], 4) == [p.shape for p in theirs]
        wrapped = im.build_pyramid(t, 4)
    else:
        ours = im.scharr_gradients_plain(t)
        theirs = jimg.scharr_gradients(j)
        wrapped = im.scharr_gradients(t)
    assert all(_bits_equal(a, b) for a, b in zip(wrapped, ours, strict=True))
    for a, b in zip(theirs, ours, strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("clip", [2.0, 3.0])
@pytest.mark.parametrize("size", SIZES, ids=["376x240", "377x241"])
def test_clahe_matches_jax(size, clip):
    # histogram counts are exact integers on both sides; the LUT blend is
    # the same f32 arithmetic: 1e-3 intensity (of 255) covers round-off
    _jax()
    import jax.numpy as jnp

    from ov2slam_tpu.core import image as jimg

    x = chip_smoke.image_fixture(*size, seed=1)
    a = np.asarray(jimg.clahe(jnp.asarray(x), clip_limit=clip))
    b = im.clahe(torch.as_tensor(x), clip_limit=clip).numpy()
    np.testing.assert_allclose(b, a, atol=1e-3)


@pytest.mark.parametrize("mode", ["undistort", "distort_px",
                                  "distort_normalized"])
@pytest.mark.parametrize("kind", ["radtan", "fisheye"])
def test_points_match_jax(kind, mode):
    # f32 on both sides, the same formulas: 1e-3 px
    _jax()
    import jax.numpy as jnp

    from ov2slam_tpu.core import camera as jcam
    from ov2slam_tpu.models import frontend_step as jfs

    fe = kind == "fisheye"
    c = _cam(kind)
    jc = jfs.CalibArrays(*(jnp.asarray(v.numpy()) for v in c))
    px = chip_smoke.image_points(752, 480, 300, 7, CPU)
    jpx = jnp.asarray(px.numpy())
    jf = jnp.stack([jc.fx, jc.fy])
    jcc = jnp.stack([jc.cx, jc.cy])
    jfn = jcam.distort_fisheye if fe else jcam.distort_radtan
    if mode == "undistort":
        a = jfs._undistort_px(jpx, jc, fe)
        b = cm.undistort_points(px, *c, fe)
    elif mode == "distort_px":
        a = jfn((jpx - jcc) / jf, jc.dist) * jf + jcc
        b = cm.distort_points(px, *c, fe)
    else:
        xn = (px - torch.stack(c[2:4])) / torch.stack(c[0:2])
        a = jfn(jnp.asarray(xn.numpy()), jc.dist) * jf + jcc
        b = cm.distort_points(xn, *c, fe, normalized=True)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)


TAIL_N = (1, 127, 300, 512)


@pytest.mark.parametrize("n", TAIL_N)
@pytest.mark.parametrize("opts", chip_smoke.TAIL_OPTIONS,
                         ids=[o or "none" for o in chip_smoke.TAIL_OPTIONS])
@pytest.mark.parametrize("kind", ["radtan", "fisheye"])
def test_tail_matches_jax(kind, opts, n):
    # the tail's plain version against the JAX package's own expressions:
    # jnp.where, frontend_step._undistort_px and the (. - c) / f of
    # frontend_step.py:278-279 and mapper_step.py:124-128; f32 on both
    # sides, as test_points_match_jax: 1e-3 px, 1e-5 normalised; the
    # select and the mask exact. The CPU wrapper is the plain version.
    _jax()
    import jax.numpy as jnp

    from ov2slam_tpu.models import frontend_step as jfs

    fe = kind == "fisheye"
    c = _cam(kind)
    inp = chip_smoke.tail_inputs(n, 11 + n, CPU)
    assert inp["px"].stride() == (8, 1)        # a column view of the state
    ours = chip_smoke.tail_call(cm.undistort_normalize_plain, inp, c, fe,
                                opts)
    wrapped = chip_smoke.tail_call(cm.undistort_normalize, inp, c, fe, opts)
    assert all(_bits_equal(a, b) if a.dtype == torch.float32
               else torch.equal(a, b) for a, b in zip(wrapped, ours,
                                                      strict=True))

    def j(t):
        return jnp.asarray(t.numpy())

    kw = chip_smoke.tail_kwargs(inp, opts)
    jc = jfs.CalibArrays(*(j(v) for v in c))
    t = j(inp["rows"])
    theirs = []
    if "px" in kw:
        t = jnp.where(j(kw["status"])[:, None], t, j(kw["px"]))
        theirs.append(t)
    und = jfs._undistort_px(t, jc, fe)
    xr = (und - jnp.stack([jc.cx, jc.cy])) / jnp.stack([jc.fx, jc.fy])
    theirs += [und, xr]
    if "ref" in kw:
        rfx, rfy, rcx, rcy = (j(v) for v in kw["ref_intrinsics"] or c[:4])
        theirs.append((j(kw["ref"]) - jnp.stack([rcx, rcy]))
                      / jnp.stack([rfx, rfy]))
    if "ref_valid" in kw:
        theirs.append(j(kw["status"]) & j(kw["ref_valid"]))
    assert len(ours) == len(theirs)
    names = [k for k in ("tracked", "und", "xr", "xl", "pair")
             if (k != "tracked" or "px" in kw) and (k != "xl" or "ref" in kw)
             and (k != "pair" or "ref_valid" in kw)]
    for name, a, b in zip(names, ours, theirs, strict=True):
        if name in ("tracked", "pair"):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(
                a.numpy(), np.asarray(b),
                atol=1e-3 if name == "und" else 1e-5)


def _inline_tail(rows, fx, fy, cx, cy, dist, fisheye=False, iters=8, *,
                 px=None, status=None, ref=None, ref_intrinsics=None,
                 ref_valid=None):
    """The tracking step's code that the tail replaced, as it stood."""
    from ov2slam_torch.models.frontend_step import CalibArrays, _undistort_px

    calib = CalibArrays(fx, fy, cx, cy, dist)
    fxy, cxy = calib.f(), calib.c()
    tracked = torch.where(status[:, None], rows, px)
    und = _undistort_px(tracked, calib, fisheye)
    pair = xl = None
    xr = (und - cxy) / fxy
    if ref is not None:
        pair = status & ref_valid
        xl = (ref - cxy) / fxy
    return cm.TailOut(tracked, und, xr, xl, pair)


def _track_scene(n=96):
    """A 188x120 frame pair of a synthetic arc, up to ``n`` landmarks of the
    scene seen in the first frame with their pixels, and a radtan
    calibration."""
    from ov2slam_torch.core.image import build_pyramid
    from ov2slam_torch.io.synthetic import generate_sequence
    from ov2slam_torch.models.frontend_step import CalibArrays
    from ov2slam_torch.utils import lie_np

    seq = generate_sequence(n_frames=3, stereo=False, width=188, height=120,
                            n_points=1500, seed=5, speed=0.05)
    T1 = seq.gt_poses[1].astype(np.float64)
    pc = lie_np.pose_apply(lie_np.pose_inverse(T1),
                           seq.points.astype(np.float64))
    K = seq.K
    uv = pc[:, :2] / pc[:, 2:] * (K[0, 0], K[1, 1]) + (K[0, 2], K[1, 2])
    ok = ((pc[:, 2] > 0.5) & (uv[:, 0] > 12) & (uv[:, 0] < 176)
          & (uv[:, 1] > 12) & (uv[:, 1] < 108))
    idx = np.nonzero(ok)[0][:n]
    rng = np.random.default_rng(3)
    px = np.zeros((n, 2), np.float32)
    lm = np.zeros((n, 3), np.float32)
    px[:len(idx)] = uv[idx]
    lm[:len(idx)] = seq.points[idx]
    valid = np.arange(n) < len(idx)
    kf_px = px + rng.normal(0.0, 1.5, (n, 2)).astype(np.float32)
    pair = valid & (rng.random(n) < 0.8)
    f32 = torch.float32
    calib = CalibArrays(*(torch.tensor(v, dtype=f32) for v in (
        K[0, 0], K[1, 1], K[0, 2], K[1, 2])),
        dist=torch.tensor([-0.05, 0.01, 1e-4, -2e-4]))
    prev = tuple(build_pyramid(torch.as_tensor(
        seq.images_left[1].astype(np.float32)), 3))
    img = torch.as_tensor(np.clip(np.round(seq.images_left[2]), 0,
                                  255).astype(np.uint8))
    args = (img, prev, torch.as_tensor(px), torch.as_tensor(valid),
            torch.as_tensor(lm), torch.as_tensor(kf_px),
            torch.as_tensor(valid), torch.as_tensor(pair),
            torch.as_tensor(seq.gt_poses[2].astype(np.float32)),
            torch.as_tensor(seq.gt_poses[1].astype(np.float32)))
    return args, calib


@pytest.mark.parametrize("epipolar", [True, False],
                         ids=["epipolar", "no_epipolar"])
def test_fused_track_step_on_cpu_equals_the_inline_code(monkeypatch,
                                                        epipolar):
    # the tracking step through the tail gives what the code it replaced
    # gave, bit for bit, in every output (debug entries included)
    from ov2slam_torch.models import frontend_step as fs

    args, calib = _track_scene()

    def step():
        gen = torch.Generator().manual_seed(7)
        return fs.fused_track_step(*args, gen, calib, levels=3,
                                   do_epipolar=epipolar, ransac_iters=40,
                                   debug=True)

    pyr, out = step()
    assert int(out["status"].sum()) >= 30
    monkeypatch.setattr(fs, "undistort_normalize", _inline_tail)
    pyr0, out0 = step()
    assert sorted(out) == sorted(out0)
    for a, b in zip(pyr, pyr0, strict=True):
        assert _bits_equal(a, b)
    for k in out:
        a, b = out[k], out0[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert (_bits_equal(a, b) if a.dtype == torch.float32
                else torch.equal(a, b)), k


def test_stereo_step_bearings_are_the_gates_coordinates():
    # the stereo step now takes its bearings from the tail's xl and xr:
    # the same operations on the same inputs as the (. - c) / f it ran
    # again before, so the same bits
    from ov2slam_torch.models import mapper_step as ms
    from ov2slam_torch.models.frontend_step import CalibArrays, _undistort_px

    inp = chip_smoke.tail_inputs(300, 5, CPU)
    cl = CalibArrays(*_cam("radtan"))
    cr = CalibArrays(*_cam("fisheye"))
    tail = cm.undistort_normalize(inp["rows"], *cr, True, ref=inp["px"],
                                  ref_intrinsics=cl.intrinsics())
    r_und = _undistort_px(inp["rows"], cr, True)
    assert _bits_equal(tail.und, r_und)
    assert _bits_equal(ms._bearing_from_xn(tail.xl),
                       ms._bearing_from_und(inp["px"], cl))
    assert _bits_equal(ms._bearing_from_xn(tail.xr),
                       ms._bearing_from_und(r_und, cr))


def test_pack_tail_reads_column_views_in_place():
    inp = chip_smoke.tail_inputs(10, 0, CPU)
    c = _cam("radtan")
    a, opts = cm.pack_tail(inp["rows"], *c, False, **chip_smoke.tail_kwargs(
        inp, chip_smoke.TAIL_TRACKING))
    base = inp["px"].data_ptr()
    assert opts == "select+ref+pair"
    assert (a.rows_stride, a.px, a.px_stride, a.ref, a.ref_stride, a.n) == (
        2, base, 8, base + 20, 8, 10)
    # the tracking step's reference rows under its own calibration
    assert (a.rfx, a.rcy) == (c[0].data_ptr(), c[3].data_ptr())
    assert (a.status, a.ref_valid) == (inp["status"].data_ptr(),
                                       inp["ref_valid"].data_ptr())
    a, opts = cm.pack_tail(inp["rows"], *c, True, 3, ref=inp["ref"],
                           ref_intrinsics=inp["ref_intrinsics"])
    assert opts == "ref" and (a.px, a.status, a.ref_valid) == (None,) * 3
    assert (a.rfx, a.fisheye, a.iters) == (
        inp["ref_intrinsics"][0].data_ptr(), 1, 3)
    a, opts = cm.pack_tail(inp["rows"], *c)
    assert opts == "" and (a.ref, a.rfx, a.rcy) == (None,) * 3


def test_pack_filter_takes_the_nonzero_taps_in_order():
    img = _img((64, 32))
    a = im.pack_filter(img, DIFF, SMOOTH, x_first=True, stride=1)
    assert (a.H, a.W, a.stride, a.x_first) == (32, 64, 1, 1)
    assert (a.ny, list(a.offy[:a.ny]), list(a.wy[:a.ny])) == (
        2, [-1, 1], [-0.5, 0.5])
    assert (a.nx, list(a.offx[:a.nx])) == (3, [-1, 0, 1])
    assert list(a.wx[:3]) == [np.float32(t) for t in SMOOTH]
    # even-length taps: offsets from -len // 2, as the plain pad
    a = im.pack_filter(img, [0.25] * 4, [1.0] * 9, stride=2)
    assert list(a.offy[:a.ny]) == [-2, -1, 0, 1]
    assert list(a.offx[:a.nx]) == list(range(-4, 5))
    g = im.gaussian_kernel1d(2.0, 4)
    a = im.pack_filter(img, g, g)
    assert list(a.wy[:9]) == list(g) and a.ny == 9


def test_pyramid_plan_chains_three_levels_a_launch():
    # each launch writes at most three levels, reading the deepest level
    # the launch before wrote
    assert [im.pyramid_plan(n) for n in (1, 2, 3, 4, 5, 7, 8)] == [
        [], [(0, 1)], [(0, 2)], [(0, 3)], [(0, 3), (3, 1)],
        [(0, 3), (3, 3)], [(0, 3), (3, 3), (6, 1)]]
    # the kernel's own limit
    with open(os.path.join(kernels.CSRC, "separable_filter.cu")) as f:
        m = re.search(r"constexpr int kMaxOut = (\d+);", f.read())
    assert int(m.group(1)) == im.PYR_LEVELS_PER_LAUNCH


def test_pyramid_shapes_are_ceil_halves():
    assert im.pyramid_shapes(241, 377, 6) == [
        (241, 377), (121, 189), (61, 95), (31, 48), (16, 24), (8, 12)]
    assert im.pyramid_shapes(480, 752, 4) == [
        (480, 752), (240, 376), (120, 188), (60, 94)]
    shapes, plan = im.pack_pyramid(_img((377, 241)), 6)
    assert shapes == im.pyramid_shapes(241, 377, 6)
    assert plan == [(0, 3), (3, 2)]
    # the plain pyramid keeps the same shapes, deep and odd
    pyr = im.build_pyramid_plain(_img((377, 241)), 6)
    assert [tuple(p.shape) for p in pyr] == shapes
    assert all(p.is_contiguous() for p in pyr)


def test_pack_scharr_takes_the_image_in_place():
    img = _img((377, 241))
    assert im.pack_scharr(img) == (img.data_ptr(), 241, 377)


def test_pack_clahe_rounds_the_limit_and_takes_torch_scan_threads():
    a = im.pack_clahe(_img((752, 480)), 3.0)
    # 60 x 94 pixels a tile: 3 * 5640 / 256 = 66.09375, exact in f32
    assert (a.H, a.W, a.ty, a.tx, a.nbins) == (480, 752, 8, 8, 256)
    assert a.limit == 66.09375 and a.log_x == 5
    a = im.pack_clahe(_img((377, 241)), 2.7)
    limit = max(2.7 * (31 * 48) / 256, 1.0)
    assert a.limit == float(np.float32(limit)) != limit
    # ATen's get_log_num_threads_x_inner_scan, in its uint32 arithmetic
    assert [im.scan_log_threads(r, n) for r, n in (
        (64, 256), (1, 256), (64, 1024), (4096, 8), (1, 1), (2, 1000))] \
        == [5, 8, 6, 4, 4, 9]


def _refuse(kind):
    img = _img((64, 32))
    px = chip_smoke.image_points(64, 32, 10, 0, CPU)
    c = _cam("radtan")
    if kind == "ten_taps":
        return lambda: im.pack_filter(img, [0.1] * 10, PYR)
    if kind == "stride_3":
        return lambda: im.pack_filter(img, PYR, PYR, stride=3)
    if kind == "image_not_contiguous":
        return lambda: im.pack_filter(img.t(), PYR, PYR)
    if kind == "image_f64":
        return lambda: im.pack_filter(img.double(), PYR, PYR)
    if kind == "image_3d":
        return lambda: im.pack_filter(img[None], PYR, PYR)
    if kind == "pyramid_not_contiguous":
        return lambda: im.pack_pyramid(img.t(), 4)
    if kind == "pyramid_f64":
        return lambda: im.pack_pyramid(img.double(), 4)
    if kind == "pyramid_3d":
        return lambda: im.pack_pyramid(img[None], 4)
    if kind == "pyramid_no_levels":
        return lambda: im.pack_pyramid(img, 0)
    if kind == "pyramid_levels_float":
        return lambda: im.pack_pyramid(img, 4.0)
    if kind == "scharr_not_contiguous":
        return lambda: im.pack_scharr(img[:, ::2])
    if kind == "scharr_f64":
        return lambda: im.pack_scharr(img.double())
    if kind == "scharr_3d":
        return lambda: im.pack_scharr(img[None])
    if kind == "clahe_not_contiguous":
        return lambda: im.pack_clahe(img[:, ::2])
    if kind == "clahe_f64":
        return lambda: im.pack_clahe(img.double())
    if kind == "clahe_bins":
        return lambda: im.pack_clahe(img, nbins=2048)
    if kind == "clahe_few_bins":
        return lambda: im.pack_clahe(img, nbins=64)
    if kind == "clahe_bins_not_4k":
        return lambda: im.pack_clahe(img, nbins=254)
    if kind == "clahe_few_tiles":
        return lambda: im.pack_clahe(img, tiles=(2, 4))
    if kind == "points_not_adjacent":
        both = torch.zeros((10, 4))
        return lambda: cm.pack_points(both[:, ::2], *c, False, 0)
    if kind == "points_f64":
        return lambda: cm.pack_points(px.double(), *c, False, 0)
    if kind == "points_shape":
        return lambda: cm.pack_points(px[:, :1], *c, False, 0)
    if kind == "intrinsic_two_elements":
        return lambda: cm.pack_points(px, c[0].expand(2), *c[1:], False, 0)
    if kind == "dist_shape":
        return lambda: cm.pack_points(px, *c[:4], c[4][:3], False, 0)
    if kind == "mode":
        return lambda: cm.pack_points(px, *c, False, 3)
    inp = chip_smoke.tail_inputs(10, 0, CPU)
    rows, st, rv = inp["rows"], inp["status"], inp["ref_valid"]
    if kind == "tail_px_without_status":
        return lambda: cm.pack_tail(rows, *c, px=inp["px"])
    if kind == "tail_pair_without_ref":
        return lambda: cm.pack_tail(rows, *c, px=inp["px"], status=st,
                                    ref_valid=rv)
    if kind == "tail_rows_f64":
        return lambda: cm.pack_tail(rows.double(), *c)
    if kind == "tail_rows_shape":
        return lambda: cm.pack_tail(rows[:, :1], *c)
    if kind == "tail_rows_3d":
        return lambda: cm.pack_tail(rows[None], *c)
    if kind == "tail_status_not_bool":
        return lambda: cm.pack_tail(rows, *c, px=inp["px"],
                                    status=st.to(torch.uint8))
    if kind == "tail_status_length":
        return lambda: cm.pack_tail(rows, *c, px=inp["px"], status=st[:9])
    if kind == "tail_ref_not_adjacent":
        both = torch.zeros((10, 4))
        return lambda: cm.pack_tail(rows, *c, ref=both[:, ::2])
    if kind == "tail_ref_length":
        return lambda: cm.pack_tail(rows, *c, ref=inp["ref"][:9])
    if kind == "tail_ref_intrinsic_two_elements":
        return lambda: cm.pack_tail(rows, *c, ref=inp["ref"],
                                    ref_intrinsics=(c[0].expand(2), *c[1:4]))
    if kind == "tail_iters":
        return lambda: cm.pack_tail(rows, *c, False, -1)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,exc", [
    ("ten_taps", ValueError), ("stride_3", ValueError),
    ("image_not_contiguous", ValueError), ("image_f64", TypeError),
    ("image_3d", ValueError), ("pyramid_not_contiguous", ValueError),
    ("pyramid_f64", TypeError), ("pyramid_3d", ValueError),
    ("pyramid_no_levels", ValueError), ("pyramid_levels_float", TypeError),
    ("scharr_not_contiguous", ValueError), ("scharr_f64", TypeError),
    ("scharr_3d", ValueError), ("clahe_not_contiguous", ValueError),
    ("clahe_f64", TypeError), ("clahe_bins", ValueError),
    ("clahe_few_bins", ValueError), ("clahe_bins_not_4k", ValueError),
    ("clahe_few_tiles", ValueError),
    ("points_not_adjacent", ValueError), ("points_f64", TypeError),
    ("points_shape", ValueError), ("intrinsic_two_elements", ValueError),
    ("dist_shape", ValueError), ("mode", ValueError),
    ("tail_px_without_status", ValueError),
    ("tail_pair_without_ref", ValueError), ("tail_rows_f64", TypeError),
    ("tail_rows_shape", ValueError), ("tail_rows_3d", ValueError),
    ("tail_status_not_bool", TypeError), ("tail_status_length", ValueError),
    ("tail_ref_not_adjacent", ValueError), ("tail_ref_length", ValueError),
    ("tail_ref_intrinsic_two_elements", ValueError),
    ("tail_iters", ValueError)])
def test_packing_refuses_what_the_kernels_do_not_take(kind, exc):
    with pytest.raises(exc):
        _refuse(kind)()


def test_pack_points_reads_column_views_in_place():
    state = torch.zeros((10, 8))
    c = _cam("fisheye")
    a = cm.pack_points(state[:, 5:7], *c, True, cm.MODE_UNDISTORT)
    assert (a.pts, a.n, a.stride) == (state.data_ptr() + 20, 10, 8)
    assert (a.fx, a.dist, a.fisheye, a.iters) == (
        c[0].data_ptr(), c[4].data_ptr(), 1, 8)
    grid = torch.zeros((3, 5, 2))
    assert cm.pack_points(grid, *c, False, 1).n == 15


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float}


def _c_params(lib, fn):
    """The C types of the exported launch function ``fn``'s parameters,
    from ``csrc/<lib>.cu``."""
    with open(os.path.join(kernels.CSRC, f"{lib}.cu")) as f:
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


ENTRY_POINTS = [(lib, fn) for lib in ("undistort_points", "separable_filter",
                                      "clahe")
                for fn in kernels.entry_points(lib)]


@pytest.mark.parametrize("lib,fn", ENTRY_POINTS,
                         ids=[fn for _, fn in ENTRY_POINTS])
def test_signatures_match_the_c_sources(lib, fn):
    restype, argtypes = kernels.entry_points(lib)[fn]
    assert restype is ctypes.c_int and lib in kernels.KERNELS
    assert argtypes == _c_params(lib, fn)


def test_every_launch_function_is_registered():
    # each extern "C" launch function of the three sources has its
    # signature, and each set-up function its entry
    for lib in ("undistort_points", "separable_filter", "clahe"):
        with open(os.path.join(kernels.CSRC, f"{lib}.cu")) as f:
            text = f.read()
        exported = set(re.findall(r'extern "C" int (\w+)\(', text))
        launches = {n for n in exported if n.endswith("_launch")}
        assert launches == set(kernels.entry_points(lib))
        assert exported - launches == (
            {kernels._INIT[lib]} if lib in kernels._INIT else set())


@pytest.mark.parametrize("fn,figures", [
    (lambda r: r.undistort_points_bound(512),
     (135168, 8224, "bytes")),
    # the tracking step's tail: 272 f32 operations and 59 bytes a row (8
    # in, 9 and 8 for the select, 8 and 8 for the reference rows, 1 and 1
    # for the pair mask, 16 out), the two calibrations' 12 floats once
    (lambda r: r.undistort_normalize_bound(512),
     (512 * 272, 512 * 59 + 48, "bytes")),
    (lambda r: r.separable_filter_bound(480, 752, 5, 5, 2),
     (2707200, 1804800, "bytes")),
    (lambda r: r.clahe_bound(480, 752), (12420096, 2887680, "bytes")),
    # three levels: 2 (5 Ho W + 5 Ho Wo) each; the image read once and
    # each level written once
    (lambda r: r.pyramid_bound(480, 752, 4),
     (2707200 + 676800 + 169200, 4 * (360960 + 90240 + 22560 + 5640),
      "bytes")),
    # both gradients: a 3-tap and a 2-tap pass each at every pixel; the
    # image read once and both gradients written once
    (lambda r: r.scharr_pair_bound(480, 752),
     (20 * 360960, 12 * 360960, "bytes"))],
    ids=["undistort_points", "undistort_normalize", "separable_filter",
         "clahe", "pyramid", "scharr_pair"])
def test_roofline_bounds(fn, figures):
    from ov2slam_torch import roofline

    b = fn(roofline)
    assert (b["ops"], b["bytes"], b["bound_by"]) == figures
    assert b["bound_ms"] == pytest.approx(1e3 * figures[1]
                                          / roofline.HBM_BYTES_PER_S)


# --------------------------------------------------------------- card #

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("size", chip_smoke.IMAGE_SIZES,
                         ids=[f"{w}x{h}" for w, h in chip_smoke.IMAGE_SIZES])
def test_cuda_kernels_bit_equal_to_plain(size):
    dev = _card()
    img = torch.as_tensor(chip_smoke.image_fixture(*size), device=dev)
    digests, errs = {}, {}
    held = chip_smoke.image_check(
        chip_smoke.image_cases(f"{size}", img, dev), digests, errs)
    assert held == 25 and len(digests) == 18
    assert errs == dict(clahe=0.0, separable_filter=0.0, build_pyramid=0.0,
                        scharr_gradients=0.0, undistort_points=0.0)


def test_cuda_graph_replay_equals_eager_and_counts_launches():
    from ov2slam_torch import graphs

    dev = _card()

    def step(img, px, fx, fy, cx, cy, dist):
        eq = im.clahe(img, 3.0)
        return (*im.build_pyramid(eq, 4), *im.scharr_gradients(eq),
                cm.undistort_points(px, fx, fy, cx, cy, dist))

    g = graphs.GraphedStep(step)
    c = _cam("radtan", dev)
    args = [(torch.as_tensor(chip_smoke.image_fixture(752, 480, s),
                             device=dev),
             chip_smoke.image_points(752, 480, 512, s, dev), *c)
            for s in range(3)]
    for a in args[:2]:
        g(*a)
    assert (g.eager, g.captures) == (1, 1)
    fns = (im.clahe, im.separable_filter, im.build_pyramid,
           im.scharr_gradients, cm.undistort_points)
    n0 = [f.launches for f in fns]
    r0 = g.replays
    for a in args[::-1]:
        out = g(*a)
        ref = step(*a)
        torch.cuda.synchronize()
        assert all(_bits_equal(x.cpu(), y.cpu()) for x, y in zip(out, ref))
    # three replays and three eager calls: CLAHE 1, the one-image filter
    # 0, the pyramid 1, Scharr's pair 1, points 1
    assert g.replays - r0 == 3
    assert [f.launches - n for f, n in zip(fns, n0)] == [6, 0, 6, 6, 6]


@pytest.mark.parametrize("n", chip_smoke.TAIL_ROWS)
def test_cuda_tail_bit_equal_to_plain_and_the_eager_sequence(n):
    # every option set, through both cameras; the tracking step's and
    # stereo mapping's calls also against the eager sequence they replaced
    dev = _card()
    digests, errs = {}, {}
    held = chip_smoke.image_check(chip_smoke.tail_cases(f"{n}", n, dev),
                                  digests, errs)
    assert len(digests) == 14 and held == 50
    assert errs == dict(undistort_normalize=0.0)


def test_cuda_graphed_tail_equals_eager_and_counts_launches():
    from ov2slam_torch import graphs

    dev = _card()
    c = _cam("radtan", dev)
    opts = chip_smoke.TAIL_TRACKING

    def step(rows, px, status, ref, ref_valid):
        inp = dict(rows=rows, px=px, status=status, ref=ref,
                   ref_valid=ref_valid, ref_intrinsics=None)
        return tuple(chip_smoke.tail_call(cm.undistort_normalize, inp, c,
                                          False, opts))

    keys = ("rows", "px", "status", "ref", "ref_valid")
    args = [[chip_smoke.tail_inputs(512, s, dev)[k] for k in keys]
            for s in range(3)]
    g = graphs.GraphedStep(step)
    for a in args[:2]:
        g(*a)
    assert (g.eager, g.captures) == (1, 1)
    n0, r0 = cm.undistort_normalize.launches, g.replays
    for a in args[::-1]:
        out = g(*a)
        ref = step(*a)
        torch.cuda.synchronize()
        assert all(torch.equal(chip_smoke._bits(x), chip_smoke._bits(y))
                   for x, y in zip(out, ref, strict=True))
    # three replays and three eager calls, one launch each
    assert g.replays - r0 == 3
    assert cm.undistort_normalize.launches - n0 == 6


def test_cuda_f64_raises_type_error():
    dev = _card()
    img = torch.zeros((48, 64), dtype=torch.float64, device=dev)
    px = torch.zeros((8, 2), dtype=torch.float64, device=dev)
    c = _cam("radtan", dev)
    for run in (lambda: im.clahe(img), lambda: im.pyr_down(img),
                lambda: im.build_pyramid(img, 4),
                lambda: im.scharr_gradients(img),
                lambda: cm.undistort_points(px, *c),
                lambda: cm.distort_points(px, *c),
                lambda: cm.undistort_normalize(px, *c)):
        with pytest.raises(TypeError):
            run()
