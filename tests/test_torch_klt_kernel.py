"""The KLT kernel's wrappers (ov2slam_torch/ops/klt.py) and its launch.

On the CPU:
- the wrappers take CPU tensors to the plain versions, bit for bit; the
  split tracker's pass 1, now one fb call, equals the two klt calls and
  the gate it replaced, bit for bit;
- the pure-Python launch packing (level table, sizes, flags, f32
  thresholds) matches the C signature, and every refusal raises: wrong
  dtype, non-contiguous, mixed devices, too many levels, a window or
  margin the kernel is not sized for;
- a per-keypoint early-exit form of the level loop (the kernel's: a row
  stops stepping once it has converged, is dead or has a bad G) equals
  the plain fixed-``iters`` version bit for bit on test_torch_klt.py's
  fixtures, which hold dead rows, rows gated by the min eigenvalue and
  rows that never converge.

On the card (skipped without one, decided inside the test): the kernel
against the plain version on the same fixtures and on the split-overflow
case (``n_sub`` 8 and 64): status equal on >= 99% of keypoints, positions
within 1e-2 px where both track (the sums over window pixels run in
another order than the plain version's), two launches bit-equal, N = 0
launching nothing. The fixtures are test_torch_klt.py's, built with the
port's own modules (``chip_smoke.klt_*_case``), so that the file imports no
JAX: on the card, ``python -m pytest --noconftest
tests/test_torch_klt_kernel.py`` runs it (the conftest imports JAX).
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from ov2slam_torch import kernels
from ov2slam_torch.core.image import build_pyramid as t_pyr
from ov2slam_torch.ops import klt as tklt
from ov2slam_torch.ops.patch import extract_patches, sample_window

torch.set_num_threads(1)

EPS_PX = 1e-2
STATUS_SHARE = 0.99


def _pyr(img, levels, dev="cpu"):
    return tuple(t_pyr(torch.as_tensor(img, device=dev), levels))


pair_case, split_case, flat_case = (chip_smoke.klt_pair_case,
                                    chip_smoke.klt_split_case,
                                    chip_smoke.klt_flat_case)


@pytest.fixture(scope="module")
def pair():
    return pair_case()


# ------------------------------------------------------------ wrappers #

def test_cpu_wrappers_equal_plain_bit_for_bit(pair):
    a, b, kps, ok = pair
    pp, pc = _pyr(a, 4), _pyr(b, 4)
    k, v = torch.as_tensor(kps), torch.as_tensor(ok)
    prior = k + torch.tensor([1.5, -0.75])
    for got, want in (
            (tklt.klt_track(pp, pc, k, prior, v),
             tklt.klt_track_plain(pp, pc, k, prior, v)),
            (tklt.fb_klt_track(pp, pc, k, prior, v),
             tklt.fb_klt_track_plain(pp, pc, k, prior, v)),
            (tklt.fb_klt_track(pp, pc, k, k, v, back_levels=2),
             tklt.fb_klt_track_plain(pp, pc, k, k, v, back_levels=2))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert tklt.klt_track_plain.cuda_runs == 0


def _split_two_klt_calls(pyr_prev, pyr_cur, kps, priors, valid, base_only,
                         n_sub, n_base_levels=1, priors2=None):
    """The split tracker as it was written before pass 1 became one fb
    call: pass 1 as a forward and a backward klt call and the gate."""
    bp, bc = tuple(pyr_prev[:n_base_levels]), tuple(pyr_cur[:n_base_levels])
    fwd1, st1f, _ = tklt.klt_track_plain(bp, bc, kps, priors, valid)
    bwd1, st1b, _ = tklt.klt_track_plain((bc[0],), (bp[0],), fwd1, kps,
                                         st1f)
    st1 = st1f & st1b & (torch.linalg.norm(bwd1 - kps, dim=-1) <= 0.5)
    need2 = valid & ((~base_only) | (~st1))
    idx = torch.argsort((~need2).to(torch.uint8), stable=True)[:n_sub]
    s_sel, s_kps = need2[idx], kps[idx]
    p2 = s_kps if priors2 is None else priors2[idx]
    fwd2, st2 = tklt.fb_klt_track_plain(pyr_prev, pyr_cur, s_kps, p2, s_sel)
    fwd = torch.where(st1[:, None], fwd1, kps).clone()
    fwd[idx] = torch.where(s_sel[:, None], fwd2, fwd[idx])
    status = st1.clone()
    status[idx] = torch.where(s_sel, st2, st1[idx])
    return fwd, status


@pytest.mark.parametrize("n_sub,n_base_levels", [(8, 1), (64, 1), (8, 2)])
def test_split_pass1_as_one_fb_call_is_bit_equal(n_sub, n_base_levels):
    base, cur, kps, prior, base_only = split_case()
    pp, pc = _pyr(base, 3), _pyr(cur, 3)
    args = (pp, pc, torch.as_tensor(kps), torch.as_tensor(prior),
            torch.ones(len(kps), dtype=torch.bool),
            torch.as_tensor(base_only))
    got = tklt.fb_klt_track_split(*args, n_sub=n_sub,
                                  n_base_levels=n_base_levels)
    want = _split_two_klt_calls(*args, n_sub=n_sub,
                                n_base_levels=n_base_levels)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------- packing #

def _inputs(levels=4, n=5, h=64, w=96):
    rng = np.random.default_rng(levels + n)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    pp = _pyr(img, levels)
    pc = _pyr(img[::-1].copy(), levels)
    k = torch.as_tensor(rng.uniform(10, 50, (n, 2)).astype(np.float32))
    return pp, pc, k, k + 1.0, torch.ones(n, dtype=torch.bool)


def _pack(pp, pc, k, p, v, **kw):
    opts = dict(back_levels=1, win=9, iters=30, eps=0.01, min_eig_th=1e-4,
                max_err=30.0, max_fb_dist=0.5, margin=5)
    opts.update(kw)
    return tklt.pack_launch(pp, pc, k, p, v, **opts)


def test_launch_packing_matches_the_c_signature():
    pp, pc, k, p, v = _inputs()
    a = _pack(pp, pc, k, p, v, back_levels=1, win=7, iters=12, margin=4)
    assert list(a.ptrs) == [t.data_ptr() for t in (*pp, *pc)]
    assert list(a.dims) == [64, 96, 64, 96, 32, 48, 32, 48,
                            16, 24, 16, 24, 8, 12, 8, 12]
    assert (a.levels, a.back_levels, a.n, a.win, a.iters, a.margin) == (
        4, 1, 5, 7, 12, 4)
    assert (a.kps, a.priors, a.valid) == (k.data_ptr(), p.data_ptr(),
                                          v.data_ptr())
    assert (a.kps_stride, a.priors_stride) == (2, 2)
    # a column view of a packed state is read in place, rows strided
    state = torch.zeros((5, 8))
    view = _pack(pp, pc, state[:, 0:2], state[:, 5:7], v)
    assert (view.kps, view.priors) == (state.data_ptr(),
                                       state.data_ptr() + 5 * 4)
    assert (view.kps_stride, view.priors_stride) == (8, 8)
    # the thresholds reach the kernel as f32, as the plain version's
    # tensors compare them
    assert ctypes.c_float(a.eps2).value == np.float32(0.01 * 0.01)
    assert ctypes.c_float(a.max_fb).value == np.float32(0.5)
    assert _pack(pp, pc, k, p, v, back_levels=0).back_levels == 0
    # every argument converts to its C type: the outputs and the stream
    # (five pointers) follow
    _, restype, argtypes = kernels._SIGNATURES["klt_track"]
    c = a.c_args()
    assert restype is ctypes.c_int and len(c) + 5 == len(argtypes)
    for value, ctype in zip(c, argtypes):
        assert ctype(value).value == pytest.approx(value)
    assert argtypes[len(c):] == [ctypes.c_void_p] * 5
    assert all(t is ctypes.c_void_p for i, t in enumerate(argtypes)
               if i in (0, 1, 4, 5, 6))
    assert all(t is ctypes.c_int for t in argtypes[7:13])
    assert all(t is ctypes.c_float for t in argtypes[13:17])


def _refusal(kind, pp, pc, k, p, v):
    if kind == "dtype_image":
        pp = (pp[0].double(), *pp[1:])
    elif kind == "dtype_kps":
        k = k.double()
    elif kind == "dtype_valid":
        v = v.to(torch.uint8)
    elif kind == "non_contiguous_image":
        pc = (pc[0].t().contiguous().t(), *pc[1:])
    elif kind == "non_contiguous_kps":
        k = torch.stack([k[:, 0], k[:, 1]], 0).t()
    elif kind == "mixed_devices":
        p = p.to("meta")
    elif kind == "too_many_levels":
        pp, pc = _inputs(levels=tklt.MAX_LEVELS + 1, h=1024, w=1024)[:2]
    elif kind == "level_counts":
        pc = pc[:-1]
    elif kind == "shape":
        v = v[:-1]
    return pp, pc, k, p, v


@pytest.mark.parametrize("kind,exc", [
    ("dtype_image", TypeError), ("dtype_kps", TypeError),
    ("dtype_valid", TypeError), ("non_contiguous_image", ValueError),
    ("non_contiguous_kps", ValueError), ("mixed_devices", ValueError),
    ("too_many_levels", ValueError), ("level_counts", ValueError),
    ("shape", ValueError)])
def test_launch_packing_refuses(kind, exc):
    args = _refusal(kind, *_inputs())
    with pytest.raises(exc):
        _pack(*args)


@pytest.mark.parametrize("kw", [
    dict(win=tklt.MAX_WIN + 2), dict(margin=tklt.MAX_MARGIN + 1),
    dict(back_levels=5), dict(iters=-1)])
def test_launch_packing_refuses_sizes(kw):
    with pytest.raises(ValueError):
        _pack(*_inputs(), **kw)


def test_unsupported_device_raises():
    pp, pc, k, p, v = _inputs()
    meta = [tuple(t.to("meta") for t in pp), tuple(t.to("meta") for t in pc),
            k.to("meta"), p.to("meta"), v.to("meta")]
    with pytest.raises(ValueError):
        tklt.klt_track(*meta)
    with pytest.raises(ValueError):
        tklt.fb_klt_track(*meta)


# ----------------------------------------------------------- early exit #

def track_level_early_exit(img_prev, img_cur, kps_lvl, flow, alive, win,
                           iters, eps, min_eig_th, margin, stats):
    """``ops/klt.py::track_level`` with the kernel's per-keypoint exit: a
    row takes steps only while it is alive, has a good G and has not
    converged, and the loop ends once no row steps. ``stats`` counts the
    rows by how their level ended."""
    H, W = img_prev.shape
    r = win // 2
    n_px = win * win
    tpatch = extract_patches(img_prev, kps_lvl - (r + 1), win + 2)
    T = tpatch[:, 1:-1, 1:-1]
    Ix = 0.5 * (tpatch[:, 1:-1, 2:] - tpatch[:, 1:-1, :-2])
    Iy = 0.5 * (tpatch[:, 2:, 1:-1] - tpatch[:, :-2, 1:-1])
    gxx = torch.sum(Ix * Ix, dim=(-2, -1))
    gxy = torch.sum(Ix * Iy, dim=(-2, -1))
    gyy = torch.sum(Iy * Iy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / (
        2.0 * n_px)
    good_g = min_eig > min_eig_th
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12),
                           det)
    iA, iB, iD = gyy / det_safe, -gxy / det_safe, gxx / det_safe
    S = win + 2 * margin
    base = torch.floor(kps_lvl + flow) - r - margin
    spatch = extract_patches(img_cur, base, S)

    flow = flow.clone()
    stepping = alive & good_g
    stats["dead"] += int((~alive).sum())
    stats["bad_g"] += int((alive & ~good_g).sum())
    for _ in range(iters):
        rows = torch.nonzero(stepping)[:, 0]
        if rows.numel() == 0:
            break
        off = (kps_lvl[rows] + flow[rows]) - r - base[rows]
        I = sample_window(spatch[rows], off, win)
        diff = T[rows] - I
        bx = torch.sum(Ix[rows] * diff, dim=(-2, -1))
        by = torch.sum(Iy[rows] * diff, dim=(-2, -1))
        dx = iA[rows] * bx + iB[rows] * by
        dy = iB[rows] * bx + iD[rows] * by
        flow[rows] = flow[rows] + torch.stack([dx, dy], -1)
        done = dx * dx + dy * dy < eps * eps
        stepping[rows[done]] = False
        stats["converged"] += int(done.sum())
    stats["never_converged"] += int(stepping.sum())

    centers = kps_lvl + flow
    in_img = (
        (centers[:, 0] >= r) & (centers[:, 0] <= W - 1 - r)
        & (centers[:, 1] >= r) & (centers[:, 1] <= H - 1 - r)
    )
    I = sample_window(spatch, centers - r - base, win)
    residual = torch.mean(torch.abs(I - T), dim=(-2, -1))
    return flow, alive & good_g & in_img, min_eig, residual


def klt_early_exit(pyr_prev, pyr_cur, kps, priors, valid, stats, win=9,
                   iters=30, eps=0.01, min_eig_th=1e-4, max_err=30.0,
                   margin=5):
    levels = len(pyr_prev)
    flow = (priors - kps) / (2.0 ** (levels - 1))
    alive = valid
    for lvl in range(levels - 1, -1, -1):
        flow, alive, _, residual = track_level_early_exit(
            pyr_prev[lvl], pyr_cur[lvl], kps / 2.0 ** lvl, flow, alive,
            win, iters, eps, min_eig_th, margin, stats)
        if lvl > 0:
            flow = flow * 2.0
    return kps + flow, alive & (residual < max_err), residual


def fb_early_exit(pyr_prev, pyr_cur, kps, priors, valid, stats,
                  back_levels=1, max_fb_dist=0.5):
    fwd, st_f, _ = klt_early_exit(pyr_prev, pyr_cur, kps, priors, valid,
                                  stats)
    bwd, st_b, _ = klt_early_exit(pyr_cur[:back_levels],
                                  pyr_prev[:back_levels], fwd, kps, st_f,
                                  stats)
    return fwd, st_f & st_b & (torch.linalg.norm(bwd - kps, dim=-1)
                               <= max_fb_dist)


def test_early_exit_equals_fixed_steps_bit_for_bit(pair):
    a, b, kps, ok = pair
    stats = dict(dead=0, bad_g=0, converged=0, never_converged=0)
    pp, pc = _pyr(a, 4), _pyr(b, 4)
    k, v = torch.as_tensor(kps), torch.as_tensor(ok)
    for got, want in (
            (klt_early_exit(pp, pc, k, k, v, stats),
             tklt.klt_track_plain(pp, pc, k, k, v)),
            (fb_early_exit(pp, pc, k, k, v, stats),
             tklt.fb_klt_track_plain(pp, pc, k, k, v))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    base, cur, skps, prior, _ = split_case()
    sp, sc = _pyr(base, 3), _pyr(cur, 3)
    sk, spr = torch.as_tensor(skps), torch.as_tensor(prior)
    sv = torch.ones(len(skps), dtype=torch.bool)
    for got, want in ((fb_early_exit(sp, sc, sk, spr, sv, stats),
                       tklt.fb_klt_track_plain(sp, sc, sk, spr, sv)),
                      (fb_early_exit(sp[:1], sc[:1], sk, spr, sv, stats),
                       tklt.fb_klt_track_plain(sp[:1], sc[:1], sk, spr,
                                               sv))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    fb, fc, fk, fp = (torch.as_tensor(x) for x in flat_case())
    fp_, fc_ = _pyr(fb.numpy(), 3), _pyr(fc.numpy(), 3)
    got = fb_early_exit(fp_, fc_, fk, fp, sv, stats)
    for g, w in zip(got, tklt.fb_klt_track_plain(fp_, fc_, fk, fp, sv)):
        assert torch.equal(g, w)
    # the fixtures reach every way a row's level ends
    assert min(stats.values()) > 0, stats


# ------------------------------------------------------------- the card #

def _agree(label, got, want):
    gpx, gst = (x.cpu().numpy() for x in got[:2])
    wpx, wst = (x.cpu().numpy() for x in want[:2])
    share = (gst == wst).mean()
    assert share >= STATUS_SHARE, (label, share)
    both = gst & wst
    assert both.sum() >= 5, label
    err = np.abs(gpx[both] - wpx[both]).max()
    assert err <= EPS_PX, (label, err)


def test_cuda_kernel_matches_plain(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs in chip_smoke.py)")
    dev = torch.device("cuda")
    a, b, kps, ok = pair
    pp, pc = _pyr(a, 4, dev), _pyr(b, 4, dev)
    k = torch.as_tensor(kps, device=dev)
    v = torch.as_tensor(ok, device=dev)
    n0 = tklt.klt_track.launches
    fwd = tklt.klt_track(pp, pc, k, k, v)
    _agree("klt pair", fwd, tklt.klt_track_plain(pp, pc, k, k, v))
    fb = tklt.fb_klt_track(pp, pc, k, k, v)
    _agree("fb pair", fb, tklt.fb_klt_track_plain(pp, pc, k, k, v))
    again = tklt.fb_klt_track(pp, pc, k, k, v)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(fb, again))
    assert tklt.klt_track.launches == n0 + 3
    empty = tklt.fb_klt_track(pp, pc, k[:0], k[:0], v[:0])
    assert empty[0].shape == (0, 2) and tklt.klt_track.launches == n0 + 3


@pytest.mark.parametrize("n_sub", [8, 64])
def test_cuda_split_matches_plain_including_overflow(n_sub):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs in chip_smoke.py)")
    dev = torch.device("cuda")
    base, cur, kps, prior, base_only = split_case()
    args = (_pyr(base, 3, dev), _pyr(cur, 3, dev),
            torch.as_tensor(kps, device=dev),
            torch.as_tensor(prior, device=dev),
            torch.ones(len(kps), dtype=torch.bool, device=dev),
            torch.as_tensor(base_only, device=dev))
    n0 = tklt.klt_track.launches
    got = tklt.fb_klt_track_split(*args, n_sub=n_sub)
    assert tklt.klt_track.launches == n0 + 2
    cpu = [tuple(t.cpu() for t in x) if isinstance(x, tuple) else x.cpu()
           for x in args]
    _agree(f"split n_sub={n_sub}", got,
           tklt.fb_klt_track_split(*cpu, n_sub=n_sub))
