"""The pose kernels' wrappers (geometry/essential.py::essential_ransac,
solvers/pnp_refine.py::pnp_refine) and their launches.

On the CPU:
- the wrappers take CPU tensors to the plain versions, bit for bit, and
  the samples are drawn as before (one weight vector for both draws gives
  the same rows as one per draw);
- the pure-Python launch packing matches both C signatures, and every
  refusal raises: f64, non-contiguous, mixed devices, N or the samples
  above what the kernels are sized for;
- torch mirrors of the kernels' algorithms: for RANSAC the null space by
  Householder reflections in LAPACK's convention (geqr2 / org2r), the LU
  with partial pivoting, the first 10 sign changes in grid order, the
  8-point projection through a Jacobi eigensolver and the packed-argmax
  tie rule; for PnP one pass a LM iteration (H, g and the cost at the
  candidate pose, kept where it is accepted), the fixed-order reduction
  (each thread's rows, a xor butterfly, the warps in order) and the 6x6
  LU. Each is held against the JAX package (imported inside the test) on
  the same seeded inputs and the same injected samples: candidates per
  slot within 1e-5 up to sign in f64 (on samples of distinct rows: a
  sample with a repeated row has no unique null space), the chosen inlier
  mask equal; the pose within 1e-4 and the masks equal in f32;
- torch mirrors of how the kernels split that work, each equal bit for
  bit to the sequential form it replaces: the root search in rounds of
  five speculative steps with its exact early exit (against 60 sequential
  steps, in f32, on det B of seeded 5-point samples from the JAX package
  and on a root near t = 0, a root on a grid point and a NaN flo; and the
  steps to the fixed point within 60), the reduce-scatter of the 28 PnP
  sums against the full butterflies (N 1 to 1024 rows), and the LU with a
  column a lane (the pivot on its column's lane, the multipliers
  broadcast) against ``lu_solve``.

On the card (skipped without one, decided inside the test): each kernel
against its plain version on the same fixtures (``chip_smoke.pose_*``),
to chip_smoke's bars: RANSAC candidates per slot within 1e-3 relative up to
sign where both are finite (samples of distinct rows), the chosen mask
equal except on rows whose Sampson distance lies within 1e-4 of the
threshold; PnP's pose within 1e-4, its mask equal except on rows within
1e-4 of the chi2 gate; two launches bit-equal; N = 0 launching nothing.
The RANSAC kernel is one launch a call, and the front end's and the loop
closer's calls issued together on two streams each equal their call alone
(the kernel's selection ticket is per stream). The file imports no JAX at
module level: on the card ``python -m pytest --noconftest
tests/test_torch_pose_kernels.py`` runs it.
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from ov2slam_torch import kernels
from ov2slam_torch.geometry import essential as te
from ov2slam_torch.solvers import pnp_refine as tpr
from ov2slam_torch.utils import lie

torch.set_num_threads(1)


def _t(a, dtype=None, dev="cpu"):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


def ransac_inputs(dtype=torch.float32, dev="cpu", **kw):
    xl, xr, valid, idx5, idx8, focal, err = chip_smoke.pose_ransac_case(
        **kw)
    return (_t(xl, dtype, dev), _t(xr, dtype, dev), _t(valid, dev=dev),
            _t(idx5, dev=dev), _t(idx8, dev=dev), focal, err)


def pnp_inputs(dev="cpu", **kw):
    T0, pts, px, valid, cal = chip_smoke.pose_pnp_case(**kw)
    return (_t(T0, dev=dev), _t(pts, dev=dev), _t(px, dev=dev),
            _t(valid, dev=dev), *cal)


def distinct_rows(idx):
    return np.array([len(set(r)) == len(r) for r in np.asarray(idx)])


# ------------------------------------------------------------ wrappers #

def test_cpu_wrappers_equal_plain_bit_for_bit():
    xl, xr, v, i5, i8, focal, err = ransac_inputs()
    n_it = i5.shape[0]
    got = te.essential_ransac(None, xl, xr, v, focal, err, n_it, i5, i8)
    want = te.essential_ransac_plain(None, xl, xr, v, focal, err, n_it, i5,
                                     i8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = te.essential_ransac(g1, xl, xr, v, focal, err, 24)
    want = te.essential_ransac_plain(g2, xl, xr, v, focal, err, 24)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    args = pnp_inputs()
    for rob in (5.9915, 0.0):
        for g, w in zip(tpr.pnp_refine(*args, robust_th=rob),
                        tpr.pnp_refine_plain(*args, robust_th=rob)):
            assert torch.equal(g, w)
    assert te.essential_ransac_plain.cuda_runs == 0
    assert tpr.pnp_refine_plain.cuda_runs == 0
    assert te.essential_ransac.launches == tpr.pnp_refine.launches == 0


def test_samples_drawn_as_before():
    """One weight vector for both draws gives the rows that one weight
    vector per draw gave."""
    valid = torch.as_tensor(np.random.default_rng(2).random(300) < 0.7)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    i5, i8 = te.ransac_samples(g1, valid, 40)
    for got, k, n in ((i5, 5, 40), (i8, 8, 10)):
        probs = valid.to(torch.float32) + 1e-9
        want = torch.multinomial(probs, n * k, replacement=True,
                                 generator=g2).reshape(n, k)
        assert torch.equal(got, want)


# ------------------------------------------------------------- packing #

def _c_types_match(c_args, argtypes):
    for value, ctype in zip(c_args, argtypes):
        if ctype is ctypes.c_void_p:
            assert value is None or isinstance(value, int)
        else:
            assert ctype(value).value == pytest.approx(value)


def test_ransac_packing_matches_the_c_signature():
    xl, xr, v, i5, i8, focal, err = ransac_inputs()
    a = te.pack_launch(xl, xr, v, i5, i8, focal, err)
    assert (a.x_l, a.x_r, a.valid, a.idx5, a.idx8) == (
        xl.data_ptr(), xr.data_ptr(), v.data_ptr(), i5.data_ptr(),
        i8.data_ptr())
    assert (a.n, a.n5, a.n8, a.n_cand) == (len(xl), len(i5), len(i8),
                                           10 * len(i5) + len(i8))
    # a number focal length: the threshold as the plain version forms it
    # (a Python float, compared in f32); a tensor one: read on the device
    assert a.focal is None and a.th == (err / focal) ** 2
    f = torch.tensor(focal)
    b = te.pack_launch(xl, xr, v, i5, i8, f, err)
    assert b.focal == f.data_ptr() and b.err == err
    _, restype, argtypes = kernels._SIGNATURES["essential_ransac"]
    c = a.c_args()
    # then the candidates, their flags and qualities, the step counts, the
    # ticket, E, the mask, the count and the stream
    assert restype is ctypes.c_int and len(c) + 9 == len(argtypes)
    _c_types_match(c, argtypes)
    assert [argtypes[i] for i in (3, 5, 7)] == [ctypes.c_int] * 3
    assert argtypes[10:12] == [ctypes.c_float] * 2
    assert argtypes[len(c):] == [ctypes.c_void_p] * 9


def test_pnp_packing_matches_the_c_signature():
    T0, pts, px, v, fx, fy, cx, cy = pnp_inputs()
    a = tpr.pack_launch(T0, pts, px, v, fx, fy, cx, cy, 5.9915, 10, 1e-4)
    assert (a.T_wc, a.pts, a.px, a.valid) == (
        T0.data_ptr(), pts.data_ptr(), px.data_ptr(), v.data_ptr())
    assert (a.n, a.pts_stride, a.px_stride, a.iters) == (len(pts), 3, 2, 10)
    assert list(a.cal_ptrs) == [0] * 4
    assert list(a.cal_vals) == [np.float32(x) for x in (fx, fy, cx, cy)]
    # a column view of a packed state is read in place; intrinsics as
    # tensors are read on the device
    state = torch.zeros((len(pts), 8))
    f = torch.tensor(fx)
    b = tpr.pack_launch(T0, state[:, 2:5], state[:, 5:7], v, f, fy, cx, cy,
                        0.0, 3, 1e-4)
    assert (b.pts, b.px) == (state.data_ptr() + 8, state.data_ptr() + 20)
    assert (b.pts_stride, b.px_stride) == (8, 8)
    assert list(b.cal_ptrs)[0] == f.data_ptr() and b.cal_ptrs[1] == 0
    _, restype, argtypes = kernels._SIGNATURES["pnp_refine"]
    c = a.c_args()
    assert restype is ctypes.c_int and len(c) + 4 == len(argtypes)
    _c_types_match(c, argtypes)
    assert [argtypes[i] for i in (2, 4, 6, 10)] == [ctypes.c_int] * 4
    assert [argtypes[i] for i in (9, 11)] == [ctypes.c_float] * 2
    assert argtypes[len(c):] == [ctypes.c_void_p] * 4


def _ransac_refusal(kind):
    xl, xr, v, i5, i8, focal, err = ransac_inputs()
    if kind == "f64":
        xl = xl.double()
    elif kind == "dtype_valid":
        v = v.to(torch.uint8)
    elif kind == "dtype_idx":
        i5 = i5.to(torch.int32)
    elif kind == "f64_focal":
        focal = torch.tensor(focal, dtype=torch.float64)
    elif kind == "tensor_err":
        err = torch.tensor(err)
    elif kind == "non_contiguous":
        xr = torch.stack([xr[:, 0], xr[:, 1]], 0).t()
    elif kind == "mixed_devices":
        i8 = i8.to("meta")
    elif kind == "shape":
        v = v[:-1]
    elif kind == "too_many_rows":
        n = te.MAX_ROWS + 1
        xl, xr = torch.zeros((n, 2)), torch.zeros((n, 2))
        v = torch.ones(n, dtype=torch.bool)
    elif kind == "too_many_samples":
        i5 = torch.zeros((te.MAX_SAMPLES, 5), dtype=torch.int64)
    elif kind == "no_samples":
        i5 = i5[:0]
        i8 = i8[:0]
    return te.pack_launch, (xl, xr, v, i5, i8, focal, err)


def _pnp_refusal(kind):
    T0, pts, px, v, fx, fy, cx, cy = pnp_inputs()
    kw = dict(robust_th=5.9915, iters=10, lam0=1e-4)
    if kind == "f64":
        T0 = T0.double()
    elif kind == "f64_points":
        pts = pts.double()
    elif kind == "f64_fx":
        fx = torch.tensor(fx, dtype=torch.float64)
    elif kind == "tensor_robust_th":
        kw["robust_th"] = torch.tensor(5.9915)
    elif kind == "dtype_valid":
        v = v.to(torch.uint8)
    elif kind == "non_contiguous":
        pts = torch.stack([pts[:, 0], pts[:, 1], pts[:, 2]], 0).t()
    elif kind == "mixed_devices":
        px = px.to("meta")
    elif kind == "shape":
        v = v[:-1]
    elif kind == "too_many_rows":
        n = tpr.MAX_ROWS + 1
        pts, px = torch.zeros((n, 3)), torch.zeros((n, 2))
        v = torch.ones(n, dtype=torch.bool)
    elif kind == "iters":
        kw["iters"] = -1
    return tpr.pack_launch, (T0, pts, px, v, fx, fy, cx, cy,
                             kw["robust_th"], kw["iters"], kw["lam0"])


@pytest.mark.parametrize("kind,exc", [
    ("f64", TypeError), ("dtype_valid", TypeError), ("dtype_idx", TypeError),
    ("f64_focal", TypeError), ("tensor_err", TypeError),
    ("non_contiguous", ValueError), ("mixed_devices", ValueError),
    ("shape", ValueError), ("too_many_rows", ValueError),
    ("too_many_samples", ValueError), ("no_samples", ValueError)])
def test_ransac_packing_refuses(kind, exc):
    fn, args = _ransac_refusal(kind)
    with pytest.raises(exc):
        fn(*args)


@pytest.mark.parametrize("kind,exc", [
    ("f64", TypeError), ("f64_points", TypeError), ("f64_fx", TypeError),
    ("tensor_robust_th", TypeError), ("dtype_valid", TypeError),
    ("non_contiguous", ValueError), ("mixed_devices", ValueError),
    ("shape", ValueError), ("too_many_rows", ValueError),
    ("iters", ValueError)])
def test_pnp_packing_refuses(kind, exc):
    fn, args = _pnp_refusal(kind)
    with pytest.raises(exc):
        fn(*args)


def test_unsupported_device_raises():
    xl, xr, v, i5, i8, focal, err = ransac_inputs()
    meta = [x.to("meta") for x in (xl, xr, v, i5, i8)]
    with pytest.raises(ValueError):
        te.essential_ransac(None, *meta[:3], focal, err, 40, *meta[3:])
    T0, pts, px, v, *cal = pnp_inputs()
    with pytest.raises(ValueError):
        tpr.pnp_refine(*[x.to("meta") for x in (T0, pts, px, v)], *cal)


# ---------------------------------------------------- the RANSAC mirror #

def householder_null_space(At):
    """Columns k..8 of the complete Q of the (S, 9, k) matrices ``At`` by
    Householder reflections in LAPACK's convention (geqr2: beta =
    -sign(alpha) |x|, tau = (beta - alpha) / beta, v = x / (alpha - beta);
    org2r: e_j with H(k-1) applied first), as the kernel forms them."""
    a = At.clone()
    S, m, k = a.shape
    one = torch.ones((S, 1), dtype=a.dtype)
    taus = []
    for i in range(k):
        alpha = a[:, i, i]
        x = a[:, i + 1:, i]
        xn2 = (x * x).sum(-1)
        beta = torch.where(alpha >= 0, -1.0, 1.0) * torch.sqrt(
            alpha * alpha + xn2)
        zero = xn2 == 0
        tau = torch.where(zero, torch.zeros_like(alpha), (beta - alpha) / beta)
        a[:, i + 1:, i] = torch.where(zero[:, None], x,
                                      x / (alpha - beta)[:, None])
        a[:, i, i] = torch.where(zero, alpha, beta)
        v = torch.cat([one, a[:, i + 1:, i]], -1)
        C = a[:, i:, i + 1:]
        w = (C * v[..., None]).sum(1)
        a[:, i:, i + 1:] = C - tau[:, None, None] * v[..., None] * w[:, None]
        taus.append(tau)
    cols = []
    for j in range(k, m):
        y = torch.zeros((S, m), dtype=a.dtype)
        y[:, j] = 1.0
        for i in range(k - 1, -1, -1):
            v = torch.cat([one, a[:, i + 1:, i]], -1)
            w = (y[:, i:] * v).sum(-1)
            y[:, i:] = y[:, i:] - (taus[i] * w)[:, None] * v
        cols.append(y)
    return torch.stack(cols, -1)


def lu_solve(A, B):
    """(S, n, n) x = (S, n, m) by LU with partial pivoting, as the kernels
    take it: the first largest pivot, multipliers by the reciprocal, the
    rank-1 updates carrying the right-hand sides, then back substitution."""
    M = torch.cat([A, B], -1).clone()
    S, n, _ = A.shape
    rows = torch.arange(S)
    for k in range(n):
        p = k + torch.argmax(M[:, k:, k].abs(), dim=-1)
        rk, rp = M[rows, k].clone(), M[rows, p].clone()
        M[rows, k], M[rows, p] = rp, rk
        M[:, k + 1:, k] = M[:, k + 1:, k] * (1.0 / M[:, k, k])[:, None]
        M[:, k + 1:, k + 1:] = (M[:, k + 1:, k + 1:] - M[:, k + 1:, k:k + 1]
                                * M[:, k:k + 1, k + 1:])
    X = M[:, :, n:].clone()
    for k in range(n - 1, -1, -1):
        X[:, k] = X[:, k] / M[:, k, k:k + 1]
        X[:, :k] = X[:, :k] - M[:, :k, k:k + 1] * X[:, k:k + 1]
    return X


def first_sign_changes(v, n_max=te._MAX_ROOTS):
    """The grid indices of the first ``n_max`` sign changes of ``v``
    (..., G) in grid order, by their ranks (the kernel's ballot and
    prefix count); (idx, valid), idx 0 where there is no such change."""
    sgn = torch.sign(v)
    change = (sgn[..., :-1] * sgn[..., 1:]) < 0
    rank = torch.cumsum(change.to(torch.int64), -1) - 1
    hits = [change & (rank == k) for k in range(n_max)]
    valid = torch.stack([h.any(-1) for h in hits], -1)
    idx = torch.stack([h.to(torch.uint8).argmax(-1) for h in hits], -1)
    return idx, valid


def bisect_sequential(evaluate, c, lo, hi, flo, steps=te._BISECT_ITERS):
    """``steps`` bisection steps of the brackets [lo, hi] (f(lo) = flo) of
    ``c``'s polynomials, ``evaluate(c, t)`` their values: keep [mid, hi]
    where flo f(mid) > 0, else [lo, mid]. Returns (lo, hi, flo)."""
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        fmid = evaluate(c, mid)
        take_lo = (flo * fmid) > 0
        lo = torch.where(take_lo, mid, lo)
        flo = torch.where(take_lo, fmid, flo)
        hi = torch.where(take_lo, hi, mid)
    return lo, hi, flo


def theta_grid(dtype=torch.float32):
    eps = 1e-4
    return torch.linspace(-torch.pi / 2 + eps, torch.pi / 2 - eps,
                          te._N_GRID, dtype=dtype)


def real_roots_mirror(c):
    theta = theta_grid(c.dtype)
    v = te._poly_tan_eval(c, theta.expand(c.shape[:-1] + (te._N_GRID,)))
    idx, valid = first_sign_changes(v)
    lo, hi = theta[idx], theta[idx + 1]
    flo = te._poly_tan_eval(c, lo)
    lo, hi, _ = bisect_sequential(te._poly_tan_eval, c, lo, hi, flo)
    roots = torch.tan(0.5 * (lo + hi))
    valid = valid & (roots.abs() < 1e6)
    return torch.where(valid, roots, torch.full_like(roots, float("nan"))), \
        valid


def _design(x_l, x_r):
    hl, hr = te._homog(x_l), te._homog(x_r)
    return (hl[..., :, :, None] * hr[..., :, None, :]).flatten(-2)


def five_point_mirror(x_l, x_r):
    """The kernel's 5-point on (S, 5, 2) samples: (Es (S, 10, 3, 3),
    valid (S, 10)). As in the kernel, the constraint rows, their solve and
    det B run in f64 from the null space, then go back to the inputs'
    dtype."""
    S = x_l.shape[0]
    null = householder_null_space(_design(x_l, x_r).transpose(-2, -1))
    basis = null.transpose(-2, -1).reshape(S, 4, 3, 3)
    M = te._nister_constraints(basis.double())
    P = lu_solve(M[..., :10], M[..., 10:])
    detB, B = te._nister_detB(P)
    detB = detB.to(x_l.dtype)
    B = [[B[i][j].to(x_l.dtype) for j in range(3)] for i in range(3)]
    z, valid = real_roots_mirror(detB)
    b = [[te._polyval(B[i][j], z) for j in range(3)] for i in range(2)]
    den = b[0][0] * b[1][1] - b[0][1] * b[1][0]
    x = (-b[0][2] * b[1][1] + b[0][1] * b[1][2]) / den
    y = (-b[0][0] * b[1][2] + b[0][2] * b[1][0]) / den
    bs = basis[:, None]
    Es = (x[..., None, None] * bs[:, :, 0] + y[..., None, None] * bs[:, :, 1]
          + z[..., None, None] * bs[:, :, 2] + bs[:, :, 3])
    Es = Es / torch.clamp(torch.linalg.norm(Es.flatten(-2), dim=-1),
                          min=1e-12)[..., None, None]
    return torch.where(valid[..., None, None], Es,
                       torch.full_like(Es, float("nan"))), valid


def jacobi_eigh3(A, sweeps=12):
    """Eigenvalues (ascending) and eigenvectors (columns) of symmetric
    (S, 3, 3) ``A`` by cyclic Jacobi rotations, as the kernel takes them."""
    a = A.clone()
    S = a.shape[0]
    V = torch.eye(3, dtype=a.dtype).repeat(S, 1, 1)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = a[:, p, q]
            rot = apq != 0
            safe = torch.where(rot, apq, torch.ones_like(apq))
            th = (a[:, q, q] - a[:, p, p]) / (2.0 * safe)
            t = torch.sign(th) / (th.abs() + torch.sqrt(th * th + 1.0))
            t = torch.where(th == 0, torch.ones_like(t), t)
            c = torch.where(rot, 1.0 / torch.sqrt(t * t + 1.0),
                            torch.ones_like(t))
            s = torch.where(rot, t * c, torch.zeros_like(t))
            J = torch.eye(3, dtype=a.dtype).repeat(S, 1, 1)
            J[:, p, p], J[:, q, q] = c, c
            J[:, p, q], J[:, q, p] = s, -s
            a = J.transpose(-2, -1) @ a @ J
            a[:, p, q] = torch.where(rot, torch.zeros_like(apq), a[:, p, q])
            a[:, q, p] = a[:, p, q]
            V = V @ J
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1)
    return (torch.gather(w, -1, order),
            torch.gather(V, -1, order[:, None, :].expand(S, 3, 3)))


def eight_point_mirror(x_l, x_r):
    """The kernel's 8-point on (S, 8, 2) samples: the null vector by the
    Householder QR, the rank-2 projection through Jacobi."""
    S = x_l.shape[0]
    e = householder_null_space(_design(x_l, x_r).transpose(-2, -1))[..., 0]
    E = e.reshape(S, 3, 3)
    lam, V = jacobi_eigh3(E.transpose(-2, -1) @ E)
    s = torch.sqrt(torch.clamp(lam, min=1e-20))
    sigma = 0.5 * (s[:, 2] + s[:, 1])
    v2, v1 = V[..., :, 2], V[..., :, 1]
    outer = (v2[..., :, None] * v2[..., None, :] / s[:, 2, None, None]
             + v1[..., :, None] * v1[..., None, :] / s[:, 1, None, None])
    return sigma[:, None, None] * (E @ outer)


def packed_argmax(q):
    """The selection kernel's argmax: the largest of (order-preserving
    bits of q, ~index), i.e. the first index of the largest value, NaN
    largest."""
    u = q.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where((u & 0x80000000) != 0, (~u) & 0xFFFFFFFF,
                      u | 0x80000000)
    key = torch.where(torch.isnan(q), torch.full_like(key, 0xFFFFFFFF), key)
    idx = torch.arange(len(q), dtype=torch.int64)
    packed = key * (1 << 31) + ((1 << 31) - 1 - idx)
    return int((1 << 31) - 1 - packed.max() % (1 << 31))


def ransac_mirror(x_l, x_r, valid, idx5, idx8, focal, err):
    """The kernel's RANSAC on given samples: (E, inlier, n, candidates,
    quality)."""
    E5, v5 = five_point_mirror(x_l[idx5], x_r[idx5])
    ok5 = (valid[idx5].all(-1)[:, None] & v5).reshape(-1)
    E8 = eight_point_mirror(x_l[idx8], x_r[idx8])
    cand = torch.cat([E5.reshape(-1, 3, 3), E8])
    ok = torch.cat([ok5, valid[idx8].all(-1)])
    finite = torch.isfinite(cand).all(-1).all(-1)
    E = torch.where(finite[:, None, None], cand, torch.zeros_like(cand))
    th = (err / focal) ** 2
    d2 = te.sampson_dist_sq(E, x_l[None], x_r[None])
    inl = (d2 < th) & valid[None]
    q = torch.where(inl, 1.0 - d2 / th, torch.zeros_like(d2)).sum(-1)
    q = torch.where(ok & finite, q, torch.full_like(q, -1.0))
    best = packed_argmax(q)
    return E[best], inl[best], inl[best].sum(), cand, q


def _jax():
    jax = pytest.importorskip("jax")
    # as tests/conftest.py sets them, where a run goes without it (on the
    # card): f64 on the CPU
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    return jax


def _match_slots(a, b, rows, tol):
    """Candidates per slot of samples with distinct rows, up to sign,
    where both are finite; returns the slots compared."""
    n = 0
    for s in np.nonzero(rows)[0]:
        for k in range(a.shape[1]):
            x, y = a[s, k].ravel(), b[s, k].ravel()
            if not (np.isfinite(x).all() and np.isfinite(y).all()):
                continue
            d = min(np.abs(x - y).max(), np.abs(x + y).max())
            assert d < tol * np.abs(y).max(), (s, k, d)
            n += 1
    return n


def test_ransac_mirror_matches_jax_per_slot_and_mask():
    jax = _jax()
    import jax.numpy as jnp

    from ov2slam_tpu.geometry import essential as je

    xl, xr, v, i5, i8, focal, err = ransac_inputs(torch.float64)
    th = (err / focal) ** 2

    @jax.jit
    def jax_ransac(x_l, x_r, valid, idx5, idx8):
        # the JAX package composed on the same samples, as
        # test_torch_geometry.py does
        E5, v5 = jax.vmap(je.five_point)(x_l[idx5], x_r[idx5])
        E8 = je.eight_point(x_l[idx8], x_r[idx8])
        E = jnp.concatenate([E5.reshape(-1, 3, 3), E8])
        ok = jnp.concatenate([(valid[idx5].all(-1)[:, None] & v5).reshape(-1),
                              valid[idx8].all(-1)])
        finite = jnp.isfinite(E).all((-2, -1))
        E = jnp.where(finite[:, None, None], E, 0.0)
        d2 = je.sampson_dist_sq(E, x_l[None], x_r[None])
        inl = (d2 < th) & valid[None]
        q = jnp.where(ok & finite, jnp.where(inl, 1.0 - d2 / th, 0.0).sum(-1),
                      -1.0)
        return E5, v5, E8, inl[jnp.argmax(q)]

    jE5, jv5, jE8, j_inl = (np.asarray(a) for a in jax_ransac(*(
        jnp.asarray(x.numpy()) for x in (xl, xr, v, i5, i8))))
    mE5, mv5 = five_point_mirror(xl[i5], xr[i5])
    rows = distinct_rows(i5)
    assert np.array_equal(jv5[rows], mv5.numpy()[rows])
    assert _match_slots(mE5.numpy(), jE5, rows, 1e-5) > 20
    mE8 = eight_point_mirror(xl[i8], xr[i8]).numpy()
    assert _match_slots(mE8[:, None], jE8[:, None], distinct_rows(i8),
                        1e-5) == distinct_rows(i8).sum()
    _, m_inl, m_n, _, _ = ransac_mirror(xl, xr, v, i5, i8, focal, err)
    assert int(m_n) == j_inl.sum() > 80
    np.testing.assert_array_equal(m_inl.numpy(), j_inl)


def test_ransac_mirror_f32_chooses_the_plain_mask():
    xl, xr, v, i5, i8, focal, err = ransac_inputs()
    E, inl, n, _, _ = ransac_mirror(xl, xr, v, i5, i8, focal, err)
    pE, pinl, pn = te.essential_ransac_plain(None, xl, xr, v, focal, err,
                                             i5.shape[0], i5, i8)
    assert int(n) == int(pn)
    assert torch.equal(inl, pinl)


def test_first_sign_changes_in_grid_order():
    """More than 10 changes: the first 10 in grid order, as the plain
    version's stable argsort keeps them; zeros are no change."""
    rng = np.random.default_rng(5)
    v = torch.as_tensor(rng.normal(size=(64, te._N_GRID)))
    v[:8, ::7] = 0.0
    idx, valid = first_sign_changes(v)
    sgn = torch.sign(v)
    change = (sgn[..., :-1] * sgn[..., 1:]) < 0
    want = torch.argsort((~change).to(torch.uint8), dim=-1,
                         stable=True)[..., :te._MAX_ROOTS]
    assert valid.all()
    assert torch.equal(idx, want)
    few = torch.ones((2, te._N_GRID), dtype=torch.float64)
    few[0, 100:] = -1.0
    idx, valid = first_sign_changes(few)
    assert valid.tolist() == [[True] + [False] * 9, [False] * 10]
    assert int(idx[0, 0]) == 99


def test_packed_argmax_keeps_the_first_index():
    q = torch.tensor([-1.0, 3.5, 0.0, 3.5, -0.5, 3.5])
    assert packed_argmax(q) == int(torch.argmax(q)) == 1
    q = torch.tensor([-1.0, -1.0, -1.0])
    assert packed_argmax(q) == int(torch.argmax(q)) == 0
    q = torch.tensor([1.0, float("nan"), 2.0, float("nan")])
    assert packed_argmax(q) == int(torch.argmax(q)) == 1
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.integers(-1, 4, 1025).astype(np.float32) / 4)
    assert packed_argmax(q) == int(torch.argmax(q))


def test_duplicate_samples_tie_to_the_first():
    """A repeated sample gives candidates equal bit for bit; the first of
    them wins, in the mirror as in the plain version."""
    xl, xr, v, i5, i8, focal, err = ransac_inputs()
    i5 = torch.cat([i5, i5])
    i8 = torch.cat([i8, i8])
    E, inl, n, cand, q = ransac_mirror(xl, xr, v, i5, i8, focal, err)
    best = packed_argmax(q)
    assert best == int(torch.argmax(q))
    n5 = i5.shape[0] // 2
    assert best < 10 * n5 or 10 * 2 * n5 <= best < 10 * 2 * n5 + len(i8) // 2
    pE, pinl, pn = te.essential_ransac_plain(None, xl, xr, v, focal, err,
                                             i5.shape[0], i5, i8)
    assert torch.equal(inl, pinl) and int(n) == int(pn)


# --------------------------- the root search, as the kernel splits it #

def poly_tan_eval_elementwise(c, t):
    """cos^10(t) p(tan t) as the kernel forms it, element by element: s^k
    and co^(10-k) by repeated products, then the terms summed in k order.
    ``c`` (t.shape + (11,)). The sine and cosine come from f64, rounded:
    torch's f32 ones may differ in the last bit with an element's place in
    a tensor, which two forms of one search must not see."""
    s = torch.sin(t.double()).to(t.dtype)
    co = torch.cos(t.double()).to(t.dtype)
    sk, ck = [torch.ones_like(t)], [torch.ones_like(t)]
    for _ in range(10):
        sk.append(sk[-1] * s)
        ck.append(ck[-1] * co)
    acc = torch.zeros_like(t)
    for k in range(11):
        acc = acc + c[..., k] * (sk[k] * ck[10 - k])
    return acc


def _same(a, b):
    return a.view(torch.int32) == b.view(torch.int32)


def bisect_speculative(evaluate, c, lo, hi, flo, levels=5,
                       cap=te._BISECT_ITERS):
    """The kernel's root search (csrc/essential_ransac.cu::bisect_warp) on
    f32 brackets: rounds of ``levels`` sequential steps, node j of each
    round's tree (heap order: children 2j + 1 keeping [lo, mid], 2j + 2
    keeping [mid, hi]) evaluated at the midpoint its path replays, then the
    walk down the levels with the sequential test. A bracket whose step
    leaves (lo, hi, flo) as it was, as bits, stops after that round.
    Returns (lo, hi, flo, steps): steps up to the first such step, that one
    included, or ``cap``."""
    nodes = 2 ** levels - 1
    j = torch.arange(nodes)
    depth = torch.tensor([(int(x) + 1).bit_length() - 1 for x in j])
    # c (S, 11) for brackets (S, K): one polynomial for all of a row's
    cc = c.reshape(c.shape[:-1] + (1,) * (lo.dim() - c.dim() + 2)
                   + c.shape[-1:]).expand(lo.shape + (nodes, c.shape[-1]))
    still = torch.zeros(lo.shape, dtype=torch.bool)
    steps = torch.zeros(lo.shape, dtype=torch.int64)
    for _ in range(cap // levels):
        l = lo[..., None].expand(lo.shape + (nodes,)).clone()
        h = hi[..., None].expand(lo.shape + (nodes,)).clone()
        for d in range(levels - 1):          # the path from the root
            on = depth > d
            bit = (((j + 1) >> (depth - 1 - d).clamp(min=0)) & 1) == 1
            m = 0.5 * (l + h)
            l = torch.where(on & bit, m, l)
            h = torch.where(on & ~bit, m, h)
        mid = 0.5 * (l + h)
        fmid = evaluate(cc, mid)
        node = torch.zeros(lo.shape, dtype=torch.int64)
        was = still.clone()
        n_lo, n_hi, n_flo = lo, hi, flo
        for _ in range(levels):
            m = torch.gather(mid, -1, node[..., None])[..., 0]
            f = torch.gather(fmid, -1, node[..., None])[..., 0]
            take_lo = (n_flo * f) > 0
            a_lo = torch.where(take_lo, m, n_lo)
            a_flo = torch.where(take_lo, f, n_flo)
            a_hi = torch.where(take_lo, n_hi, m)
            same = _same(a_lo, n_lo) & _same(a_hi, n_hi) & _same(a_flo, n_flo)
            steps = steps + (~still).to(torch.int64)
            still = still | same
            n_lo, n_hi, n_flo = a_lo, a_hi, a_flo
            node = 2 * node + torch.where(take_lo, 2, 1)
        # a bracket that had stopped before this round keeps its state
        lo = torch.where(was, lo, n_lo)
        hi = torch.where(was, hi, n_hi)
        flo = torch.where(was, flo, n_flo)
        if bool(still.all()):
            break
    return lo, hi, flo, steps


def brackets(c, evaluate=poly_tan_eval_elementwise):
    """The first 10 sign changes of ``c``'s polynomials (f32 (S, 11)) on the
    grid, as the kernel brackets them: (lo, hi, flo, valid), each (S,
    10)."""
    theta = theta_grid()
    cg = c[:, None, :].expand(c.shape[0], te._N_GRID, 11)
    v = evaluate(cg, theta.expand(c.shape[0], te._N_GRID))
    idx, valid = first_sign_changes(v)
    lo, hi = theta[idx], theta[idx + 1]
    flo = torch.gather(v, -1, idx)
    return lo, hi, flo, valid


def five_point_det_b(n_samples=40, seed=0):
    """det B's coefficients (f32 (S, 11)) of seeded 5-point samples of the
    fixture scene, from the JAX package's five_point steps (the QR's null
    space, the Nister constraints, the solve, det B)."""
    jax = _jax()
    import jax.numpy as jnp

    from ov2slam_tpu.geometry import essential as je

    xl, xr, v, i5, i8, focal, err = chip_smoke.pose_ransac_case(
        seed=seed, n_iters=n_samples)

    def one(x_l, x_r):
        ones = jnp.ones_like(x_l[..., :1])
        hl = jnp.concatenate([x_l, ones], axis=-1)
        hr = jnp.concatenate([x_r, ones], axis=-1)
        A = (hl[:, :, None] * hr[:, None, :]).reshape(5, 9)
        q, _ = jnp.linalg.qr(A.T, mode="complete")
        basis = q[:, 5:9].T.reshape(4, 3, 3)
        M = je._nister_constraints(basis)
        P = jnp.linalg.solve(M[:, :10], M[:, 10:])
        return je._nister_detB(P)[0]

    rows = distinct_rows(i5)
    c = jax.vmap(one)(jnp.asarray(xl[i5[rows]], jnp.float64),
                      jnp.asarray(xr[i5[rows]], jnp.float64))
    return torch.as_tensor(np.array(c), dtype=torch.float32)


def _both_searches(c, lo, hi, flo):
    ev = poly_tan_eval_elementwise
    cc = c[:, None, :].expand(lo.shape + (11,))
    want = bisect_sequential(ev, cc, lo, hi, flo)
    got = bisect_speculative(ev, c, lo, hi, flo)
    return want, got


def test_speculative_bisection_equals_sequential_on_five_point_polys():
    c = five_point_det_b()
    lo, hi, flo, valid = brackets(c)
    assert int(valid.sum()) > 60
    want, got = _both_searches(c, lo, hi, flo)
    for w, g in zip(want, got[:3]):
        assert torch.equal(_same(w, g), torch.ones_like(valid))
    steps = got[3][valid]
    # a grid cell's bracket reaches adjacent floats well before 60 steps
    assert int(steps.max()) <= te._BISECT_ITERS
    assert float(steps.double().median()) < 40


def _hand_poly(roots, scale=1.0):
    """Lowest-first f32 coefficients (1, 11) of scale * prod (z - r)."""
    p = np.array([scale], dtype=np.float64)
    for r in roots:
        p = np.convolve(p, [-r, 1.0])
    c = np.zeros(11)
    c[:len(p)] = p
    return torch.as_tensor(c[None], dtype=torch.float32)


@pytest.mark.parametrize("case", ["root_near_zero", "root_on_grid_point",
                                  "nan_flo"])
def test_speculative_bisection_hand_cases(case):
    theta = theta_grid()
    if case == "root_near_zero":
        c = _hand_poly([3e-7, 0.6, -2.5])
        lo, hi, flo, valid = brackets(c)
        # the bracket around t = 0, where the floats are densest
        assert bool(((lo < 0) & (hi > 0) & valid).any())
    elif case == "root_on_grid_point":
        z0 = float(torch.tan(theta[300].double()))
        c = _hand_poly([z0, -0.3, 1.7])
        lo, hi, flo, valid = brackets(c)
        # and the cell that starts on that grid point, searched as well
        lo = torch.cat([lo, theta[300:301][None]], -1)
        hi = torch.cat([hi, theta[301:302][None]], -1)
        flo = torch.cat([flo, poly_tan_eval_elementwise(
            c[:, None, :], theta[300:301][None])], -1)
    else:
        c = _hand_poly([0.25, -1.0])
        lo, hi = theta[None, 200:205], theta[None, 201:206]
        flo = torch.full_like(lo, float("nan"))
    want, got = _both_searches(c, lo, hi, flo)
    for w, g in zip(want, got[:3]):
        assert bool(_same(w, g).all()), case
    assert int(got[3].max()) <= te._BISECT_ITERS
    if case == "nan_flo":
        # every step keeps [lo, mid]: the bracket closes on lo to within a
        # float and stops there
        up = torch.nextafter(lo, torch.full_like(lo, float("inf")))
        assert bool(_same(got[0], lo).all()) and bool((got[1] <= up).all())
        assert int(got[3].max()) < te._BISECT_ITERS


def test_early_exit_stops_within_the_cap():
    """The steps a bracket takes to its fixed point, as the speculative
    search counts them (at most 60), are the sequential search's own: its
    last step left the bracket as it was, the one before moved it."""
    c = five_point_det_b(n_samples=12, seed=3)
    lo, hi, flo, valid = brackets(c)
    ev = poly_tan_eval_elementwise
    cc = c[:, None, :].expand(lo.shape + (11,))
    steps = bisect_speculative(ev, c, lo, hi, flo)[3]
    assert int(steps.max()) <= te._BISECT_ITERS
    assert int(steps[valid].min()) >= 2

    def same(a, b):
        return _same(a[0], b[0]) & _same(a[1], b[1]) & _same(a[2], b[2])

    for k in sorted(set(steps[valid].tolist()))[:6]:
        sel = valid & (steps == k)
        if k == te._BISECT_ITERS:
            continue
        last = bisect_sequential(ev, cc, lo, hi, flo, steps=k)
        before = bisect_sequential(ev, cc, lo, hi, flo, steps=k - 1)
        two_before = bisect_sequential(ev, cc, lo, hi, flo, steps=k - 2)
        assert bool(same(last, before)[sel].all())
        assert not bool(same(before, two_before)[sel].any())


# ------------------------------------------------------- the PnP mirror #

THREADS, WARPS = 256, 8


def fixed_order_sum(x):
    """(N, V) row values summed as the kernel sums them: each of 256
    threads its rows (i = tid, tid + 256, ...) in order, a xor butterfly
    over each warp's 32 lanes (lane 0's result), then the warps in order."""
    N, V = x.shape
    acc = torch.zeros((THREADS, V), dtype=x.dtype)
    for i in range(0, N, THREADS):
        blk = x[i:i + THREADS]
        acc[:len(blk)] = acc[:len(blk)] + blk
    lanes = acc.reshape(WARPS, 32, V)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ o]
    total = torch.zeros(V, dtype=x.dtype)
    for w in range(WARPS):
        total = total + lanes[w, 0]
    return total


def _rows(T, pts, px, valid, cal, robust_th):
    """Per-row terms at pose T: the 21 entries of w J^T J, w J^T r, the
    cost; and chi2, depth_ok."""
    fx, fy, cx, cy = cal
    r, J, dok = tpr._pose_residuals(T, pts, px, fx, fy, cx, cy)
    chi2 = torch.sum(r * r, -1)
    if robust_th > 0:
        w_rob = torch.where(chi2 <= robust_th, torch.ones_like(chi2),
                            torch.sqrt(robust_th / torch.clamp(chi2,
                                                               min=1e-12)))
        rho = torch.where(chi2 > robust_th,
                          2.0 * torch.sqrt(robust_th * chi2) - robust_th,
                          chi2)
    else:
        w_rob, rho = torch.ones_like(chi2), chi2
    wv = valid.to(r.dtype)
    w = wv * w_rob * dok
    JtJ = torch.einsum("oik,oil->okl", J, J) * w[:, None, None]
    iu = torch.triu_indices(6, 6)
    Jtr = torch.einsum("oik,oi->ok", J, r * w[:, None])
    return torch.cat([JtJ[:, iu[0], iu[1]], Jtr,
                      (rho * wv * dok)[:, None]], -1), chi2, dok


def pnp_mirror(T_wc, points, px, valid, fx, fy, cx, cy, robust_th=5.9915,
               iters=10, lam0=1e-4):
    """The kernel's LM loop: one pass a iteration at the candidate pose,
    its H, g and cost kept where the step is accepted; the fixed-order
    reduction; the 6x6 LU."""
    cal = (fx, fy, cx, cy)
    center = T_wc[4:7]
    T_cw = lie.pose_inverse(torch.cat([T_wc[:4], T_wc[4:7] - center]))
    pts = points - center
    iu = torch.triu_indices(6, 6)

    def reduce(T):
        return fixed_order_sum(_rows(T, pts, px, valid, cal, robust_th)[0])

    cur = reduce(T_cw)
    lam = torch.tensor(lam0, dtype=torch.float32)
    c1 = torch.zeros((), dtype=torch.float32)
    for _ in range(iters):
        H = torch.zeros((6, 6), dtype=cur.dtype)
        H[iu[0], iu[1]] = cur[:21]
        H = H + H.T - torch.diag(torch.diagonal(H))
        Hd = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-6))
        Hd = Hd + 1e-8 * torch.eye(6)
        dx = lu_solve(Hd[None], -cur[21:27][None, :, None])[0, :, 0]
        T_new = lie.pose_left_update(T_cw, dx)
        nxt = reduce(T_new)
        c1 = nxt[27]
        if bool(c1 < cur[27]):
            T_cw, cur = T_new, nxt
            lam = torch.clamp(lam * 0.5, min=1e-8)
        else:
            lam = torch.clamp(lam * 4.0, max=1e2)
    _, chi2, dok = _rows(T_cw, pts, px, valid, cal, robust_th)
    gate = robust_th if robust_th > 0 else 5.9915
    T_out = lie.pose_inverse(T_cw)
    return (torch.cat([T_out[:4], T_out[4:7] + center]),
            valid & (chi2 <= gate) & dok, c1)


def reduce_scatter_sum(x):
    """(N, V <= 32) row values summed as the PnP kernel now sums them: each
    of 256 threads its rows in order; in each warp a xor reduce-scatter
    (offsets 16, 8, 4, 2, 1: a lane with that bit keeps the upper half of
    its values and the partner's of the same half added, the other half
    sent), after which lane k holds value k; then the warps in order."""
    N, V = x.shape
    acc = torch.zeros((THREADS, 32), dtype=x.dtype)
    for i in range(0, N, THREADS):
        blk = x[i:i + THREADS]
        acc[:len(blk), :V] = acc[:len(blk), :V] + blk
    lanes = acc.reshape(WARPS, 32, 32)
    lane = torch.arange(32)
    width = 32
    for o in (16, 8, 4, 2, 1):
        upper = ((lane & o) != 0)[None, :, None]
        lower_half, upper_half = lanes[..., :o], lanes[..., o:width]
        keep = torch.where(upper, upper_half, lower_half)
        send = torch.where(upper, lower_half, upper_half)
        lanes = keep + send[:, lane ^ o]
        width = o
    per_warp = lanes[:, lane, 0]          # lane k: value k
    total = torch.zeros(32, dtype=x.dtype)
    for w in range(WARPS):
        total = total + per_warp[w]
    return total[:V]


@pytest.mark.parametrize("n", [1, 80, 512, 1024])
def test_reduce_scatter_equals_the_butterflies(n):
    x = torch.as_tensor(np.random.default_rng(n).normal(size=(n, 28)),
                        dtype=torch.float32)
    want = fixed_order_sum(x)
    got = reduce_scatter_sum(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def lu_solve_lanes(A, B):
    """``lu_solve`` with a column a lane, as the RANSAC kernel's warp takes
    it: lane k finds the pivot of its column (the first largest) and sends
    its index, every lane swaps rows k and p of its own column, lane k
    forms the multipliers by the reciprocal and sends them, the lanes right
    of k update their columns; then lane j of each right-hand side divides
    by the diagonal lane k sends and updates the rows above."""
    S, n, _ = A.shape
    cols = list(torch.cat([A, B], -1).clone().unbind(-1))   # lane = column
    for k in range(n):
        p = k + torch.argmax(cols[k][:, k:].abs(), dim=-1)  # on lane k
        rows = torch.arange(S)
        for c in range(len(cols)):                          # every lane
            rk, rp = cols[c][rows, k].clone(), cols[c][rows, p].clone()
            cols[c][rows, k], cols[c][rows, p] = rp, rk
        mult = cols[k][:, k + 1:] * (1.0 / cols[k][:, k:k + 1])
        cols[k][:, k + 1:] = mult                           # sent
        for c in range(k + 1, len(cols)):
            cols[c][:, k + 1:] = (cols[c][:, k + 1:]
                                  - mult * cols[c][:, k:k + 1])
    for c in range(n, len(cols)):                           # the rhs lanes
        for k in range(n - 1, -1, -1):
            cols[c][:, k] = cols[c][:, k] / cols[k][:, k]
            cols[c][:, :k] = cols[c][:, :k] - cols[k][:, :k] * \
                cols[c][:, k:k + 1]
    return torch.stack(cols[n:], -1)


@pytest.mark.parametrize("n,m", [(6, 1), (10, 10)])
def test_lane_lu_equals_lu_solve(n, m):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(32, n, n))
    A[:, 0, 0] = 0.0                    # the first pivot must be swapped
    A[:8, 2] = A[:8, 1]                 # ties: the first largest wins
    A[:8, 2, 1] = -A[:8, 2, 1]
    B = rng.normal(size=(32, n, m))
    for dtype in (torch.float32, torch.float64):
        a, b = (torch.as_tensor(x, dtype=dtype) for x in (A, B))
        want, got = lu_solve(a, b), lu_solve_lanes(a, b)
        assert torch.equal(got, want), dtype


def test_fixed_order_sum_is_the_sum():
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(700, 5)))
    np.testing.assert_allclose(fixed_order_sum(x).numpy(),
                               x.sum(0).numpy(), rtol=1e-12)


def test_lu_solve_partial_pivoting():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(16, 6, 6))
    A[:, 0, 0] = 0.0                    # the first pivot must be swapped
    B = rng.normal(size=(16, 6, 2))
    X = lu_solve(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(X, np.linalg.solve(A, B), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("robust", [5.9915, 0.0])
def test_pnp_mirror_matches_jax(robust):
    _jax()
    import jax.numpy as jnp

    from ov2slam_tpu.solvers import pnp_refine as jpr

    T0, pts, px, v, fx, fy, cx, cy = pnp_inputs()
    a = jpr.pnp_refine(*[jnp.asarray(x.numpy()) for x in (T0, pts, px, v)],
                       fx, fy, cx, cy, robust_th=robust)
    b = pnp_mirror(T0, pts, px, v, fx, fy, cx, cy, robust_th=robust)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), atol=1e-4)
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
    # two passes, as pnp_refine_two_pass runs them
    a2 = jpr.pnp_refine_two_pass(*[jnp.asarray(x.numpy())
                                   for x in (T0, pts, px, v)],
                                 fx, fy, cx, cy)
    T1, inl1, _ = pnp_mirror(T0, pts, px, v, fx, fy, cx, cy)
    T2, inl2, _ = pnp_mirror(T1, pts, px, v & inl1, fx, fy, cx, cy,
                             robust_th=0.0, iters=5)
    np.testing.assert_allclose(T2.numpy(), np.asarray(a2[0]), atol=1e-4)
    np.testing.assert_array_equal((inl1 & inl2).numpy(), np.asarray(a2[1]))


# --------------------------------------------------------------- card #

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cuda_ransac_matches_plain():
    dev = _card()
    s = chip_smoke.PoseSet.ransac("fixture", *ransac_inputs(dev=dev))
    chip_smoke.ransac_check(s)


@pytest.mark.parametrize("robust", [5.9915, 0.0])
def test_cuda_pnp_matches_plain(robust):
    dev = _card()
    s = chip_smoke.PoseSet.pnp("fixture", *pnp_inputs(dev=dev),
                               robust_th=robust)
    chip_smoke.pnp_check(s)


def test_cuda_ransac_is_one_launch_a_call():
    dev = _card()
    xl, xr, v, i5, i8, focal, err = ransac_inputs(dev=dev)
    assert te.KERNELS_PER_LAUNCH == 1
    n0 = te.essential_ransac.launches
    te.essential_ransac(None, xl, xr, v, focal, err, i5.shape[0], i5, i8)
    torch.cuda.synchronize()
    assert te.essential_ransac.launches - n0 == 1


def test_cuda_two_streams_equal_their_calls_alone():
    """A front-end-sized and a loop-closer-sized call issued together on
    two streams (the kernel's selection ticket is kept per stream), each
    equal bit for bit to its call alone, with every ticket back at 0."""
    dev = _card()
    small = chip_smoke.PoseSet.ransac("fixture", *ransac_inputs(dev=dev))
    big = chip_smoke.PoseSet.ransac("many samples", *ransac_inputs(
        dev=dev, seed=2, n=128, n_iters=1000))
    streams = [torch.cuda.Stream() for _ in range(2)]
    assert chip_smoke.two_stream_rounds((small, big), streams, 10) == (10, 10)


def test_cuda_empty_launches_nothing():
    dev = _card()
    xl, xr, v, i5, i8, focal, err = ransac_inputs(dev=dev)
    T0, pts, px, pv, *cal = pnp_inputs(dev=dev)
    n_r, n_p = te.essential_ransac.launches, tpr.pnp_refine.launches
    E, inl, n = te.essential_ransac(None, xl[:0], xr[:0], v[:0], focal, err,
                                    i5.shape[0], i5, i8)
    T, pinl, c = tpr.pnp_refine(T0, pts[:0], px[:0], pv[:0], *cal)
    torch.cuda.synchronize()
    assert (te.essential_ransac.launches, tpr.pnp_refine.launches) == (
        n_r, n_p)
    assert inl.shape == (0,) and int(n) == 0 and pinl.shape == (0,)
    assert torch.equal(T, T0)
