"""Batched essential-matrix estimation, decomposition, and epipolar filters.

Port of ``ov2slam_tpu/geometry/essential.py`` (the reference's
`compute5ptEssentialMatrix` with OpenGV's Nister backend, and the Sampson
helpers). The structure is kept:

- the 10 cubic constraints (det E = 0, 2·E·EᵗE − tr(E·Eᵗ)E = 0) are
  assembled numerically via monomial multiplication tables;
- Gauss–Jordan reduction is one batched 10×10 solve;
- the degree-10 polynomial's real roots are found by sign-change
  bracketing + bisection under z = tan θ;
- every 5-point sample yields up to 10 candidate E's, scored together with
  a pool of 8-point hypotheses in one batched Sampson pass.

Batch dimensions are written out (the JAX version vmaps). RANSAC draws its
samples from a ``torch.Generator``, or takes them explicitly (``idx5``,
``idx8``) so a test can feed both packages the same samples.
"""

from __future__ import annotations

import functools

from typing import Optional

import numpy as _np
import torch

from ..utils import lie
from .triangulation import triangulate_midpoint


def essential_from_pose(T_lr):
    """E such that x_l^T E x_r = 0 for normalized coords, from the pose of
    the right view in the left frame (x_l = R x_r + t): E = [t]x R."""
    R = lie.quat_to_matrix(lie.pose_q(T_lr))
    t = lie.pose_t(T_lr)
    return lie.so3_hat(t) @ R


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def sampson_dist_sq(E, x_l, x_r):
    """Squared Sampson distance (normalized coords) of correspondences under
    E (x_l^T E x_r = 0). x_l/x_r: (..., N, 2) normalized image coords."""
    hl = _homog(x_l)
    hr = _homog(x_r)
    Ex_r = torch.einsum("...ij,...nj->...ni", E, hr)
    Etx_l = torch.einsum("...ji,...nj->...ni", E, hl)
    num = torch.einsum("...ni,...ni->...n", hl, Ex_r) ** 2
    den = (Ex_r[..., 0] ** 2 + Ex_r[..., 1] ** 2
           + Etx_l[..., 0] ** 2 + Etx_l[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def eight_point(x_l, x_r):
    """Essential matrix from ≥8 normalized correspondences (batched).

    x_l, x_r: (..., M, 2). Returns E (..., 3, 3) with singular values
    projected to (σ, σ, 0). The null vector comes from a complete QR of Aᵀ
    (M = 8) or the smallest eigenvector of AᵀA (M > 8), as in the JAX
    version; AᵀA is formed in full f32 (TF32 is off, see ``device.py``).
    """
    hl = _homog(x_l)
    hr = _homog(x_r)
    A = (hl[..., :, :, None] * hr[..., :, None, :]).reshape(
        x_l.shape[:-1] + (9,))
    if A.shape[-2] == 8:
        q, _ = torch.linalg.qr(A.transpose(-2, -1), mode="complete")
        e = q[..., :, 8]
    else:
        AtA = A.transpose(-2, -1) @ A
        _, vecs = torch.linalg.eigh(AtA)
        e = vecs[..., :, 0]
    E = e.reshape(e.shape[:-1] + (3, 3))
    EtE = E.transpose(-2, -1) @ E
    lam, V = torch.linalg.eigh(EtE)
    s = torch.sqrt(torch.clamp(lam, min=1e-20))
    sigma = 0.5 * (s[..., 2] + s[..., 1])
    v2 = V[..., :, 2]
    v1 = V[..., :, 1]
    outer = (v2[..., :, None] * v2[..., None, :] / s[..., 2, None, None]
             + v1[..., :, None] * v1[..., None, :] / s[..., 1, None, None])
    return sigma[..., None, None] * (E @ outer)


# --------------------------------------------------------------------- #
# 5-point (Nister) — batched, eigendecomposition-free
# --------------------------------------------------------------------- #
# Monomial bases over (x, y, z):
#   deg-1: [x, y, z, 1]
#   deg-2: [x2, xy, y2, xz, yz, z2, x, y, z, 1]
#   deg-3 in Nister column order — first 10 are the Gauss-Jordan pivots:
#     [x3, y3, x2y, xy2, x2z, x2, y2z, y2, xyz, xy |
#      xz2, xz, x, yz2, yz, y, z3, z2, z, 1]
_E1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_E2 = [(2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1),
       (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_E3 = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
       (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
       (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
       (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]


def _mul_table(ea, eb, ec):
    idx = {e: i for i, e in enumerate(ec)}
    T = _np.zeros((len(ea), len(eb), len(ec)), _np.float32)
    for i, a in enumerate(ea):
        for j, b in enumerate(eb):
            T[i, j, idx[(a[0] + b[0], a[1] + b[1], a[2] + b[2])]] = 1.0
    return T


@functools.lru_cache(maxsize=None)
def _conv_table(la, lb, out_len):
    T = _np.zeros((la, lb, out_len), _np.float32)
    for i in range(la):
        for j in range(lb):
            if i + j < out_len:
                T[i, j, i + j] = 1.0
    return T


_T112 = _mul_table(_E1, _E1, _E2)   # deg1 * deg1 -> deg2
_T213 = _mul_table(_E2, _E1, _E3)   # deg2 * deg1 -> deg3


_TABLES = {}


def _tab(T, ref):
    """``T`` (one of this module's constant tables) on ``ref``'s device and
    dtype, uploaded once per (table, device, dtype): an upload per call
    would synchronize the stream. The cache keeps ``T`` alive, so its id
    is not reused while cached."""
    key = (id(T), ref.device, ref.dtype)
    hit = _TABLES.get(key)
    if hit is None:
        hit = _TABLES[key] = (T, torch.as_tensor(T, dtype=ref.dtype,
                                                 device=ref.device))
    return hit[1]


def _pmul(a, b, T):
    return torch.einsum("...i,...j,ijk->...k", a, b, _tab(T, a))


def _conv(a, b, out_len: int):
    """Polynomial product of lowest-first coefficient vectors (batched over
    leading dims), padded or truncated to out_len."""
    return _pmul(a, b, _conv_table(a.shape[-1], b.shape[-1], out_len))


def _nister_constraints(basis):
    """(..., 10, 20) coefficient matrix of the 10 cubic constraints.

    basis: (..., 4, 3, 3) null-space Es [X, Y, Z, W]; E = x·X + y·Y + z·Z + W.
    """
    Ep = basis.movedim(-3, -1)                      # (..., 3, 3, 4)

    def p11(a, b):
        return _pmul(a, b, _T112)

    def p21(a, b):
        return _pmul(a, b, _T213)

    def minor2(i0, i1, j0, j1):
        return (p11(Ep[..., i0, j0, :], Ep[..., i1, j1, :])
                - p11(Ep[..., i0, j1, :], Ep[..., i1, j0, :]))

    det = (p21(minor2(1, 2, 1, 2), Ep[..., 0, 0, :])
           - p21(minor2(1, 2, 0, 2), Ep[..., 0, 1, :])
           + p21(minor2(1, 2, 0, 1), Ep[..., 0, 2, :]))

    C = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for k in range(3):
            acc = torch.zeros(basis.shape[:-3] + (10,), dtype=basis.dtype,
                              device=basis.device)
            for m in range(3):
                acc = acc + p11(Ep[..., i, m, :], Ep[..., k, m, :])
            C[i][k] = acc
    tr = C[0][0] + C[1][1] + C[2][2]
    rows = [det]
    for i in range(3):
        for j in range(3):
            acc = torch.zeros(basis.shape[:-3] + (20,), dtype=basis.dtype,
                              device=basis.device)
            for k in range(3):
                acc = acc + 2.0 * p21(C[i][k], Ep[..., k, j, :])
            acc = acc - p21(tr, Ep[..., i, j, :])
            rows.append(acc)
    return torch.stack(rows, dim=-2)


def _nister_detB(P):
    """Reduced rows → 3×3 polynomial matrix B(z) → det coefficients.

    P: (..., 10, 10) trailing block of the reduced constraint matrix.
    Returns (detB (..., 11) lowest-first, B: 3x3 nested list of polys).
    """
    zero = torch.zeros_like(P[..., 0, :1])

    def row_polys(i):
        p = torch.cat([P[..., i, 2:3], P[..., i, 1:2], P[..., i, 0:1], zero],
                      dim=-1)
        q = torch.cat([P[..., i, 5:6], P[..., i, 4:5], P[..., i, 3:4], zero],
                      dim=-1)
        r = torch.cat([P[..., i, 9:10], P[..., i, 8:9], P[..., i, 7:8],
                       P[..., i, 6:7], zero], dim=-1)
        return p, q, r

    def zshift(c):
        return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)

    pairs = [(4, 5), (6, 7), (8, 9)]
    B = []
    for a, b in pairs:
        pa, qa, ra = row_polys(a)
        pb, qb, rb = row_polys(b)
        B.append((pa - zshift(pb), qa - zshift(qb), ra - zshift(rb)))

    def det2(r0, r1, c0, c1):
        return (_conv(B[r0][c0], B[r1][c1], 11)
                - _conv(B[r0][c1], B[r1][c0], 11))

    detB = (_conv(B[0][0], det2(1, 2, 1, 2), 11)
            - _conv(B[0][1], det2(1, 2, 0, 2), 11)
            + _conv(B[0][2], det2(1, 2, 0, 1), 11))
    return detB, B


_N_GRID = 512
_MAX_ROOTS = 10
_BISECT_ITERS = 60


def _poly_tan_eval(c, theta):
    """Evaluate cos¹⁰θ · p(tan θ) for lowest-first coeffs c (..., 11) at
    theta (..., G) — bounded over the whole real line."""
    s, co = torch.sin(theta), torch.cos(theta)
    ones = torch.ones_like(s)
    sk = torch.cumprod(torch.stack([ones] + [s] * 10, dim=0), dim=0)
    ck = torch.cumprod(torch.stack([ones] + [co] * 10, dim=0),
                       dim=0).flip(0)
    return torch.einsum("...k,k...g->...g", c, sk * ck)


def _real_roots_deg10(c):
    """Real roots of degree-≤10 polynomials (lowest-first coeffs (..., 11)).

    Sign-change bracketing on a tan-spaced grid + fixed-count bisection in
    θ-space. Returns (roots (..., 10), valid (..., 10)); non-roots are NaN.
    """
    eps = 1e-4
    theta = torch.linspace(-torch.pi / 2 + eps, torch.pi / 2 - eps, _N_GRID,
                           dtype=c.dtype, device=c.device)
    v = _poly_tan_eval(c, theta.expand(c.shape[:-1] + (_N_GRID,)))
    sgn = torch.sign(v)
    change = (sgn[..., :-1] * sgn[..., 1:]) < 0
    order = torch.argsort((~change).to(torch.uint8), dim=-1,
                          stable=True)[..., :_MAX_ROOTS]
    valid = torch.gather(change, -1, order)

    lo = theta[order]
    hi = theta[order + 1]
    flo = _poly_tan_eval(c, lo)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        fmid = _poly_tan_eval(c, mid)
        take_lo = (flo * fmid) > 0
        lo = torch.where(take_lo, mid, lo)
        flo = torch.where(take_lo, fmid, flo)
        hi = torch.where(take_lo, hi, mid)
    roots = torch.tan(0.5 * (lo + hi))
    valid = valid & (roots.abs() < 1e6)
    return torch.where(valid, roots, torch.full_like(roots, float("nan"))), \
        valid


def _polyval(c, z):
    """Lowest-first coefficients c (..., L) at z (..., K) by Horner."""
    out = torch.zeros_like(z)
    for k in range(c.shape[-1] - 1, -1, -1):
        out = out * z + c[..., k:k + 1]
    return out


def five_point(x_l, x_r):
    """Nister 5-point on a batch of samples: (..., 5, 2)+(..., 5, 2)
    normalized coords → (Es (..., 10, 3, 3), valid (..., 10)); invalid
    slots are NaN."""
    hl = _homog(x_l)
    hr = _homog(x_r)
    A = (hl[..., :, :, None] * hr[..., :, None, :]).reshape(
        x_l.shape[:-2] + (5, 9))
    q, _ = torch.linalg.qr(A.transpose(-2, -1), mode="complete")
    basis = q[..., :, 5:9].transpose(-2, -1).reshape(
        x_l.shape[:-2] + (4, 3, 3))

    M = _nister_constraints(basis)
    P, _ = torch.linalg.solve_ex(M[..., :, :10], M[..., :, 10:])
    detB, B = _nister_detB(P)
    z, valid = _real_roots_deg10(detB)

    b = [[_polyval(B[i][j], z) for j in range(3)] for i in range(2)]
    den = b[0][0] * b[1][1] - b[0][1] * b[1][0]
    x = (-b[0][2] * b[1][1] + b[0][1] * b[1][2]) / den
    y = (-b[0][0] * b[1][2] + b[0][2] * b[1][0]) / den

    bs = basis[..., None, :, :, :]                   # (..., 1, 4, 3, 3)
    Es = (x[..., None, None] * bs[..., 0, :, :]
          + y[..., None, None] * bs[..., 1, :, :]
          + z[..., None, None] * bs[..., 2, :, :] + bs[..., 3, :, :])
    norm = torch.linalg.norm(Es.flatten(-2), dim=-1)
    Es = Es / torch.clamp(norm, min=1e-12)[..., None, None]
    Es = torch.where(valid[..., None, None], Es,
                     torch.full_like(Es, float("nan")))
    return Es, valid


def decompose_essential(E, x_l, x_r, valid_mask):
    """E → relative pose T_lr (right-in-left) by cheirality voting over the
    4 (R, t) candidates (Hartley–Zisserman); unit-norm translation."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]

    bl = _homog(x_l)
    bl = bl / torch.linalg.norm(bl, dim=-1, keepdim=True)
    br = _homog(x_r)
    br = br / torch.linalg.norm(br, dim=-1, keepdim=True)

    scores, poses = [], []
    for R_, t_ in ((Ra, t), (Ra, -t), (Rb, t), (Rb, -t)):
        T_lr = lie.make_pose(lie.matrix_to_quat(R_), t_)
        pts_l = triangulate_midpoint(T_lr[None, :], bl, br)
        pts_r = lie.pose_apply(lie.pose_inverse(T_lr)[None, :], pts_l)
        ok = (pts_l[..., 2] > 0) & (pts_r[..., 2] > 0) & valid_mask
        scores.append(ok.sum())
        poses.append(T_lr)
    scores = torch.stack(scores)
    poses = torch.stack(poses)
    best = torch.argmax(scores)
    return poses[best], scores[best]


def draw_samples(gen: torch.Generator, valid_mask, n: int, k: int):
    """(n, k) row indices drawn with replacement, uniformly over the valid
    rows (the JAX version's categorical over log(valid + 1e-9))."""
    probs = valid_mask.to(torch.float32) + 1e-9
    return torch.multinomial(probs, n * k, replacement=True,
                             generator=gen).reshape(n, k)


def essential_ransac(gen: Optional[torch.Generator], x_l, x_r, valid_mask,
                     focal, err_th_px, n_iters: int = 100,
                     idx5=None, idx8=None):
    """Batched essential RANSAC: Nister 5-point minimal samples plus an
    8-point hypothesis pool (quarter budget), all Sampson-scored together.

    Args:
      gen: generator for the samples (unused where ``idx5``/``idx8`` are
        given: (n_iters, 5) and (max(n_iters // 4, 4), 8) row indices).
      x_l, x_r: (N, 2) normalized coords; valid_mask: (N,) bool.
      focal: focal length (px) converting err_th to normalized units.

    Returns:
      (E (3,3), inlier_mask (N,), n_inliers)
    """
    n8 = max(n_iters // 4, 4)
    if idx5 is None:
        idx5 = draw_samples(gen, valid_mask, n_iters, 5)
    if idx8 is None:
        idx8 = draw_samples(gen, valid_mask, n8, 8)
    ok5 = valid_mask[idx5].all(dim=-1)
    E5, v5 = five_point(x_l[idx5], x_r[idx5])
    E5 = E5.reshape(-1, 3, 3)
    ok5 = (ok5[:, None] & v5).reshape(-1)

    ok8 = valid_mask[idx8].all(dim=-1)
    E8 = eight_point(x_l[idx8], x_r[idx8])

    E = torch.cat([E5, E8], dim=0)
    cand_ok = torch.cat([ok5, ok8], dim=0)
    finite = torch.isfinite(E).all(-1).all(-1)
    cand_ok = cand_ok & finite
    E = torch.where(finite[:, None, None], E, torch.zeros_like(E))

    th = (err_th_px / focal) ** 2
    d2 = sampson_dist_sq(E, x_l[None], x_r[None])
    inl = (d2 < th) & valid_mask[None, :]
    quality = torch.where(inl, 1.0 - d2 / th, torch.zeros_like(d2)).sum(-1)
    quality = torch.where(cand_ok, quality, torch.full_like(quality, -1.0))
    # a one-element index tensor: a 0-d one would be read on the host
    best = torch.argmax(quality).reshape(1)
    inl_best = inl[best][0]
    return E[best][0], inl_best, inl_best.sum()


def relative_pose_ransac(gen, x_l, x_r, valid_mask, focal, err_th_px,
                         n_iters: int = 100, idx5=None, idx8=None):
    """Essential RANSAC + cheirality decomposition → (T_lr, inliers, n);
    unit-norm translation. ``idx5``/``idx8``: as in
    :func:`essential_ransac`."""
    E, inl, n = essential_ransac(gen, x_l, x_r, valid_mask, focal,
                                 err_th_px, n_iters, idx5=idx5, idx8=idx8)
    T_lr, _ = decompose_essential(E, x_l, x_r, inl)
    return T_lr, inl, n
