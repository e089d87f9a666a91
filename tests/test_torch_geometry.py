"""Parity: ov2slam_torch geometry/ and solvers/pnp_refine.py against
ov2slam_tpu.

Closed-form pieces run in f64 on both sides and agree to round-off (1e-8).
RANSAC is compared on identical injected samples: the JAX side is composed
from its own five_point / eight_point / sampson_dist_sq / p3p_kneip on the
same indices, so the winning inlier sets must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch.geometry import essential as te
from ov2slam_torch.geometry import pnp as tp
from ov2slam_torch.geometry import poly as tpoly
from ov2slam_torch.geometry import triangulation as ttri
from ov2slam_torch.solvers import pnp_refine as tpr
from ov2slam_tpu.geometry import essential as je
from ov2slam_tpu.geometry import pnp as jp
from ov2slam_tpu.geometry import poly as jpoly
from ov2slam_tpu.geometry import triangulation as jtri
from ov2slam_tpu.solvers import pnp_refine as jpr
from ov2slam_tpu.utils import lie as jlie

torch.set_num_threads(1)


def T(x):
    return torch.as_tensor(np.array(x))


def scene(rng, n=100, noise=0.0):
    pts = rng.uniform([-2, -2, 4], [2, 2, 12], size=(n, 3))
    T_lr = np.concatenate([np.array(jlie.so3_exp(jnp.asarray(
        [0.05, -0.1, 0.03]))), [0.3, 0.05, -0.1]])
    M_rl = np.array(jlie.pose_to_matrix(jlie.pose_inverse(jnp.asarray(T_lr))))
    pts_r = (M_rl[:3, :3] @ pts.T).T + M_rl[:3, 3]
    xl = pts[:, :2] / pts[:, 2:]
    xr = pts_r[:, :2] / pts_r[:, 2:] + rng.normal(0, noise, (n, 2))
    return pts, pts_r, T_lr, xl, xr


def _match_up_to_sign(A, B, tol):
    for a in A:
        d = min(min(np.abs(a - b).max(), np.abs(a + b).max()) for b in B)
        assert d < tol, d


def test_poly_roots_match(rng):
    c = rng.normal(size=(64, 4))
    for a, b in zip(jpoly.solve_quartic_real(*[jnp.asarray(c[:, i])
                                               for i in range(4)]),
                    tpoly.solve_quartic_real(*[T(c[:, i])
                                               for i in range(4)])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-8)
    np.testing.assert_allclose(
        tpoly.solve_cubic_real(T(c[:, 0]), T(c[:, 1]), T(c[:, 2])).numpy(),
        np.asarray(jpoly.solve_cubic_real(*[jnp.asarray(c[:, i])
                                            for i in range(3)])), atol=1e-8)


def test_triangulation_matches(rng):
    pts, pts_r, T_lr, _, _ = scene(rng)
    bl = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    br = pts_r / np.linalg.norm(pts_r, axis=-1, keepdims=True)
    Tb = np.broadcast_to(T_lr, (len(pts), 7))
    for fn in ("triangulate_midpoint", "triangulate_dlt"):
        a = np.asarray(getattr(jtri, fn)(jnp.asarray(Tb), jnp.asarray(bl),
                                         jnp.asarray(br)))
        b = getattr(ttri, fn)(T(Tb), T(bl), T(br)).numpy()
        np.testing.assert_allclose(b, a, atol=1e-8)
        np.testing.assert_allclose(b, pts, atol=1e-6)
    a = np.asarray(jtri.reprojection_checks(jnp.asarray(T_lr), jnp.asarray(bl),
                                            jnp.asarray(br), jnp.asarray(pts),
                                            450.0, 2.0))
    b = ttri.reprojection_checks(T(T_lr), T(bl), T(br), T(pts), 450.0,
                                 2.0).numpy()
    np.testing.assert_array_equal(a, b)


def test_five_eight_point_and_decompose(rng):
    pts, _, T_lr, xl, xr = scene(rng, n=40)
    # 5-point: the same set of up-to-10 solutions (each up to sign)
    jE, jv = jax.vmap(je.five_point)(jnp.asarray(xl[None, :5]),
                                     jnp.asarray(xr[None, :5]))
    tE, tv = te.five_point(T(xl[None, :5]), T(xr[None, :5]))
    jE, jv = np.asarray(jE)[0], np.asarray(jv)[0]
    tE, tv = tE.numpy()[0], tv.numpy()[0]
    assert jv.sum() == tv.sum() > 0
    _match_up_to_sign(jE[jv], tE[tv], 1e-6)
    E_true = np.array(je.essential_from_pose(jnp.asarray(T_lr)))
    E_true /= np.linalg.norm(E_true)
    _match_up_to_sign([E_true], tE[tv], 1e-6)
    # 8-point, minimal (QR) and overdetermined (eigh)
    for n in (8, 40):
        a = np.asarray(je.eight_point(jnp.asarray(xl[:n]), jnp.asarray(xr[:n])))
        b = te.eight_point(T(xl[:n]), T(xr[:n])).numpy()
        _match_up_to_sign([a], [b], 1e-6)
    # decomposition picks the same pose
    valid = np.ones(len(xl), bool)
    a, sa = je.decompose_essential(jnp.asarray(E_true), jnp.asarray(xl),
                                   jnp.asarray(xr), jnp.asarray(valid))
    b, sb = te.decompose_essential(T(E_true), T(xl), T(xr), T(valid))
    assert int(sa) == int(sb) == len(xl)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-8)
    np.testing.assert_allclose(b.numpy()[4:],
                               T_lr[4:] / np.linalg.norm(T_lr[4:]), atol=1e-6)


def test_essential_ransac_same_samples(rng):
    _, _, _, xl, xr = scene(rng, n=120, noise=1e-3)
    xr[:20] += rng.normal(0, 0.05, (20, 2))            # outliers
    valid = np.ones(120, bool)
    valid[-8:] = False
    n_it = 40
    idx5 = rng.choice(np.nonzero(valid)[0], (n_it, 5))
    idx8 = rng.choice(np.nonzero(valid)[0], (max(n_it // 4, 4), 8))
    focal, err = 450.0, 3.0
    # JAX side composed from its own pieces on the same samples
    jx, jy, jvm = jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(valid)
    E5, v5 = jax.vmap(je.five_point)(jx[idx5], jy[idx5])
    E = jnp.concatenate([E5.reshape(-1, 3, 3), je.eight_point(jx[idx8],
                                                              jy[idx8])])
    ok = jnp.concatenate([v5.reshape(-1), jnp.ones(idx8.shape[0], bool)])
    finite = jnp.isfinite(E).all((-2, -1))
    ok = ok & finite
    E = jnp.where(finite[:, None, None], E, 0.0)
    th = (err / focal) ** 2
    d2 = je.sampson_dist_sq(E, jx[None], jy[None])
    inl = (d2 < th) & jvm[None]
    q = jnp.where(ok, jnp.where(inl, 1.0 - d2 / th, 0.0).sum(-1), -1.0)
    j_inl = np.asarray(inl[jnp.argmax(q)])
    _, t_inl, t_n = te.essential_ransac(
        None, T(xl), T(xr), T(valid), focal, err, n_iters=n_it,
        idx5=T(idx5), idx8=T(idx8))
    assert int(t_n) == j_inl.sum() > 80
    np.testing.assert_array_equal(t_inl.numpy(), j_inl)


def test_p3p_kneip_and_ransac(rng):
    R = np.array(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05])))
    T_wc = np.concatenate([R, [0.3, -0.1, 0.2]])
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], size=(60, 3))
    pc = np.array(jlie.pose_apply(jlie.pose_inverse(jnp.asarray(T_wc)),
                                  jnp.asarray(pts)))
    bv = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    px = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                   pc[:, 1] / pc[:, 2] * fy + cy], -1)
    px[:10] += rng.uniform(-40, 40, (10, 2))           # outliers
    a, av = jp.p3p_kneip(jnp.asarray(bv[None, :3]), jnp.asarray(pts[None, :3]))
    b, bvld = tp.p3p_kneip(T(bv[None, :3]), T(pts[None, :3]))
    np.testing.assert_array_equal(bvld.numpy(), np.asarray(av))
    m = np.asarray(av)
    np.testing.assert_allclose(b.numpy()[m], np.asarray(a)[m], atol=1e-7)
    valid = np.ones(60, bool)
    idx = rng.integers(0, 60, (50, 3))
    jpose, jv = jp.p3p_kneip(jnp.asarray(bv)[idx], jnp.asarray(pts)[idx])
    sok = (idx[:, 0] != idx[:, 1]) & (idx[:, 0] != idx[:, 2]) & (
        idx[:, 1] != idx[:, 2])
    flat_v = (np.asarray(jv) & sok[:, None]).reshape(-1)
    errs = jp.reproj_errors_px(jnp.asarray(jpose).reshape(-1, 7),
                               jnp.asarray(pts), jnp.asarray(px),
                               fx, fy, cx, cy)
    inl = np.asarray(errs < 2.0)
    j_n = np.where(flat_v, inl.sum(-1), -1).max()
    _, t_inl, t_n = tp.p3p_ransac(None, T(bv), T(pts), T(px), T(valid),
                                  fx, fy, cx, cy, 2.0, n_iters=50, idx=T(idx))
    assert int(t_n) == int(j_n) >= 45


@pytest.mark.parametrize("robust", [5.9915, 0.0])
def test_pnp_refine_matches(rng, robust):
    # f32 solve on both sides (as the runtime): 1e-4 on pose components
    R = np.array(jlie.so3_exp(jnp.asarray([0.05, 0.1, -0.02])))
    T_wc = np.concatenate([R, [0.2, 0.1, -0.3]]).astype(np.float32)
    pts = rng.uniform([-2, -2, 3], [2, 2, 9], size=(80, 3)).astype(np.float32)
    pc = np.array(jlie.pose_apply(jlie.pose_inverse(jnp.asarray(T_wc)),
                                  jnp.asarray(pts)))
    px = (np.stack([pc[:, 0] / pc[:, 2], pc[:, 1] / pc[:, 2]], -1) * 400.0
          + 300.0 + rng.normal(0, 0.5, (80, 2))).astype(np.float32)
    px[:6] += 30.0
    T0 = np.array(jlie.pose_left_update(jnp.asarray(T_wc), jnp.asarray(
        [0.02, -0.01, 0.03, 0.01, 0.0, -0.01], jnp.float32)))
    valid = np.ones(80, bool)
    valid[-4:] = False
    a = jpr.pnp_refine(jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(px),
                       jnp.asarray(valid), 400.0, 400.0, 300.0, 300.0,
                       robust_th=robust)
    b = tpr.pnp_refine(T(T0), T(pts), T(px), T(valid), 400.0, 400.0, 300.0,
                       300.0, robust_th=robust)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), atol=1e-4)
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
    a2 = jpr.pnp_refine_two_pass(jnp.asarray(T0), jnp.asarray(pts),
                                 jnp.asarray(px), jnp.asarray(valid),
                                 400.0, 400.0, 300.0, 300.0)
    b2 = tpr.pnp_refine_two_pass(T(T0), T(pts), T(px), T(valid), 400.0,
                                 400.0, 300.0, 300.0)
    np.testing.assert_allclose(b2[0].numpy(), np.asarray(a2[0]), atol=1e-4)
    np.testing.assert_allclose(b2[0].numpy()[4:], T_wc[4:], atol=0.02)
