"""Parity: ov2slam_torch solvers/ba_invdepth.py and solvers/posegraph.py
against ov2slam_tpu, plus the port's analytic Jacobians against autograd.

Problems come from tests/test_solvers.py::synth_ba_problem (numpy, seeded).
Both sides solve in f32; the port accumulates with sorted segmented sums
(``solvers/segment.py``) where the JAX package uses one-hot GEMMs, so sums
differ in order: one LM step is
compared at 1e-4 (poses) / 1e-3 relative (inverse depths), full solves at
1e-3, and inlier masks exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ov2slam_torch.solvers.ba_invdepth as tbi
import ov2slam_tpu.solvers.ba_invdepth as jbi
from ov2slam_torch.solvers import posegraph as tpg
from ov2slam_torch.solvers.ba import BAParams as TParams
from ov2slam_torch.solvers.segment import SegmentSum
from ov2slam_torch.utils import lie as tlie
from ov2slam_tpu.solvers import posegraph as jpg
from ov2slam_tpu.utils import lie as jlie
from ov2slam_tpu.utils import lie_np
from tests.test_ba_invdepth import _invdepth_state
from tests.test_solvers import CX, CY, FX, FY, perturb, synth_ba_problem

torch.set_num_threads(1)


def T(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t.to(dtype) if dtype is not None else t


def tparams(obs, dtype=torch.float32):
    return TParams(fx=torch.tensor(FX, dtype=dtype),
                   fy=torch.tensor(FY, dtype=dtype),
                   cx=torch.tensor(CX, dtype=dtype),
                   cy=torch.tensor(CY, dtype=dtype),
                   T_rl=T(obs["params"].T_rl, dtype),
                   intr=(FX, FY, CX, CY))


@pytest.fixture
def problem(rng):
    gt, lms, obs = synth_ba_problem(rng, n_kf=6, n_lm=80, stereo=True,
                                    noise_px=0.3)
    poses0, lms0, fixed = perturb(rng, gt, lms, fix_first=2)
    rho, anchor, ray = _invdepth_state(poses0, lms, obs, lm_pos_override=lms0)
    return gt, poses0, fixed, rho, anchor, ray, obs


@pytest.mark.parametrize("shape", [(), (6,), (6, 6)])
def test_segment_sum_matches_index_add(rng, shape):
    """Equal to ``index_add_`` up to f32 rounding of the order (1e-5),
    bins with no rows are 0, and two calls agree bit for bit."""
    n, rows = 9, 200
    idx = rng.integers(0, n - 2, rows)          # the last two bins stay empty
    v = rng.standard_normal((rows,) + shape).astype(np.float32)
    seg = SegmentSum(T(idx).long(), n)
    got = seg(T(v))
    ref = torch.zeros((n,) + shape).index_add_(0, T(idx).long(), T(v))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not got[n - 2:].any()
    assert torch.equal(got, seg(T(v)))
    empty = SegmentSum(torch.zeros(0, dtype=torch.long), n)
    assert torch.equal(empty(torch.zeros((0,) + shape)),
                       torch.zeros((n,) + shape))


def _obs_args(obs, torch_side):
    keys = ("obs_kf", "obs_lm", "obs_px", "obs_cam")
    if torch_side:
        return [T(obs[k]).long() if k in ("obs_kf", "obs_lm") else T(obs[k])
                for k in keys]
    return [obs[k] for k in keys]


def test_residuals_and_jacobians_match(problem):
    _, poses0, _, rho, anchor, ray, obs = problem
    jr = jbi._residuals_jacobians_inv(
        jlie.pose_inverse(jnp.asarray(poses0)), jnp.asarray(rho),
        jnp.asarray(anchor), jnp.asarray(ray), *_obs_args(obs, False),
        obs["params"])
    tr = tbi._residuals_jacobians_inv(
        tlie.pose_inverse(T(poses0)), T(rho), T(anchor).long(), T(ray),
        *_obs_args(obs, True), tparams(obs))
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-3)


def test_analytic_jacobians_vs_autograd(problem):
    # f64 so the comparison sees the Jacobian formulas, not f32 round-off
    _, poses0, _, rho, anchor, ray, obs = problem
    f64 = torch.float64
    prm = tparams(obs, f64)
    T_cw = tlie.pose_inverse(T(poses0, f64))
    args = (T(anchor).long(), T(ray, f64), *_obs_args(obs, True)[:2],
            T(obs["obs_px"], f64), T(obs["obs_cam"]))
    r0, J_obs, J_anch, J_rho, _ = tbi._residuals_jacobians_inv(
        T_cw, T(rho, f64), args[0], args[1], *args[2:], prm)
    Kw, Lw = len(poses0), len(rho)

    def res(dxi, drho):
        return tbi._residuals_jacobians_inv(
            tlie.pose_left_update(T_cw, dxi), T(rho, f64) + drho, args[0],
            args[1], *args[2:], prm)[0]

    Jp, Jr = torch.autograd.functional.jacobian(
        res, (torch.zeros(Kw, 6, dtype=f64), torch.zeros(Lw, dtype=f64)))
    O = r0.shape[0]
    okf, olm = np.array(obs["obs_kf"]), np.array(obs["obs_lm"])
    Jp_ana = np.zeros((O, 2, Kw, 6))
    Jr_ana = np.zeros((O, 2, Lw))
    for o in range(O):
        Jp_ana[o, :, okf[o]] += J_obs[o].numpy()
        Jp_ana[o, :, anchor[olm[o]]] += J_anch[o].numpy()
        Jr_ana[o, :, olm[o]] = J_rho[o].numpy()
    np.testing.assert_allclose(Jp.numpy(), Jp_ana, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(Jr.numpy(), Jr_ana, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("path", ["dense", "cg"])
def test_one_lm_iteration_matches(problem, monkeypatch, path):
    """One damped Schur step from the same state; ``cg`` lowers the dense
    threshold on both sides so the matrix-free PCG branch runs."""
    if path == "cg":
        monkeypatch.setattr(jbi, "DENSE_SCHUR_MAX_KFS", 2)
        monkeypatch.setattr(tbi, "DENSE_SCHUR_MAX_KFS", 2)
    _, poses0, fixed, rho, anchor, ray, obs = problem
    w = np.ones(len(np.array(obs["obs_kf"])), np.float32)
    free = (~fixed).astype(np.float32)
    jT, jrho = jbi._solve_iteration_inv(
        jlie.pose_inverse(jnp.asarray(poses0)), jnp.asarray(rho),
        jnp.float32(1e-3), jnp.asarray(anchor), jnp.asarray(ray),
        *_obs_args(obs, False), jnp.asarray(w), jnp.asarray(free),
        obs["params"])
    tT, trho = tbi._solve_iteration_inv(
        tlie.pose_inverse(T(poses0)), T(rho), torch.tensor(1e-3),
        T(anchor).long(), T(ray), *_obs_args(obs, True), T(w), T(free),
        tparams(obs))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), rtol=1e-3,
                               atol=1e-5)


def test_two_pass_solve_matches_and_converges(problem, rng):
    gt, poses0, fixed, rho, anchor, ray, obs = problem
    obs_px = np.array(obs["obs_px"])
    bad = rng.choice(len(obs_px), len(obs_px) // 20, replace=False)
    obs_px[bad] += rng.uniform(30, 80, (len(bad), 2)).astype(np.float32)
    valid = np.ones(len(obs_px), bool)
    j = jbi.ba_solve_invdepth_two_pass(
        jnp.asarray(poses0), jnp.asarray(fixed), jnp.asarray(rho),
        jnp.asarray(anchor), jnp.asarray(ray), obs["obs_kf"], obs["obs_lm"],
        jnp.asarray(obs_px), obs["obs_cam"], jnp.asarray(valid),
        obs["params"])
    t = tbi.ba_solve_invdepth_two_pass(
        T(poses0), T(fixed), T(rho), T(anchor), T(ray), T(obs["obs_kf"]),
        T(obs["obs_lm"]), T(obs_px), T(obs["obs_cam"]), T(valid),
        tparams(obs))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-3)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    assert not t[3].numpy()[bad].any()
    rot, tr = lie_np.pose_distance(t[0].numpy().astype(np.float64),
                                   gt.astype(np.float64))
    assert rot.max() < 2e-3 and tr.max() < 1e-2


def _loop(n=24, r=3.0):
    gt = []
    for i in range(n):
        a = 2 * np.pi * i / n
        gt.append(np.concatenate([lie_np.so3_exp(np.array([0.0, a, 0.0])),
                                  [r * np.sin(a), 0.0, r * (1 - np.cos(a))]]))
    gt = np.stack(gt).astype(np.float32)
    drift = np.concatenate([lie_np.so3_exp([0.0, 0.004, 0.0]),
                            [0.004, 0.0, 0.002]])
    est = [gt[0]]
    for i in range(1, n):
        rel = lie_np.pose_compose(lie_np.pose_relative(gt[i - 1], gt[i]),
                                  drift)
        est.append(lie_np.pose_compose(est[-1], rel))
    return gt, np.stack(est).astype(np.float32)


def test_pose_graph_solve_matches():
    # f32 damped GN on both sides; Jacobians by autograd (port) vs jacfwd
    # (JAX): 1e-4 on poses. Padding rows/edges as the loop closer pads.
    gt, est = _loop()
    n = len(gt)
    ei, ej, eT, ew = tpg.build_chain_edges(
        est, list(range(n)), loop_i=0, loop_j=n - 1,
        T_loop=lie_np.pose_relative(gt[0], gt[n - 1]), loop_weight=20.0)
    je = jpg.build_chain_edges(
        est, list(range(n)), loop_i=0, loop_j=n - 1,
        T_loop=lie_np.pose_relative(gt[0], gt[n - 1]), loop_weight=20.0)
    for a, b in zip(je, (ei, ej, eT, ew)):
        np.testing.assert_array_equal(a, b)
    M, E = 32, 40
    P = np.zeros((M, 7), np.float32)
    P[:, 0] = 1.0
    P[:n] = est
    fx = np.ones(M, bool)
    fx[1:n] = False
    pi = np.full(E, -1, np.int32)
    pj = np.full(E, -1, np.int32)
    pT = np.zeros((E, 7), np.float32)
    pT[:, 0] = 1.0
    pw = np.zeros(E, np.float32)
    pi[:len(ei)], pj[:len(ei)], pT[:len(ei)], pw[:len(ei)] = ei, ej, eT, ew
    a, ca = jpg.pose_graph_solve(*[jnp.asarray(x) for x in
                                   (P, fx, pi, pj, pT, pw)], iters=10)
    b, cb = tpg.pose_graph_solve(*[T(x) for x in (P, fx, pi, pj, pT, pw)],
                                 iters=10)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    np.testing.assert_allclose(float(cb), float(ca), rtol=1e-3, atol=1e-6)
    assert np.isfinite(b.numpy()).all()
    end_before = np.linalg.norm(est[n - 1, 4:] - gt[n - 1, 4:])
    end_after = np.linalg.norm(b.numpy()[n - 1, 4:] - gt[n - 1, 4:])
    assert end_after < 0.5 * end_before


def test_loose_ba_seed3_lands_where_the_reference_does():
    """Slice A's loose BA after its loop closure, as the H100 built it for
    RANSAC seed 3 (``closure_stages.py --dump``): the JAX package's and the
    port's two-pass inverse-depth solves, with ``_solve_window``'s iteration
    counts, both move the window's second half ~0.27 m away from the truth
    (the far solution is the reference's own behaviour). Keyframe
    positions agree to 0.02 m (f32 solves whose sums differ in order, on a
    problem whose LM accept/reject path is sensitive to them)."""
    import os

    d = dict(np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "torch_loose_ba_seed3.npz")))
    fx, fy, cx, cy = (float(v) for v in d["intr"])
    args = [d[k] for k in ("kf_poses", "kf_fixed", "rho", "lm_anchor", "ray",
                           "obs_kf", "obs_lm", "obs_px", "obs_cam",
                           "obs_valid_inv")]
    kw = dict(robust_th=float(d["robust_th"]),
              iters_robust=int(d["iters_robust"]),
              iters_l2=int(d["iters_l2"]))
    jp = jbi.BAParams(fx=jnp.float32(fx), fy=jnp.float32(fy),
                      cx=jnp.float32(cx), cy=jnp.float32(cy),
                      T_rl=jnp.asarray(d["T_rl"]))
    tp = TParams(fx=torch.tensor(fx), fy=torch.tensor(fy),
                 cx=torch.tensor(cx), cy=torch.tensor(cy),
                 T_rl=T(d["T_rl"]), intr=(fx, fy, cx, cy))
    j = np.asarray(jbi.ba_solve_invdepth_two_pass(
        *[jnp.asarray(a) for a in args], jp, **kw)[0])
    t = tbi.ba_solve_invdepth_two_pass(*[T(a) for a in args], tp, **kw)[0]
    t = t.numpy()
    kf = d["kf_ids"] >= 0
    np.testing.assert_allclose(t[kf, 4:7], j[kf, 4:7], atol=0.02)
    err_j = np.linalg.norm(j[kf, 4:7] - d["gt_pos"][kf], axis=1)
    err_t = np.linalg.norm(t[kf, 4:7] - d["gt_pos"][kf], axis=1)
    before = np.linalg.norm(d["kf_poses"][kf, 4:7] - d["gt_pos"][kf], axis=1)
    assert before.max() < 0.11
    assert err_j[-5:].min() > 0.2 and err_t[-5:].min() > 0.2
    # the two gauge-fixed keyframes do not move (the recentring round
    # trip in f32 aside)
    np.testing.assert_allclose(t[kf][:2], d["kf_poses"][kf][:2], atol=1e-6)
