"""Parity: the port's packed keyframe interface against ov2slam_tpu.

The packers (``models/mapper_step.pack_stereo_state``,
``pack_temporal_state``, ``solvers/ba_invdepth.pack_ba_invdepth``) and
``loopclosure/index.bit_signature`` are numpy in both packages: equal, atol
0, ``out=`` included. The packed steps run f32 on both sides, at
test_torch_mapping.py's tolerances (188 px wide: disparities of 2-5 px make
the midpoint solve amplify round-off): triangulation masks agree on at
least 97% of rows, landmarks within rtol 5e-3 / atol 1e-3, right pixels
within 0.01 px, the temporal mask equal. ``ba_invdepth_packed`` against
the JAX one on the same vector at test_torch_ba.py's full-solve tolerances
(poses and points 1e-3, inlier masks equal), and bit for bit against the
port's unpacked two-pass solve. The mapper's packed steps upload nothing
inside (a CUDA graph capture refuses a host upload): checked here by
making every host-to-tensor constructor raise while they run. A manager's
graph state (each mapper's steps, each estimator's BA runners) is its own
and is freed with it.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from ov2slam_torch import bench as tbench
from ov2slam_torch.core.image import build_pyramid as t_pyr
from ov2slam_torch.geometry.essential import essential_from_pose as t_efp
from ov2slam_torch.loopclosure import index as tindex
from ov2slam_torch.models import mapper_step as tms
from ov2slam_torch.models.frontend_step import CalibArrays as TCalib
from ov2slam_torch.solvers import ba_invdepth as tbi
from ov2slam_tpu.core.image import build_pyramid as j_pyr
from ov2slam_tpu.geometry.essential import essential_from_pose as j_efp
from ov2slam_tpu.io.synthetic import generate_sequence
from ov2slam_tpu.loopclosure import index as jindex
from ov2slam_tpu.models import mapper_step as jms
from ov2slam_tpu.models.frontend_step import CalibArrays as JCalib
from ov2slam_tpu.ops.detect import detect_single_scale
from ov2slam_tpu.solvers import ba_invdepth as jbi
from ov2slam_tpu.utils import lie_np

torch.set_num_threads(1)


def T(x):
    return torch.as_tensor(np.array(x))


# --------------------------------------------------------------------------
# packers
# --------------------------------------------------------------------------

def _stereo_inputs(rng, n=50):
    return (rng.uniform(0, 200, (n, 2)).astype(np.float32),
            rng.normal(0, 3, (n, 3)),                   # f64, as the map's
            rng.random(n) < 0.8, rng.random(n) < 0.4,
            np.concatenate([lie_np.so3_exp(rng.normal(0, 0.3, 3)),
                            rng.normal(0, 1, 3)]))


@pytest.mark.parametrize("reuse", [False, True])
def test_pack_stereo_state_equals_jax(rng, reuse):
    args = _stereo_inputs(rng)
    want = jms.pack_stereo_state(*args)
    out = np.full_like(want, 7.0) if reuse else None
    if reuse:
        out[:-1, 6:] = 0.0          # columns 6-7 of the rows stay as given
        out[-1, 7] = 0.0
    got = tms.pack_stereo_state(*args, out=out)
    assert got.dtype == np.float32 and got.shape == (51, 8)
    assert (got is out) == reuse
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reuse", [False, True])
def test_pack_temporal_state_equals_jax(rng, reuse):
    n = 40
    args = (rng.uniform(0, 200, (n, 2)), rng.uniform(0, 200, (n, 2)),
            rng.normal(0, 1, (n, 7)), rng.normal(0, 1, (n, 7)),
            rng.random(n) < 0.5)
    want = jms.pack_temporal_state(*args)
    out = np.full_like(want, 3.0) if reuse else None
    got = tms.pack_temporal_state(*args, out=out)
    assert (got is out) == reuse
    np.testing.assert_array_equal(got, want)


def _ba_problem(n_kf=8, n_lm=120, seed=0):
    """The bench's problem as a BAProblem-like object and (rho, ray,
    obs_valid), with some observations masked out."""
    p = tbench.synth_ba_problem(n_kf, n_lm, seed=seed)
    valid = p["obs_valid"].copy()
    valid[::11] = False
    prob = types.SimpleNamespace(
        kf_poses=p["poses"].astype(np.float64), kf_fixed=p["fixed"],
        lm_anchor=p["anchor"], obs_kf=p["obs_kf"], obs_lm=p["obs_lm"],
        obs_px=p["obs_px"], obs_cam=p["obs_cam"])
    return prob, p["rho"], p["ray"], valid


@pytest.mark.parametrize("reuse", [False, True])
def test_pack_ba_invdepth_equals_jax(reuse):
    prob, rho, ray, valid = _ba_problem()
    want = jbi.pack_ba_invdepth(prob, rho, ray, valid)
    out = np.full_like(want, 5.0) if reuse else None
    got = tbi.pack_ba_invdepth(prob, rho, ray, valid, out=out)
    assert (got is out) == reuse
    assert got.shape == (tbi.ba_packed_size(8, len(rho),
                                            len(prob.obs_kf)),)
    np.testing.assert_array_equal(got, want)


def test_ba_padding_is_the_graphs_padding():
    """Grown by :func:`pad_landmarks`, the problem packs and unpacks to
    itself followed by :class:`GraphedTwoPass`'s padding rows."""
    prob, rho, ray, valid = _ba_problem()
    Kw, Lw, O = 8, len(rho), len(prob.obs_kf)
    L = tbi.landmark_capacity(Lw, O)
    assert L > Lw
    grown = tbi.pad_landmarks(prob, rho, ray, L)
    assert len(grown[0].lm_anchor) == len(grown[1]) == len(grown[2]) == L
    assert len(prob.lm_anchor) == Lw          # the problem is left as it was
    flat = tbi.pack_ba_invdepth(*grown, valid)
    got = tbi.unpack_ba_invdepth(torch.from_numpy(flat), Kw, L, O)
    ref = tbi.unpack_ba_invdepth(torch.from_numpy(
        tbi.pack_ba_invdepth(prob, rho, ray, valid)), Kw, Lw, O)
    for i, (a, b) in enumerate(zip(got, ref)):
        if i in tbi.GraphedTwoPass._PAD:
            assert torch.equal(a[:Lw], b)
            assert (a[Lw:] == tbi.GraphedTwoPass._PAD[i]).all()
        else:
            assert torch.equal(a, b)
    assert got[3].dtype == torch.int32 and got[8].dtype == torch.int8
    assert got[1].dtype == torch.bool and got[9].dtype == torch.bool


@pytest.mark.parametrize("sel", [
    "all", "some", "none"])
def test_bit_signature_equals_jax(rng, sel):
    desc = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    desc[:20] &= np.uint32(0x0F0F0F0F)       # a skewed bit histogram
    valid = dict(all=np.ones(64, bool), some=rng.random(64) < 0.3,
                 none=np.zeros(64, bool))[sel]
    got = tindex.bit_signature(desc, valid)
    want = jindex.bit_signature(desc, valid)
    assert got.dtype == np.float32 and got.shape == (256,)
    np.testing.assert_array_equal(got, want)
    if sel == "none":
        assert not got.any()
    else:
        assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-5


# --------------------------------------------------------------------------
# the packed steps
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stereo():
    seq = generate_sequence(n_frames=1, stereo=True, width=188, height=120,
                            n_points=800, seed=2)
    left = seq.images_left[0].astype(np.float32)
    right = seq.images_right[0].astype(np.float32)
    kps, _, ok = detect_single_scale(jnp.asarray(left), jnp.zeros((1, 2)),
                                     jnp.zeros(1, bool), 0.01, 12, 128)
    K = seq.K.astype(np.float32)
    d0 = np.zeros(4, np.float32)
    jc = JCalib(*[jnp.asarray(v, jnp.float32)
                  for v in (K[0, 0], K[1, 1], K[0, 2], K[1, 2])],
                dist=jnp.asarray(d0))
    tc = TCalib(*[torch.tensor(float(v)) for v in
                  (K[0, 0], K[1, 1], K[0, 2], K[1, 2])], dist=T(d0))
    return dict(left=left, right=right, kps=np.array(kps, np.float32),
                ok=np.array(ok), T_lr=np.asarray(seq.T_lr, np.float32),
                jc=jc, tc=tc)


def _stereo_pair(s, state):
    j = np.asarray(jms.fused_stereo_map_step(
        tuple(j_pyr(jnp.asarray(s["left"]), 3)), jnp.asarray(s["right"]),
        jnp.asarray(state), jnp.asarray(s["T_lr"]),
        j_efp(jnp.asarray(s["T_lr"])), s["jc"], s["jc"], levels=3))
    t = tms.fused_stereo_map_step(
        tuple(t_pyr(T(s["left"]), 3)), T(s["right"]), T(state),
        T(s["T_lr"]), t_efp(T(s["T_lr"])), s["tc"], s["tc"], levels=3)
    return j, t.numpy()


@pytest.mark.parametrize("case", ["fresh", "with_3d_landmarks"])
def test_packed_stereo_step_against_jax(stereo, case):
    """A keyframe of 2D landmarks, and the same keyframe with half of its
    triangulated landmarks 3D (their right-camera projections become the
    KLT's priors, and they are no triangulation candidates)."""
    s = stereo
    kps, ok = s["kps"], s["ok"]
    N = len(kps)
    T_wc = np.array([1, 0, 0, 0, 0.1, -0.2, 0.3], np.float32)
    lm_pos = np.zeros((N, 3), np.float32)
    is3d = np.zeros(N, bool)
    if case == "with_3d_landmarks":
        j0, _ = _stereo_pair(s, jms.pack_stereo_state(kps, lm_pos, ok, is3d,
                                                      T_wc))
        is3d = (j0[:, 6] > 0.5) & (np.arange(N) % 2 == 0)
        lm_pos[is3d] = j0[is3d, 2:5]
        assert is3d.sum() > 10
    state = tms.pack_stereo_state(kps, lm_pos, ok, is3d, T_wc)
    j, t = _stereo_pair(s, state)
    assert t.shape == j.shape == (N, 8) and t.dtype == np.float32
    for col in (5, 6, 7):           # stereo_ok, tri_ok, tri_cand
        assert ((j[:, col] > 0.5) == (t[:, col] > 0.5)).mean() >= 0.97
    j_tri, t_tri = j[:, 6] > 0.5, t[:, 6] > 0.5
    assert j_tri.sum() > 10
    assert not t_tri[is3d].any() and not j_tri[is3d].any()
    both = j_tri & t_tri
    np.testing.assert_allclose(t[both, 2:5], j[both, 2:5], rtol=5e-3,
                               atol=1e-3)
    matched = (j[:, 5] > 0.5) & (t[:, 5] > 0.5)
    assert matched[is3d].sum() >= 0.5 * is3d.sum()
    np.testing.assert_allclose(t[matched, 0:2], j[matched, 0:2], atol=0.01)


def test_packed_temporal_step_against_jax(rng, stereo):
    """Rows with their own anchor poses: points 3-8 m from an anchor and a
    current camera about 0.6 m aside (the parallax the mapper triangulates
    at; at a few cm the midpoint solve is ill-conditioned in f32), a
    quarter of the rows invalid."""
    tc, jc = stereo["tc"], stereo["jc"]
    fx, fy, cx, cy = (float(v) for v in tc[:4])
    n = 96
    T_a = np.stack([np.concatenate([lie_np.so3_exp(rng.normal(0, 0.2, 3)),
                                    rng.normal(0, 1, 3)]) for _ in range(n)])
    T_rel = np.stack([np.concatenate([
        lie_np.so3_exp(rng.normal(0, 0.05, 3)),
        rng.normal(0, 0.1, 3) + [0.6, 0.0, 0.0]]) for _ in range(n)])
    p_a = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                    rng.uniform(3, 8, n)], -1)
    p_c = lie_np.pose_apply(lie_np.pose_inverse(T_rel), p_a)

    def px(p):
        return np.stack([fx * p[:, 0] / p[:, 2] + cx,
                         fy * p[:, 1] / p[:, 2] + cy], -1) + rng.normal(
            0, 0.3, (n, 2))

    valid = rng.random(n) < 0.75
    state = tms.pack_temporal_state(px(p_a), px(p_c), T_a, T_rel, valid)
    j = np.asarray(jms.fused_temporal_step(jnp.asarray(state), jc))
    t = tms.fused_temporal_step(T(state), tc).numpy()
    assert t.shape == (n, 4) and t.dtype == np.float32
    ok = t[:, 3] > 0.5
    np.testing.assert_array_equal(ok, j[:, 3] > 0.5)
    assert ok.sum() > 20 and not ok[~valid].any()
    np.testing.assert_allclose(t[ok, 0:3], j[ok, 0:3], rtol=5e-3, atol=1e-3)


class _NoUploads:
    """Within ``with``: every way of making a tensor from host data, or of
    reading one back, raises (what a CUDA graph's capture refuses)."""

    NAMES = ("tensor", "as_tensor", "from_numpy")
    METHODS = ("item", "tolist", "numpy", "cpu")

    def __enter__(self):
        self.saved = [(torch, n, getattr(torch, n)) for n in self.NAMES] + [
            (torch.Tensor, n, getattr(torch.Tensor, n)) for n in self.METHODS]

        def refuse(name):
            def f(*a, **k):
                raise AssertionError(f"{name} inside a graphed step")
            return f

        for owner, name, _ in self.saved:
            setattr(owner, name, refuse(name))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def test_packed_steps_upload_nothing(stereo):
    s = stereo
    N = len(s["kps"])
    state = T(tms.pack_stereo_state(
        s["kps"], np.zeros((N, 3)), s["ok"], np.zeros(N, bool),
        np.array([1, 0, 0, 0, 0, 0, 0])))
    pyr = tuple(t_pyr(T(s["left"]), 3))
    right, T_lr = T(s["right"]), T(s["T_lr"])
    E_lr = t_efp(T_lr)
    tstate = T(tms.pack_temporal_state(
        s["kps"], s["kps"] + 1.0, np.tile([1, 0, 0, 0, 0, 0, 0], (N, 1)),
        np.tile([1, 0, 0, 0, 0.1, 0, 0], (N, 1)), s["ok"]))
    stereo_step, temporal_step = tms.map_steps()
    with _NoUploads():
        out = stereo_step(*pyr, right, state, T_lr=T_lr, E_lr=E_lr,
                          calib_l=s["tc"], calib_r=s["tc"], levels=3)
        tout = temporal_step(tstate, calib_l=s["tc"])
    assert out.shape == (N, 8) and tout.shape == (N, 4)
    want = tms.fused_stereo_map_step(pyr, right, state, T_lr, E_lr,
                                     s["tc"], s["tc"], levels=3)
    assert torch.equal(out, want)
    assert torch.equal(tout, tms.fused_temporal_step(tstate, s["tc"]))


# --------------------------------------------------------------------------
# the packed BA solve
# --------------------------------------------------------------------------

def test_ba_invdepth_packed_against_jax():
    n_kf, n_lm = 8, 150
    j = jbench._synth_ba_problem(jnp, n_kf, n_lm)
    prob, rho, ray, valid = _ba_problem(n_kf, n_lm)
    flat = tbi.pack_ba_invdepth(prob, rho, ray, valid)
    O = len(prob.obs_kf)
    want = np.asarray(jbi.ba_invdepth_packed(
        jnp.asarray(flat), j["params"], Kw=n_kf, Lw=n_lm, O=O))
    _, params = tbench.ba_inputs(tbench.synth_ba_problem(n_kf, n_lm),
                                 "cpu")
    got = tbi.ba_invdepth_packed(torch.from_numpy(flat), params, n_kf,
                                 n_lm, O).numpy()
    assert got.shape == want.shape == (n_kf * 7 + n_lm * 3 + O + 1,)
    a, b = n_kf * 7, n_kf * 7 + n_lm * 3
    np.testing.assert_allclose(got[:a], want[:a], atol=1e-3)
    np.testing.assert_allclose(got[a:b], want[a:b], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got[b:-1] > 0.5, want[b:-1] > 0.5)
    assert (got[b:-1] > 0.5).sum() > 0.8 * valid.sum()


def test_ba_invdepth_packed_equals_the_unpacked_solve():
    """Bit for bit: the same solve of the same values, and
    ``between_iters`` is called after every LM iteration."""
    prob, rho, ray, valid = _ba_problem()
    Kw, Lw, O = 8, len(rho), len(prob.obs_kf)
    _, params = tbench.ba_inputs(tbench.synth_ba_problem(8, 120), "cpu")
    calls = []
    got = tbi.ba_invdepth_packed(
        torch.from_numpy(tbi.pack_ba_invdepth(prob, rho, ray, valid)),
        params, Kw, Lw, O, robust_th=5.9915, iters_robust=4, iters_l2=2,
        between_iters=lambda: calls.append(1))
    assert len(calls) == 6
    args = [torch.as_tensor(np.ascontiguousarray(a)) for a in (
        prob.kf_poses, prob.kf_fixed, rho, prob.lm_anchor, ray, prob.obs_kf,
        prob.obs_lm, prob.obs_px, prob.obs_cam, valid)]
    poses, pos, _, inlier, cost = tbi.ba_solve_invdepth_two_pass(
        *args, params, robust_th=5.9915, iters_robust=4, iters_l2=2)
    assert torch.equal(got, tbi.pack_ba_out(poses, pos, inlier, cost))
    with pytest.raises(ValueError):
        tbi.ba_invdepth_packed(got, params, Kw, Lw, O)


def test_estimator_queues_the_next_capacity_near_the_boundary(monkeypatch):
    """A window within one step (256 rows) of its graphs' landmark
    capacity queues the next capacity's pre-warm, once; a window far below
    it queues nothing; :meth:`prewarm_next` builds what was queued. The
    solve itself runs here through the CPU's eager solve."""
    from ov2slam_torch.models import estimator
    from ov2slam_torch.models.slam import SlamManager
    from ov2slam_torch.io.synthetic import generate_sequence as t_gen

    seq = t_gen(n_frames=1, stereo=True, width=188, height=120,
                n_points=200, seed=1)
    est = SlamManager(seq.make_config(), device="cpu").estimator
    _, params = tbench.ba_inputs(tbench.synth_ba_problem(8, 120), "cpu")
    monkeypatch.setattr(est, "params", params)   # the problem's camera
    monkeypatch.setattr(estimator, "graphed", lambda device, n_kf: True)
    built = []
    monkeypatch.setattr(est, "_prewarm_bucket",
                        lambda L, problem: built.append(L))
    prob, rho, ray, valid = _ba_problem()
    O = len(prob.obs_kf)
    L = tbi.landmark_capacity(len(rho), O)
    poses, points, inlier = est.solve_packed(prob, rho, ray, valid)
    assert poses.shape == (8, 7) and points.shape == (len(rho), 3)
    assert inlier.shape == (O,) and inlier.sum() > 0.8 * valid.sum()
    est.prewarm_next()
    assert built == [] and est._next_warm is None
    est.solve_packed(*tbi.pad_landmarks(prob, rho, ray, L), valid)
    est.prewarm_next()
    est.prewarm_next()
    assert built == [L + 256]


def test_graph_state_goes_with_its_manager():
    """Each mapper makes its own graphed steps (their graphs bake in its
    calibration), counting on the module's shared counters, and each
    estimator keeps its own BA runners: nothing outside a manager holds
    them, so they are freed with it."""
    import gc
    import weakref

    from ov2slam_torch.models.slam import SlamManager
    from ov2slam_torch.io.synthetic import generate_sequence as t_gen

    cfg = t_gen(n_frames=1, stereo=True, width=188, height=120,
                n_points=200, seed=1).make_config()
    a, b = (SlamManager(cfg, device="cpu") for _ in range(2))
    steps = [(s.mapper._stereo_step, s.mapper._temporal_step)
             for s in (a, b)]
    assert steps[0][0] is not steps[1][0]
    assert steps[0][1] is not steps[1][1]
    for stereo, temporal in steps:
        assert stereo.counts is tms.stereo_step_counts
        assert temporal.counts is tms.temporal_step_counts
    assert a.estimator._ba_runners is not b.estimator._ba_runners
    refs = [weakref.ref(x) for x in (a.mapper, a.estimator, *steps[0])]
    del a, steps
    gc.collect()
    assert all(r() is None for r in refs)

