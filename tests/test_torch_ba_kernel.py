"""Local BA's two hand kernels (``csrc/ba_normal_eq.cu``,
``csrc/ba_schur_step.cu``), their wrappers and plain versions
(``solvers/ba_invdepth.py``: ``normal_equations``, ``schur_step``,
``lm_accept`` and their ``_plain`` forms).

On the CPU, with tests/test_torch_ba.py's problems (tests/test_solvers.py's
``synth_ba_problem``, ``perturb`` and tests/test_ba_invdepth.py's
``_invdepth_state``: 6 keyframes, 80 landmarks, the first two fixed), the
same numpy inputs going to both packages, the JAX package imported inside
each test:
- the normal equations' plain version against the JAX package's
  ``_residuals_jacobians_inv`` summed by the one-hot formula of
  ``ov2slam_tpu/solvers/ba_invdepth.py:385-401`` (Hpp, bp, Z, Hrr, brho;
  the cost as ``iter_body`` takes it), each within 1e-4 of its largest
  entry: stereo with right-camera rows, mono, padded landmark rows (anchor
  -1), invalid observation rows, rows behind their camera (depth_ok
  false), all of them; Huber and L2;
- one LM iteration through the two plain versions against
  ``_solve_iteration_inv`` (poses 1e-4, inverse depths 1e-3 relative, as
  tests/test_torch_ba.py);
- the cost mode against ``_total_cost_inv`` (1e-5 relative), and its
  accept test both ways;
- the launch packing (on ``chip_smoke.ba_case``'s 6-keyframe window): the
  ctypes structures field for field the C sources' ``Args``, and every
  refusal (f64, a strided tensor, a wrong shape, 65 poses, bins that are
  not the dense branch's);
- on the fixtures no (k, q) bin or pose bin k is longer than (k, k),
  which is why the sums kernel starts the diagonal bins first;
  ``chip_smoke.ba_worst_case`` puts every valid row in one diagonal bin;
- ``roofline.py``'s chains of both kernels (the Schur step's at the
  kernel's own ``kChains``) and the LU's bound, at the figures PERF.md
  gives.

On the card (skipped without one, decided inside the test; the fixtures
are ``chip_smoke.ba_case``'s, numpy from a seed): each kernel against its
plain version at 2, 32 and 64 keyframes (padded landmark rows, invalid
rows, a row behind its camera; rows not a multiple of the kernels' blocks)
to chip_smoke's bars (``chip_smoke.ba_check``: each sum within 1e-4 of
its largest entry of an f64 plain solve's, or no farther from it than 2x
the plain f32 version; cost 1e-5, poses 1e-4, inverse depths 1e-3
relative; a second launch bit-equal); the normal equations into outputs
full of NaN at 1, 7 and 64 keyframes equal to a usual launch's (every
entry written); the worst case's normal equations and cost mode
(``chip_smoke.ba_sums_check``); the two-pass solve within 1e-3, masks
equal; two windows' LM iterations issued together on two streams, each
bit-equal to its iteration alone (the kernels keep no state between
launches: no ticket); a ``GraphedTwoPass`` replay bit-equal to its eager
solve, its launches counted at each replay; the launch checks raising on an f64
tensor, a tensor on another device and 65 keyframes. The file imports no
JAX at module level: on the card ``python -m pytest --noconftest
tests/test_torch_ba_kernel.py`` runs it (the tests that hold the JAX
package skip there).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from ov2slam_torch import kernels
from ov2slam_torch.solvers import ba_invdepth as bi
from ov2slam_torch.solvers.ba import BAParams

torch.set_num_threads(1)

FX = FY = 458.0
CX, CY = 376.0, 240.0
TH = 5.9915
VARIANTS = ("stereo", "mono", "padded_landmarks", "invalid_rows",
            "behind_camera", "all")


def _jax():
    """JAX as tests/conftest.py sets it up (f64, the CPU), also where a run
    goes without it (on the card); skips where there is no JAX."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    return jax


def _problem(variant, seed=0):
    """tests/test_torch_ba.py's problem with ``variant``'s rows
    (``chip_smoke.ba_extras``): (numpy arrays, JAX calibration). Skips
    where its fixtures do not import (on the card, which runs without the
    JAX package's test modules)."""
    _jax()
    _invdepth_state = pytest.importorskip(
        "tests.test_ba_invdepth")._invdepth_state
    solvers = pytest.importorskip("tests.test_solvers")
    perturb, synth_ba_problem = solvers.perturb, solvers.synth_ba_problem

    rng = np.random.default_rng(seed)
    gt, lms, obs = synth_ba_problem(rng, n_kf=6, n_lm=80,
                                    stereo=variant != "mono", noise_px=0.3)
    poses0, lms0, fixed = perturb(rng, gt, lms, fix_first=2)
    rho, anchor, ray = _invdepth_state(poses0, lms, obs,
                                       lm_pos_override=lms0)
    n = len(np.array(obs["obs_kf"]))
    prob = dict(poses=poses0, fixed=fixed, rho=rho, anchor=anchor, ray=ray,
                obs_kf=np.array(obs["obs_kf"]), obs_lm=np.array(obs["obs_lm"]),
                obs_px=np.array(obs["obs_px"]),
                obs_cam=np.array(obs["obs_cam"]), obs_valid=np.ones(n, bool))
    every = variant == "all"
    prob = chip_smoke.ba_extras(
        prob, padded=7 if every or variant == "padded_landmarks" else 0,
        invalid=5 if every or variant == "invalid_rows" else 0,
        behind=every or variant == "behind_camera", block=1 << 30)
    return prob, obs["params"]


def _tparams(jparams):
    return BAParams(fx=torch.tensor(FX), fy=torch.tensor(FY),
                    cx=torch.tensor(CX), cy=torch.tensor(CY),
                    T_rl=torch.as_tensor(np.array(jparams.T_rl)),
                    intr=(FX, FY, CX, CY))


def _state(prob, prm):
    args = tuple(torch.as_tensor(prob[k]) for k in (
        "poses", "fixed", "rho", "anchor", "ray", "obs_kf", "obs_lm",
        "obs_px", "obs_cam", "obs_valid"))
    s = bi._prepare(*args[:8], args[9], 1e-3, args[8])
    st = (s["anchor"], s["lm_ray"], s["obs_kf"], s["obs_lm"], s["obs_px"],
          s["right"])
    return args, s, st


def _jax_inputs(s, args):
    """The torch state's arrays for the JAX package's functions: (T_cw,
    rho, anchor, ray, obs_kf, obs_lm, obs_px, obs_cam), w_valid, free."""
    cols = [s[k].numpy() for k in ("T_cw", "rho", "anchor", "lm_ray",
                                   "obs_kf", "obs_lm", "obs_px")]
    return cols + [args[8].numpy()], s["w_valid"].numpy(), s["free"].numpy()


def _jax_weights(r, depth_ok, w_valid, th):
    """``ba_solve_invdepth``'s ``iter_body``: the weights and cost0."""
    import jax.numpy as jnp

    chi2 = jnp.sum(r * r, -1)
    w_rob = (jnp.where(chi2 <= th, 1.0,
                       jnp.sqrt(th / jnp.maximum(chi2, 1e-12)))
             if th > 0 else jnp.ones_like(chi2))
    w = w_valid * w_rob * depth_ok
    rho_l = (jnp.where(chi2 <= th, chi2,
                       2.0 * jnp.sqrt(th * jnp.maximum(chi2, 0.0)) - th)
             if th > 0 else chi2)
    return w, jnp.sum(rho_l * w_valid * depth_ok)


def _jax_normal_equations(cols, w_valid, free, jparams, th):
    """The JAX package's normal equations: ``_residuals_jacobians_inv``,
    the weights and cost0 of ``iter_body``, and the gauge, weights and
    one-hot sums of ``_solve_iteration_inv`` (:356-401)."""
    import jax
    import jax.numpy as jnp

    import ov2slam_tpu.solvers.ba_invdepth as jbi

    T_cw, rho, anchor, ray, obs_kf, obs_lm, obs_px, obs_cam = cols
    Kw, Lw = T_cw.shape[0], rho.shape[0]
    r, J_obs, J_anch, J_rho, depth_ok = jbi._residuals_jacobians_inv(
        jnp.asarray(T_cw), jnp.asarray(rho), jnp.asarray(anchor),
        jnp.asarray(ray), jnp.asarray(obs_kf), jnp.asarray(obs_lm),
        jnp.asarray(obs_px), jnp.asarray(obs_cam), jparams)
    w, cost0 = _jax_weights(r, depth_ok, jnp.asarray(w_valid), th)
    w = w * depth_ok
    anch_kf = jnp.asarray(anchor)[obs_lm]
    free = jnp.asarray(free)
    J_obs = J_obs * free[obs_kf][:, None, None]
    J_anch = J_anch * free[anch_kf][:, None, None]
    wJ_obs = J_obs * w[:, None, None]
    wJ_anch = J_anch * w[:, None, None]
    wJ_rho = J_rho * w[:, None]
    Hrr = jnp.zeros((Lw,), r.dtype).at[obs_lm].add(
        jnp.einsum("oi,oi->o", wJ_rho, J_rho))
    brho = jnp.zeros((Lw,), r.dtype).at[obs_lm].add(
        -jnp.einsum("oi,oi->o", wJ_rho, r))
    ohA = jax.nn.one_hot(obs_kf, Kw, dtype=r.dtype)
    ohB = jax.nn.one_hot(anch_kf, Kw, dtype=r.dtype)
    P = (ohA[:, :, None, None] * J_obs[:, None]
         + ohB[:, :, None, None] * J_anch[:, None])
    Pw = (ohA[:, :, None, None] * wJ_obs[:, None]
          + ohB[:, :, None, None] * wJ_anch[:, None])
    Hpp = jnp.einsum("okid,oqie->kqde", Pw, P)
    bp = -jnp.einsum("okid,oi->kd", Pw, r)
    Z = jnp.zeros((Lw, Kw, 6), r.dtype).at[obs_lm].add(
        jnp.einsum("okid,oi->okd", Pw, J_rho))
    return [np.asarray(x) for x in (Hpp, bp, Z, Hrr, brho, cost0)]


@pytest.mark.parametrize("th", [TH, 0.0], ids=["huber", "l2"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_normal_equations_plain_matches_jax(variant, th):
    prob, jparams = _problem(variant)
    prm = _tparams(jparams)
    args, s, st = _state(prob, prm)
    got = bi.normal_equations_plain(s["T_cw"], s["rho"], *st, s["w_valid"],
                                    s["free"], s["bins"], prm, th)
    cols, w_valid, free = _jax_inputs(s, args)
    want = _jax_normal_equations(cols, w_valid, free, jparams, th)
    for name, g, w in zip(("Hpp", "bp", "Z", "Hrr", "brho", "cost"), got,
                          want):
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (name, err)
    if variant in ("behind_camera", "all"):
        _, dok, _ = bi._project_inv(s["T_cw"], s["rho"], *st, prm,
                                    rotations=False)
        assert not bool(dok.all())


@pytest.mark.parametrize("th", [TH, 0.0], ids=["huber", "l2"])
@pytest.mark.parametrize("variant", ["stereo", "all"])
def test_one_iteration_through_the_plain_versions_matches_jax(variant, th):
    """normal_equations_plain then schur_step_plain from the weights
    ``iter_body`` forms, against ``_solve_iteration_inv`` on them."""
    jnp = _jax().numpy

    import ov2slam_tpu.solvers.ba_invdepth as jbi

    prob, jparams = _problem(variant)
    prm = _tparams(jparams)
    args, s, st = _state(prob, prm)
    lam = torch.tensor(1e-3)
    ne = bi.normal_equations_plain(s["T_cw"], s["rho"], *st, s["w_valid"],
                                   s["free"], s["bins"], prm, th)
    T_new, rho_new = bi.schur_step_plain(s["T_cw"], s["rho"], lam, *ne[:5],
                                         s["free"])
    cols, w_valid, free = _jax_inputs(s, args)
    jc = [jnp.asarray(c) for c in cols]
    r, _, _, _, depth_ok = jbi._residuals_jacobians_inv(*jc, jparams)
    w, _ = _jax_weights(r, depth_ok, jnp.asarray(w_valid), th)
    jT, jrho = jbi._solve_iteration_inv(
        jc[0], jc[1], jnp.float32(1e-3), *jc[2:], w, jnp.asarray(free),
        jparams)
    np.testing.assert_allclose(T_new.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(rho_new.numpy(), np.asarray(jrho), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("th", [TH, 0.0], ids=["huber", "l2"])
def test_cost_mode_matches_jax_and_accepts_both_ways(th):
    jnp = _jax().numpy

    import ov2slam_tpu.solvers.ba_invdepth as jbi

    prob, jparams = _problem("all")
    prm = _tparams(jparams)
    args, s, st = _state(prob, prm)
    ne = bi.normal_equations_plain(s["T_cw"], s["rho"], *st, s["w_valid"],
                                   s["free"], s["bins"], prm, th)
    T_new, rho_new = bi.schur_step_plain(s["T_cw"], s["rho"], s["lam"],
                                         *ne[:5], s["free"])
    cols, w_valid, _ = _jax_inputs(s, args)
    want = float(jbi._total_cost_inv(
        jnp.asarray(T_new.numpy()), jnp.asarray(rho_new.numpy()),
        *[jnp.asarray(c) for c in cols[2:]], jnp.asarray(w_valid), jparams,
        th))
    inf = torch.tensor(float("inf"))
    for cost0, keep in ((inf, True), (-inf, False)):
        T, rho, lam, cost1 = bi.lm_accept_plain(
            s["T_cw"], s["rho"], s["lam"], cost0, T_new, rho_new, *st,
            s["w_valid"], prm, th)
        assert abs(float(cost1) - want) <= 1e-5 * abs(want)
        assert torch.equal(T, T_new if keep else s["T_cw"])
        assert torch.equal(rho, rho_new if keep else s["rho"])
        assert float(lam) == pytest.approx(5e-4 if keep else 4e-3)
    # the CPU wrapper is the plain version, bit for bit
    got = bi.lm_accept(s["T_cw"], s["rho"], s["lam"], ne[5], T_new, rho_new,
                       *st, s["w_valid"], prm, th)
    ref = bi.lm_accept_plain(s["T_cw"], s["rho"], s["lam"], ne[5], T_new,
                             rho_new, *st, s["w_valid"], prm, th)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _c_fields(name):
    """The field names of ``struct Args`` in ``csrc/<name>.cu``, in order."""
    with open(os.path.join(kernels.CSRC, f"{name}.cu")) as f:
        src = f.read()
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        decl = line.rstrip(";").split(None, 1)[1] if not line.startswith(
            "const") else line.rstrip(";").split(None, 2)[2]
        names += [n.strip().lstrip("*") for n in decl.split(",")]
    return names


@pytest.mark.parametrize("lib,struct", [
    ("ba_normal_eq", bi.NormalEqArgs), ("ba_schur_step", bi.SchurArgs)])
def test_argument_structs_match_the_c_sources(lib, struct):
    assert [f[0] for f in struct._fields_] == _c_fields(lib)
    n_ptr = sum(f[1] is ctypes.c_void_p for f in struct._fields_)
    assert ctypes.sizeof(struct) == -(-(8 * n_ptr + 4 * (
        len(struct._fields_) - n_ptr)) // 8) * 8
    assert kernels._SIGNATURES[lib][2] == [ctypes.c_void_p, ctypes.c_void_p]
    assert lib in kernels.KERNELS


def _pack_args():
    args, prm = chip_smoke.ba_case(6, torch.device("cpu"))
    s, st = chip_smoke.ba_state(args, prm)
    return s, st, prm


def test_pack_normal_eq_takes_the_state_and_refuses_the_rest():
    s, st, prm = _pack_args()
    a, Kw, Lw, O = bi.pack_normal_eq(s["T_cw"], s["rho"], *st, s["w_valid"],
                                     s["free"], prm, TH, bins=s["bins"])
    assert (Kw, Lw, O) == (6, s["rho"].shape[0], s["obs_kf"].shape[0])
    assert a.mode == 0 and a.perm_pp == s["bins"]["pp"].perm.data_ptr()
    assert a.off_lp == s["bins"]["off"]["lp"].data_ptr()
    c, *_ = bi.pack_normal_eq(s["T_cw"], s["rho"], *st, s["w_valid"], None,
                              prm, 0.0, state=(s["T_cw"], s["rho"], s["lam"],
                                               s["cost"]))
    assert c.mode == 1 and c.robust_th == 0.0

    def pack(T=s["T_cw"], rho=s["rho"], st=st, bins=s["bins"]):
        return bi.pack_normal_eq(T, rho, *st, s["w_valid"], s["free"], prm,
                                 TH, bins=bins)

    with pytest.raises(TypeError):
        pack(T=s["T_cw"].double())
    with pytest.raises(TypeError):
        pack(st=st[:5] + (st[5].to(torch.int8),))
    with pytest.raises(ValueError):
        pack(rho=s["rho"][:-1])
    with pytest.raises(ValueError):
        pack(st=(st[0], st[1].t().contiguous().t()) + st[2:])
    with pytest.raises(ValueError):
        pack(bins={k: v for k, v in s["bins"].items() if k != "off"})
    with pytest.raises(ValueError):
        pack(T=s["T_cw"].new_zeros((65, 7)))


def test_pack_schur_step_refuses_what_the_kernel_does_not_take():
    s, st, prm = _pack_args()
    ne = bi.normal_equations_plain(s["T_cw"], s["rho"], *st, s["w_valid"],
                                   s["free"], s["bins"], prm, TH)
    a = bi.pack_schur_step(s["T_cw"], s["rho"], s["lam"], *ne[:5],
                           s["free"])
    assert (a.Kw, a.Lw) == (6, s["rho"].shape[0])
    with pytest.raises(TypeError):
        bi.pack_schur_step(s["T_cw"], s["rho"], s["lam"].double(), *ne[:5],
                           s["free"])
    with pytest.raises(ValueError):
        bi.pack_schur_step(s["T_cw"], s["rho"], s["lam"], ne[0][:5],
                           *ne[1:5], s["free"])


@pytest.mark.parametrize("n_kf", [2, 6, 32])
def test_diagonal_bins_are_the_longest(n_kf):
    """The sums kernel starts the diagonal (pose, pose) bins first because
    no (k, q) bin and no pose bin k holds more entries than (k, k)."""
    args, prm = chip_smoke.ba_case(n_kf, torch.device("cpu"))
    s, _ = chip_smoke.ba_state(args, prm)
    pp = s["bins"]["pp"].lengths[:n_kf * n_kf].reshape(n_kf, n_kf)
    diag = pp.diagonal()
    assert bool((pp <= diag[:, None]).all())
    assert bool((s["bins"]["pose"].lengths[:n_kf] <= diag).all())
    assert chip_smoke.ba_longest_bin(s["bins"]) == int(diag.max())


def test_worst_case_puts_every_row_in_one_diagonal_bin():
    args, prm = chip_smoke.ba_worst_case(torch.device("cpu"))
    s, _ = chip_smoke.ba_state(args, prm)
    Kw = s["T_cw"].shape[0]
    pp = s["bins"]["pp"].lengths[:Kw * Kw]
    valid = int(args[9].sum())
    assert int(pp[5 * Kw + 5]) == 4 * valid >= 4096
    assert int(pp.sum()) == 4 * valid
    assert chip_smoke.ba_longest_bin(s["bins"]) == 4 * valid


# the figures PERF.md gives for slice B's problem (2610 entries in its
# busiest bin, 4096 landmarks, a 192-wide system) and the worst case
@pytest.mark.parametrize("entries,ms", [(0, 0.0), (32, 6.4646e-5),
                                        (2610, 5.2727e-3),
                                        (80364, 0.16235)])
def test_roofline_ba_normal_eq_chain(entries, ms):
    from ov2slam_torch import roofline as rf

    assert rf.ba_normal_eq_chain(entries) == pytest.approx(ms, rel=1e-4)


@pytest.mark.parametrize("Lw,ms", [(1, 6.6667e-5), (32, 6.6667e-5),
                                   (4096, 3.2323e-4), (4097, 3.2525e-4)])
def test_roofline_ba_schur_step_chain(Lw, ms):
    """At the kernel's own chain count: ``SCHUR_B_CHAINS`` is
    csrc/ba_schur_step.cu's ``kChains``."""
    from ov2slam_torch import roofline as rf

    with open(os.path.join(kernels.CSRC, "ba_schur_step.cu")) as f:
        chains = int(re.search(r"constexpr int kChains = (\d+);",
                               f.read()).group(1))
    assert bi.SCHUR_B_CHAINS == chains
    assert rf.ba_schur_step_chain(Lw, chains) == pytest.approx(ms, rel=1e-4)


@pytest.mark.parametrize("n,ops,nbytes,by", [
    (12, 1440, 672, "bytes"), (192, 4792320, 148992, "operations"),
    (384, 38043648, 592896, "operations")])
def test_roofline_lu_solve_bound(n, ops, nbytes, by):
    from ov2slam_torch import roofline as rf

    b = rf.lu_solve_bound(n)
    assert (b["ops"], b["bytes"], b["bound_by"]) == (ops, nbytes, by)
    assert b["bound_ms"] == pytest.approx(
        1e3 * max(ops / rf.F32_FLOP_PER_S, nbytes / rf.HBM_BYTES_PER_S))


# --------------------------------------------------------------- card #

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("th", [TH, 0.0], ids=["huber", "l2"])
@pytest.mark.parametrize("n_kf", chip_smoke.BA_CASE_KFS)
def test_cuda_kernels_match_plain(n_kf, th):
    dev = _card()
    args, prm = chip_smoke.ba_case(n_kf, dev)
    assert args[5].shape[0] % 128 != 0
    chip_smoke.ba_check(f"fixture {n_kf} KFs", args, prm, th)


@pytest.mark.parametrize("n_kf", [1, 7, 64])
def test_cuda_normal_equations_write_every_output(n_kf, monkeypatch):
    """Every entry of Hpp, bp, Z, Hrr, brho and the cost is written by the
    launch: into outputs allocated full of NaN it gives a launch's usual
    outputs, bit for bit (one keyframe without the extra rows, which need
    a second)."""
    dev = _card()
    args, prm = chip_smoke.ba_case(n_kf, dev, extras=n_kf > 1)
    s, st = chip_smoke.ba_state(args, prm)
    ne = (s["T_cw"], s["rho"], *st, s["w_valid"], s["free"], s["bins"],
          prm, TH)
    want = bi.normal_equations(*ne)
    new_empty = torch.Tensor.new_empty
    monkeypatch.setattr(torch.Tensor, "new_empty", lambda t, *a, **k:
                        new_empty(t, *a, **k).fill_(float("nan")))
    got = bi.normal_equations(*ne)
    monkeypatch.undo()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)


def test_cuda_worst_case_diagonal_bin_matches_plain():
    """Every valid row of a 32-keyframe window in one diagonal bin (tens of
    thousands of entries: the sums kernel's ring of tiles wraps thousands
    of times): the normal equations and the cost mode against their plain
    versions to chip_smoke's gates, two launches bit-equal."""
    dev = _card()
    args, prm = chip_smoke.ba_worst_case(dev)
    res = chip_smoke.ba_sums_check("worst case", args, prm)
    assert res["longest_bin"] >= 4096 and res["bit_equal"]


def test_cuda_two_pass_solve_matches_plain():
    dev = _card()
    args, prm = chip_smoke.ba_case(32, dev)
    n = [f.cuda_runs for f in chip_smoke.ba_kernel_fns()[1]]
    bi._two_pass(args, prm, TH, 5, 3, None)
    assert [f.cuda_runs for f in chip_smoke.ba_kernel_fns()[1]] == n
    chip_smoke.ba_solve_check("fixture 32 KFs", args, prm)


def _iteration(args, prm):
    s, _ = chip_smoke.ba_state(args, prm)
    return bi._lm_step(s, prm, TH)


def test_cuda_two_streams_equal_their_iterations_alone():
    dev = _card()
    cases = [chip_smoke.ba_case(n, dev, seed=i)
             for i, n in enumerate((32, 64))]
    alone = [_iteration(*c) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in cases]
    for rnd in range(5):
        outs = []
        torch.cuda._sleep(int(1e6))
        for st, c in zip(streams, cases):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(_iteration(*c))
        torch.cuda.synchronize()
        for got, want in zip(outs, alone):
            assert all(chip_smoke._bits_equal(x, y)
                       for x, y in zip(got, want)), rnd


def test_cuda_graph_replay_equals_eager_and_counts_launches():
    dev = _card()
    args, prm = chip_smoke.ba_case(32, dev, seed=3)
    run = bi.GraphedTwoPass(args, prm, TH, 5, 3)
    eager = run(args)
    n0 = (bi.normal_equations.launches, bi.schur_step.launches,
          bi.lm_accept.launches)
    replays = [run(args), run(args)]
    torch.cuda.synchronize()
    for out in replays:
        assert all(chip_smoke._bits_equal(x, y) for x, y in zip(out, eager))
    # each replay runs 8 LM iterations: one launch each of the normal
    # equations and the cost mode, two of the Schur step
    assert (bi.normal_equations.launches - n0[0],
            bi.schur_step.launches - n0[1],
            bi.lm_accept.launches - n0[2]) == (16, 32, 16)


def test_cuda_launch_checks_raise():
    dev = _card()
    args, prm = chip_smoke.ba_case(2, dev)
    s, st = chip_smoke.ba_state(args, prm)

    def ne(T=s["T_cw"], rho=s["rho"]):
        return bi.normal_equations(T, rho, *st, s["w_valid"], s["free"],
                                   s["bins"], prm, TH)

    with pytest.raises(TypeError):
        ne(T=s["T_cw"].double())
    with pytest.raises(ValueError):
        ne(rho=s["rho"].cpu())
    with pytest.raises(ValueError):
        ne(T=s["T_cw"].new_zeros((65, 7)))
    Hpp, bp, Z, Hrr, brho, _ = ne()
    with pytest.raises(TypeError):
        bi.schur_step(s["T_cw"], s["rho"], s["lam"], Hpp.double(), bp, Z,
                      Hrr, brho, s["free"])
    with pytest.raises(ValueError):
        bi.schur_step(s["T_cw"].new_zeros((65, 7)), s["rho"], s["lam"], Hpp,
                      bp, Z, Hrr, brho, s["free"])
