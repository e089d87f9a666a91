"""Parity: ov2slam_torch parallel/{problems,dist_ba}.py against ov2slam_tpu.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port runs its shards in-process (8 shards standing in for the 8-device
mesh) or over gloo ranks in subprocesses. Tolerances:

- realistic_window_problem and the host sharding are numpy in both
  packages: equal, atol 0;
- one shard step's partials (Hpp, bp, S_corr, b_corr) against JAX's
  ``_local_schur`` on the same shard: f32 sums in another order (sorted
  segmented sums against scatters), within 1e-4 of each array's largest
  entry;
- whole solves: poses within 5e-4 rad and m (tests/test_dist_ba.py's
  tolerance for another reduction order), the cost within 1e-3 relative;
- gloo ranks against the in-process shards: within 1e-5 (the port sums
  the partials across shards and ranks in f64, so in practice they are
  equal).

Counterparts of tests/test_dist_ba.py's six cases come first.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch import interop
from ov2slam_torch.entry import dryrun_multichip
from ov2slam_torch.mapping.store import BAProblem
from ov2slam_torch.parallel import dist_ba as tdb
from ov2slam_torch.parallel import problems as tpr
from ov2slam_torch.parallel import worker
from ov2slam_torch.solvers.ba import ba_solve as t_ba_solve
from ov2slam_torch.utils import lie as tlie
from ov2slam_tpu.parallel import dist_ba as jdb
from ov2slam_tpu.parallel import problems as jpr
from ov2slam_tpu.solvers import ba as jba
from ov2slam_tpu.utils import lie as jlie
from ov2slam_tpu.utils import lie_np
from tests.test_dist_ba import to_problem
from tests.test_solvers import perturb, pose_errors, synth_ba_problem

torch.set_num_threads(1)

TH = 5.9915
FIELDS = ("kf_ids", "kf_poses", "kf_fixed", "lm_ids", "lm_pos", "obs_kf",
          "obs_lm", "obs_px", "obs_cam", "obs_valid")


def tparams(jparams):
    return interop.ba_params(*(np.asarray(getattr(jparams, k)) for k in
                               ("fx", "fy", "cx", "cy", "T_rl")),
                             device="cpu")


def synth(rng, n_kf, n_lm):
    gt, lms, obs = synth_ba_problem(rng, n_kf=n_kf, n_lm=n_lm)
    poses0, lms0, fixed = perturb(rng, gt, lms)
    jprob = to_problem(gt, lms, obs, poses0, lms0, fixed)
    tprob = interop.ba_problem(dataclasses.asdict(jprob))
    return gt, lms, jprob, tprob, obs["params"]


def mean_t(poses, prob, gt):
    live = prob.kf_ids >= 0
    _, t = lie_np.pose_distance(poses[live].astype(np.float64),
                                gt[: live.sum()].astype(np.float64))
    return float(np.mean(t))


def assert_poses_close(a, b, tol=5e-4):
    rot, tr = lie_np.pose_distance(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64))
    assert np.max(tr) < tol and np.max(rot) < tol, (np.max(tr), np.max(rot))


@pytest.fixture(scope="module")
def window3():
    """The 28-KF window of test_distributed_on_realistic_mapstore_window
    (seed 3), built by both packages."""
    _, jprob, jparams, gt = jpr.realistic_window_problem(28, 6000, seed=3)
    _, tprob, params, tgt = tpr.realistic_window_problem(28, 6000, seed=3,
                                                         device="cpu")
    return jprob, jparams, tprob, params, gt, tgt


@pytest.fixture(scope="module")
def jax_window3(window3):
    """The JAX package's 8-device solve of that window, 6 iterations."""
    jprob, jparams = window3[:2]
    return jdb.distributed_ba_solve(jdb.make_mesh(), jprob, jparams,
                                    robust_th=TH, iters=6)


# ------------------------------------- counterparts of test_dist_ba.py #

def test_step_sees_8_shards(window3):
    """test_mesh_has_8_devices: the mesh the JAX test builds has 8
    devices; the port's 8-shard mesh puts 8 shards in this process and
    its step gives partials with a leading axis of 8."""
    assert len(jdb.make_mesh().devices.flat) == 8
    _, _, prob, params, _, _ = window3
    mesh = tdb.make_mesh(8)
    assert (mesh.n_shards, mesh.local_shards, mesh.world_size) == (8, 8, 1)
    sh = tdb.put_sharded(mesh, tdb.shard_ba_problem(prob, 8), 28, "cpu")
    assert sh.n == 8
    T_cw = tlie.pose_inverse(torch.as_tensor(prob.kf_poses))
    free = torch.as_tensor(~prob.kf_fixed).float()
    parts, _ = tdb.shard_partials(T_cw, sh.lm_pos, torch.tensor(1e-3), sh,
                                  free, params, TH)
    assert [tuple(p.shape) for p in parts] == [
        (8, 28, 6, 6), (8, 28, 6), (8, 28, 28, 6, 6), (8, 28, 6), (8,)]


def test_distributed_matches_ground_truth(rng):
    gt, lms, _, prob, jparams = synth(rng, 6, 160)
    poses, new_lms, _ = tdb.distributed_ba_solve(
        8, prob, tparams(jparams), robust_th=TH, iters=10, device="cpu")
    rot_err, t_err = pose_errors(poses, gt)
    assert t_err < 2e-3, t_err
    assert rot_err < 1e-3
    assert np.median(np.linalg.norm(new_lms - lms, axis=-1)) < 5e-3


def test_distributed_matches_single_device(rng):
    _, _, _, prob, jparams = synth(rng, 5, 100)
    params = tparams(jparams)
    d_poses, _, _ = tdb.distributed_ba_solve(8, prob, params, robust_th=TH,
                                             iters=5, device="cpu")
    s_poses, _, _, _ = t_ba_solve(
        *(torch.as_tensor(getattr(prob, k)) for k in (
            "kf_poses", "kf_fixed", "lm_pos", "obs_kf", "obs_lm", "obs_px",
            "obs_cam", "obs_valid")), params, robust_th=TH, iters=5)
    assert_poses_close(d_poses, s_poses.numpy())


def test_shard_partition_covers_all(rng):
    _, _, _, prob, _ = synth(rng, 4, 64)
    shard = tdb.shard_ba_problem(prob, 8)
    assert shard["obs_valid"].sum() == prob.obs_valid.sum()
    per = shard["lm_ids"].shape[1]
    for s in range(8):
        ok = shard["obs_valid"][s]
        assert (shard["obs_lm"][s][ok] < per).all()
        assert (shard["obs_lm"][s][ok] >= 0).all()


def test_balanced_sharding_bounds_padding_under_skew(rng):
    n_kf, n_lm = 16, 512
    rows = [(k, l) for l in range(32) for k in range(n_kf)]
    for l in range(32, n_lm):
        for k in rng.choice(n_kf, int(rng.integers(1, 4)), replace=False):
            rows.append((int(k), l))
    O = len(rows)
    prob = BAProblem(
        kf_ids=np.arange(n_kf, dtype=np.int32),
        kf_poses=np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
                         (n_kf, 1)),
        kf_fixed=np.zeros(n_kf, bool),
        lm_ids=np.arange(n_lm, dtype=np.int32),
        lm_pos=np.zeros((n_lm, 3), np.float32),
        obs_kf=np.array([r[0] for r in rows], np.int32),
        obs_lm=np.array([r[1] for r in rows], np.int32),
        obs_px=np.zeros((O, 2), np.float32),
        obs_cam=np.zeros(O, np.int8),
        obs_valid=np.ones(O, bool))
    shard = tdb.shard_ba_problem(prob, 8)
    assert tdb.shard_padding_overhead(shard) <= 0.15
    assert shard["obs_valid"].sum() == O


def test_distributed_on_realistic_mapstore_window(window3):
    _, _, prob, params, gt, _ = window3
    assert int(prob.obs_valid.sum()) > 10_000
    poses, _, cost = tdb.distributed_ba_solve(8, prob, params, robust_th=TH,
                                              iters=6, device="cpu")
    assert mean_t(poses, prob, gt) < 0.35 * mean_t(prob.kf_poses, prob, gt)
    _, _, _, s_cost = t_ba_solve(
        *(torch.as_tensor(getattr(prob, k)) for k in (
            "kf_poses", "kf_fixed", "lm_pos", "obs_kf", "obs_lm", "obs_px",
            "obs_cam", "obs_valid")), params, robust_th=TH, iters=6)
    assert cost < 1.05 * float(s_cost)


# ------------------------------------------------ parity with the JAX side #

@pytest.mark.parametrize("seed,skew,n_kf,n_lm", [
    (0, 0.0, 28, 6000), (1, 0.25, 28, 6000), (3, 0.0, 28, 6000),
    (2, 0.0, 12, 1500)])
def test_realistic_window_problem_equals_jax(seed, skew, n_kf, n_lm):
    jstore, jprob, jparams, jgt = jpr.realistic_window_problem(
        n_kf, n_lm, seed=seed, skew=skew)
    tstore, tprob, params, tgt = tpr.realistic_window_problem(
        n_kf, n_lm, seed=seed, skew=skew, device="cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tprob, k), getattr(jprob, k),
                                      err_msg=k)
    np.testing.assert_array_equal(tgt, jgt)
    for k in ("fx", "fy", "cx", "cy", "T_rl"):
        np.testing.assert_array_equal(getattr(params, k).numpy(),
                                      np.asarray(getattr(jparams, k)))
    assert params.intr == (tpr.FX, tpr.FY, tpr.CX, tpr.CY)
    assert params.fx.device.type == "cpu"
    assert tstore.n_keyframes == jstore.n_keyframes == n_kf


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_ba_problem_equals_jax(window3, n_shards):
    jprob, _, tprob = window3[:3]
    j = jdb.shard_ba_problem(jprob, n_shards)
    t = tdb.shard_ba_problem(tprob, n_shards)
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert tdb.shard_padding_overhead(t) == jdb.shard_padding_overhead(j)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_shard_partials_equal_jax_local_schur(window3, n_shards):
    """Each shard's Hpp, bp, S_corr and b_corr, all shards in one batched
    step, against JAX's ``_local_schur`` on that shard alone (weights as
    ``_iteration_sharded`` makes them), at a damped, perturbed state."""
    jprob, jparams, tprob, params = window3[:4]
    shard_np = tdb.shard_ba_problem(tprob, n_shards)
    sh = tdb.put_sharded(tdb.make_mesh(n_shards), shard_np, 28, "cpu")
    lam = 1e-2
    T_cw = tlie.pose_inverse(torch.as_tensor(tprob.kf_poses))
    free = torch.as_tensor(~tprob.kf_fixed).float()
    parts, _ = tdb.shard_partials(T_cw, sh.lm_pos, torch.tensor(lam), sh,
                                  free, params, TH)
    jT = jlie.pose_inverse(jnp.asarray(jprob.kf_poses))
    jfree = jnp.asarray(~jprob.kf_fixed, jnp.float32)
    for s in range(n_shards):
        obs_kf = jnp.maximum(jnp.asarray(shard_np["obs_kf"][s]), 0)
        args = (obs_kf, jnp.asarray(shard_np["obs_lm"][s]),
                jnp.asarray(shard_np["obs_px"][s]),
                jnp.asarray(shard_np["obs_cam"][s]))
        pts = jnp.asarray(shard_np["lm_pos"][s])
        r, _, _, dok = jba._residuals_jacobians(jT, pts, *args, jparams)
        w = (jnp.asarray(shard_np["obs_valid"][s], jnp.float32)
             * jba._huber_weight(jnp.sum(r * r, -1), TH) * dok)
        ref = jdb._local_schur(jT, pts, jnp.float32(lam), *args, w, jfree,
                               jparams)[:4]
        for name, got, want in zip(("Hpp", "bp", "S_corr", "b_corr"),
                                   parts[:4], ref):
            want = np.asarray(want)
            scale = float(np.abs(want).max())
            assert scale > 0, name
            np.testing.assert_allclose(got[s].numpy(), want, rtol=0,
                                       atol=1e-4 * scale,
                                       err_msg=f"shard {s} {name}")


def test_solve_equals_jax_on_synth_problem(rng):
    gt, _, jprob, tprob, jparams = synth(rng, 6, 160)
    j_poses, j_lms, j_cost = jdb.distributed_ba_solve(
        jdb.make_mesh(), jprob, jparams, robust_th=TH, iters=5)
    t_poses, t_lms, t_cost = tdb.distributed_ba_solve(
        8, tprob, tparams(jparams), robust_th=TH, iters=5, device="cpu")
    assert_poses_close(t_poses, j_poses)
    np.testing.assert_allclose(t_lms, j_lms, atol=5e-4)
    assert t_cost == pytest.approx(j_cost, rel=1e-3, abs=1e-3)


def test_solve_equals_jax_on_the_realistic_window(window3, jax_window3):
    _, _, prob, params, gt, _ = window3
    j_poses, j_lms, j_cost = jax_window3
    t_poses, t_lms, t_cost = tdb.distributed_ba_solve(
        8, prob, params, robust_th=TH, iters=6, device="cpu")
    assert_poses_close(t_poses, j_poses)
    assert t_cost == pytest.approx(j_cost, rel=1e-3)
    assert mean_t(t_poses, prob, gt) == pytest.approx(
        mean_t(j_poses, prob, gt), abs=5e-4)
    live = prob.lm_ids >= 0
    assert np.median(np.abs(t_lms[live] - j_lms[live])) < 5e-4


def test_solve_is_deterministic(window3):
    """Two runs of one problem agree bit for bit, at 8 shards and at 3
    (whose last shard is padded)."""
    _, _, prob, params, _, _ = window3
    for n in (8, 3):
        a = tdb.distributed_ba_solve(n, prob, params, iters=3, device="cpu")
        b = tdb.distributed_ba_solve(n, prob, params, iters=3, device="cpu")
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]


@pytest.mark.parametrize("world_size", [2, 4])
def test_gloo_ranks_equal_in_process_shards(window3, tmp_path, world_size):
    """8 shards over 2 or 4 gloo ranks in subprocesses (file:// rendezvous
    under tmp_path, a timeout per process) give the in-process 8-shard
    result."""
    _, _, prob, params, _, _ = window3
    want = tdb.distributed_ba_solve(8, prob, params, iters=3, device="cpu")
    got = worker.run_ranks(prob, params, str(tmp_path), world_size, 8,
                           iters=3, device="cpu",
                           timeout=120, env={"OMP_NUM_THREADS": "1"})
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    assert got[2] == pytest.approx(want[2], rel=1e-5)


def test_init_multihost_does_nothing_unconfigured(monkeypatch):
    import torch.distributed as dist

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tdb.init_multihost() is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="split evenly"):
        tdb.make_mesh(0)


def test_dryrun_multichip_on_cpu(capsys):
    """The entry point's two 28-KF problems pass the JAX dryrun's checks
    at 8 in-process shards, and it names the GPU by default."""
    out = dryrun_multichip(8, device="cpu")
    assert out["uniform"]["obs"] >= 10_000
    assert out["skewed"]["padding"] < 0.15
    for r in out.values():
        assert r["t_err_after"] < r["t_err_before"]
        assert np.isfinite(r["cost"])
    text = capsys.readouterr().out
    assert "dryrun_multichip(8) uniform" in text
    assert "dryrun_multichip(8) skewed" in text


def test_entry_points_default_to_gpu(monkeypatch, window3, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpr.realistic_window_problem(4, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
    prob, params = window3[2], window3[3]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdb.distributed_ba_solve(8, prob, params, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.run_ranks(prob, params, str(tmp_path), 2, 8, iters=1)
    assert not list(tmp_path.iterdir())    # no rank was started
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main([str(tmp_path / "p.npz"), str(tmp_path / "o.npz"),
                     "--init-method", f"file://{tmp_path}/pg", "--rank",
                     "0", "--world-size", "1", "--n-shards", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdb.init_multihost(f"file://{tmp_path}/pg", 1, 0)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_chip_smoke_slice_i_work_counts(window3):
    """chip_smoke's slice I: its problems are the dryrun's and the 64-KF
    window; the bound's sparse count equals a brute-force count of the
    solver's blocks on the 28-KF window; a cross-process reduction
    carries 8 B per value of Hpp, bp, S_corr, b_corr and the two costs."""
    import chip_smoke

    names = [p[0] for p in chip_smoke.SLICE_I_PROBLEMS]
    assert names == ["dryrun", "dryrun_skewed", "window64"]
    assert chip_smoke.SLICE_I_PROBLEMS[2][1] == dict(n_kf=64, n_lm=12000,
                                                     seed=0)
    _, _, prob, _, _, _ = window3
    shard_np = tdb.shard_ba_problem(prob, 8)
    w = chip_smoke.dist_ba_work(prob, shard_np, iters=5)
    v = prob.obs_valid
    kf_of = {}
    for l, k in zip(prob.obs_lm[v], prob.obs_kf[v]):
        kf_of.setdefault(int(l), set()).add(int(k))
    pairs = sum(len(s) for s in kf_of.values())
    co = sum(len(s) ** 2 for s in kf_of.values())
    macs = int(v.sum()) * 144 + pairs * 90 + co * 108
    assert w["ops"] == 2 * macs + 2 * (6 * 28) ** 3 / 3
    assert (w["lm_pose_pairs"], w["window_landmarks"]) == (pairs,
                                                          len(kf_of))
    n, per_lm = shard_np["lm_pos"].shape[:2]
    assert w["dense_ops"] == 2 * n * per_lm * 28 * 28 * 108
    assert w["bound_by"] == "operations"
    Kw = 64
    assert chip_smoke.reduction_bytes(Kw) == 8 * (
        36 * Kw + 6 * Kw + 36 * Kw * Kw + 6 * Kw + 2)


def test_chip_smoke_fb_klt_bound():
    """The fb-KLT bound of entry()'s call: the pixels its patches touch
    are at most both pyramids and at least one template per keypoint;
    the dependent chain is 5 level passes, each a setup and 30 steps."""
    import chip_smoke
    from ov2slam_torch.entry import entry_arrays

    _, _, kps = entry_arrays()
    shapes = [(480, 752), (240, 376), (120, 188), (60, 94)]
    b = chip_smoke.fb_klt_bound(kps, shapes)
    assert 256 * 11 * 11 <= b["pixels_read"] <= 2 * sum(
        h * w for h, w in shapes)
    assert b["ops"] == 256 * 5 * (11 * 11 * 8 + 81 * 10
                                  + 30 * (81 * 13 + 12))
    assert b["chain_estimate_ms"] == pytest.approx(
        1e3 * 5 * (chip_smoke.KLT_SETUP_CYCLES
                   + 30 * chip_smoke.KLT_CHAIN_CYCLES) / chip_smoke.SM_CLOCK_HZ)
    assert b["bound_ms"] == pytest.approx(1e3 * max(
        b["ops"] / chip_smoke.F32_FLOP_PER_S,
        b["bytes"] / chip_smoke.HBM_BYTES_PER_S))
