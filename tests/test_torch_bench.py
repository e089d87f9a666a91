"""The port's benchmark entry points against the root bench and ov2slam_tpu.

``ov2slam_torch/{bench,scaling_bench,protocol_bench}.py`` on the CPU at
small sizes (their card runs are ``chip_smoke.py``'s ``[bench]`` phase).
The root ``bench.py`` imports numpy only, so its problem builder is called
here directly; the root ``scaling_bench.py`` is not imported (it sets
JAX's platform and device count when imported), ``ov2slam_tpu``'s sharding
is. Tolerances:

- the BA problem and the shard loads are numpy in both packages: equal,
  atol 0;
- the BA stage's two-pass solve against the JAX solve: poses within 1e-3
  (test_torch_ba.py's tolerance), on the dense and the PCG branch;
- the place-index query: integer counts and one f32 division on both
  sides, so the top-3 ids and scores are equal.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from ov2slam_torch import bench as tbench
from ov2slam_torch import protocol_bench as tproto
from ov2slam_torch import scaling_bench as tscale
from ov2slam_torch.solvers import ba_invdepth as tbi
from ov2slam_tpu.solvers import ba_invdepth as jbi
from ov2slam_tpu.utils import lie_np
from tests.test_torch_package import ROOT, _imports, _sources

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("n_kf,n_lm,n_obs", [(25, 1200, 34870),
                                             (200, 8000, 357218)])
def test_synth_ba_problem_equals_the_root_bench(n_kf, n_lm, n_obs):
    """local_ba's and full_ba_pcg's problems, bit for bit."""
    j = jbench._synth_ba_problem(jnp, n_kf, n_lm)
    t = tbench.synth_ba_problem(n_kf, n_lm)
    assert t["n_obs"] == j["n_obs"] == n_obs
    for k in tbench.BA_ARGS + ("gt",):
        a = np.asarray(j[k])
        assert t[k].dtype == a.dtype and t[k].shape == a.shape, k
        np.testing.assert_array_equal(t[k], a, err_msg=k)
    _, params = tbench.ba_inputs(t, CPU)
    for k in ("fx", "fy", "cx", "cy", "T_rl"):
        np.testing.assert_array_equal(getattr(params, k).numpy(),
                                      np.asarray(getattr(j["params"], k)))


@pytest.mark.parametrize("path,n_kf", [("dense", 8), ("pcg", 9)])
def test_ba_stage_solve_matches_the_jax_solve(path, n_kf, monkeypatch):
    """The stage's two-pass solve on a small problem of the bench's
    generator. ``pcg`` lowers the dense threshold on both sides (as
    test_torch_ba.py does) at another size than ``dense``, so that JAX
    traces the solve anew; the port counts the branch where it runs."""
    if path == "pcg":
        monkeypatch.setattr(jbi, "DENSE_SCHUR_MAX_KFS", 4)
        monkeypatch.setattr(tbi, "DENSE_SCHUR_MAX_KFS", 4)
    j = jbench._synth_ba_problem(jnp, n_kf, 300)
    jout = jbi.ba_solve_invdepth_two_pass(
        *(j[k] for k in tbench.BA_ARGS), j["params"], robust_th=5.9915,
        iters_robust=5, iters_l2=3)
    prob = tbench.synth_ba_problem(n_kf, 300)
    args, params = tbench.ba_inputs(prob, CPU)
    calls0 = tbi._solve_iteration_inv_cg.calls
    tout = tbench.ba_solve(args, params, 5, 3)
    assert tbi._solve_iteration_inv_cg.calls - calls0 == (
        8 if path == "pcg" else 0)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=1e-3)
    _, tr = lie_np.pose_distance(tout[0].numpy().astype(np.float64),
                                 prob["gt"])
    assert tr.max() < tbench.LOCAL_BA["max_terr"]


def test_lc_query_matches_the_jax_index():
    """A 128-keyframe store of 64 descriptors, the target inside it: the
    port's and the JAX index's top 3, ids and scores, are equal."""
    from ov2slam_tpu.loopclosure.index import PlaceIndex

    _, descs, q, qv = tbench.lc_problem(128, 64, target=100)
    tidx = tbench.lc_index(descs, CPU)
    jidx = PlaceIndex(capacity=128, recent_mask=30)
    for i in range(128):
        jidx.add(i, descs[i], np.ones(64, bool))
    hits = tidx.query_best(q, qv, top_k=3)
    assert hits == jidx.query_best(q, qv, top_k=3)
    assert len(hits) == 3 and hits[0][0] == 100


class FakeClock:
    """A clock that moves only when the loop sleeps or a frame is
    processed (frame i takes ``cost[i]`` seconds)."""

    def __init__(self, cost):
        self.t, self.cost, self.sleeps = 0.0, cost, []

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.sleeps.append(dt)
        self.t += dt

    def process(self, i):
        self.t += self.cost[i]


# (frames, warm, fps, {frame: seconds} of the slow frames (the rest take
# 0.05 s), processed indices, dropped) — worked by hand from the rule: a
# frame more than one interval late skips to the newest arrival,
# int(lateness / interval) frames on, never past the last frame
SCHEDULES = {
    "never behind": (10, 2, 10.0, {}, list(range(2, 10)), 0),
    # frame 2 takes 3.5 intervals: frame 3 is due at 0.3 s and taken at
    # 0.55 s, 2.5 intervals late, so frames 3 and 4 are dropped
    "one stall of 3.5 intervals": (12, 0, 10.0, {2: 0.35},
                                   [0, 1, 2, 5, 6, 7, 8, 9, 10, 11], 2),
    # the last frame is never dropped, however late
    "a stall before the last frame": (6, 0, 10.0, {4: 0.35},
                                      [0, 1, 2, 3, 4, 5], 0),
    # 2.5 intervals late one frame before the last: only one to drop
    "a stall two frames before the last": (6, 0, 10.0, {3: 0.35},
                                           [0, 1, 2, 3, 5], 1),
    "flat out": (8, 3, None, {3: 0.35}, list(range(3, 8)), 0),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_paced_replay_under_a_fake_clock(name):
    n, warm, fps, slow, processed, dropped = SCHEDULES[name]
    fake = FakeClock([slow.get(i, 0.05) for i in range(n)])
    arr = tbench.paced_replay(list(range(n)), fake.process, warm, fps,
                              clock=fake.clock, sleep=fake.sleep)
    assert arr.processed == processed
    assert arr.n_dropped == dropped
    np.testing.assert_allclose(arr.walls, [fake.cost[i] for i in processed])
    assert arr.t_start == 0.0
    if fps is None:
        assert fake.sleeps == []


@pytest.fixture(scope="module")
def windows():
    """The scaling bench's 28-KF window, plain and skewed, from each
    package's own builder."""
    from ov2slam_torch.parallel import problems as tpr
    from ov2slam_tpu.parallel import problems as jpr

    out = {}
    for skew in (0.0, tscale.SKEW):
        _, j, _, _ = jpr.realistic_window_problem(**tscale.WINDOW, skew=skew)
        _, t, _, _ = tpr.realistic_window_problem(**tscale.WINDOW, skew=skew,
                                                  device="cpu")
        out[skew] = (j, t)
    return out


def test_scaling_bench_loads_match_the_jax_sharding(windows):
    """obs_per_shard, efficiency and padding at 1/2/4/8 shards, and the
    skewed row's balanced and contiguous efficiencies, against what
    ov2slam_tpu's shard_ba_problem / shard_padding_overhead give."""
    from ov2slam_tpu.parallel import dist_ba as jdb

    j, t = windows[0.0]
    n_obs = int(np.sum(j.obs_valid))
    for n in tscale.SHARDS:
        js = jdb.shard_ba_problem(j, n)
        per = int(js["obs_valid"].shape[1])
        _, fig = tscale.shard_figures(t, n)
        assert fig == dict(obs_per_shard=per, efficiency=(n_obs / n) / per,
                           padding=jdb.shard_padding_overhead(js))
    j, t = windows[tscale.SKEW]
    n = tscale.SHARDS[-1]
    n_obs = int(np.sum(j.obs_valid))
    js = jdb.shard_ba_problem(j, n)
    counts = np.bincount(np.maximum(j.obs_lm, 0)[j.obs_valid],
                         minlength=len(j.lm_ids))
    contig = max(int(counts[b].sum())
                 for b in np.array_split(np.arange(len(counts)), n))
    _, row = tscale.skew_figures(t, n)
    assert row == dict(n_shards=n, n_obs=n_obs,
                       efficiency=(n_obs / n) / js["obs_valid"].shape[1],
                       padding=jdb.shard_padding_overhead(js),
                       contiguous_efficiency=(n_obs / n) / contig)
    assert row["efficiency"] > row["contiguous_efficiency"]


@pytest.fixture
def small_stages(monkeypatch):
    monkeypatch.setitem(tbench.LOCAL_BA, "n_kf", 8)
    monkeypatch.setitem(tbench.LOCAL_BA, "n_lm", 300)
    monkeypatch.setitem(tbench.LOCAL_BA, "reps", 1)
    for k, v in dict(n_store=128, n_kp=64, reps=2, queries=2,
                     rounds=1).items():
        monkeypatch.setitem(tbench.LC_QUERY, k, v)


# the root bench's recorded keys of these stages, less its bf16-peak
# share ("mfu"), which the port reports against the H100's int8 and f32
# peaks on the card only
JAX_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "stages"}
JAX_STAGE_KEYS = {"local_ba": {"value", "unit", "vs_baseline", "solve_ms"},
                  "lc_query": {"value", "unit", "vs_baseline",
                               "qps_device"}}


def test_bench_main_prints_one_line_on_the_cpu(small_stages, capsys):
    detail = {}
    rc = tbench.main(["--device", "cpu", "--stage", "local_ba,lc_query"],
                     detail=detail)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 1
    line = json.loads(out[0])
    assert set(line) == JAX_LINE_KEYS | {"device"}
    assert line["device"] == "cpu" and line["metric"] == "failed"
    for name, keys in JAX_STAGE_KEYS.items():
        assert keys <= set(line["stages"][name]), name
        assert "error" not in line["stages"][name]
    assert line["stages"]["local_ba"]["branch"] == "dense"
    assert line["stages"]["lc_query"]["best"] == 100
    # no device metric from a CPU run
    assert "int8_share" not in line["stages"]["lc_query"]
    assert "f32_share" not in line["stages"]["local_ba"]
    assert tbench.nonfinite(line) == []
    assert detail["line"]["stages"].keys() == line["stages"].keys()


def test_bench_main_fails_when_a_stage_raises(small_stages, capsys,
                                              monkeypatch):
    def boom(b):
        raise ValueError("stage broke")

    monkeypatch.setitem(tbench.RUNNERS, "lc_query", boom)
    rc = tbench.main(["--device", "cpu", "--stage", "local_ba,lc_query"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc != 0
    assert line["stages"]["lc_query"]["error"] == "ValueError: stage broke"
    assert "error" not in line["stages"]["local_ba"]     # figures survive

    # an asynchronous stage whose worker raised is a failed stage
    monkeypatch.setitem(tbench.RUNNERS, "lc_query",
                        lambda b: {"value": 1.0, "n_worker_errors": 2})
    assert tbench.main(["--device", "cpu", "--stage", "lc_query"]) != 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["stages"]["lc_query"]["error"] == "2 worker errors"
    assert line["stages"]["lc_query"]["value"] == 1.0


def test_protocol_bench_records_failures(tmp_path, monkeypatch):
    """Every run is a record naming its device; a run that raises or whose
    worker raised is an error record, and the exit code is then 1."""
    import types

    seq = types.SimpleNamespace()
    monkeypatch.setattr(tproto, "render", lambda n, kind, seed: (seq, [],
                                                                 0.5))
    outcomes = iter([dict(fps_net=2.0, n_worker_errors=0),
                     dict(fps_net=2.0, n_worker_errors=0)])
    monkeypatch.setattr(tproto, "run_once", lambda *a: next(outcomes))
    out = tmp_path / "runs.jsonl"
    assert tproto.main(["--smoke", "--device", "cpu", "--out",
                        str(out)]) == 0
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(r["cell"], r["mode"], r["seed"], r["n_frames"]) for r in recs] \
        == [("fast_arc", "throughput", 100, 120),
            ("fast_arc", "online", 100, 120)]
    assert all(r["device"] == "cpu" and "error" not in r for r in recs)

    def fail(seq, frames, profile, use_lc, pace, dev):
        if pace:
            raise RuntimeError("lost")
        return dict(fps_net=2.0, n_worker_errors=1)

    monkeypatch.setattr(tproto, "run_once", fail)
    assert tproto.main(["--smoke", "--device", "cpu", "--out",
                        str(out)]) == 1
    recs = [json.loads(x) for x in out.read_text().splitlines()][2:]
    assert [r["error"] for r in recs] == ["1 worker errors",
                                          "RuntimeError: lost"]


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tbench.main, tscale.main, tproto.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


def test_all_reduce_timed_over_gloo_ranks(tmp_path):
    """The NCCL anchor's timing path, over two gloo ranks on the CPU."""
    from ov2slam_torch.parallel import worker
    from ov2slam_torch.roofline import reduction_bytes

    ms = worker.time_all_reduce(reduction_bytes(28), str(tmp_path), 2,
                                device="cpu", env={"OMP_NUM_THREADS": "1"})
    assert np.isfinite(ms) and ms > 0


@pytest.mark.parametrize("name", ["bench.py", "scaling_bench.py",
                                  "protocol_bench.py"])
def test_bench_modules_import_no_jax(name):
    path = os.path.join(ROOT, "ov2slam_torch", name)
    assert path in _sources()
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ov2slam_tpu", "bench",
                                  "scaling_bench", "chip_smoke")]
    assert not bad, bad
    text = open(path).read()
    for tpu_figure in ("819e9", "197e12", "45e9", "v5e", "ici_us"):
        assert tpu_figure not in text


def test_chip_smoke_bench_depth_names_the_bench_repetitions():
    """chip_smoke's [bench] phase cuts repetitions, never widths: the keys
    it overrides exist in the bench's stage settings and are counts of
    steps, windows and repetitions."""
    import chip_smoke

    for stage, over in chip_smoke.BENCH_DEPTH.items():
        assert set(over) <= set(getattr(tbench, stage)), stage
        assert set(over) <= {"steps", "windows", "reps"}, stage
    assert chip_smoke.BENCH_LC_SHAPE == (tbench.LC_QUERY["n_store"],
                                         tbench.LC_QUERY["n_kp"],
                                         tbench.LC_QUERY["n_kp"])
