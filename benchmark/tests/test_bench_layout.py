"""The benchmark finds every cell, configuration, traffic kind and metric
by its name, and a new cell is added by files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys

from benchmark import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_config_kind_and_metric_is_found_by_name():
    bench = common.spec()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = common.workload(w["name"])
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert cell["chips"] == w["chips"]
        assert cell["config_file"]["name"] == w["config"]
        assert os.path.exists(os.path.join(common.ROOT,
                                           configs[w["config"]]["file"]))
        assert callable(common.traffic(cell["traffic"]["kind"]).run)
        assert w["traffic"] == cell["traffic"]["kind"]
    for m in bench["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def test_the_spec_keeps_to_its_own_rules():
    bench = common.spec()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in bench["workloads"]:
        cell = w["name"]
        mine = [m["name"] for m in common.cell_metrics(bench, cell, False)]
        assert "setup_s" in mine and len(mine) >= 2
        layer = common.cell_metrics(bench, cell, True)
        assert layer
        for m in layer:
            assert m["moves"] in mine
    assert all(x["workloads"] for x in bench["per_layer"])


DUMMY_KIND = '''
def run(cell, seed, seconds, trace, device, t_start):
    return dict(setup_s=0.25, attempted=4, failed=0,
                e2e={"dummy_rate": (float(cell["traffic"]["rate"]), "ops/s")},
                obs={"count": 3}, checks={"exact": (0.0, 0, "<=")},
                memory_peak=0, chips=1, trace=None)
'''
DUMMY_METRIC = '''
def read(obs):
    return 2.0 * obs["count"]
'''


def _copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(common.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), root)
    return root


def _files(top):
    return {os.path.relpath(os.path.join(dp, f), top):
            open(os.path.join(dp, f), "rb").read()
            for dp, _, fs in os.walk(top) if "__pycache__" not in dp
            for f in fs}


def _run(root, workload, trace):
    code = ("import sys; from benchmark import run; "
            f"a = run.parse(['--workload', '{workload}', '--seed', "
            f"'4294967311', '--seconds', '1', '--trace', '{trace}']); "
            "sys.exit(run.execute(a, 'cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out


def test_a_cell_is_added_by_new_files_and_entries_alone(tmp_path):
    root = _copy(tmp_path)
    before = _files(root / "benchmark")
    b = root / "benchmark"
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps(
        {"name": "dummy_cfg"}))
    (b / "workloads" / "dummy_cfg.mix.json").write_text(json.dumps(
        {"name": "dummy_cfg.mix", "config": "dummy_cfg", "chips": 1,
         "why": "a dummy", "traffic": {"kind": "dummy_kind", "rate": 7}}))
    (b / "traffic" / "dummy_kind.py").write_text(DUMMY_KIND)
    (b / "metrics" / "dummy_metric.py").write_text(DUMMY_METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_cfg", "source": "a dummy",
                            "file": "benchmark/configs/dummy_cfg.json",
                            "reduced": [], "why": "a dummy"})
    spec["workloads"].append({"name": "dummy_cfg.mix", "config": "dummy_cfg",
                              "traffic": "dummy_kind", "chips": 1,
                              "why": "a dummy"})
    spec["end_to_end"].append({"name": "dummy_rate", "unit": "ops/s",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["dummy_cfg.mix"]})
    spec["per_layer"].append({"name": "dummy_metric", "unit": "ops",
                              "better": "higher", "source": "program_counter",
                              "layer": "dummy", "moves": "dummy_rate",
                              "workloads": ["dummy_cfg.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    line = json.loads(_run(root, "dummy_cfg.mix", 0).stdout.splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"dummy_rate": {"value": 7.0, "unit": "ops/s"},
                               "setup_s": {"value": 0.25, "unit": "s"}}
    traced = json.loads(_run(root, "dummy_cfg.mix", 1).stdout
                        .splitlines()[-1])
    assert traced["metrics"] == {"dummy_metric": {"value": 6.0,
                                                  "unit": "ops"}}
    after = _files(b)
    assert all(after[p] == v for p, v in before.items())


def test_the_checks_end_stderr_and_the_line_ends_stdout(tmp_path):
    root = _copy(tmp_path)
    b = root / "benchmark"
    (b / "configs" / "dummy_cfg.json").write_text('{"name": "dummy_cfg"}')
    (b / "workloads" / "dummy_cfg.mix.json").write_text(json.dumps(
        {"name": "dummy_cfg.mix", "config": "dummy_cfg", "chips": 1,
         "why": "a dummy", "traffic": {"kind": "dummy_kind", "rate": 1}}))
    (b / "traffic" / "dummy_kind.py").write_text(DUMMY_KIND)
    out = _run(root, "dummy_cfg.mix", 0)
    assert out.stderr.splitlines()[-1] == "check exact: 0.0 (limit <= 0)"
    assert json.loads(out.stdout.splitlines()[-1])["checks"] == {
        "exact": {"value": 0.0, "limit": 0, "sense": "<="}}


def test_the_run_refuses_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "carla_rig.fuse", "--seed", "1", "--seconds", "1"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
