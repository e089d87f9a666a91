"""Each cell's run, driven here on the CPU at a small size past the look for
a chip, comes out correct on the program as it is and not correct with the
timed path broken underneath: a step that leaves its state unchanged, half
of the work left out, an answer altered where it is produced. The SLAM
cell's runs also read its bfloat16 control, which its limits refuse."""

import time

import pytest

from benchmark import common
from benchmark.traffic import rig_fuse, slam_fleet

from .small import fleet_cell, fuse_cell

SEED = 2 ** 35 + 17


def _fuse(seconds=0.6):
    out = rig_fuse.run(fuse_cell(), SEED, seconds, False, "cpu",
                       time.perf_counter())
    assert out["attempted"] > 0
    return common.passes(out["checks"]), out


def test_fusion_sound_run_is_correct(one_thread):
    ok, out = _fuse()
    assert ok, out["checks"]
    assert all(v == 0 for v, _, _ in out["checks"].values())


def _patched_integrate(monkeypatch, make):
    from ov2slam_torch.mapping import tsdf

    monkeypatch.setattr(tsdf.TsdfVolume, "integrate",
                        make(tsdf.TsdfVolume.integrate))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_fusion_refuses_a_broken_timed_path(one_thread, monkeypatch, fault):
    def make(orig):
        calls = [0]

        def integrate(self, *a, **k):
            calls[0] += 1
            if fault == "state_unchanged" or (fault == "half_left_out"
                                              and calls[0] % 2):
                time.sleep(0.003)   # as long as an integration here
                return None
            orig(self, *a, **k)
            if fault == "answer_altered":
                self.tsdf[::97] += 1e-3
        return integrate

    _patched_integrate(monkeypatch, make)
    ok, out = _fuse()
    assert not ok, out["checks"]


def _fleet(control=False, seconds=4.0):
    out = slam_fleet.run(fleet_cell(), SEED, seconds, False, "cpu",
                         time.perf_counter(), inproc=True, control=control)
    return common.passes(out["checks"]), out


def test_fleet_sound_run_is_correct_and_its_control_is_refused(one_thread):
    ok, out = _fleet(control=True)
    assert ok, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    lim = common.workload("euroc_stereo.fleet")["check"]["limits"]
    ctrl = out["per_session"][0]["control"]
    assert ctrl["clahe_max_err"] > lim["clahe_max_err"]
    assert slam_fleet.mismatch_share(ctrl["tracks"]) > \
        lim["klt_mismatch_share"]


@pytest.mark.parametrize("fault", ["state_unchanged", "clahe_altered",
                                   "tracks_altered"])
def test_fleet_refuses_a_broken_timed_path(one_thread, monkeypatch, fault):
    from ov2slam_torch.models import frontend_step, slam

    if fault == "state_unchanged":
        orig = slam.SlamManager.process_frame
        warm = fleet_cell()["traffic"]["warmup_frames"]

        def process_frame(self, *a, **k):
            self._calls = getattr(self, "_calls", 0) + 1
            if self._calls <= warm:
                self._last = orig(self, *a, **k)
            return self._last
        monkeypatch.setattr(slam.SlamManager, "process_frame", process_frame)
    elif fault == "clahe_altered":
        orig_clahe = frontend_step.clahe
        monkeypatch.setattr(frontend_step, "clahe",
                            lambda img, clip: orig_clahe(img, clip) + 0.5)
    else:   # whichever KLT the front end calls, its answers move 0.25 px
        for name in ("fb_klt_track_split", "klt_track"):
            def shifted(*a, _orig=getattr(frontend_step, name), **k):
                out = _orig(*a, **k)
                return (out[0] + 0.25,) + tuple(out[1:])
            monkeypatch.setattr(frontend_step, name, shifted)
    ok, out = _fleet()
    assert not ok, out["checks"]


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card(cuda_device):
    import json
    import subprocess
    import sys

    for w in common.spec()["workloads"]:
        out = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload", w["name"],
             "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
            cwd=common.ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.splitlines()[-1])
        assert line["correct"], line["checks"]
