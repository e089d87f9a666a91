"""Parity of the port's host utilities with ov2slam_tpu.

- the numpy-only modules the port copies stay verbatim copies (only their
  import lines may differ);
- the port's native map core (built from native/mapcore.cpp into
  build/ov2slam_torch/) gives the same answers as the JAX package's;
- the port's profiler records the same scope statistics.
"""

import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ["utils/config.py", "utils/lie_np.py", "utils/trajectory.py",
          "utils/evaluation.py", "utils/profiles.py", "mapping/store.py",
          "io/synthetic.py", "io/euroc.py"]


def _body(path):
    src = open(path).read().splitlines()
    return [l for l in src if not re.match(r"\s*(from|import)\s", l)]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_are_verbatim(rel):
    assert _body(os.path.join(ROOT, "ov2slam_torch", rel)) == \
        _body(os.path.join(ROOT, "ov2slam_tpu", rel))


def test_native_map_core_matches():
    from ov2slam_torch import native as tn
    from ov2slam_tpu import native as jn

    assert tn.AVAILABLE
    rng = np.random.default_rng(0)
    obs_lmid = rng.integers(-1, 50, (8, 16)).astype(np.int32)
    valid = rng.random(50) < 0.8
    window = np.array([0, 2, 5], np.int32)
    a = tn.count_window_lms(window, obs_lmid, valid)
    if jn.AVAILABLE:
        np.testing.assert_array_equal(
            a, jn.count_window_lms(window, obs_lmid, valid))
    ref = np.zeros(50, np.int32)
    for k in window:
        for l in obs_lmid[k]:
            if l >= 0 and valid[l]:
                ref[l] += 1
    np.testing.assert_array_equal(a, ref)


def test_profiler_records_like_jax():
    import jax.numpy as jnp

    from ov2slam_torch.utils.profiler import Profiler as TP
    from ov2slam_tpu.utils.profiler import Profiler as JP

    stats = []
    for P, sync in ((JP, jnp.ones(3)), (TP, torch.ones(3))):
        p = P()
        for _ in range(3):
            p.start("a")
            p.stop("a", sync=sync)
            with p.scope("b"):
                pass
        p.stop("never-started")
        stats.append({k: v["n"] for k, v in p.stats().items()})
        assert p.summary().splitlines()[0].split() == [
            "scope", "calls", "mean", "ms", "std", "min", "max"]
        p.reset()
        assert p.stats() == {}
    assert stats[0] == stats[1] == {"a": 3, "b": 3}


def test_profiler_times_one_scope_on_two_threads():
    # the asynchronous manager's worker and front end can time the same
    # scope at once: each thread's start is its own, so both count and
    # neither interval is taken from the other's start
    import threading
    import time

    from ov2slam_torch.utils.profiler import Profiler

    p = Profiler()
    a_started, b_stopped = threading.Event(), threading.Event()

    def a():
        p.start("2.KF_StereoMap")
        a_started.set()
        b_stopped.wait(5)
        time.sleep(0.05)
        p.stop("2.KF_StereoMap")

    t = threading.Thread(target=a)
    t.start()
    a_started.wait(5)
    p.start("2.KF_StereoMap")       # would overwrite a's start if shared
    p.stop("2.KF_StereoMap")
    b_stopped.set()
    t.join(5)
    assert not t.is_alive()
    st = p.stats()["2.KF_StereoMap"]
    assert st["n"] == 2
    assert st["max_ms"] >= 50.0      # a's interval runs from a's own start
    assert st["min_ms"] < 50.0
