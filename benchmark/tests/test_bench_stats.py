"""The pooled rate and tail of the fleet, and the statistics they use."""

import numpy as np

from benchmark import common
from benchmark.traffic import slam_fleet

from .small import fleet_cell


def test_quantile_is_numpys_linear_one():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 100, 1001):
        v = rng.random(n).tolist()
        for q in (0.0, 0.5, 0.95, 1.0):
            assert abs(common.quantile(v, q) - np.quantile(v, q)) < 1e-12


def _session(index, frame_ms, stall_every=0, stall_ms=0.0, t0=100.0,
             seconds=2.0):
    """A session's report: frames back to back from t0, each ``frame_ms``,
    every ``stall_every``-th one ``stall_ms`` instead, past the window's
    end by one frame."""
    stamps, t, m = [], t0, 0
    while t < t0 + seconds:
        d = stall_ms if stall_every and m % stall_every == stall_every - 1 \
            else frame_ms
        stamps.append((t, t + d / 1e3))
        t += d / 1e3
        m += 1
    tracks = [dict(tracked=10, lost=0, far=0, off_p50=0.0, off_max=0.0)]
    return dict(index=index, stamps=stamps, end=t0 + seconds, peak=10,
                stats={"0.FE_dispatch": dict(n=4, mean_ms=2.0)},
                keyframes=0, frames=len(stamps), trace_frames=0,
                events=None, w=None, control=None, forbidden=[],
                numbers=dict(ate_rmse_m=0.01, clahe_max_err=0.0,
                             pyramid_max_err=0.0, tracks=tracks))


def _aggregate(results, errors=None):
    cell = fleet_cell(sessions=len(results) + len(errors or {}))
    return slam_fleet.aggregate(cell, results, errors or {}, 2.0, 1.0,
                                100.0, False)


def test_rate_and_tail_are_pooled_over_sessions_and_show_a_stall():
    # frames of 1/64 s, exact on the clock
    calm = _aggregate({0: _session(0, 15.625), 1: _session(1, 15.625)})
    rate = calm["e2e"]["slam_frames_per_s"][0]
    assert rate == 2 * 64
    assert calm["e2e"]["slam_frame_ms_p95"][0] == 15.625
    # every third frame of one session stalls for 62.5 ms
    stall = _aggregate({0: _session(0, 15.625),
                        1: _session(1, 15.625, stall_every=3,
                                    stall_ms=62.5)})
    assert stall["e2e"]["slam_frames_per_s"][0] < rate - 10
    assert stall["e2e"]["slam_frame_ms_p95"][0] > 50.0
    assert stall["attempted"] < calm["attempted"]
    assert stall["failed"] == 0


def test_frames_past_the_window_do_not_count():
    r = _session(0, 300.0, seconds=2.0)
    assert r["stamps"][-1][1] > r["end"]
    out = _aggregate({0: r})
    assert out["attempted"] == len(r["stamps"]) - 1
    assert out["e2e"]["slam_frames_per_s"][0] == (len(r["stamps"]) - 1) / 2


def test_a_failed_session_counts_and_refuses():
    sound = _session(0, 15.625)
    done = sum(b <= sound["end"] for _, b in sound["stamps"])
    out = _aggregate({0: sound}, errors={1: ("boom", 40)})
    assert out["failed"] == 40
    assert out["attempted"] == 40 + done
    assert not common.passes(out["checks"])
    # one that never reported fails as many frames as a sound one completed
    lost = _aggregate({0: sound}, errors={1: ("never reported", None)})
    assert lost["failed"] == done
    assert common.passes(_aggregate({0: _session(0, 15.625)})["checks"])


def test_the_mismatch_share_counts_lost_and_far_tracks():
    t = [dict(tracked=8, lost=1, far=1), dict(tracked=2, lost=0, far=0)]
    assert slam_fleet.mismatch_share(t) == 0.2
    assert slam_fleet.mismatch_share([]) == 1.0


def test_idle_share_and_gaps_merge_processes_on_one_clock():
    a = dict(device=[(0.0, 10.0, "kernel", "k1"), (20.0, 30.0, "kernel",
                                                   "k1")],
             host=[(10.0, 20.0, "cpu_op", "aten::mul")])
    b = dict(device=[(5.0, 25.0, "kernel", "k2")], host=[])
    tr = common.reduce_traces([a, b], 0.0, 40.0)
    assert abs(tr["busy_s"] - 30e-6) < 1e-12
    assert abs(common.idle_share(tr) - 25.0) < 1e-9
    assert tr["idle_gaps"][0][0] == "host: no traced call"
    assert len(tr["kernels"]) == 3
