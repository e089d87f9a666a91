"""``trace_slice.py``'s accounting of the hand kernels, on stand-in
profiler events (the card's trace cannot be taken here).

- each hand-kernel library's kernel names are the ``__global__`` kernels
  of its ``csrc`` source, and its wrappers count launches;
- :class:`trace_slice.HandKernelTimer` wraps every launch function each
  library exports (``kernels.entry_points``), counts each call once with
  the kernels it starts, counts nothing inside a capture or while
  inactive, and reads the wrappers' counters over the active frames only;
- the trace's hand kernels are grouped with every other kernel by the
  runtime call that launched them (device time from the device events),
  an eager one whose call the trace lacks by the timer's calls in order;
  host calls count each launch once (the trace's runtime calls, nothing
  added); ``hand_check`` holds the trace's kernels to the wrappers'
  launches times the kernels a launch starts, and its runtime calls to the
  counted launch calls' kernels.
"""

import os
import re
import types

import pytest
import torch

import trace_slice as ts
from ov2slam_torch import kernels

CPU_T = torch.autograd.DeviceType.CPU
CUDA_T = torch.autograd.DeviceType.CUDA


class Range:
    def __init__(self, start, us):
        self.start = start
        self._us = us

    def elapsed_us(self):
        return self._us


def ev(id_, name, device, start=0.0, us=0.0, parent=None):
    return types.SimpleNamespace(id=id_, name=name, device_type=device,
                                 cpu_parent=parent,
                                 time_range=Range(start, us))


def test_hand_kernels_are_the_sources_kernels():
    for lib, names in ts.HAND_KERNELS.items():
        with open(os.path.join(kernels.CSRC, f"{lib}.cu")) as f:
            text = f.read()
        found = set(re.findall(
            r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(",
            text))
        assert set(names) == found, lib
        assert lib in kernels.KERNELS


def test_hand_wrappers_count_launches():
    counts = ts.wrapper_launches()
    assert set(counts) == set(ts.HAND_KERNELS)
    assert all(isinstance(n, int) for n in counts.values())
    assert ts.kernels_per_launch("ba_normal_eq") == 2
    assert ts.kernels_per_launch("clahe") == 1


@pytest.mark.parametrize("name,lib", [
    ("void (anonymous namespace)::filter_kernel<1, 9, 9>(Params)",
     "separable_filter"),
    ("_ZN12_GLOBAL__N_114pyramid_kernelENS_9PyrParamsE", "separable_filter"),
    ("(anonymous namespace)::clahe_kernel<true>(Params)", "clahe"),
    ("void at::native::my_filter_kernel(float*)", None),
    ("void at::native::elementwise_kernel<128, 2>", None)])
def test_hand_kernel_of_names_only_the_hand_kernels(name, lib):
    assert ts.hand_kernel_of(name) == lib


def test_timer_wraps_every_entry_point_and_counts_each_call_once(
        monkeypatch):
    calls = []

    def fake_fn(name):
        def fn(*args):
            calls.append(name)
            return 0
        return fn

    libs = {}
    for lib in ts.HAND_KERNELS:
        libs[lib] = types.SimpleNamespace(**{
            fn: fake_fn(fn) for fn in kernels.entry_points(lib)})
    monkeypatch.setattr(kernels, "build_all", lambda names: 0.0)
    monkeypatch.setattr(kernels, "load", lambda name: libs[name])
    counters = {lib: 0 for lib in ts.HAND_KERNELS}
    monkeypatch.setattr(ts, "wrapper_launches", lambda: dict(counters))
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])

    with ts.HandKernelTimer() as hand:
        sf = libs["separable_filter"]
        assert set(vars(sf)) == set(kernels.entry_points("separable_filter"))
        sf.separable_pyramid_launch(1, 2)
        sf.separable_scharr_launch(1)
        sf.separable_filter_launch(1)
        libs["ba_normal_eq"].ba_normal_eq_launch(0, 0)
        counters["separable_filter"] += 3
        counters["ba_normal_eq"] += 1
        capturing[0] = True           # a capture: counted at its replays
        sf.separable_pyramid_launch(1, 2)
        capturing[0] = False
        hand.active = False           # outside the traced frames
        libs["clahe"].clahe_launch(0)
        counters["clahe"] += 5
        hand.active = True
        libs["clahe"].clahe_launch(0)
        counters["clahe"] += 1
    # every wrapped call reached the library; the originals are back
    assert calls.count("separable_pyramid_launch") == 2
    assert libs["clahe"].clahe_launch.__name__ == "fn"
    rows = hand.per_frame(2, {})
    assert rows["separable_filter"]["totals"]["launch_calls"] == 3
    assert rows["ba_normal_eq"]["totals"]["launched_kernels"] == 2
    assert rows["clahe"]["totals"]["launch_calls"] == 1
    assert hand.wrapper_delta["clahe"] == 1
    assert rows["separable_filter"]["launch_calls"] == 1.5


def _trace():
    """Stand-in events of one frame: a scope holding a port function that
    launches a torch kernel and two hand kernels (one of whose runtime
    calls the trace lacks), and a graph replay running a hand kernel."""
    scope = ev(1, "0.FE_dispatch", CPU_T)
    fn = ev(2, "fn core/image.py::build_pyramid", CPU_T, parent=scope)
    return [
        scope, fn,
        ev(10, "cudaLaunchKernel", CPU_T, parent=fn),
        ev(10, "void at::native::add_kernel", CUDA_T, 1.0, 2.0),
        ev(11, "cudaLaunchKernel", CPU_T, parent=fn),
        ev(11, "(anonymous namespace)::pyramid_kernel(PyrParams)", CUDA_T,
           2.0, 8.0),
        # no runtime call in the trace for this one
        ev(12, "(anonymous namespace)::clahe_kernel<true>(Params)", CUDA_T,
           3.0, 13.0),
        ev(13, "cudaGraphLaunch", CPU_T, parent=scope),
        ev(13, "void (anonymous namespace)::filter_kernel<1, 9, 9>(P)",
           CUDA_T, 4.0, 4.0),
    ]


def test_hand_kernels_grouped_with_the_rest_from_device_events():
    hand = types.SimpleNamespace(rows=[
        ("separable_filter", 1, "0.FE_dispatch", "core/image.py::x"),
        ("clahe", 1, "0.FE_dispatch", "core/image.py::clahe")])
    groups, by_order = ts.kernel_groups(_trace(), {"0.FE_dispatch"}, hand)
    assert by_order == 1
    assert groups["scope"]["0.FE_dispatch"] == (4, 27.0)
    f = groups["function"]
    assert f["core/image.py::build_pyramid"] == (2, 10.0)
    assert f["core/image.py::clahe"] == (1, 13.0)
    assert f["(models: 0.FE_dispatch)"] == (1, 4.0)
    # without the timer's calls the unjoined one is unattributed
    groups, by_order = ts.kernel_groups(_trace(), {"0.FE_dispatch"})
    assert by_order == 0 and groups["scope"]["(unattributed)"] == (1, 13.0)


def test_host_calls_count_each_launch_once():
    g = ts.host_call_groups(_trace(), {"0.FE_dispatch"})
    assert g["scope"] == {"0.FE_dispatch": 3}
    assert ts.runtime_calls(_trace(), 1) == {"cudaGraphLaunch": 1.0,
                                             "cudaLaunchKernel": 2.0}


def test_hand_events_and_check():
    traced = ts.hand_events(_trace())
    assert traced["separable_filter"] == dict(
        kernels=2, us=12.0, runtime_calls=1, in_graph=1, in_graph_us=4.0)
    assert traced["clahe"]["runtime_calls"] == 0
    hand = types.SimpleNamespace(
        rows=[("separable_filter", 1, "s", "f"), ("clahe", 1, "s", "f")],
        wrapper_delta={"separable_filter": 2, "clahe": 1})
    rows = ts.HandKernelTimer.per_frame(hand, 1, traced)
    check = ts.hand_check(rows)
    # the pyramid's launch and the graph's filter kernel: both counted
    # once; CLAHE's runtime call is missing from the trace
    assert check == {"separable_filter": True, "clahe": False,
                     "all": False}
    assert rows["separable_filter"]["device_ms"] == pytest.approx(0.012)
