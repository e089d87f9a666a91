"""The port's CUDA graphs of fixed-shape steps: ``ov2slam_torch/graphs.py``,
``solvers/ba_invdepth.GraphedTwoPass`` (local BA, unpacked and packed),
``models/frontend_step.detect_describe`` (keyframe detection) and the
mapper's steps (``models/mapper_step.map_steps``: stereo mapping, temporal
triangulation).

On the CPU: what the graphs rest on — the solve's residual-only cost is the
Jacobian pass's residuals bit for bit, the segment counts by ``index_add_``
equal ``bincount``, a solve padded to the graph's landmark capacity agrees
with the unpadded solve (poses 1e-4, points 1e-3, masks equal: eight LM
iterations carry the sums' other rounding) and returns the unpadded
shapes, the CPU never enters a graph, and detection with its threshold as a
0-d tensor (the graph's input) equals detection with the number, bit for
bit, for every detector; the collector stays off while any thread
captures, and a graphed step is no reference cycle.

On the card (skipped without one, decided inside the test): a replayed
solve, detection, stereo step and temporal step are bit-equal to the eager
call of the same shape, two problem sizes share one set of graphs, the
counters say which calls ran eagerly, captured or replayed, a KLT launch
inside the stereo graph counts at each replay, the packed solve replays
its caller's runner bit-equal to the unpacked runner, and a step's
function runs with the cyclic collector off while it is captured. The file
imports no JAX, so that ``python -m pytest --noconftest
tests/test_torch_graphs.py`` runs on the card.
"""

import numpy as np
import pytest
import torch

from ov2slam_torch import bench, graphs
from ov2slam_torch.models import frontend_step
from ov2slam_torch.ops import detect
from ov2slam_torch.solvers import ba_invdepth as bi
from ov2slam_torch.solvers.segment import SegmentSum

torch.set_num_threads(1)


def _problem(dev, n_kf=8, n_lm=150, seed=0):
    prob = bench.synth_ba_problem(n_kf, n_lm, seed=seed)
    return bench.ba_inputs(prob, dev)


def _fewer_landmarks(args, n):
    """The problem with its first ``n`` landmarks: the others' observation
    rows become padding (index -1, not valid)."""
    poses, fixed, rho, anchor, ray, okf, olm, opx, ocam, ovalid = args
    gone = olm >= n
    return (poses, fixed, rho[:n], anchor[:n], ray[:n],
            torch.where(gone, -1, okf), torch.where(gone, -1, olm), opx,
            ocam, ovalid & ~gone)


def _frame(seed=5):
    from ov2slam_torch.io.synthetic import generate_sequence

    seq = generate_sequence(n_frames=1, stereo=False, width=188, height=120,
                            n_points=800, seed=seed)
    return torch.as_tensor(seq.images_left[0].astype(np.float32))


def _calib(dev):
    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return frontend_step.CalibArrays(
        fx=t(100.0), fy=t(100.0), cx=t(94.0), cy=t(60.0),
        dist=t([0.01, -0.002, 0.0, 0.0]))


def _existing(dev, seed=1):
    rng = np.random.default_rng(seed)
    ex = rng.uniform([10, 10], [170, 110], size=(12, 2)).astype(np.float32)
    ok = np.ones(12, bool)
    ok[-3:] = False
    return (torch.as_tensor(ex, device=dev), torch.as_tensor(ok, device=dev))


def test_landmark_capacity():
    assert bi.landmark_capacity(10, 100) == 256
    assert bi.landmark_capacity(300, 100) == 512
    assert bi.landmark_capacity(256, 8192) == 4096
    assert bi.landmark_capacity(5000, 8192) == 5120


def test_residual_only_cost_is_the_jacobian_pass_residuals():
    """The LM loop takes the candidate's cost from the residual-only pass:
    its residuals and depth flags are the full pass's, bit for bit."""
    args, prm = _problem("cpu")
    s = bi._prepare(*args[:8], args[9], 1e-3, args[8])
    full = bi._residuals_jacobians_inv(
        s["T_cw"], s["rho"], s["anchor"], s["lm_ray"], s["obs_kf"],
        s["obs_lm"], s["obs_px"], args[8], prm)
    r, ok, _ = bi._project_inv(
        s["T_cw"], s["rho"], s["anchor"], s["lm_ray"], s["obs_kf"],
        s["obs_lm"], s["obs_px"], args[8], prm, rotations=False)
    assert torch.equal(r, full[0]) and torch.equal(ok, full[4])


def test_segment_counts_equal_bincount():
    idx = torch.as_tensor(np.random.default_rng(0).integers(0, 7, 300))
    assert torch.equal(SegmentSum(idx, 9).lengths,
                       torch.bincount(idx, minlength=9))
    assert torch.equal(SegmentSum(idx[:0], 4).lengths,
                       torch.zeros(4, dtype=torch.long))


def test_padded_solve_matches_unpadded():
    """The graph's first call (eager, on the padded problem) against the
    unpadded solve: extra landmark rows with no observation change the
    sums' grouping only."""
    args, prm = _problem("cpu")
    ref = bi._two_pass(args, prm, 5.9915, 5, 3, None)
    run = bi.GraphedTwoPass(args, prm, 5.9915, 5, 3)
    assert run.inputs[2].shape[0] == bi.landmark_capacity(
        args[2].shape[0], args[5].shape[0]) > args[2].shape[0]
    got = run(args)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), atol=1e-4)
    assert torch.equal(got[3], ref[3])
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-4)


def test_cpu_solve_and_step_never_capture():
    args, prm = _problem("cpu", n_kf=5, n_lm=60)
    n = (len(bi.GraphedTwoPass.cache), bi.GraphedTwoPass.eager)
    out = bi.ba_solve_invdepth_two_pass(*args, prm)
    assert (len(bi.GraphedTwoPass.cache), bi.GraphedTwoPass.eager) == n
    assert all(torch.equal(a, b) for a, b in zip(
        out, bi._two_pass(args, prm, 5.9915, 5, 3, None)))
    step = graphs.GraphedStep(lambda x, k=1: x * k)
    assert torch.equal(step(torch.ones(3), k=2), 2 * torch.ones(3))
    assert not step.cache and step.eager == 0


def test_collector_is_off_while_any_capture_runs():
    """:func:`graphs.collector_off` nests across threads: the cyclic
    collector stays off until the last holder leaves, then is as before;
    and a graphed step is no reference cycle of its own, so dropping it
    frees its graphs at once rather than at some later collection."""
    import gc
    import threading
    import weakref

    was = gc.isenabled()
    gc.enable()
    try:
        inside, leave = threading.Event(), threading.Event()

        def hold():
            with graphs.collector_off():
                inside.set()
                leave.wait(10)

        t = threading.Thread(target=hold)
        t.start()
        inside.wait(10)
        with graphs.collector_off():
            assert not gc.isenabled()
        assert not gc.isenabled()          # the other thread still holds
        leave.set()
        t.join(10)
        assert gc.isenabled()
        gc.disable()
        with graphs.collector_off():
            pass
        assert not gc.isenabled()          # left as it was found
        step = graphs.GraphedStep(lambda x: x)
        ref = weakref.ref(step)
        del step
        assert ref() is None               # freed without a collection
    finally:
        (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("detector,th", [("fast", 20.0), ("single", 0.01),
                                         ("gftt", 0.01)])
def test_detection_threshold_as_a_tensor_is_bit_equal(detector, th):
    img = _frame()
    px, valid = _existing("cpu")
    kw = dict(detector=detector, cell_size=16, max_out=128, fisheye=False)
    a = frontend_step.fused_detect_describe(img, px, valid, th,
                                            _calib("cpu"), **kw)
    b = frontend_step.fused_detect_describe(
        img, px, valid, torch.tensor(th, dtype=torch.float32),
        _calib("cpu"), **kw)
    assert b[1]["ok"].sum() > 10
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])


def test_grid_occupancy_counts_valid_rows_only():
    """Invalid existing keypoints occupy no cell: detecting with them
    equals detecting without them."""
    img = _frame()
    px, valid = _existing("cpu")
    resp = detect.fast_response(img, 20.0)
    a = detect.grid_detect(resp, px, valid, 0.0, 16, 128, refine=False)
    b = detect.grid_detect(resp, px[valid], valid[valid], 0.0, 16, 128,
                           refine=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cuda_graphed_solve_is_bit_equal_to_eager():
    dev = _cuda()
    args, prm = _problem(dev, n_kf=12, n_lm=300)
    run = bi.GraphedTwoPass(args, prm, 5.9915, 5, 3)
    calls = []
    outs = [run(args, between_iters=lambda: calls.append(1))
            for _ in range(3)]
    torch.cuda.synchronize()
    assert run.graphs is not None and len(run.graphs) == 5
    assert len(calls) == 3 * 8          # the yields of every solve
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
    # fewer landmarks, the same capacity: the same graphs replay, and
    # equal a fresh eager solve of that problem
    small = _fewer_landmarks(args, 200)
    graphs_before = run.graphs
    got = run(small)
    assert run.graphs is graphs_before
    want = bi.GraphedTwoPass(small, prm, 5.9915, 5, 3)(small)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cuda_graphed_detection_is_bit_equal_to_eager():
    dev = _cuda()
    img = _frame().to(dev)
    px, valid = _existing(dev)
    step = graphs.GraphedStep(frontend_step.fused_detect_describe)
    kw = dict(calib=_calib(dev), detector="fast", cell_size=16,
              max_out=128, fisheye=False)
    th = torch.full((), 20.0, device=dev)
    outs = [step(img, px, valid, th, **kw) for _ in range(3)]
    assert (step.eager, step.captures, step.replays) == (1, 1, 2)
    for out in outs[1:]:
        assert torch.equal(out[0], outs[0][0])
        assert all(torch.equal(out[1][k], outs[0][1][k]) for k in out[1])
    # the threshold is an input of the graph
    th2 = torch.full((), 40.0, device=dev)
    got = step(img, px, valid, th2, **kw)
    want = frontend_step.fused_detect_describe(img, px, valid, th2, **kw)
    assert torch.equal(got[0], want[0])


def _stereo_case(dev, n=96, seed=2):
    """A 188x120 stereo keyframe on ``dev``: the left pyramid, the right
    image, a packed state with every third row a 3D landmark, and the
    step's static arguments."""
    from ov2slam_torch.core.image import build_pyramid
    from ov2slam_torch.geometry.essential import essential_from_pose
    from ov2slam_torch.io.synthetic import generate_sequence
    from ov2slam_torch.models import mapper_step

    seq = generate_sequence(n_frames=1, stereo=True, width=188, height=120,
                            n_points=800, seed=seed)
    rng = np.random.default_rng(seed)
    px = rng.uniform([12, 12], [176, 108], (n, 2)).astype(np.float32)
    is3d = np.arange(n) % 3 == 0
    lm_pos = np.where(is3d[:, None], rng.uniform([-1, -1, 4], [1, 1, 8],
                                                 (n, 3)), 0.0)
    state = mapper_step.pack_stereo_state(
        px, lm_pos, rng.random(n) < 0.9, is3d, np.array([1, 0, 0, 0, 0, 0,
                                                         0.0]))
    left = torch.as_tensor(seq.images_left[0].astype(np.float32),
                           device=dev)
    T_lr = torch.as_tensor(np.asarray(seq.T_lr, np.float32), device=dev)
    calib = _calib(dev)._replace(dist=torch.zeros(4, device=dev))
    static = dict(T_lr=T_lr, E_lr=essential_from_pose(T_lr), calib_l=calib,
                  calib_r=calib, levels=3)
    return ((*build_pyramid(left, 3),
             torch.as_tensor(seq.images_right[0], device=dev),
             torch.as_tensor(state, device=dev)), static)


def test_cuda_graphed_stereo_step_is_bit_equal_and_counts_klt_launches():
    """Replays equal the eager step, and the eager step with the tracks'
    tail in its plain form (the eager operations it replaced); the capture
    launches no KLT kernel of its own, and each replay counts the one it
    holds, with this thread and stream; the graph holds one launch each of
    the right image's pyramid, the KLT and the tail kernels (the tail in
    place of the undistortion and the eight torch kernels around it),
    each counted at every replay; a new left pyramid is copied into the
    graph's inputs."""
    import threading

    from ov2slam_torch.core import camera
    from ov2slam_torch.models import mapper_step
    from ov2slam_torch.ops import klt

    dev = _cuda()
    tensors, static = _stereo_case(dev)
    step = graphs.GraphedStep(mapper_step._stereo_graph_fn)
    fns = (klt.klt_track, camera.undistort_normalize,
           camera.undistort_points)
    counts = [[f.launches for f in fns]]
    outs = []
    for _ in range(4):
        outs.append(step(*tensors, **static))
        counts.append([f.launches for f in fns])
    torch.cuda.synchronize()
    assert (step.eager, step.captures, step.replays) == (1, 1, 3)
    assert np.diff(counts, axis=0).tolist() == [[1, 1, 0]] * 4
    (entry,) = step.cache.values()
    assert sorted(fn.__name__ for fn, _ in entry["launches"]) == [
        "build_pyramid", "klt_track", "undistort_normalize"]
    key = (threading.current_thread().name,
           torch.cuda.current_stream(dev).cuda_stream)
    assert klt.klt_track.origins[key] >= 4
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    saved = mapper_step.undistort_normalize
    mapper_step.undistort_normalize = camera.undistort_normalize_plain
    try:
        plain = mapper_step._stereo_graph_fn(*tensors, **static)
    finally:
        mapper_step.undistort_normalize = saved
    assert torch.equal(outs[0], plain)
    other, _ = _stereo_case(dev, seed=4)
    moved = (*other[:3], *tensors[3:])       # another keyframe's left image
    assert torch.equal(step(*moved, **static),
                       mapper_step._stereo_graph_fn(*moved, **static))


def test_cuda_graphed_temporal_step_is_bit_equal():
    from ov2slam_torch.models import mapper_step

    dev = _cuda()
    rng = np.random.default_rng(3)
    n = 128
    T_a = np.tile([1.0, 0, 0, 0, 0, 0, 0], (n, 1))
    T_rel = np.tile([1.0, 0, 0, 0, 0.5, 0, 0], (n, 1))
    px_a = rng.uniform(20, 160, (n, 2))
    state = torch.as_tensor(mapper_step.pack_temporal_state(
        px_a, px_a - [10.0, 0.0], T_a, T_rel, rng.random(n) < 0.8),
        device=dev)
    step = graphs.GraphedStep(mapper_step.fused_temporal_step)
    calib = _calib(dev)            # a static argument: keyed by the object
    outs = [step(state, calib_l=calib) for _ in range(3)]
    assert (step.eager, step.captures, step.replays) == (1, 1, 2)
    assert outs[0][:, 3].sum() > 50
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_cuda_packed_ba_runner_is_bit_equal_to_the_unpacked_runner():
    """The packed solve unpacks on the card into a :class:`GraphedTwoPass`
    runner of its caller's own cache: eager, captured, replayed, each
    bit-equal to a runner given the unpacked arrays."""
    import types

    dev = _cuda()
    args, prm = _problem(dev, n_kf=12, n_lm=300)
    Kw, Lw, O = 12, args[2].shape[0], args[5].shape[0]
    host = [a.cpu().numpy() for a in args]
    prob = types.SimpleNamespace(
        kf_poses=host[0], kf_fixed=host[1], lm_anchor=host[3],
        obs_kf=host[5], obs_lm=host[6], obs_px=host[7], obs_cam=host[8])
    flat = torch.as_tensor(bi.pack_ba_invdepth(
        prob, host[2], host[4], host[9]), device=dev)
    run = bi.GraphedTwoPass(args, prm, 5.9915, 5, 3)
    want = [run(args) for _ in range(3)]
    calls, runners = [], {}
    n = (len(bi.GraphedTwoPass.cache), bi.GraphedTwoPass.replays)
    got = [bi.ba_invdepth_packed(flat, prm, Kw, Lw, O,
                                 between_iters=lambda: calls.append(1),
                                 runners=runners)
           for _ in range(3)]
    torch.cuda.synchronize()
    assert len(calls) == 3 * 8
    (packed,) = runners.values()
    assert packed.graphs is not None and packed.solves == 3
    assert len(bi.GraphedTwoPass.cache) == n[0]
    assert bi.GraphedTwoPass.replays == n[1] + 2
    for w, g in zip(want, got):
        poses, pos, _, inlier, cost = w
        assert torch.equal(g[:Kw * 7], poses.reshape(-1))
        assert torch.equal(g[Kw * 7:Kw * 7 + Lw * 3], pos.reshape(-1))
        assert torch.equal(g[Kw * 7 + Lw * 3:-1] > 0.5, inlier)
        assert torch.equal(g[-1], cost)


def test_cuda_capture_runs_with_the_collector_off():
    """A step's function runs with the cyclic collector on when eager and
    off while captured (a collection there could destroy a graph held in a
    garbage cycle, which invalidates the capture), and the collector is
    back on after."""
    import gc

    dev = _cuda()
    x = torch.arange(8.0, device=dev)
    seen = []

    def fn(t):
        seen.append(gc.isenabled())
        return t * 2

    was = gc.isenabled()
    gc.enable()
    try:
        step = graphs.GraphedStep(fn)
        outs = [step(x) for _ in range(3)]
        torch.cuda.synchronize()
        assert seen == [True, False] and gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
    assert (step.eager, step.captures, step.replays) == (1, 1, 2)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
