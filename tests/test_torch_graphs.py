"""The port's CUDA graphs of fixed-shape steps: ``ov2slam_torch/graphs.py``,
``solvers/ba_invdepth.GraphedTwoPass`` (local BA) and
``models/frontend_step.detect_describe`` (keyframe detection).

On the CPU: what the graphs rest on — the solve's residual-only cost is the
Jacobian pass's residuals bit for bit, the segment counts by ``index_add_``
equal ``bincount``, a solve padded to the graph's landmark capacity agrees
with the unpadded solve (poses 1e-4, points 1e-3, masks equal: eight LM
iterations carry the sums' other rounding) and returns the unpadded
shapes, the CPU never enters a graph, and detection with its threshold as a
0-d tensor (the graph's input) equals detection with the number, bit for
bit, for every detector.

On the card (skipped without one, decided inside the test): a replayed
solve and a replayed detection are bit-equal to the eager call of the same
shape, two problem sizes share one set of graphs, and the counters say
which calls ran eagerly, captured or replayed. The file imports no JAX, so
that ``python -m pytest --noconftest tests/test_torch_graphs.py`` runs on
the card.
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
    s = bi._prepare(*args[:8], args[9], 1e-3)
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
