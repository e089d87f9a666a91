"""Parity: the port's ``full_pose_graph`` (``ov2slam_torch/solvers/
posegraph.py``) against ``ov2slam_tpu``'s, on the cases of
tests/test_posegraph.py:97-157, and its batched segment solve against
one-graph solves (``pose_graph_solve``, a batch of one).

Both sides solve each segment in f32 (the port's Jacobians by autograd, the
JAX package's by jacfwd): optimized poses agree to 1e-4. The port also
meets the reference tests' own gates.
"""

import numpy as np
import pytest
import torch

from ov2slam_torch.solvers import posegraph as tpg
from ov2slam_tpu.solvers import posegraph as jpg
from ov2slam_tpu.utils import lie_np
from tests.test_posegraph import make_loop_trajectory

torch.set_num_threads(1)


def drifted(F, kf_every=8):
    gt = make_loop_trajectory(F).astype(np.float64)
    drift = np.concatenate([lie_np.so3_exp([0.0, 0.003, 0.0]),
                            [0.003, 0.0, 0.001]])
    est = [gt[0]]
    for i in range(1, F):
        rel = lie_np.pose_compose(lie_np.pose_relative(gt[i - 1], gt[i]),
                                  drift)
        est.append(lie_np.pose_compose(est[-1], rel))
    est = np.stack(est)
    is_kf = np.zeros(F, bool)
    is_kf[::kf_every] = True
    init = est.copy()
    last_kf = 0
    for i in range(F):
        if is_kf[i]:
            init[i] = gt[i]
            last_kf = i
        else:
            init[i] = lie_np.pose_compose(
                gt[last_kf], lie_np.pose_relative(est[last_kf], est[i]))
    return gt, est, init, is_kf


def test_full_pose_graph_distributes_correction_as_reference():
    gt, est, init, is_kf = drifted(41)
    opt = tpg.full_pose_graph(init, est, is_kf, iters=15, device="cpu")
    ref = jpg.full_pose_graph(init, est, is_kf, iters=15)
    np.testing.assert_allclose(opt, ref, atol=1e-4)
    # the reference test's gates: KFs untouched, interior frames pulled
    # toward the truth, quaternions normalized
    assert np.allclose(opt[is_kf], gt[is_kf], atol=1e-9)
    err_init = np.linalg.norm(init[~is_kf, 4:7] - gt[~is_kf, 4:7], axis=1)
    err_opt = np.linalg.norm(opt[~is_kf, 4:7] - gt[~is_kf, 4:7], axis=1)
    assert err_opt.mean() < 0.7 * err_init.mean()
    assert np.allclose(np.linalg.norm(opt[:, :4], axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("case", ["no_kf", "all_kf", "middle_kf"])
def test_full_pose_graph_edge_cases_as_reference(case):
    gt = make_loop_trajectory(6).astype(np.float64)
    is_kf = {"no_kf": np.zeros(6, bool), "all_kf": np.ones(6, bool),
             "middle_kf": np.arange(6) == 3}[case]
    out = tpg.full_pose_graph(gt, gt, is_kf, iters=3, device="cpu")
    ref = jpg.full_pose_graph(gt, gt, is_kf, iters=3)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # consistent measurements + consistent init => stays at init
    assert np.abs(out[:, 4:7] - gt[:, 4:7]).max() < 1e-3


def test_batched_segments_equal_separate_solves():
    """Each graph of the batch keeps its own damping and accept/reject:
    the batch equals S one-graph solves (f32 round-off, 1e-5)."""
    gt, est, init, is_kf = drifted(25, kf_every=6)
    P, FX, EI, EJ, ET, EW = [], [], [], [], [], []
    for a in (0, 6, 12):
        seg = slice(a, a + 8)
        P.append(init[seg].astype(np.float32))
        fx = np.zeros(8, bool)
        fx[0] = fx[-1] = True
        FX.append(fx)
        EI.append(np.arange(7))
        EJ.append(np.arange(1, 8))
        ET.append(lie_np.pose_relative(est[seg][:-1], est[seg][1:])
                  .astype(np.float32))
        EW.append(np.ones(7, np.float32))
    args = [np.stack(x) for x in (P, FX, EI, EJ, ET, EW)]
    batch, costs = tpg.pose_graph_solve_batched(
        *[torch.as_tensor(a) for a in args], iters=6)
    for s in range(len(args[0])):
        one, c = tpg.pose_graph_solve(
            *[torch.as_tensor(a[s]) for a in args], iters=6)
        np.testing.assert_allclose(batch[s].numpy(), one.numpy(), atol=1e-5)
        np.testing.assert_allclose(float(costs[s]), float(c), rtol=1e-4,
                                   atol=1e-9)
