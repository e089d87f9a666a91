"""Pose-graph optimization over SE(3) relative-pose constraints.

Port of ``ov2slam_tpu/solvers/posegraph.py`` (the reference's
`Optimizer::localPoseGraph` and `fullPoseGraph`, `optimizer.cpp:2346-2591,
2783-2865`): a chain of consecutive relative-pose edges plus loop edges,
solved with damped Gauss-Newton on a dense system.

Residual per edge (i, j):  r = log( T_meas⁻¹ · T_wi⁻¹ · T_wj )  ∈ R⁶
(`LeftSE3RelativePoseError`, `se3left_parametrization.hpp:76-99`).
Jacobians come from autograd of the per-edge function at zero tangent
perturbations: every edge depends only on its own perturbations, so six
reverse passes over the batched residual give all edges' 6x12 Jacobians.

One solver, ``pose_graph_solve_batched``, runs S graphs of one shape at
once (one batched linear solve per iteration, each graph with its own
damping and accept/reject); the loop closer's local pose graph is a batch
of one (``pose_graph_solve``). ``full_pose_graph`` optimizes every frame
with the keyframes held constant; the chain then falls apart into
independent segments between keyframes, padded to one shape and solved as
one batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import lie, lie_np
from .segment import SegmentSum


def _edge_residual(T_wi, T_wj, T_meas):
    rel = lie.pose_compose(lie.pose_inverse(T_wi), T_wj)
    err = lie.pose_compose(lie.pose_inverse(T_meas), rel)
    return lie.se3_log(err)


def _edge_jacobians(T_wi, T_wj, T_meas):
    """(E, 6, 6) d r / d xi_i and d r / d xi_j at xi = 0."""
    E = T_wi.shape[0]
    xi = torch.zeros((E, 12), dtype=T_wi.dtype, device=T_wi.device,
                     requires_grad=True)
    with torch.enable_grad():
        r = _edge_residual(lie.pose_left_update(T_wi, xi[:, :6]),
                           lie.pose_left_update(T_wj, xi[:, 6:]), T_meas)
        rows = []
        for k in range(6):
            (g,) = torch.autograd.grad(r[:, k].sum(), xi, retain_graph=k < 5)
            rows.append(g)
    J = torch.stack(rows, dim=1)          # (E, 6, 12)
    return J[:, :, :6], J[:, :, 6:]


def pose_graph_solve_batched(poses_wc, fixed, edge_i, edge_j, edge_T,
                             edge_weight, iters: int = 10,
                             lam0: float = 1e-4):
    """Damped Gauss-Newton solve of S independent graphs of one shape at
    once: poses (S, M, 7), fixed (S, M), edges (S, E) / (S, E, 7) / (S, E)
    (see ``pose_graph_solve`` for one graph). Each graph keeps its own
    damping and accept/reject, as S separate solves would. Returns
    (new_poses (S, M, 7), final_costs (S,))."""
    f32 = torch.float32
    dev = poses_wc.device
    S, M = poses_wc.shape[:2]
    E = edge_i.shape[1]
    poses = poses_wc.to(f32)
    center = poses[:, :1, 4:7].clone()
    poses = torch.cat([poses[..., :4], poses[..., 4:7] - center], dim=-1)
    poses = poses.reshape(S * M, 7)

    off = (torch.arange(S, device=dev) * M)[:, None]
    ei = (torch.clamp(edge_i.long(), min=0) + off).reshape(-1)   # global
    ej = (torch.clamp(edge_j.long(), min=0) + off).reshape(-1)
    eT = edge_T.to(f32).reshape(S * E, 7)
    w = edge_weight.to(f32).reshape(-1)
    free = (~fixed).to(f32).reshape(-1)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    ar = torch.arange(M, device=dev)

    def costs(p):
        r = _edge_residual(p[ei], p[ej], eT)
        return (w * torch.sum(r * r, -1)).reshape(S, E).sum(-1)

    # (graph, pose, pose) and (graph, pose) bins: with the graph offsets,
    # a global pair (a, b) of graph s is s·M² + (a − s·M)·M + (b − s·M)
    g = torch.div(ei, M, rounding_mode="floor")
    li, lj = ei - g * M, ej - g * M
    pair_sum = SegmentSum(torch.cat([
        g * M * M + li * M + li, g * M * M + lj * M + lj,
        g * M * M + li * M + lj, g * M * M + lj * M + li]), S * M * M)
    pose_sum = SegmentSum(torch.cat([ei, ej]), S * M)

    lam = torch.full((S,), lam0, dtype=f32, device=dev)
    c1 = torch.zeros(S, dtype=f32, device=dev)
    for _ in range(iters):
        r = _edge_residual(poses[ei], poses[ej], eT)
        Ji, Jj = _edge_jacobians(poses[ei], poses[ej], eT)
        Ji = Ji * free[ei][:, None, None]
        Jj = Jj * free[ej][:, None, None]
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]
        H = pair_sum(torch.cat([
            torch.einsum("eik,eil->ekl", wJi, Ji),
            torch.einsum("eik,eil->ekl", wJj, Jj),
            torch.einsum("eik,eil->ekl", wJi, Jj),
            torch.einsum("eik,eil->ekl", wJj, Ji)])).reshape(S, M, M, 6, 6)
        b = pose_sum(torch.cat([-torch.einsum("eik,ei->ek", wJi, r),
                                -torch.einsum("eik,ei->ek", wJj, r)]))

        fr = free.reshape(S, M)
        diag = torch.clamp(torch.diagonal(H[:, ar, ar], dim1=-2, dim2=-1),
                           min=1e-8)                           # (S, M, 6)
        H[:, ar, ar] += lam[:, None, None, None] * diag[..., None] \
            * eye6
        H[:, ar, ar] += (1.0 - fr)[..., None, None] * eye6
        Hd = H.permute(0, 1, 3, 2, 4).reshape(S, M * 6, M * 6)
        dx, _ = torch.linalg.solve_ex(
            Hd + 1e-8 * torch.eye(M * 6, dtype=f32, device=dev),
            b.reshape(S, M * 6, 1))
        dx = dx.reshape(S * M, 6) * free[:, None]

        new_poses = lie.pose_left_update(poses, dx)
        c0, c1 = costs(poses), costs(new_poses)
        accept = c1 < c0                                         # (S,)
        acc = accept.repeat_interleave(M)[:, None]
        poses = torch.where(acc, new_poses, poses)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e2))
    poses = poses.reshape(S, M, 7)
    return torch.cat([poses[..., :4], poses[..., 4:7] + center], dim=-1), c1


def pose_graph_solve(poses_wc, fixed, edge_i, edge_j, edge_T, edge_weight,
                     iters: int = 10, lam0: float = 1e-4):
    """Damped Gauss-Newton solve of one graph: ``pose_graph_solve_batched``
    over a batch of one.

    Args: poses (M, 7); fixed (M,) bool, the gauge anchors (reference: the
    loop KF); edge_i, edge_j (E,) int indices (-1 pad); edge_T (E, 7), the
    measured T_ij = T_wi⁻¹ T_wj; edge_weight (E,) (0 for padding, > 1 for
    loop edges).

    Returns (new_poses (M, 7), final_cost ()).
    """
    new_poses, costs = pose_graph_solve_batched(
        *[x[None] for x in (poses_wc, fixed, edge_i, edge_j, edge_T,
                            edge_weight)], iters=iters, lam0=lam0)
    return new_poses[0], costs[0]


def build_chain_edges(poses_wc, kf_ids, loop_i=None, loop_j=None,
                      T_loop=None, loop_weight: float = 10.0):
    """Host helper: consecutive-KF chain edges (measured at current
    estimates, `optimizer.cpp:2387-2424`) plus an optional loop edge.

    Returns (edge_i, edge_j, edge_T, edge_weight) as numpy arrays.
    """
    M = len(kf_ids)
    ei, ej, eT, ew = [], [], [], []
    for a in range(M - 1):
        ei.append(a)
        ej.append(a + 1)
        eT.append(lie_np.pose_relative(poses_wc[a], poses_wc[a + 1]))
        ew.append(1.0)
    if loop_i is not None:
        ei.append(loop_i)
        ej.append(loop_j)
        eT.append(np.asarray(T_loop))
        ew.append(loop_weight)
    return (np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.asarray(eT, np.float32), np.asarray(ew, np.float32))


# --------------------------------------------------------------------- #
# Full-trajectory pose graph (`Optimizer::fullPoseGraph`,
# `optimizer.cpp:2783-2865`)
# --------------------------------------------------------------------- #

def full_pose_graph(poses_init, poses_meas, is_kf, iters: int = 20,
                    device=None):
    """Optimize all frame poses with keyframes fixed.

    Args:
      poses_init: (F, 7) starting poses (typically the LC-corrected
        replay — KF frames carry their optimized poses).
      poses_meas: (F, 7) the originally estimated trajectory; consecutive
        relative poses of this sequence are the chain measurements
        (`optimizer.cpp:2797-2818` uses the logger's recorded motion).
      is_kf: (F,) bool — fixed frames.
      iters: GN iterations per segment (reference: 100 Ceres iterations;
        the damped-GN segments converge in far fewer).
      device: where the segments are solved (``None`` = the GPU).

    Returns (F, 7) optimized poses (float64, numpy).
    """
    from ..device import resolve_device

    F = len(poses_init)
    poses_init = np.asarray(poses_init, np.float64)
    poses_meas = np.asarray(poses_meas, np.float64)
    is_kf = np.asarray(is_kf, bool)
    kf_idx = np.nonzero(is_kf)[0]
    if F < 3 or len(kf_idx) == 0:
        return poses_init.copy()

    # segments: [start..end] inclusive, cut at every keyframe; leading /
    # trailing non-KF runs are anchored on one side only
    bounds = sorted(set([0] + list(kf_idx) + [F - 1]))
    segs = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b - a >= 2]
    if not segs:
        return poses_init.copy()

    # padding poses are fixed and their edges weigh 0 (the JAX package
    # pads to a power of two to bound its compiles; one shape suffices here)
    pad = max(b - a + 1 for a, b in segs)
    S = len(segs)
    P = np.zeros((S, pad, 7), np.float32)
    P[:, :, 0] = 1.0  # identity quats in padding
    FX = np.ones((S, pad), bool)
    EI = np.zeros((S, pad - 1), np.int32)
    EJ = np.zeros((S, pad - 1), np.int32)
    ET = np.zeros((S, pad - 1, 7), np.float32)
    ET[:, :, 0] = 1.0
    EW = np.zeros((S, pad - 1), np.float32)
    for s, (a, b) in enumerate(segs):
        m = b - a + 1
        P[s, :m] = poses_init[a:b + 1]
        fx = is_kf[a:b + 1].copy()
        fx[0] = True   # segment endpoints anchor the gauge; a leading/
        fx[-1] = True  # trailing non-KF endpoint is simply kept rigid
        FX[s, :m] = fx
        EI[s, :m - 1] = np.arange(m - 1)
        EJ[s, :m - 1] = np.arange(1, m)
        ET[s, :m - 1] = lie_np.pose_relative(poses_meas[a:b],
                                             poses_meas[a + 1:b + 1])
        EW[s, :m - 1] = 1.0

    dev = resolve_device(device)
    new_P, _ = pose_graph_solve_batched(
        *[torch.as_tensor(x, device=dev) for x in (P, FX, EI, EJ, ET, EW)],
        iters=iters)
    new_P = new_P.cpu().numpy().astype(np.float64)

    out = poses_init.copy()
    for s, (a, b) in enumerate(segs):
        m = b - a + 1
        inner = ~FX[s, :m]
        out[a:a + m][inner] = new_P[s, :m][inner]
    # renormalize quaternions after the f32 solve
    out[:, :4] /= np.linalg.norm(out[:, :4], axis=1, keepdims=True)
    return out
