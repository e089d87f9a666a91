"""Pose-graph optimization over SE(3) relative-pose constraints.

Port of ``pose_graph_solve`` and ``build_chain_edges`` of
``ov2slam_tpu/solvers/posegraph.py`` (the reference's
`Optimizer::localPoseGraph`, `optimizer.cpp:2346-2591`): a chain of
consecutive relative-pose edges plus loop edges, solved with damped
Gauss-Newton on a dense system.

Residual per edge (i, j):  r = log( T_meas⁻¹ · T_wi⁻¹ · T_wj )  ∈ R⁶
(`LeftSE3RelativePoseError`, `se3left_parametrization.hpp:76-99`).
Jacobians come from autograd of the per-edge function at zero tangent
perturbations: every edge depends only on its own perturbations, so six
reverse passes over the batched residual give all edges' 6x12 Jacobians.
``full_pose_graph`` is not ported yet.
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


def pose_graph_solve(
    poses_wc,            # (M, 7)
    fixed,               # (M,) bool — gauge anchors (reference: loop KF)
    edge_i, edge_j,      # (E,) int indices (-1 pad)
    edge_T,              # (E, 7) measured T_ij = T_wi⁻¹ T_wj
    edge_weight,         # (E,) f32 (0 for padding; >1 for loop edges)
    iters: int = 10,
    lam0: float = 1e-4,
):
    """Damped Gauss-Newton pose-graph solve.

    Returns (new_poses (M, 7), final_cost ()).
    """
    f32 = torch.float32
    dev = poses_wc.device
    M = poses_wc.shape[0]
    poses = poses_wc.to(f32)
    center = poses[0, 4:7].clone()
    poses = torch.cat([poses[:, :4], poses[:, 4:7] - center], dim=-1)

    ei = torch.clamp(edge_i.long(), min=0)
    ej = torch.clamp(edge_j.long(), min=0)
    edge_T = edge_T.to(f32)
    w = edge_weight.to(f32)
    free = (~fixed).to(f32)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    ar = torch.arange(M, device=dev)

    def cost_fn(p):
        r = _edge_residual(p[ei], p[ej], edge_T)
        return torch.sum(w * torch.sum(r * r, -1))

    # the normal equations' sums, each index sorted once
    pair_sum = SegmentSum(torch.cat([ei * M + ei, ej * M + ej,
                                     ei * M + ej, ej * M + ei]), M * M)
    pose_sum = SegmentSum(torch.cat([ei, ej]), M)

    lam = torch.tensor(lam0, dtype=f32, device=dev)
    c1 = torch.zeros((), dtype=f32, device=dev)
    for _ in range(iters):
        r = _edge_residual(poses[ei], poses[ej], edge_T)          # (E, 6)
        Ji, Jj = _edge_jacobians(poses[ei], poses[ej], edge_T)
        Ji = Ji * free[ei][:, None, None]
        Jj = Jj * free[ej][:, None, None]
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]

        H = pair_sum(torch.cat([
            torch.einsum("eik,eil->ekl", wJi, Ji),
            torch.einsum("eik,eil->ekl", wJj, Jj),
            torch.einsum("eik,eil->ekl", wJi, Jj),
            torch.einsum("eik,eil->ekl", wJj, Ji)])).reshape(M, M, 6, 6)
        b = pose_sum(torch.cat([-torch.einsum("eik,ei->ek", wJi, r),
                                -torch.einsum("eik,ei->ek", wJj, r)]))

        # damping + identity for fixed/unconstrained poses
        diag = torch.clamp(torch.diagonal(H[ar, ar], dim1=-2, dim2=-1),
                           min=1e-8)
        H[ar, ar] += lam * diag[..., None] * eye6[None]
        H[ar, ar] += (1.0 - free)[:, None, None] * eye6[None]

        Hd = H.permute(0, 2, 1, 3).reshape(M * 6, M * 6)
        dx, _ = torch.linalg.solve_ex(
            Hd + 1e-8 * torch.eye(M * 6, dtype=f32, device=dev),
            b.reshape(-1, 1))
        dx = dx.reshape(M, 6) * free[:, None]

        new_poses = lie.pose_left_update(poses, dx)
        c0, c1 = cost_fn(poses), cost_fn(new_poses)
        accept = c1 < c0
        poses = torch.where(accept, new_poses, poses)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e2))
    return torch.cat([poses[:, :4], poses[:, 4:7] + center], dim=-1), c1


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
