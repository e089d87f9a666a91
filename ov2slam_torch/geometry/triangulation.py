"""Batched two-view triangulation — port of
``ov2slam_tpu/geometry/triangulation.py`` (OpenGV midpoint and the SVD-DLT
fallback of the reference, as closed-form batched tensor programs).

Conventions: ``T_lr`` is the pose of view r in view l's frame (x_l = R x_r
+ t); bearings are unit 3-vectors in each camera frame.
"""

from __future__ import annotations

import torch

from ..utils import lie


def _nz(x, eps):
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def triangulate_midpoint(T_lr, bv_l, bv_r):
    """Midpoint of the common perpendicular of the two rays, in the *left*
    camera frame. T_lr (..., 7); bv_l, bv_r (..., 3)."""
    t = lie.pose_t(T_lr)
    d1 = bv_l
    d2 = lie.quat_rotate(lie.pose_q(T_lr), bv_r)

    a = torch.sum(d1 * d1, dim=-1)
    b = -torch.sum(d1 * d2, dim=-1)
    c = torch.sum(d2 * d2, dim=-1)
    e1 = torch.sum(d1 * t, dim=-1)
    e2 = -torch.sum(d2 * t, dim=-1)
    det = _nz(a * c - b * b, 1e-12)
    l1 = (c * e1 - b * e2) / det
    l2 = (a * e2 - b * e1) / det
    p1 = d1 * l1[..., None]
    p2 = t + d2 * l2[..., None]
    return 0.5 * (p1 + p2)


def triangulate_dlt(T_lr, bv_l, bv_r):
    """SVD-DLT triangulation; same signature/frames as
    :func:`triangulate_midpoint`. Batched 4x4 SVD."""
    M_rl = lie.pose_to_matrix(lie.pose_inverse(T_lr))
    P1 = torch.eye(3, 4, dtype=T_lr.dtype, device=T_lr.device).expand(
        T_lr.shape[:-1] + (3, 4))
    P2 = M_rl[..., :3, :]
    x1 = bv_l[..., 0:2] / bv_l[..., 2:3]
    x2 = bv_r[..., 0:2] / bv_r[..., 2:3]
    A = torch.stack(
        [
            x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )
    _, _, vt = torch.linalg.svd(A)
    X = vt[..., 3, :]
    return X[..., 0:3] / _nz(X[..., 3:4], 1e-12)


def reprojection_checks(T_lr, bv_l, bv_r, pts_l, fx, max_reproj_err,
                        min_depth: float = 0.0):
    """Positive depth in both views and reprojection error under
    ``max_reproj_err`` px (via focal ``fx``). Returns a bool mask (...,)."""
    pts_r = lie.pose_apply(lie.pose_inverse(T_lr), pts_l)
    ok_depth = (pts_l[..., 2] > min_depth) & (pts_r[..., 2] > min_depth)

    def px_err(pts, bv):
        proj = pts[..., 0:2] / _nz(pts[..., 2:3], 1e-12)
        obs = bv[..., 0:2] / bv[..., 2:3]
        return fx * torch.linalg.norm(proj - obs, dim=-1)

    ok_err = (px_err(pts_l, bv_l) < max_reproj_err) & (
        px_err(pts_r, bv_r) < max_reproj_err)
    return ok_depth & ok_err
