"""Pure-numpy mirror of the SE3 ops in `lie.py` for *host-side* code
(dataset generation, trajectory logging, covisibility bookkeeping).

Host code must not round-trip tiny 7-vectors through the device — on this
target the accelerator may be remote, so every dispatch is a network hop.
Same layouts as `lie.py`: quaternions wxyz, poses (..., 7) = [q | t].
"""

from __future__ import annotations

import numpy as np


def quat_normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q, v):
    qv = q[..., 1:4]
    qw = q[..., 0:1]
    uv = np.cross(qv, v)
    return v + 2.0 * (qw * uv + np.cross(qv, uv))


def quat_to_matrix(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp(w):
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    small = theta < 1e-8
    half = 0.5 * theta
    with np.errstate(invalid="ignore", divide="ignore"):
        k = np.where(small, 0.5 - theta**2 / 48.0, np.sin(half) / np.where(small, 1.0, theta))
    qw = np.where(small, 1.0 - theta**2 / 8.0, np.cos(half))
    return quat_normalize(np.concatenate([qw, k * w], axis=-1))


def so3_log(q):
    q = np.where(q[..., 0:1] < 0, -q, q)
    qv = q[..., 1:4]
    sin_half = np.linalg.norm(qv, axis=-1, keepdims=True)
    half = np.arctan2(sin_half, np.clip(q[..., 0:1], -1, 1))
    small = sin_half < 1e-8
    scale = np.where(small, 2.0 + (2 * half) ** 2 / 12.0,
                     2.0 * half / np.where(small, 1.0, sin_half))
    return scale * qv


def make_pose(q, t):
    return np.concatenate([q, t], axis=-1)


def pose_identity():
    return np.array([1.0, 0, 0, 0, 0, 0, 0])


def pose_q(T):
    return T[..., 0:4]


def pose_t(T):
    return T[..., 4:7]


def pose_compose(Ta, Tb):
    qa, ta = pose_q(Ta), pose_t(Ta)
    qb, tb = pose_q(Tb), pose_t(Tb)
    return make_pose(quat_normalize(quat_mul(qa, qb)),
                     quat_rotate(qa, tb) + ta)


def pose_inverse(T):
    q, t = pose_q(T), pose_t(T)
    qinv = quat_conj(q)
    return make_pose(qinv, -quat_rotate(qinv, t))


def pose_apply(T, pts):
    return quat_rotate(pose_q(T), pts) + pose_t(T)


def pose_relative(Ta, Tb):
    return pose_compose(pose_inverse(Ta), Tb)


def pose_to_matrix(T):
    R = quat_to_matrix(pose_q(T))
    t = pose_t(T)
    top = np.concatenate([R, t[..., None]], axis=-1)
    bottom = np.broadcast_to(np.array([0.0, 0, 0, 1.0]),
                             T.shape[:-1] + (4,))[..., None, :]
    return np.concatenate([top, bottom], axis=-2)


def pose_from_matrix(M):
    """Rotation part converted via the robust largest-pivot method."""
    R = M[..., :3, :3]
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = 0.5 * np.sqrt(np.maximum(1.0 + tr, 1e-12))
    qx = (R[..., 2, 1] - R[..., 1, 2]) / (4 * qw)
    qy = (R[..., 0, 2] - R[..., 2, 0]) / (4 * qw)
    qz = (R[..., 1, 0] - R[..., 0, 1]) / (4 * qw)
    q = quat_normalize(np.stack([qw, qx, qy, qz], axis=-1))
    return make_pose(q, M[..., :3, 3])


def pose_distance(Ta, Tb):
    rel = pose_relative(Ta, Tb)
    return (np.linalg.norm(so3_log(pose_q(rel)), axis=-1),
            np.linalg.norm(pose_t(rel), axis=-1))
