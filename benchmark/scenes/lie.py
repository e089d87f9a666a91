"""Poses as (..., 7) = [qw qx qy qz | t] in numpy f64: a frozen copy of the
operations the scenes and references need (the program's
``utils/lie_np.py`` computes them the same way)."""

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
        k = np.where(small, 0.5 - theta**2 / 48.0,
                     np.sin(half) / np.where(small, 1.0, theta))
    qw = np.where(small, 1.0 - theta**2 / 8.0, np.cos(half))
    return quat_normalize(np.concatenate([qw, k * w], axis=-1))


def pose_inverse(T):
    q, t = T[..., 0:4], T[..., 4:7]
    qinv = quat_conj(q)
    return np.concatenate([qinv, -quat_rotate(qinv, t)], axis=-1)


def pose_to_matrix(T):
    R = quat_to_matrix(T[..., 0:4])
    t = T[..., 4:7]
    top = np.concatenate([R, t[..., None]], axis=-1)
    bottom = np.broadcast_to(np.array([0.0, 0, 0, 1.0]),
                             T.shape[:-1] + (4,))[..., None, :]
    return np.concatenate([top, bottom], axis=-2)


def pose_from_matrix(M):
    R = M[..., :3, :3]
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    qw = 0.5 * np.sqrt(np.maximum(1.0 + tr, 1e-12))
    qx = (R[..., 2, 1] - R[..., 1, 2]) / (4 * qw)
    qy = (R[..., 0, 2] - R[..., 2, 0]) / (4 * qw)
    qz = (R[..., 1, 0] - R[..., 0, 1]) / (4 * qw)
    q = quat_normalize(np.stack([qw, qx, qy, qz], axis=-1))
    return np.concatenate([q, M[..., :3, 3]], axis=-1)
