"""SE(3)/SO(3) Lie-group operations on batched torch tensors.

Port of ``ov2slam_tpu/utils/lie.py``: every operation is a pure function
over tensors with arbitrary leading batch dimensions, so poses live in
fixed-capacity ``(K, 7)`` tensors and are transformed by broadcasting.

Pose layout: a pose is a ``(..., 7)`` tensor ``[qw, qx, qy, qz, tx, ty, tz]``
representing ``T = (R(q), t)`` acting on points as ``x' = R x + t``. The
update convention is left-multiplicative: ``T_new = exp(dx) * T``.

All functions are f32/f64 polymorphic and differentiable by autograd.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


# --------------------------------------------------------------------------
# Quaternion primitives (w, x, y, z layout)
# --------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    """Hamilton product q1 ⊗ q2 (batched)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors ``v`` (..., 3) by quaternions ``q`` (..., 4)."""
    qv = q[..., 1:4]
    qw = q[..., 0:1]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q):
    """Unit quaternion (..., 4) → rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4), w ≥ 0.

    Branch-free Shepperd's method: all four candidate quaternions are
    computed and the best-conditioned one (largest pivot) is selected.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    c0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
         (m10 - m01) / (4 * qw0)], dim=-1)

    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
         (m02 + m20) / (4 * qx1)], dim=-1)

    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
         (m12 + m21) / (4 * qy2)], dim=-1)

    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
         (m12 + m21) / (4 * qz3), qz3], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4, 4)
    q = torch.take_along_dim(
        cands, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2
    )[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


# --------------------------------------------------------------------------
# SO(3) exp / log
# --------------------------------------------------------------------------

def so3_exp(w):
    """Axis-angle (..., 3) → unit quaternion (..., 4). Taylor-safe at 0."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    qw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([qw, k * w], dim=-1))


def so3_log(q):
    """Unit quaternion (..., 4) → axis-angle (..., 3). Taylor-safe at 0,
    including under autograd: every quantity the SELECTED small branch
    touches has a finite derivative at qv = 0, so the Taylor term is driven
    by sum(qv²), never by ||qv|| (whose sqrt-at-zero derivative is NaN)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # w >= 0 ⇒ θ in [0, π]
    qw = torch.clamp(q[..., 0:1], -1.0, 1.0)
    qv = q[..., 1:4]
    sh2 = torch.sum(qv * qv, dim=-1, keepdim=True)   # sin²(θ/2)
    small = sh2 < _EPS * _EPS
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(sh2), sh2))
    half = torch.atan2(sin_half, qw)
    scale = torch.where(small, 2.0 + sh2 / 3.0, 2.0 * half / sin_half)
    return scale * qv


def so3_hat(w):
    """(..., 3) → skew-symmetric (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    m = torch.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def _so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3) (..., 3, 3), Taylor-safe."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < _EPS
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    W = so3_hat(w)
    W2 = W @ W
    A = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe)) / safe ** 2)
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe - torch.sin(safe)) / safe ** 3)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A * W + B * W2


# --------------------------------------------------------------------------
# SE(3) poses: (..., 7) = [qw qx qy qz | tx ty tz]
# --------------------------------------------------------------------------

def pose_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def make_pose(q, t):
    return torch.cat([q, t], dim=-1)


def pose_q(T):
    return T[..., 0:4]


def pose_t(T):
    return T[..., 4:7]


def pose_from_Rt(R, t):
    return make_pose(matrix_to_quat(R), t)


def pose_to_matrix(T):
    """(..., 7) → homogeneous (..., 4, 4)."""
    R = quat_to_matrix(pose_q(T))
    t = pose_t(T)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype,
                          device=T.device).expand(T.shape[:-1] + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def pose_from_matrix(M):
    return make_pose(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


def pose_compose(Ta, Tb):
    """Ta * Tb (batched)."""
    qa, ta = pose_q(Ta), pose_t(Ta)
    qb, tb = pose_q(Tb), pose_t(Tb)
    return make_pose(quat_normalize(quat_mul(qa, qb)),
                     quat_rotate(qa, tb) + ta)


def pose_inverse(T):
    q, t = pose_q(T), pose_t(T)
    qinv = quat_conj(q)
    return make_pose(qinv, -quat_rotate(qinv, t))


def pose_apply(T, pts):
    """Apply pose to points (..., 3): R @ p + t."""
    return quat_rotate(pose_q(T), pts) + pose_t(T)


def se3_exp(xi):
    """se(3) twist (..., 6) = [v | w] → pose (..., 7)."""
    v, w = xi[..., 0:3], xi[..., 3:6]
    q = so3_exp(w)
    V = _so3_left_jacobian(w)
    t = (V @ v[..., None])[..., 0]
    return make_pose(q, t)


def se3_log(T):
    """pose (..., 7) → twist (..., 6) = [v | w]."""
    q, t = pose_q(T), pose_t(T)
    w = so3_log(q)
    Vinv = torch.linalg.inv(_so3_left_jacobian(w))
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def pose_left_update(T, xi):
    """Left-multiplicative retraction: exp(xi) * T."""
    return pose_compose(se3_exp(xi), T)


def pose_relative(Ta, Tb):
    """T_ab = Ta⁻¹ * Tb."""
    return pose_compose(pose_inverse(Ta), Tb)


def pose_distance(Ta, Tb):
    """(rotation angle [rad], translation distance) between two poses."""
    rel = pose_relative(Ta, Tb)
    rot = torch.linalg.norm(so3_log(pose_q(rel)), dim=-1)
    trans = torch.linalg.norm(pose_t(rel), dim=-1)
    return rot, trans


def pose_slerp(Ta, Tb, alpha):
    """Screw-linear interpolation between poses (for viz/tests)."""
    rel = pose_relative(Ta, Tb)
    return pose_compose(Ta, se3_exp(alpha * se3_log(rel)))
