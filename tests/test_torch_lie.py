"""Parity: ov2slam_torch.utils.lie against ov2slam_tpu.utils.lie.

Both sides run in f64 on the CPU on the same numpy inputs; the cases are
those of test_lie.py, each checked on the JAX side and the port side, plus
a direct JAX-vs-port comparison at 1e-12 (f64 round-off only: the formulas
are the same, term for term).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ov2slam_torch.utils import lie as tlie
from ov2slam_tpu.utils import lie as jlie

torch.set_num_threads(1)

SIDES = {"jax": (jlie, jnp.asarray, np.asarray),
         "torch": (tlie, torch.as_tensor, lambda x: x.detach().numpy())}


def random_poses(rng, n):
    q = Rotation.random(n, random_state=np.random.RandomState(1)).as_quat()
    q = np.concatenate([q[:, 3:4], q[:, :3]], axis=1)
    t = rng.normal(size=(n, 3))
    return np.concatenate([q, t], axis=1)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_lie_reference_cases(side, rng):
    lie, arr, np_ = SIDES[side]
    T = arr(random_poses(rng, 64))
    q = lie.pose_q(T)
    q2 = lie.matrix_to_quat(lie.quat_to_matrix(q))
    qc = np.where(np_(q)[..., 0:1] < 0, -np_(q), np_(q))
    np.testing.assert_allclose(np_(q2), qc, atol=1e-9)

    v = rng.normal(size=(64, 3))
    r1 = np_(lie.quat_rotate(q, arr(v)))
    R = np_(lie.quat_to_matrix(q))
    np.testing.assert_allclose(r1, np.einsum("nij,nj->ni", R, v), atol=1e-10)

    w = rng.normal(size=(100, 3))
    w = w / np.maximum(np.linalg.norm(w, axis=-1, keepdims=True),
                       1.0) * 0.95 * np.pi
    w = np.concatenate([w, [[1e-10, 0, 0], [3.1, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    np.testing.assert_allclose(np_(lie.so3_log(lie.so3_exp(arr(w)))), w,
                               atol=1e-7)
    R_ours = np_(lie.quat_to_matrix(lie.so3_exp(arr(w[:50]))))
    np.testing.assert_allclose(R_ours, Rotation.from_rotvec(w[:50]).as_matrix(),
                               atol=1e-9)

    xi = rng.normal(size=(64, 6))
    xi[:, 3:6] = xi[:, 3:6] / np.maximum(
        np.linalg.norm(xi[:, 3:6], axis=-1, keepdims=True), 1.0) * 0.95 * np.pi
    np.testing.assert_allclose(np_(lie.se3_log(lie.se3_exp(arr(xi)))), xi,
                               atol=1e-8)

    Ta, Tb = T[:16], T[16:32]
    Ma, Mb = np_(lie.pose_to_matrix(Ta)), np_(lie.pose_to_matrix(Tb))
    np.testing.assert_allclose(np_(lie.pose_to_matrix(lie.pose_compose(Ta, Tb))),
                               Ma @ Mb, atol=1e-9)
    ident = lie.pose_compose(Ta, lie.pose_inverse(Ta))
    np.testing.assert_allclose(np_(lie.pose_t(ident)), 0.0, atol=1e-9)

    M = lie.pose_to_matrix(T)
    np.testing.assert_allclose(np_(lie.pose_to_matrix(lie.pose_from_matrix(M))),
                               np_(M), atol=1e-9)

    dx = rng.normal(size=(4, 6)) * 1e-6
    T2 = lie.pose_left_update(T[:4], arr(dx))
    t0 = np_(lie.pose_t(T[:4]))
    np.testing.assert_allclose(np_(lie.pose_t(T2)),
                               t0 + dx[:, :3] + np.cross(dx[:, 3:], t0),
                               atol=1e-10)


def test_lie_port_matches_jax(rng):
    T = random_poses(rng, 32)
    U = random_poses(np.random.default_rng(5), 32)
    xi = rng.normal(size=(32, 6))
    pts = rng.normal(size=(32, 3))
    tT, tU = torch.as_tensor(T), torch.as_tensor(U)
    jT, jU = jnp.asarray(T), jnp.asarray(U)
    pairs = [
        (jlie.pose_compose(jT, jU), tlie.pose_compose(tT, tU)),
        (jlie.pose_inverse(jT), tlie.pose_inverse(tT)),
        (jlie.pose_apply(jT, jnp.asarray(pts)),
         tlie.pose_apply(tT, torch.as_tensor(pts))),
        (jlie.se3_exp(jnp.asarray(xi)), tlie.se3_exp(torch.as_tensor(xi))),
        (jlie.se3_log(jT), tlie.se3_log(tT)),
        (jlie.pose_relative(jT, jU), tlie.pose_relative(tT, tU)),
        (jlie.pose_distance(jT, jU)[0], tlie.pose_distance(tT, tU)[0]),
        (jlie.pose_slerp(jT, jU, 0.3), tlie.pose_slerp(tT, tU, 0.3)),
        (jlie.matrix_to_quat(jlie.quat_to_matrix(jT[:, :4])),
         tlie.matrix_to_quat(tlie.quat_to_matrix(tT[:, :4]))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-12)


def test_so3_log_autograd_finite_at_identity():
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0], [1.0, 1e-9, 0.0, 0.0]],
                     dtype=torch.float64, requires_grad=True)
    w = tlie.so3_log(q)
    (g,) = torch.autograd.grad(w.sum(), q)
    assert torch.isfinite(g).all()
    T = tlie.pose_identity(torch.float64).requires_grad_(True)
    xi = tlie.se3_log(tlie.pose_left_update(T, torch.zeros(6, dtype=torch.float64)))
    (g,) = torch.autograd.grad(xi.sum(), T)
    assert torch.isfinite(g).all()
