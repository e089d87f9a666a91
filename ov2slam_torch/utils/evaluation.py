"""Trajectory evaluation: ATE / RPE with Umeyama (Sim3 or SE3) alignment.

The reference has no in-repo evaluator — its benchmark harness
(`benchmark_scripts/euroc_bench.sh`) produces TUM files and defers ATE to
external evo/TUM tooling. We build the evaluator in, since ATE is the
framework's headline correctness metric (BASELINE.json).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import lie_np as lie


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src→dst (both (N, 3)).

    Returns (R, t, s) minimizing ||dst - (s R src + t)||².
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def associate(
    times_a: np.ndarray, times_b: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (indices into a and b)."""
    ia, ib = [], []
    j = 0
    for i, ta in enumerate(times_a):
        while j + 1 < len(times_b) and abs(times_b[j + 1] - ta) <= abs(
            times_b[j] - ta
        ):
            j += 1
        if abs(times_b[j] - ta) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.array(ia, int), np.array(ib, int)


def interpolate_poses(times: np.ndarray, poses: np.ndarray,
                      query_times: np.ndarray) -> np.ndarray:
    """SE3-interpolate a pose track (N, 7) at ``query_times`` (clamped to
    the track's span): slerp on rotation via the relative log, lerp on
    translation along the relative transform."""
    times = np.asarray(times, np.float64)
    poses = np.asarray(poses, np.float64)
    q = np.clip(np.asarray(query_times, np.float64),
                times[0], times[-1])
    hi = np.clip(np.searchsorted(times, q, side="right"), 1, len(times) - 1)
    lo = hi - 1
    denom = np.maximum(times[hi] - times[lo], 1e-12)
    a = ((q - times[lo]) / denom)[:, None]
    rel = lie.pose_relative(poses[lo], poses[hi])
    step = np.concatenate(
        [lie.so3_exp(lie.so3_log(rel[:, :4]) * a), rel[:, 4:] * a], axis=-1)
    return lie.pose_compose(poses[lo], step)


def transform_body_to_cam(gt_poses: np.ndarray,
                          T_body_cam: np.ndarray) -> np.ndarray:
    """Convert body-frame ground-truth poses T_w_body (N, 7) into camera
    poses T_w_cam = T_w_body · T_body_cam.

    EuRoC's `state_groundtruth_estimate0` records the *body* (IMU) frame;
    the estimate is the cam0 frame, so GT must be pushed through the
    `body_T_cam0` extrinsic from the parameter YAML before comparing
    (the reference leaves this to external evo tooling; we do it in-
    framework).
    """
    T_bc = np.asarray(T_body_cam, np.float64)
    if T_bc.shape == (4, 4):
        T_bc = lie.pose_from_matrix(T_bc)
    return lie.pose_compose(np.asarray(gt_poses, np.float64),
                            T_bc[None, :])


def ate_rmse(
    est_poses: np.ndarray,
    gt_poses: np.ndarray,
    est_times: Optional[np.ndarray] = None,
    gt_times: Optional[np.ndarray] = None,
    align_scale: bool = True,
) -> float:
    """Absolute trajectory error RMSE (m) after Umeyama alignment.

    Poses are (N, 7) [qw qx qy qz | t]. For monocular runs pass
    ``align_scale=True`` (scale is unobservable); stereo uses SE3 alignment.
    """
    if est_times is not None and gt_times is not None:
        ia, ib = associate(est_times, gt_times)
        if len(ia) < 3:
            return float("inf")
        p_est = est_poses[ia, 4:7]
        p_gt = gt_poses[ib, 4:7]
    else:
        n = min(len(est_poses), len(gt_poses))
        p_est = est_poses[:n, 4:7]
        p_gt = gt_poses[:n, 4:7]
    R, t, s = umeyama_alignment(p_est, p_gt, with_scale=align_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = aligned - p_gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error over a fixed index delta.

    Returns (trans RMSE [m], rot RMSE [rad]).
    """
    n = min(len(est_poses), len(gt_poses))
    terrs, rerrs = [], []
    for i in range(n - delta):
        rel_est = np.array(
            lie.pose_relative(est_poses[i], est_poses[i + delta]))
        rel_gt = np.array(lie.pose_relative(gt_poses[i], gt_poses[i + delta]))
        err = np.array(lie.pose_relative(rel_gt, rel_est))
        terrs.append(np.linalg.norm(err[4:7]))
        rerrs.append(np.linalg.norm(np.array(lie.so3_log(err[0:4]))))
    return (
        float(np.sqrt(np.mean(np.square(terrs)))),
        float(np.sqrt(np.mean(np.square(rerrs)))),
    )
