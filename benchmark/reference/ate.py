"""Absolute trajectory error after a rigid Umeyama alignment: a frozen
copy of the program's ``utils/evaluation.py`` alignment, so that the
yardstick cannot move with the program."""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray):
    """(R, t) minimizing ||dst - (R src + t)||^2 over (N, 3) points."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE (m) of the positions of ``est`` (N, 7) against ``gt`` (N, 7),
    [q | t] rows in the same order, after the alignment; inf for fewer
    than three poses or a non-finite one."""
    p_est = np.asarray(est, np.float64)[:, 4:7]
    p_gt = np.asarray(gt, np.float64)[:, 4:7]
    if len(p_est) < 3 or not np.isfinite(p_est).all():
        return float("inf")
    R, t = umeyama(p_est, p_gt)
    err = (R @ p_est.T).T + t - p_gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def segment_ate(est: np.ndarray, gt: np.ndarray, frames: int) -> float:
    """The largest ATE (m) of the consecutive stretches of ``frames``
    poses, each aligned on its own (a trailing shorter stretch is left
    out); inf for fewer than ``frames`` poses. It does not grow with the
    length of the window, as one alignment of a long path does with its
    drift."""
    if len(est) < frames:
        return float("inf")
    return max(ate_rmse(est[s:s + frames], gt[s:s + frames])
               for s in range(0, len(est) - frames + 1, frames))
