"""Realistic distributed-BA problems built through the actual MapStore.

Port of ``ov2slam_tpu/parallel/problems.py``: the multichip dryrun and the
sharded solver's tests need covisibility-sparse problems of the size the
estimator really produces (25+ KF windows, 10k+ stereo observations), so
one is built through the same ``MapStore.add_keyframe`` /
``build_ba_problem`` path the pipeline uses (`mapping/store.py`). The
function is numpy and draws from ``default_rng(seed)`` in the JAX
original's order, so the ``BAProblem`` arrays equal the JAX package's bit
for bit; only the solver calibration is the port's (tensors on a device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..mapping.store import MapStore
from ..solvers.ba import BAParams
from ..utils import lie_np
from ..utils.config import SlamConfig

FX = FY = 458.0
CX, CY = 376.0, 240.0
W, H = 752, 480
BASELINE = 0.11


def realistic_window_problem(n_kf: int = 28, n_lm: int = 6000,
                             seed: int = 0, noise_px: float = 0.3,
                             pose_sigma: float = 0.01,
                             lm_sigma: float = 0.03,
                             skew: float = 0.0, device=None):
    """Arc trajectory with sliding covisibility through a real MapStore.

    Returns (store, prob, params, gt_poses): ``prob`` is the BAProblem of
    the full n_kf window (stereo rows included), with poses/landmarks
    perturbed from ground truth so the solve has real work to do;
    ``params`` holds the calibration on ``device`` (``None`` = the GPU).

    ``skew``: fraction of landmarks made far-field "hub" points visible
    from (nearly) the whole window — the skewed-covisibility regime where
    a contiguous landmark split would overload one shard; exercises the
    LPT balanced assignment (`dist_ba.balanced_lm_assignment`).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cfg = SlamConfig()
    cfg.max_keyframes = max(32, n_kf + 4)
    cfg.max_landmarks = max(8192, int(1.5 * n_lm))
    cfg.local_ba_max_obs = 65536
    cfg.max_kps_factor = 2.5   # wide per-KF slot budget for dense windows

    # arc trajectory, camera looking forward (+z = direction of travel)
    ts = np.arange(n_kf, dtype=np.float64)
    ang = 0.04 * ts
    pos = np.stack([4.0 * np.sin(ang) / 0.04,
                    (1 - np.cos(ang)) * 4.0 / 0.04,
                    0.05 * np.sin(0.5 * ts)], -1) * 0.25
    gt_poses = np.stack([
        lie_np.make_pose(lie_np.so3_exp([0.0, 0.0, a]), p)
        for a, p in zip(ang, pos)]).astype(np.float32)
    # rotate so camera +z looks along world +x-ish travel direction
    R_fix = lie_np.make_pose(lie_np.so3_exp([0.0, -np.pi / 2, 0.0]),
                             np.zeros(3))
    gt_poses = lie_np.pose_compose(
        gt_poses.astype(np.float64), R_fix[None]).astype(np.float32)

    # landmarks strewn along the trajectory, 2-10 m ahead of their
    # nearest keyframe → each is visible from a handful of nearby KFs
    near_kf = rng.integers(0, n_kf, n_lm)
    ahead = rng.uniform(2.0, 10.0, n_lm)
    lateral = rng.uniform(-4.0, 4.0, n_lm)
    height = rng.uniform(-2.0, 2.0, n_lm)
    max_depth = np.full(n_lm, 12.0)
    n_hub = int(skew * n_lm)
    if n_hub:
        # far-field hubs anchored mid-window: visible from most KFs
        near_kf[:n_hub] = n_kf // 2
        ahead[:n_hub] = rng.uniform(15.0, 40.0, n_hub)
        lateral[:n_hub] = rng.uniform(-12.0, 12.0, n_hub)
        max_depth[:n_hub] = 60.0
    cam_pts = np.stack([lateral, height, ahead], -1)
    lms = lie_np.pose_apply(gt_poses[near_kf].astype(np.float64),
                            cam_pts).astype(np.float32)

    store = MapStore(cfg)
    lmids = store.new_landmarks(n_lm)
    store.set_landmark_positions(
        lmids, lms + rng.normal(0, lm_sigma, lms.shape).astype(np.float32))

    N = cfg.max_kps
    T_rl = np.concatenate([[1, 0, 0, 0], [-BASELINE, 0, 0]])
    for k in range(n_kf):
        T_cw = lie_np.pose_inverse(gt_poses[k].astype(np.float64))
        pc = lie_np.pose_apply(T_cw, lms.astype(np.float64))
        u = FX * pc[:, 0] / np.maximum(pc[:, 2], 1e-6) + CX
        v = FY * pc[:, 1] / np.maximum(pc[:, 2], 1e-6) + CY
        vis = ((pc[:, 2] > 0.5) & (pc[:, 2] < max_depth)
               & (u > 8) & (u < W - 8) & (v > 8) & (v < H - 8))
        li = np.nonzero(vis)[0]
        if len(li) > N:
            li = rng.choice(li, N, replace=False)
        n = len(li)
        slot_lm = np.full(N, -1, np.int32)
        px = np.zeros((N, 2), np.float32)
        rpx = np.zeros((N, 2), np.float32)
        st = np.zeros(N, bool)
        slot_lm[:n] = lmids[li]
        px[:n] = (np.stack([u[li], v[li]], -1)
                  + rng.normal(0, noise_px, (n, 2)))
        pc_r = lie_np.pose_apply(T_rl, pc[li])
        rpx[:n] = (np.stack([FX * pc_r[:, 0] / pc_r[:, 2] + CX,
                             FY * pc_r[:, 1] / pc_r[:, 2] + CY], -1)
                   + rng.normal(0, noise_px, (n, 2)))
        st[:n] = True

        # perturbed pose stored in the map (body-frame perturbation);
        # the gauge KF (k = 0) stays at ground truth — perturbing the
        # anchor would offset the whole solution
        xi = rng.normal(0, pose_sigma, 6) if k > 0 else np.zeros(6)
        T_pert = lie_np.pose_compose(
            gt_poses[k].astype(np.float64),
            np.concatenate([lie_np.so3_exp(xi[3:]), xi[:3]]))
        store.add_keyframe(float(k), T_pert.astype(np.float32), slot_lm,
                           px, np.zeros((N, 8), np.uint32),
                           is_stereo=st, rpx=rpx)

    window = list(range(n_kf))
    prob = store.build_ba_problem(
        window, fixed_kf_ids=window[:1], max_kfs=n_kf,
        max_obs=cfg.local_ba_max_obs)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    params = BAParams(fx=f32(FX), fy=f32(FY), cx=f32(CX), cy=f32(CY),
                      T_rl=f32(T_rl), intr=(FX, FY, CX, CY))
    return store, prob, params, gt_poses
