"""The CARLA rig's street, rendered from a seed: a ground plane and 20-40
coloured boxes (buildings, parked vehicles) beside a 7 m road along x,
seen by six RGB-D cameras on a rig that moves along the road.

A frozen copy of the street, rig and ray caster of the program's
``chip_smoke.py`` slice G, sized by the configuration's file and seeded by
the run's ``--seed``. Frames are ray-cast on the device in f64, in set-up.
"""

from __future__ import annotations

import numpy as np

from . import lie


def street_scene(seed: int) -> dict:
    """Boxes (lo, hi corners, colour) and the ground's colour, numpy."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 41))
    half = rng.uniform([0.5, 0.5], [3.0, 3.0], (n, 2))
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    cx = rng.uniform(-30.0, 30.0, n)
    cy = side * (3.5 + half[:, 1] + rng.uniform(0.0, 12.0, n))
    h = rng.uniform(1.0, 5.5, n)
    lo = np.stack([cx - half[:, 0], cy - half[:, 1], np.zeros(n)], -1)
    hi = np.stack([cx + half[:, 0], cy + half[:, 1], h], -1)
    return dict(box_lo=lo, box_hi=hi,
                box_rgb=rng.uniform(40.0, 255.0, (n, 3)),
                ground_rgb=np.array([90.0, 90.0, 90.0]))


def rig_intrinsics(rig: dict) -> np.ndarray:
    """A pinhole camera of ``width`` x ``height`` pixels and a horizontal
    field of view of ``fov_deg``."""
    w, h = rig["width"], rig["height"]
    f = w / (2.0 * np.tan(np.radians(rig["fov_deg"]) / 2.0))
    return np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])


def rig_poses(rig: dict) -> list:
    """T_wc [q, t] of every camera at every rig step, in integration
    order: the rig moves ``step_m`` along x a step at ``cam_height``
    above the ground from x = -15 m; its cameras look horizontally, yawed
    360 / n_cams degrees apart (x right, y down, z forward)."""
    out = []
    for k in range(rig["steps"]):
        pos = np.array([-15.0 + rig["step_m"] * k, 0.0, rig["cam_height"]])
        for c in range(rig["n_cams"]):
            yaw = 2.0 * np.pi * c / rig["n_cams"]
            M = np.eye(4)
            M[:3, 0] = [np.sin(yaw), -np.cos(yaw), 0.0]
            M[:3, 1] = [0.0, 0.0, -1.0]
            M[:3, 2] = [np.cos(yaw), np.sin(yaw), 0.0]
            M[:3, 3] = pos
            out.append(lie.pose_from_matrix(M))
    return out


def render_rgbd(scene: dict, T_wc, K, width: int, height: int, device):
    """Depth (H, W) and RGB (H, W, 3) f32 tensors on ``device`` of the
    street seen from ``T_wc``, by analytic ray casting in f64 (depth is
    the z distance; inf where a ray hits nothing)."""
    import torch

    f64 = dict(dtype=torch.float64, device=device)
    M = torch.as_tensor(lie.pose_to_matrix(np.asarray(T_wc)), **f64)
    vs, us = torch.meshgrid(torch.arange(height, **f64),
                            torch.arange(width, **f64), indexing="ij")
    d_cam = torch.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1],
                         torch.ones_like(us)], -1).reshape(-1, 3)
    d = d_cam @ M[:3, :3].T            # per unit of camera z
    o = M[:3, 3]
    inf = torch.full_like(d[:, 0], float("inf"))
    t = torch.where(d[:, 2] < 0, -o[2] / d[:, 2], inf)
    rgb = torch.as_tensor(scene["ground_rgb"], **f64).expand(len(t), 3)
    rgb = torch.where(torch.isfinite(t)[:, None], rgb, 0.0)
    d_safe = torch.where(d == 0, 1e-30, d)
    for lo, hi, c in zip(scene["box_lo"], scene["box_hi"],
                         scene["box_rgb"]):
        t1 = (torch.as_tensor(lo, **f64) - o) / d_safe
        t2 = (torch.as_tensor(hi, **f64) - o) / d_safe
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        hit = (near <= far) & (near > 0) & (near < t)
        t = torch.where(hit, near, t)
        rgb = torch.where(hit[:, None], torch.as_tensor(c, **f64), rgb)
    return (t.reshape(height, width).to(torch.float32),
            rgb.reshape(height, width, 3).to(torch.float32))
