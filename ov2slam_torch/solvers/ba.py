"""Bundle-adjustment calibration and shared helpers.

Port of the parts of ``ov2slam_tpu/solvers/ba.py`` that the inverse-depth
solver (`solvers/ba_invdepth.py`) uses: the solver calibration, the Huber
IRLS weight, and the dense/iterative Schur switch-over. The xyz
``ba_solve`` is not reached while ``use_inv_depth`` is on and is not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import lie


class BAParams(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    T_rl: torch.Tensor        # (7,) left-cam pose in right-cam frame (cam 1)
    intr: Tuple[float, float, float, float]   # (fx, fy, cx, cy) on the host


def make_ba_params(cam_l, cam_r=None) -> BAParams:
    """Build solver calibration from Camera objects (undistorted model)."""
    f32 = torch.float32
    T_rl = (lie.pose_inverse(cam_r.T_c0_ci) if cam_r is not None
            else lie.pose_identity(device=cam_l.device))
    return BAParams(
        fx=cam_l.fx.to(f32), fy=cam_l.fy.to(f32),
        cx=cam_l.cx.to(f32), cy=cam_l.cy.to(f32),
        T_rl=T_rl.to(f32), intr=cam_l.intrinsics_f)


def _huber_weight(chi2, th):
    """IRLS weight for Huber loss with threshold th (on chi2)."""
    return torch.where(chi2 <= th, torch.ones_like(chi2),
                       torch.sqrt(th / torch.clamp(chi2, min=1e-12)))


# dense reduced camera system up to this many poses; above it the
# matrix-free PCG path engages
DENSE_SCHUR_MAX_KFS = 64
