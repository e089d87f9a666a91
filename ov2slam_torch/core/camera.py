"""Camera models — port of ``ov2slam_tpu/core/camera.py``.

Supports the two models of the reference:
- ``pinhole``: radtan distortion [k1 k2 p1 p2]
- ``fisheye``: Kannala–Brandt equidistant-4 [k1 k2 k3 k4]

All projection/undistortion functions are pure and batched over leading
dims. The camera's parameters are tensors on the camera's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import lie, lie_np
from ..utils.config import CameraConfig


# --------------------------------------------------------------------------
# Distortion models (batched)
# --------------------------------------------------------------------------

def distort_radtan(xn, dist):
    """Apply radtan distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def distort_fisheye(xn, dist):
    """Kannala–Brandt equidistant-4 distortion on normalized coords."""
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    x, y = xn[..., 0], xn[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3
                       + k4 * t2 ** 4)
    scale = theta_d / r
    return torch.stack([x * scale, y * scale], dim=-1)


def _undistort_iterative(xd, dist, distort_fn, iters: int = 8):
    """Fixed-point inversion of a distortion model (fixed iterations, as
    cv::undistortPoints' default tolerance for typical SLAM lenses)."""
    xn = xd
    for _ in range(iters):
        xn = xd - (distort_fn(xn, dist) - xn)
    return xn


# --------------------------------------------------------------------------
# Camera
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Camera:
    """Immutable calibrated camera; parameters live on ``K.device``.

    ``T_c0_ci`` is the extrinsic: this-camera pose in camera-0 frame
    (Tc0ci = Tbc0⁻¹ * Tbci).
    """

    model: str                      # "pinhole" | "fisheye"
    width: int
    height: int
    K: torch.Tensor                 # (3, 3)
    dist: torch.Tensor              # (4,)
    T_c0_ci: torch.Tensor           # (7,) pose of cam i in cam0 frame
    undist_map: Optional[torch.Tensor] = None   # (H, W, 2) xy

    @property
    def device(self) -> torch.device:
        return self.K.device

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]

    @property
    def intrinsics_f(self) -> Tuple[float, float, float, float]:
        """(fx, fy, cx, cy) as host Python floats, read back once."""
        c = getattr(self, "_intr_cache", None)
        if c is None:
            K = self.K.detach().cpu().numpy()
            c = (float(K[0, 0]), float(K[1, 1]),
                 float(K[0, 2]), float(K[1, 2]))
            object.__setattr__(self, "_intr_cache", c)
        return c

    def _f(self):
        return torch.stack([self.fx, self.fy])

    def _c(self):
        return torch.stack([self.cx, self.cy])

    def _distort_fn(self):
        return distort_fisheye if self.model == "fisheye" else distort_radtan

    # -- projections ----------------------------------------------------- #

    def project_cam_to_image(self, pts_cam):
        """3D cam-frame points (..., 3) → *undistorted* pixel coords."""
        z = pts_cam[..., 2:3]
        xn = pts_cam[..., 0:2] / torch.where(z.abs() < 1e-9,
                                             torch.full_like(z, 1e-9), z)
        return xn * self._f() + self._c()

    def project_cam_to_image_dist(self, pts_cam):
        """3D cam points → *distorted* (raw-image) pixels."""
        z = pts_cam[..., 2:3]
        xn = pts_cam[..., 0:2] / torch.where(z.abs() < 1e-9,
                                             torch.full_like(z, 1e-9), z)
        xd = self._distort_fn()(xn, self.dist)
        return xd * self._f() + self._c()

    def undistort_px(self, px):
        """Distorted pixels (..., 2) → undistorted pixels."""
        xn = (px - self._c()) / self._f()
        xu = _undistort_iterative(xn, self.dist, self._distort_fn())
        return xu * self._f() + self._c()

    def bearing(self, px_undist):
        """Undistorted pixels → unit bearing vectors (..., 3)."""
        xn = (px_undist - self._c()) / self._f()
        v = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    def in_image(self, px, border: float = 0.0):
        return (
            (px[..., 0] >= border)
            & (px[..., 0] <= self.width - 1 - border)
            & (px[..., 1] >= border)
            & (px[..., 1] <= self.height - 1 - border)
        )

    # -- image undistortion ---------------------------------------------- #

    def rectify_image(self, img):
        """Bilinear remap through the undistortion LUT."""
        if self.undist_map is None:
            return img
        return bilinear_sample(img, self.undist_map)


def build_camera(cfg: CameraConfig, other: Optional[CameraConfig] = None,
                 build_undist_map: bool = False,
                 dtype=torch.float32, device=None) -> Camera:
    """Construct a Camera from config; computes T_c0_ci from body extrinsics.
    ``device`` is required in practice (callers resolve it with
    :func:`ov2slam_torch.device.resolve_device`); ``None`` is torch's
    default device."""
    K = torch.tensor(
        [[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1]], dtype=dtype,
        device=device)
    dist = torch.tensor(np.asarray(cfg.dist, np.float64), dtype=dtype,
                        device=device)
    if other is not None and cfg.T_body_cam is not None \
            and other.T_body_cam is not None:
        T_b_ci = lie.pose_from_matrix(torch.as_tensor(
            np.asarray(cfg.T_body_cam), dtype=dtype, device=device))
        T_b_c0 = lie.pose_from_matrix(torch.as_tensor(
            np.asarray(other.T_body_cam), dtype=dtype, device=device))
        T_c0_ci = lie.pose_relative(T_b_c0, T_b_ci)
    else:
        T_c0_ci = lie.pose_identity(dtype, device)
    cam = Camera(model=cfg.model, width=cfg.width, height=cfg.height,
                 K=K, dist=dist, T_c0_ci=T_c0_ci)
    if build_undist_map and bool(np.any(np.asarray(cfg.dist))):
        cam = dataclasses.replace(cam, undist_map=compute_undist_map(cam))
    return cam


def compute_undist_map(cam: Camera) -> torch.Tensor:
    """LUT mapping each *undistorted* output pixel to its source position in
    the distorted input image (forward distortion of the output grid)."""
    ys, xs = torch.meshgrid(
        torch.arange(cam.height, dtype=cam.K.dtype, device=cam.device),
        torch.arange(cam.width, dtype=cam.K.dtype, device=cam.device),
        indexing="ij",
    )
    px = torch.stack([xs, ys], dim=-1)
    xn = (px - cam._c()) / cam._f()
    xd = cam._distort_fn()(xn, cam.dist)
    return xd * cam._f() + cam._c()


# --------------------------------------------------------------------------
# Bilinear sampling (shared by remap, KLT, BRIEF)
# --------------------------------------------------------------------------

def bilinear_sample(img, coords, out_of_bounds: float = 0.0):
    """Sample ``img`` (H, W) at ``coords`` (..., 2) xy with bilinear interp.

    Out-of-bounds samples return ``out_of_bounds``; neighbours of an
    in-bounds sample are clamped to the border.
    """
    H, W = img.shape[-2], img.shape[-1]
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    # clamp before the int cast: NaN/huge coords must not overflow int64
    x0i = x0.clamp(-2, W + 1).nan_to_num(-2).long()
    y0i = y0.clamp(-2, H + 1).nan_to_num(-2).long()
    flat = img.reshape(img.shape[:-2] + (H * W,))

    def gather(yi, xi):
        return flat[..., yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    val = (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return torch.where(valid, val, torch.full_like(val, out_of_bounds))


# --------------------------------------------------------------------------
# Stereo rectification
# --------------------------------------------------------------------------

def stereo_rectify(
    cam_l: Camera, cam_r: Camera
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Rectifying rotations and shared intrinsics for a stereo pair
    (cv::stereoRectify as used by `ov2slam.cpp:343-426`), on the host in
    float64: returns (R_rect_l (3,3), R_rect_r (3,3), K_new (3,3),
    baseline). After rectification the right camera sits at [+b, 0, 0] in
    the left rectified frame and epipolar lines are horizontal."""
    T_lr = cam_r.T_c0_ci.detach().cpu().numpy().astype(np.float64)
    R_lr = lie_np.quat_to_matrix(T_lr[0:4])
    t_lr = T_lr[4:7]

    # new shared orientation A (rows = new axes in the left frame): x along
    # the baseline, y close to the left camera's image-down axis, z = x × y
    e1 = t_lr / np.linalg.norm(t_lr)
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    R_rect_l = np.stack([e1, e2, e3], axis=0)
    # x_rect_r = (A @ R_lr) x_r shares orientation with x_rect_l = A x_l
    R_rect_r = R_rect_l @ R_lr

    baseline = float(np.linalg.norm(t_lr))
    K_new = 0.5 * (cam_l.K.detach().cpu().numpy().astype(np.float64)
                   + cam_r.K.detach().cpu().numpy().astype(np.float64))
    K_new[0, 1] = 0.0
    return R_rect_l, R_rect_r, K_new, baseline


def compute_rectify_map(cam: Camera, R_rect: np.ndarray,
                        K_new: np.ndarray) -> torch.Tensor:
    """Remap LUT (H, W, 2) on the camera's device: rectified output pixel
    → raw input pixel, folding the rectifying rotation and the distortion
    (`setUndistStereoMap`, `camera_calibration.cpp:134-194`)."""
    dtype, dev = cam.K.dtype, cam.device
    ys, xs = torch.meshgrid(
        torch.arange(cam.height, dtype=dtype, device=dev),
        torch.arange(cam.width, dtype=dtype, device=dev), indexing="ij")
    K_new = torch.as_tensor(np.asarray(K_new), dtype=dtype, device=dev)
    xn = torch.stack(
        [(xs - K_new[0, 2]) / K_new[0, 0], (ys - K_new[1, 2]) / K_new[1, 1],
         torch.ones_like(xs)], dim=-1)
    # rotate back into the raw camera frame
    Rinv = torch.as_tensor(np.asarray(R_rect), dtype=dtype, device=dev).T
    v = xn @ Rinv.T
    xn_raw = v[..., 0:2] / v[..., 2:3]
    xd = cam._distort_fn()(xn_raw, cam.dist)
    return xd * cam._f() + cam._c()
