"""Camera models — port of ``ov2slam_tpu/core/camera.py``.

Supports the two models of the reference:
- ``pinhole``: radtan distortion [k1 k2 p1 p2]
- ``fisheye``: Kannala–Brandt equidistant-4 [k1 k2 k3 k4]

All projection/undistortion functions are pure and batched over leading
dims. The camera's parameters are tensors on the camera's device.

The fixed-point undistortion and the distortion of points
(:func:`undistort_points`, :func:`distort_points`) launch
``csrc/undistort_points.cu`` on CUDA tensors, one launch a call, and take
their plain versions (:func:`undistort_points_plain`,
:func:`distort_points_plain`) on CPU tensors. So does the tracks' tail
(:func:`undistort_normalize`: select, undistort, normalise, and the pair
mask, in one launch of the same library; plain version
:func:`undistort_normalize_plain`).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import launch
from ..ops.launch import check, device_of
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


def _distort_fn(fisheye: bool):
    return distort_fisheye if fisheye else distort_radtan


# --------------------------------------------------------------------------
# Points through the camera's distortion: plain versions and the kernel
# --------------------------------------------------------------------------

def _undistort(px, fx, fy, cx, cy, dist, fisheye: bool, iters: int):
    f, c = torch.stack([fx, fy]), torch.stack([cx, cy])
    xn = (px - c) / f
    xu = _undistort_iterative(xn, dist, _distort_fn(fisheye), iters)
    return xu * f + c


def undistort_points_plain(px, fx, fy, cx, cy, dist, fisheye: bool = False,
                           iters: int = 8):
    """Distorted pixels (..., 2) → undistorted pixels, in plain PyTorch:
    normalised by the intrinsics (0-d tensors), ``iters`` fixed-point
    steps of the radtan or fisheye model, and back to pixels."""
    if px.is_cuda:
        undistort_points_plain.cuda_runs += 1
    return _undistort(px, fx, fy, cx, cy, dist, fisheye, iters)


def distort_points_plain(x, fx, fy, cx, cy, dist, fisheye: bool = False,
                         normalized: bool = False):
    """Undistorted pixels (..., 2) — or normalised coordinates, with
    ``normalized`` — → distorted pixels, in plain PyTorch."""
    if x.is_cuda:
        distort_points_plain.cuda_runs += 1
    f, c = torch.stack([fx, fy]), torch.stack([cx, cy])
    xn = x if normalized else (x - c) / f
    return _distort_fn(fisheye)(xn, dist) * f + c


class TailOut(NamedTuple):
    """The outputs of :func:`undistort_normalize`; a part its call left out
    is None."""
    tracked: Optional[torch.Tensor]   # (N, 2): the select's pixels
    und: torch.Tensor                 # (N, 2): undistorted pixels
    xr: torch.Tensor                  # (N, 2): und normalised
    xl: Optional[torch.Tensor]        # (N, 2): the reference rows' xn
    pair: Optional[torch.Tensor]      # (N,) bool: status & ref_valid


def _tail_options(fn, px, status, ref, ref_valid):
    """The option set of a tail call, as its counters' key names it
    ("select", "ref", "pair", joined by "+"; "" for none); raises
    ValueError on a set the kernel does not run."""
    if (px is None) != (status is None):
        raise ValueError(f"{fn}: px and status go together (the select)")
    if ref_valid is not None and (status is None or ref is None):
        raise ValueError(f"{fn}: the pair mask needs the select and the "
                         "reference rows")
    return "+".join(name for name, t in (("select", px), ("ref", ref),
                                          ("pair", ref_valid))
                    if t is not None)


def undistort_normalize_plain(rows, fx, fy, cx, cy, dist,
                              fisheye: bool = False, iters: int = 8, *,
                              px=None, status=None, ref=None,
                              ref_intrinsics=None, ref_valid=None):
    """The tracks' tail in plain PyTorch, the eager operations the front
    end and stereo mapping ran around the undistortion: with ``px`` and
    ``status`` the select ``tracked = where(status, rows, px)``; ``und``
    the undistortion of ``tracked`` (else of ``rows``); ``xr = (und - c) /
    f``; with ``ref`` (N, 2), ``xl = (ref - c_ref) / f_ref`` under
    ``ref_intrinsics`` (fx, fy, cx, cy; the tracks' own by default); with
    ``ref_valid`` the pair mask ``status & ref_valid``."""
    _tail_options("undistort_normalize", px, status, ref, ref_valid)
    if rows.is_cuda:
        undistort_normalize_plain.cuda_runs += 1
    tracked = None if px is None else torch.where(status[:, None], rows, px)
    und = _undistort(rows if tracked is None else tracked, fx, fy, cx, cy,
                     dist, fisheye, iters)
    xr = (und - torch.stack([cx, cy])) / torch.stack([fx, fy])
    xl = None
    if ref is not None:
        rfx, rfy, rcx, rcy = ref_intrinsics or (fx, fy, cx, cy)
        xl = (ref - torch.stack([rcx, rcy])) / torch.stack([rfx, rfy])
    pair = None if ref_valid is None else status & ref_valid
    return TailOut(tracked, und, xr, xl, pair)


# calls on CUDA tensors (the card runs the kernel instead)
undistort_points_plain.cuda_runs = 0
distort_points_plain.cuda_runs = 0
undistort_normalize_plain.cuda_runs = 0

# the kernel's modes
MODE_UNDISTORT, MODE_DISTORT_PX, MODE_DISTORT_NORMALIZED = 0, 1, 2


class PointsLaunch(NamedTuple):
    """The arguments of ``undistort_points_launch`` but the output and the
    stream."""
    pts: int
    n: int
    stride: int
    fx: int
    fy: int
    cx: int
    cy: int
    dist: int
    mode: int
    fisheye: int
    iters: int


def _scalar_ptrs(fn, dev, names, ts):
    ptrs = []
    for name, t in zip(names, ts):
        check(fn, name, t, torch.float32, dev)
        if t.numel() != 1:
            raise ValueError(f"{fn}: {name} must have one element")
        ptrs.append(t.data_ptr())
    return ptrs


def pack_points(x, fx, fy, cx, cy, dist, fisheye: bool, mode: int,
                iters: int = 8) -> PointsLaunch:
    """Checks a launch of ``csrc/undistort_points.cu`` and packs its
    arguments; raises on what the kernel does not take: TypeError on a
    dtype (f32 only), ValueError on another device, points that are not
    rows of 2 adjacent values (a 2-D view may have any row stride, more
    dimensions must be contiguous), intrinsics that are not one element,
    coefficients that are not 4 contiguous values, or a mode or iteration
    count it does not run."""
    fn = "undistort_points"
    dev = device_of(x, fn)
    if x.dim() < 1 or x.shape[-1] != 2:
        raise ValueError(f"{fn}: points must be (..., 2), not "
                         f"{tuple(x.shape)}")
    if x.dim() != 2:
        check(fn, "points", x, torch.float32, dev)
        x = x.reshape(-1, 2)
    stride = check(fn, "points", x, torch.float32, dev, rows=True)
    ptrs = _scalar_ptrs(fn, dev, ("fx", "fy", "cx", "cy"), (fx, fy, cx, cy))
    check(fn, "dist", dist, torch.float32, dev, shape=(4,))
    if mode not in (MODE_UNDISTORT, MODE_DISTORT_PX,
                    MODE_DISTORT_NORMALIZED):
        raise ValueError(f"{fn}: mode {mode}")
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"{fn}: iters {iters}")
    return PointsLaunch(x.data_ptr(), x.shape[0], stride, *ptrs,
                        dist.data_ptr(), mode, int(bool(fisheye)), iters)


def launch_points(x, fx, fy, cx, cy, dist, fisheye: bool, mode: int,
                  iters: int = 8):
    """One launch of ``csrc/undistort_points.cu`` on CUDA tensors, on the
    current stream of their device; returns the pixels (..., 2). No
    points launch nothing."""
    a = pack_points(x, fx, fy, cx, cy, dist, fisheye, mode, iters)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if a.n > 0:
        launch.run("undistort_points", (*a, out.data_ptr()),
                    undistort_points, (mode, a.n), x.device)
    return out


def undistort_points(px, fx, fy, cx, cy, dist, fisheye: bool = False,
                     iters: int = 8):
    """Distorted pixels (..., 2) → undistorted pixels (see
    :func:`undistort_points_plain`). CPU tensors take the plain version;
    CUDA tensors one kernel launch, which reads the intrinsics (one-element
    f32 tensors) and the coefficients on the device."""
    if device_of(px, "undistort_points").type == "cpu":
        return undistort_points_plain(px, fx, fy, cx, cy, dist, fisheye,
                                      iters)
    return launch_points(px, fx, fy, cx, cy, dist, fisheye, MODE_UNDISTORT,
                         iters)


def distort_points(x, fx, fy, cx, cy, dist, fisheye: bool = False,
                   normalized: bool = False):
    """Undistorted pixels (or normalised coordinates) (..., 2) → distorted
    pixels (see :func:`distort_points_plain`). CPU tensors take the plain
    version; CUDA tensors one launch of the undistortion kernel in its
    distortion mode."""
    if device_of(x, "distort_points").type == "cpu":
        return distort_points_plain(x, fx, fy, cx, cy, dist, fisheye,
                                    normalized)
    return launch_points(x, fx, fy, cx, cy, dist, fisheye,
                         MODE_DISTORT_NORMALIZED if normalized
                         else MODE_DISTORT_PX)


# launches of the kernel (by undistort_points and distort_points; a launch
# inside a CUDA graph counts on each replay), how many at each (mode, N),
# and how many from each (thread name, CUDA stream handle)
undistort_points.launches = 0
undistort_points.shapes = collections.Counter()
undistort_points.origins = collections.Counter()


class TailLaunch(NamedTuple):
    """The arguments of ``undistort_normalize_launch`` before the outputs
    (pointers as ints, None for a part left out)."""
    rows: int
    rows_stride: int
    px: Optional[int]
    px_stride: int
    status: Optional[int]
    ref: Optional[int]
    ref_stride: int
    ref_valid: Optional[int]
    n: int
    fx: int
    fy: int
    cx: int
    cy: int
    dist: int
    rfx: Optional[int]
    rfy: Optional[int]
    rcx: Optional[int]
    rcy: Optional[int]
    fisheye: int
    iters: int


def pack_tail(rows, fx, fy, cx, cy, dist, fisheye: bool = False,
              iters: int = 8, *, px=None, status=None, ref=None,
              ref_intrinsics=None, ref_valid=None):
    """Checks a launch of the tracks' tail (``undistort_normalize_launch``)
    and packs its arguments; returns (:class:`TailLaunch`, the options'
    name). Raises on what the kernel does not take: TypeError on a dtype
    (f32 rows and calibration, bool masks), ValueError on another device,
    rows that are not (N, 2) rows of adjacent values (any row stride: a
    column view of a packed state is read in place), masks that are not
    contiguous (N,), intrinsics that are not one element, coefficients
    that are not 4 contiguous values, an option set it does not run
    (``_tail_options``), or a negative iteration count."""
    fn = "undistort_normalize"
    opts = _tail_options(fn, px, status, ref, ref_valid)
    dev = device_of(rows, fn)
    if rows.dim() != 2 or rows.shape[1] != 2:
        raise ValueError(f"{fn}: rows must be (N, 2), not "
                         f"{tuple(rows.shape)}")
    n = rows.shape[0]
    stride = check(fn, "rows", rows, torch.float32, dev, rows=True)
    px_ptr = status_ptr = ref_ptr = valid_ptr = None
    px_stride = ref_stride = 0
    if px is not None:
        px_stride = check(fn, "px", px, torch.float32, dev, shape=(n, 2),
                          rows=True)
        check(fn, "status", status, torch.bool, dev, shape=(n,))
        px_ptr, status_ptr = px.data_ptr(), status.data_ptr()
    if ref is not None:
        ref_stride = check(fn, "ref", ref, torch.float32, dev,
                           shape=(n, 2), rows=True)
        ref_ptr = ref.data_ptr()
    if ref_valid is not None:
        check(fn, "ref_valid", ref_valid, torch.bool, dev, shape=(n,))
        valid_ptr = ref_valid.data_ptr()
    intr = _scalar_ptrs(fn, dev, ("fx", "fy", "cx", "cy"), (fx, fy, cx, cy))
    check(fn, "dist", dist, torch.float32, dev, shape=(4,))
    rintr = [None] * 4
    if ref is not None:
        rintr = _scalar_ptrs(fn, dev, ("ref fx", "ref fy", "ref cx",
                                       "ref cy"),
                             ref_intrinsics or (fx, fy, cx, cy))
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"{fn}: iters {iters}")
    return TailLaunch(rows.data_ptr(), stride, px_ptr, px_stride,
                      status_ptr, ref_ptr, ref_stride, valid_ptr, n, *intr,
                      dist.data_ptr(), *rintr, int(bool(fisheye)),
                      iters), opts


def undistort_normalize(rows, fx, fy, cx, cy, dist, fisheye: bool = False,
                        iters: int = 8, *, px=None, status=None, ref=None,
                        ref_intrinsics=None, ref_valid=None) -> TailOut:
    """The tracks' tail (see :func:`undistort_normalize_plain`): select,
    undistort, normalise, and the reference rows' normalisation and the
    pair mask where asked. CPU tensors take the plain version; CUDA
    tensors one launch of ``csrc/undistort_points.cu``'s second kernel,
    which reads the calibration on the device. No rows launch nothing."""
    if device_of(rows, "undistort_normalize").type == "cpu":
        return undistort_normalize_plain(
            rows, fx, fy, cx, cy, dist, fisheye, iters, px=px,
            status=status, ref=ref, ref_intrinsics=ref_intrinsics,
            ref_valid=ref_valid)
    a, opts = pack_tail(rows, fx, fy, cx, cy, dist, fisheye, iters, px=px,
                        status=status, ref=ref,
                        ref_intrinsics=ref_intrinsics, ref_valid=ref_valid)
    n, dev = a.n, rows.device
    # the (N, 2) outputs in one allocation
    outs = iter(torch.empty((2 + (px is not None) + (ref is not None), n, 2),
                            dtype=torch.float32, device=dev).unbind(0))
    out = TailOut(
        tracked=next(outs) if px is not None else None, und=next(outs),
        xr=next(outs), xl=next(outs) if ref is not None else None,
        pair=(torch.empty(n, dtype=torch.bool, device=dev)
              if ref_valid is not None else None))
    if n > 0:
        launch.run("undistort_points", (
            *a, *(None if t is None else t.data_ptr() for t in out)),
            undistort_normalize, (opts, n), dev,
            fn="undistort_normalize_launch")
    return out


# launches of the tail's kernel (a launch inside a CUDA graph counts on
# each replay), how many at each (options, N), and how many from each
# (thread name, CUDA stream handle)
undistort_normalize.launches = 0
undistort_normalize.shapes = collections.Counter()
undistort_normalize.origins = collections.Counter()


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

    @property
    def fisheye(self) -> bool:
        return self.model == "fisheye"

    def _intrinsics(self):
        """(fx, fy, cx, cy) as 0-d views of ``K`` (read on the device)."""
        return self.fx, self.fy, self.cx, self.cy

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
        return distort_points(xn, *self._intrinsics(), self.dist,
                              self.fisheye, normalized=True)

    def undistort_px(self, px):
        """Distorted pixels (..., 2) → undistorted pixels."""
        return undistort_points(px, *self._intrinsics(), self.dist,
                                self.fisheye)

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
    return distort_points(px, *cam._intrinsics(), cam.dist, cam.fisheye)


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
    return distort_points(xn_raw, *cam._intrinsics(), cam.dist, cam.fisheye,
                          normalized=True)
