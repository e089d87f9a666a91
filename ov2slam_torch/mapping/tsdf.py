"""TSDF volumetric mapping — port of ``ov2slam_tpu/mapping/tsdf.py``, the
replacement for the fork's voxblox glue (`launch/carla.launch:28-76` runs a
voxblox `tsdf_server` over the fused RGB-D cloud from
`scripts/talker.py`; params: voxel 0.1 m, truncation 0.3 m, ray bounds
0.5-10 m, 1/z^2 weights, color mode, PLY mesh output, ESDF distances).

Integration is projective (KinectFusion-style): every voxel of a fixed
dense grid is projected into the depth image and updated in one
elementwise + gather pass. The grid (``tsdf`` (V,), ``weight`` (V,),
``color`` (V, 3), f32) lives on the device and is updated in place; the
ESDF is a chamfer sweep of 6-neighbour min-plus updates on the device,
from an occupancy grid built there. Meshing (naive surface nets), surface
points and PLY export run on the host in numpy, as in the JAX package.

On the card both run as hand kernels (``csrc/tsdf.cu``:
``tsdf_integrate_launch``, one launch an integration;
``esdf_sweep_launch``, one launch a sweep), bit-equal to the plain
versions (``_tsdf_integrate_plain``, ``_esdf_sweep_plain``), which CPU
tensors take. Each wrapper counts its launches (``.launches``, ``.shapes``,
``.origins``); each plain version its runs on the card (``.cuda_runs``).

Both packages project the same points: voxel centres are ``origin + (idx
+ 0.5) * voxel`` in f32 in the grid's C order, and the camera transform is
the same quaternion rotation, one coordinate at a time, so no (V, 3)
temporary is made for it.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import launch
from ..ops.launch import check, device_of, number
from ..utils import lie_np


def _f32(x) -> float:
    """``x`` rounded to f32, as a Python float (exact in f32 arithmetic)."""
    return float(np.float32(x))


def _voxel_centers_cam(dims, origin, voxel, T_cw, device):
    """Camera-frame coordinates (x, y, z), each (V,) in the grid's C order,
    of every voxel centre: ``pose_apply(T_cw, origin + (idx + 0.5) *
    voxel)`` with the rotation written out per coordinate
    (``lie.quat_rotate``'s order). The centres' coordinates are three
    broadcast axes, so the terms that involve one or two axes only are
    computed on those axes; every value is the f32 operation the JAX
    package makes on the same operands."""
    vox = _f32(voxel)
    p = [((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
          * vox + _f32(o)).view([n if a == k else 1 for a in range(3)])
         for k, (n, o) in enumerate(zip(dims, origin))]
    qw, qx, qy, qz, tx, ty, tz = (_f32(v) for v in T_cw)
    # uv = qv x p, uuv = qv x uv, pc = p + 2 (qw uv + uuv) + t
    uv = (qy * p[2] - qz * p[1], qz * p[0] - qx * p[2],
          qx * p[1] - qy * p[0])
    uuv = (qy * uv[2] - qz * uv[1], qz * uv[0] - qx * uv[2],
           qx * uv[1] - qy * uv[0])
    return [(p[k] + 2.0 * (qw * uv[k] + uuv[k]) + t).reshape(-1)
            for k, t in enumerate((tx, ty, tz))]


def _voxel_pixels(dims, origin, voxel, T_cw, fx, fy, cx, cy, hw, device):
    """Where every voxel centre projects: the flat index ``v * W + u`` (int32)
    of its pixel (``u``, ``v`` rounded half to even, then clipped to the
    image), whether the centre lies in front of the camera and inside the
    image, and its camera-frame depth ``z``."""
    H, W = hw
    x, y, z = _voxel_centers_cam(dims, origin, voxel, T_cw, device)
    zs = torch.where(z > 1e-6, z, 1.0)
    u = _f32(fx) * x / zs + _f32(cx)
    v = _f32(fy) * y / zs + _f32(cy)
    del x, y, zs
    # clipped before the conversion, so that a centre just in front of the
    # camera plane (|u| or |v| beyond int32) gets the same pixel on every
    # device; inside the image this is the JAX package's clip after it
    pix = (torch.round(v).clamp_(0, H - 1).to(torch.int32) * W
           + torch.round(u).clamp_(0, W - 1).to(torch.int32))
    in_img = (z > 1e-6) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return pix, in_img, z


def _tsdf_integrate_plain(tsdf, weight, color, depth, rgb, T_cw, fx, fy,
                          cx, cy, origin, voxel, trunc, min_ray, max_ray,
                          max_weight, dims: Tuple[int, int, int],
                          use_const_weight: bool):
    """One projective TSDF update over the whole grid, in place, in plain
    PyTorch (the CPU's path, and what the kernel is held to on the card).

    tsdf:   (V,) signed distance in truncation units, in [-1, 1]
    weight: (V,) accumulated observation weight
    color:  (V, 3) running-average color (f32) or None
    depth:  (H, W) metric depth tensor; rgb: (H, W, 3) tensor or None
    T_cw:   (7,) world->camera pose [q, t] (host values)

    The new tsdf and colour are averaged with the *old* weight; the stored
    weight is clamped to ``max_weight`` only after that.
    """
    if tsdf.is_cuda:
        _tsdf_integrate_plain.cuda_runs += 1
    pix, in_img, z = _voxel_pixels(dims, origin, voxel, T_cw, fx, fy, cx,
                                   cy, depth.shape, tsdf.device)
    d = depth.reshape(-1)[pix]
    d_ok = torch.isfinite(d) & (d >= _f32(min_ray)) & (d <= _f32(max_ray))
    sdf = d - z
    del z
    # update only voxels in front of / within one truncation band behind
    # the measured surface (voxblox: no carving beyond -trunc)
    upd = in_img & d_ok & (sdf > -_f32(trunc))
    del in_img, d_ok
    tsdf_obs = torch.clamp(sdf / _f32(trunc), -1.0, 1.0)
    del sdf

    if use_const_weight:
        w_obs = torch.ones_like(d)
    else:  # voxblox use_const_weight=false => 1/z^2 dropoff
        w_obs = 1.0 / torch.clamp(d, min=1e-3) ** 2
    w_obs = torch.where(upd, w_obs, 0.0)
    del d, upd

    w_new = weight + w_obs
    denom = torch.clamp(w_new, min=1e-9)
    tsdf.mul_(weight).add_(tsdf_obs * w_obs).div_(denom)
    del tsdf_obs
    if color is not None and rgb is not None:
        c_obs = rgb.reshape(-1, 3)[pix]
        color.mul_(weight[:, None]).add_(c_obs.mul_(w_obs[:, None])) \
            .div_(denom[:, None])
        del c_obs
    weight.copy_(torch.clamp(w_new, max=_f32(max_weight)))
    return tsdf, weight, color


def _esdf_sweep_plain(occ_dist, voxel, n_iters: int):
    """Chamfer distance transform: n_iters of 6-neighbor min-plus updates
    (each iteration propagates distance one voxel outward). Each iteration
    takes its six minimums against the start-of-iteration grid, padded
    once with 1e9 (a Jacobi step, as the JAX package's ``lax.scan``).
    Plain PyTorch (the CPU's path, and what the kernel is held to on the
    card); returns a new grid."""
    if occ_dist.is_cuda:
        _esdf_sweep_plain.cuda_runs += 1
    vox = _f32(voxel)
    d = occ_dist.clone()
    for _ in range(n_iters):
        # the padded start-of-iteration grid, one voxel added (the same
        # f32 sums the JAX package forms per neighbour)
        p = F.pad(d[None, None], (1, 1, 1, 1, 1, 1), value=1e9)[0, 0]
        p += vox
        for nb in (p[:-2, 1:-1, 1:-1], p[2:, 1:-1, 1:-1],
                   p[1:-1, :-2, 1:-1], p[1:-1, 2:, 1:-1],
                   p[1:-1, 1:-1, :-2], p[1:-1, 1:-1, 2:]):
            torch.minimum(d, nb, out=d)
    return d


# calls on CUDA tensors (the card runs the kernels instead)
_tsdf_integrate_plain.cuda_runs = 0
_esdf_sweep_plain.cuda_runs = 0

# the largest grid the kernels index (int32 voxel offsets), and the plain
# version's constants they take as f32 arguments
MAX_VOXELS = 1 << 31
Z_MIN, MIN_DEPTH, MIN_DENOM, ESDF_PAD = 1e-6, 1e-3, 1e-9, 1e9
# the sweep kernels' smallest tile in y and shortest run of x planes
# (csrc/tsdf.cu), and CUDA's grid limit in y and z: the largest ny and nx
# a launch covers
SWEEP_TILE_Y, SWEEP_RUN_X, GRID_YZ = 8, 2, 65535


class IntegrateLaunch(NamedTuple):
    """The arguments of ``tsdf_integrate_launch`` but the stream: device
    pointers (color and rgb 0 together: no colour update), the sizes, and
    the f32 values the plain version computes with."""
    tsdf: int
    weight: int
    color: int
    depth: int
    rgb: int
    nx: int
    ny: int
    nz: int
    H: int
    W: int
    qw: float
    qx: float
    qy: float
    qz: float
    tx: float
    ty: float
    tz: float
    fx: float
    fy: float
    cx: float
    cy: float
    ox: float
    oy: float
    oz: float
    voxel: float
    z_min: float
    inv_trunc: float
    neg_trunc: float
    min_ray: float
    max_ray: float
    min_depth: float
    min_denom: float
    max_weight: float
    const_weight: int


def _dims(fn: str, dims) -> Tuple[int, int, int]:
    if len(dims) != 3 or any(not isinstance(n, (int, np.integer)) or n < 1
                             for n in dims):
        raise ValueError(f"{fn}: dims must be three positive ints, not "
                         f"{dims}")
    dims = tuple(int(n) for n in dims)
    if dims[0] * dims[1] * dims[2] >= MAX_VOXELS:
        raise ValueError(f"{fn}: {dims} holds 2^31 voxels or more; the "
                         "kernel indexes fewer")
    return dims


def _host_floats(fn: str, name: str, x, n: int) -> np.ndarray:
    """``x`` (n host numbers) as f32; a tensor is refused (reading one
    would wait for the device)."""
    if isinstance(x, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be host values, not a tensor")
    a = np.asarray(x, np.float32).reshape(-1)
    if a.shape != (n,):
        raise ValueError(f"{fn}: {name} must hold {n} values")
    return a


def pack_integrate(tsdf, weight, color, depth, rgb, T_cw, fx, fy, cx, cy,
                   origin, voxel, trunc, min_ray, max_ray, max_weight,
                   dims, use_const_weight: bool) -> IntegrateLaunch:
    """Checks one launch of ``tsdf_integrate_launch`` and packs its
    arguments (as :func:`_tsdf_integrate` takes them); raises on what the
    kernel does not take: TypeError on a dtype (f32 only) or a tensor
    where host numbers go, ValueError on another device, a tensor that is
    not contiguous, shapes that do not match the grid or the image, or a
    grid of 2^31 voxels or more. The f32 constants are the plain version's
    on the card: ``sdf / trunc`` is ATen's product with ``1 / trunc``
    formed in f32 for a CPU-scalar divisor; the clamps' and comparisons'
    Python numbers rounded to f32."""
    fn = "tsdf_integrate"
    nx, ny, nz = _dims(fn, dims)
    V = nx * ny * nz
    dev = device_of(tsdf, fn)
    check(fn, "tsdf", tsdf, torch.float32, dev, shape=(V,))
    check(fn, "weight", weight, torch.float32, dev, shape=(V,))
    if depth.dim() != 2:
        raise ValueError(f"{fn}: depth must be (H, W), not "
                         f"{tuple(depth.shape)}")
    H, W = depth.shape
    if H * W >= MAX_VOXELS:
        raise ValueError(f"{fn}: a {H}x{W} image is above what the kernel "
                         "indexes")
    check(fn, "depth", depth, torch.float32, dev)
    with_color = color is not None and rgb is not None
    if with_color:
        check(fn, "color", color, torch.float32, dev, shape=(V, 3))
        check(fn, "rgb", rgb, torch.float32, dev, shape=(H, W, 3))
    q = _host_floats(fn, "T_cw", T_cw, 7)
    o = _host_floats(fn, "origin", origin, 3)
    f32 = np.float32
    trunc32 = f32(number(fn, "trunc", trunc))
    return IntegrateLaunch(
        tsdf.data_ptr(), weight.data_ptr(),
        color.data_ptr() if with_color else 0, depth.data_ptr(),
        rgb.data_ptr() if with_color else 0, nx, ny, nz, H, W,
        *(float(v) for v in q),
        *(_f32(number(fn, n, v)) for n, v in (("fx", fx), ("fy", fy),
                                               ("cx", cx), ("cy", cy))),
        *(float(v) for v in o), _f32(number(fn, "voxel", voxel)),
        _f32(Z_MIN), float(f32(1.0) / trunc32), float(-trunc32),
        _f32(number(fn, "min_ray", min_ray)),
        _f32(number(fn, "max_ray", max_ray)), _f32(MIN_DEPTH),
        _f32(MIN_DENOM), _f32(number(fn, "max_weight", max_weight)),
        int(bool(use_const_weight)))


def _tsdf_integrate(tsdf, weight, color, depth, rgb, T_cw, fx, fy, cx, cy,
                    origin, voxel, trunc, min_ray, max_ray, max_weight,
                    dims: Tuple[int, int, int], use_const_weight: bool):
    """One projective TSDF update over the whole grid, in place (see
    :func:`_tsdf_integrate_plain`). CPU tensors take the plain version;
    CUDA tensors one launch of ``csrc/tsdf.cu``'s integration kernel on
    the current stream, bit-equal to the plain version there."""
    if device_of(tsdf, "tsdf_integrate").type == "cpu":
        return _tsdf_integrate_plain(
            tsdf, weight, color, depth, rgb, T_cw, fx, fy, cx, cy, origin,
            voxel, trunc, min_ray, max_ray, max_weight, dims,
            use_const_weight)
    a = pack_integrate(tsdf, weight, color, depth, rgb, T_cw, fx, fy, cx,
                       cy, origin, voxel, trunc, min_ray, max_ray,
                       max_weight, dims, use_const_weight)
    launch.run("tsdf", a, _tsdf_integrate,
               (a.nx, a.ny, a.nz, a.H, a.W, a.color != 0, a.const_weight),
               tsdf.device)
    return tsdf, weight, color


_tsdf_integrate.launches = 0
_tsdf_integrate.shapes = collections.Counter()
_tsdf_integrate.origins = collections.Counter()


def pack_sweep(occ_dist, voxel, n_iters: int):
    """Checks the sweeps of ``esdf_sweep_launch`` on ``occ_dist``; returns
    (dims, voxel in f32, the padding value in f32). Raises TypeError on a
    dtype (f32 only), ValueError on a grid that is not 3-D and contiguous,
    of 2^31 voxels or more, or beyond the launch grid's reach, or on a
    negative sweep count."""
    fn = "esdf_sweep"
    dev = device_of(occ_dist, fn)
    if occ_dist.dim() != 3:
        raise ValueError(f"{fn}: the grid must be (nx, ny, nz), not "
                         f"{tuple(occ_dist.shape)}")
    dims = _dims(fn, tuple(occ_dist.shape))
    check(fn, "grid", occ_dist, torch.float32, dev)
    if dims[0] > SWEEP_RUN_X * GRID_YZ or dims[1] > SWEEP_TILE_Y * GRID_YZ:
        raise ValueError(f"{fn}: {dims} is beyond one launch's grid")
    if not isinstance(n_iters, (int, np.integer)) or n_iters < 0:
        raise ValueError(f"{fn}: n_iters {n_iters}")
    return dims, _f32(number(fn, "voxel", voxel)), _f32(ESDF_PAD)


def _esdf_sweep(occ_dist, voxel, n_iters: int):
    """Chamfer distance transform (see :func:`_esdf_sweep_plain`); returns a
    new grid and leaves ``occ_dist`` as it is. CPU tensors take the plain
    version; CUDA tensors one launch of ``csrc/tsdf.cu``'s sweep kernel a
    sweep, from one buffer into the other, bit-equal to the plain
    version."""
    if device_of(occ_dist, "esdf_sweep").type == "cpu":
        return _esdf_sweep_plain(occ_dist, voxel, n_iters)
    dims, vox, pad = pack_sweep(occ_dist, voxel, n_iters)
    if n_iters == 0:
        return occ_dist.clone()
    bufs = [torch.empty_like(occ_dist)]
    if n_iters > 1:
        bufs.append(torch.empty_like(occ_dist))
    src = occ_dist
    for s in range(int(n_iters)):
        dst = bufs[s % 2]
        launch.run("tsdf", (src.data_ptr(), dst.data_ptr(), *dims, vox,
                            pad), _esdf_sweep, dims, occ_dist.device,
                   fn="esdf_sweep_launch")
        src = dst
    return src


_esdf_sweep.launches = 0
_esdf_sweep.shapes = collections.Counter()
_esdf_sweep.origins = collections.Counter()


@dataclass
class TsdfVolume:
    """Fixed-capacity dense TSDF grid on ``device`` (``None`` = the GPU)."""

    origin: np.ndarray                       # (3,) world min corner
    dims: Tuple[int, int, int]               # voxels per axis
    voxel_size: float = 0.1                  # carla.launch voxel_size
    truncation: float = 0.3                  # truncation_distance
    min_ray: float = 0.5                     # min_ray_length_m
    max_ray: float = 10.0                    # max_ray_length_m
    use_const_weight: bool = False           # use_const_weight
    max_weight: float = 1e4
    with_color: bool = True
    device: object = None

    tsdf: torch.Tensor = field(init=False)
    weight: torch.Tensor = field(init=False)
    color: Optional[torch.Tensor] = field(init=False)
    n_integrated: int = field(init=False, default=0)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.dims = tuple(int(n) for n in self.dims)
        v = int(np.prod(self.dims))
        self.origin = np.asarray(self.origin, np.float32)
        self.tsdf = torch.ones(v, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros(v, dtype=torch.float32, device=self.device)
        self.color = (torch.zeros((v, 3), dtype=torch.float32,
                                  device=self.device)
                      if self.with_color else None)

    def _tensor(self, a) -> torch.Tensor:
        """``a`` (array or tensor) as an f32 tensor on the volume's
        device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def integrate(self, depth, K: np.ndarray, T_wc: np.ndarray, rgb=None):
        """Fuse one depth (+optional RGB) frame taken at camera pose T_wc
        (world-from-camera, [q, t] 7-vector). ``depth`` (H, W) and ``rgb``
        (H, W, 3) are arrays or tensors on any device."""
        T_cw = lie_np.pose_inverse(np.asarray(T_wc, np.float64))
        depth = self._tensor(depth)
        rgb_t = None
        if self.color is not None:
            rgb_t = (self._tensor(rgb) if rgb is not None else
                     torch.zeros((*depth.shape, 3), dtype=torch.float32,
                                 device=self.device))
        _tsdf_integrate(
            self.tsdf, self.weight, self.color, depth, rgb_t,
            np.asarray(T_cw, np.float32),
            K[0, 0], K[1, 1], K[0, 2], K[1, 2], self.origin,
            self.voxel_size, self.truncation, self.min_ray, self.max_ray,
            self.max_weight, dims=self.dims,
            use_const_weight=self.use_const_weight)
        self.n_integrated += 1

    def integrate_frames(self, frames: Sequence[Tuple]):
        """Fuse (depth, rgb|None, K, T_wc) tuples — same frame format as
        `io.rgbd.fuse_rgbd_frames` (the talker.py multi-camera rig)."""
        for depth, rgb, K, T_wc in frames:
            self.integrate(depth, K, T_wc, rgb=rgb)

    # ---- queries (host) ---------------------------------------------

    def _grids(self, min_weight: float):
        t = self.tsdf.cpu().numpy().reshape(self.dims)
        w = self.weight.cpu().numpy().reshape(self.dims)
        return t, w >= min_weight

    def _occupancy(self, min_weight: float) -> torch.Tensor:
        """The ESDF's start on the device, (nx, ny, nz) f32: 0 on occupied
        voxels (tsdf < 0, weight >= min_weight in f32, as ``_grids``
        compares), 1e9 elsewhere."""
        occ = (self.tsdf < 0) & (self.weight >= _f32(min_weight))
        return torch.full_like(self.tsdf, ESDF_PAD).masked_fill_(
            occ, 0.0).view(self.dims)

    def voxel_centers(self) -> np.ndarray:
        nx, ny, nz = self.dims
        g = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                 np.arange(nz), indexing="ij"),
                     -1).reshape(-1, 3)
        return self.origin + (g + 0.5) * self.voxel_size

    def extract_surface_points(self, min_weight: float = 1e-4):
        """Near-surface voxel centers (|tsdf| < 1 voxel) with colors —
        voxblox `publish_pointclouds` equivalent."""
        t = self.tsdf.cpu().numpy()
        w = self.weight.cpu().numpy()
        band = self.voxel_size / self.truncation
        sel = (w >= min_weight) & (np.abs(t) < band)
        pts = self.voxel_centers()[sel]
        cols = None
        if self.color is not None:
            cols = np.clip(self.color.cpu().numpy()[sel], 0, 255) \
                .astype(np.uint8)
        return pts, cols

    def extract_mesh(self, min_weight: float = 1e-4):
        """Naive surface nets over the zero level set.

        Returns (vertices (Nv,3), faces (Nf,3) int, colors (Nv,3) u8|None).
        One vertex per dual cell (2x2x2 voxel cube) containing a sign
        change, placed at the mean of its edge zero-crossings; two
        triangles per sign-changing voxel edge, wound toward the
        positive (outside) voxel.
        """
        t, obs = self._grids(min_weight)
        nx, ny, nz = self.dims
        # cell (i,j,k) spans voxels [i..i+1]x[j..j+1]x[k..k+1]
        cdims = (nx - 1, ny - 1, nz - 1)
        corners = np.empty((8,) + cdims, np.float32)
        cobs = np.ones(cdims, bool)
        for b in range(8):
            dx, dy, dz = b & 1, (b >> 1) & 1, (b >> 2) & 1
            corners[b] = t[dx:dx + cdims[0], dy:dy + cdims[1],
                           dz:dz + cdims[2]]
            cobs &= obs[dx:dx + cdims[0], dy:dy + cdims[1],
                        dz:dz + cdims[2]]
        neg = corners < 0
        has_vert = cobs & neg.any(0) & (~neg).any(0)
        cell_ids = -np.ones(cdims, np.int64)
        ci, cj, ck = np.nonzero(has_vert)
        cell_ids[ci, cj, ck] = np.arange(len(ci))
        if len(ci) == 0:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int64), None)

        # vertex = mean of edge zero-crossings within the cube
        offs = np.array([[b & 1, (b >> 1) & 1, (b >> 2) & 1]
                         for b in range(8)], np.float32)
        edges = [(a, b) for a in range(8) for b in range(a + 1, 8)
                 if bin(a ^ b).count("1") == 1]
        vsum = np.zeros((len(ci), 3), np.float64)
        vcnt = np.zeros(len(ci), np.float64)
        vals = corners[:, ci, cj, ck]           # (8, Nc)
        for a, b in edges:
            va, vb = vals[a], vals[b]
            cross = (va < 0) != (vb < 0)
            alpha = np.where(cross, va / np.where(
                (va - vb) == 0, 1.0, va - vb), 0.0)
            p = offs[a][None] + alpha[:, None] * (offs[b] - offs[a])[None]
            vsum += np.where(cross[:, None], p, 0.0)
            vcnt += cross
        local = vsum / np.maximum(vcnt, 1)[:, None]
        base = np.stack([ci, cj, ck], -1).astype(np.float64)
        verts = (self.origin + (base + local + 0.5) * self.voxel_size) \
            .astype(np.float32)

        # faces: for each voxel edge with a sign change, connect the 4
        # dual cells around it (two triangles), oriented by sign
        faces = []
        for axis in range(3):
            sl_lo = [slice(0, -1) if a == axis else slice(None)
                     for a in range(3)]
            sl_hi = [slice(1, None) if a == axis else slice(None)
                     for a in range(3)]
            v0, v1 = t[tuple(sl_lo)], t[tuple(sl_hi)]
            o0, o1 = obs[tuple(sl_lo)], obs[tuple(sl_hi)]
            cross = ((v0 < 0) != (v1 < 0)) & o0 & o1
            ei, ej, ek = np.nonzero(cross)
            # the 4 dual cells share this edge; offsets in the two
            # non-edge axes
            a1, a2 = [a for a in range(3) if a != axis]
            e = np.stack([ei, ej, ek], -1)
            quad_ids = []
            ok = np.ones(len(ei), bool)
            for (d1, d2) in ((0, 0), (1, 0), (1, 1), (0, 1)):
                c = e.copy()
                c[:, a1] -= d1
                c[:, a2] -= d2
                inb = ((c >= 0).all(1)
                       & (c < np.array(cdims)[None]).all(1))
                ids = np.where(
                    inb, cell_ids[c[:, 0].clip(0, cdims[0] - 1),
                                  c[:, 1].clip(0, cdims[1] - 1),
                                  c[:, 2].clip(0, cdims[2] - 1)], -1)
                ok &= ids >= 0
                quad_ids.append(ids)
            q = np.stack(quad_ids, -1)[ok]          # (Ne, 4)
            flip = (v0 < 0)[ei, ej, ek][ok]         # edge points -inside
            tri1 = np.where(flip[:, None], q[:, [0, 1, 2]],
                            q[:, [0, 2, 1]])
            tri2 = np.where(flip[:, None], q[:, [0, 2, 3]],
                            q[:, [0, 3, 2]])
            faces.append(tri1)
            faces.append(tri2)
        faces = np.concatenate(faces) if faces else np.zeros((0, 3),
                                                             np.int64)
        cols = None
        if self.color is not None:
            cg = self.color.cpu().numpy().reshape(self.dims + (3,))
            cols = np.clip(cg[ci, cj, ck], 0, 255).astype(np.uint8)
        return verts, faces, cols

    def esdf(self, max_distance: float = 5.0,
             min_weight: float = 1e-4) -> np.ndarray:
        """Euclidean-ish (chamfer) distance field from the occupied set
        (tsdf < 0) — voxblox esdf_server equivalent with
        esdf_max_distance_m/esdf_default_distance_m = max_distance. The
        occupancy grid is built and swept on the device; only the field
        comes back."""
        d0 = self._occupancy(min_weight)
        n_iters = int(np.ceil(max_distance / self.voxel_size))
        d = _esdf_sweep(d0, self.voxel_size, n_iters).cpu().numpy()
        return np.minimum(d, max_distance).astype(np.float32)

    def export_mesh_ply(self, path: str, min_weight: float = 1e-4) -> int:
        """Write the surface-nets mesh as PLY (voxblox mesh_filename
        output). Returns the face count."""
        verts, faces, cols = self.extract_mesh(min_weight)
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(verts)}\n")
            f.write("property float x\nproperty float y\n"
                    "property float z\n")
            if cols is not None:
                f.write("property uchar red\nproperty uchar green\n"
                        "property uchar blue\n")
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
            f.write("end_header\n")
            for i, p in enumerate(verts):
                row = f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}"
                if cols is not None:
                    c = cols[i]
                    row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
                f.write(row + "\n")
            for tri in faces:
                f.write(f"3 {int(tri[0])} {int(tri[1])} {int(tri[2])}\n")
        return len(faces)
