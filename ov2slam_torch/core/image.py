"""Image preprocessing: pyramids, gradients, blur, CLAHE.

Port of ``ov2slam_tpu/core/image.py`` (the reference's OpenCV
preprocessing: CLAHE + buildOpticalFlowPyramid). Images are f32 in
[0, 255]. The separable filters keep the JAX package's edge-replicated
shift-add form, tap by tap, so the port sums in the same order; CLAHE
counts its tile histograms with ``scatter_add`` instead of the TPU's
comparison-reduce (the counts are exact integers either way).

On CUDA tensors the filters launch ``csrc/separable_filter.cu``:
:func:`separable_filter` (and with it the blur, box filter and
``pyr_down``) one launch a filtered image, :func:`build_pyramid` one launch
for up to three levels below its base (:func:`pyramid_plan`), and
:func:`scharr_gradients` one launch for both gradients; :func:`clahe`
launches ``csrc/clahe.cu``, one kernel. CPU tensors take the plain versions
(:func:`separable_filter_plain`, :func:`build_pyramid_plain`,
:func:`scharr_gradients_plain`, :func:`clahe_plain`).
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import launch
from ..ops.launch import check, device_of


def _filter_x(img, taps) -> torch.Tensor:
    """Horizontal FIR via shift-add over an edge-replicated pad."""
    r = len(taps) // 2
    H, W = img.shape
    p = F.pad(img[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for i, t in enumerate(taps):
        if t != 0.0:
            out = out + float(t) * p[:, i:i + W]
    return out


def _filter_y(img, taps) -> torch.Tensor:
    r = len(taps) // 2
    H, W = img.shape
    p = F.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for i, t in enumerate(taps):
        if t != 0.0:
            out = out + float(t) * p[i:i + H, :]
    return out


def separable_filter_plain(img, taps_y, taps_x, x_first: bool = False,
                           stride: int = 1):
    """The separable filter in plain PyTorch: the pass along y, then along
    x (along x first with ``x_first``), then every ``stride``-th row and
    column."""
    if img.is_cuda:
        separable_filter_plain.cuda_runs += 1
    if x_first:
        out = _filter_y(_filter_x(img, taps_x), taps_y)
    else:
        out = _filter_x(_filter_y(img, taps_y), taps_x)
    return out if stride == 1 else out[::stride, ::stride].contiguous()


# calls on CUDA tensors (the card runs the kernel instead)
separable_filter_plain.cuda_runs = 0

MAX_TAPS = 9      # csrc/separable_filter.cu's kMaxTaps (offsets within ±4)


def _image(fn: str, img):
    """Checks an image a launch reads: (H, W), f32, contiguous; returns
    (H, W)."""
    dev = device_of(img, fn)
    check(fn, "img", img, torch.float32, dev)
    if img.dim() != 2 or img.numel() == 0:
        raise ValueError(f"{fn}: img must be (H, W), not "
                         f"{tuple(img.shape)}")
    return tuple(img.shape)


class FilterLaunch(NamedTuple):
    """The arguments of ``separable_filter_launch`` but the output and the
    stream (the taps as ctypes arrays the call reads on the host)."""
    img: int
    H: int
    W: int
    stride: int
    x_first: int
    ny: int
    offy: ctypes.Array
    wy: ctypes.Array
    nx: int
    offx: ctypes.Array
    wx: ctypes.Array


def _taps(fn: str, name: str, taps):
    """The non-zero taps in order, as the plain version takes them: (count,
    offsets, f32 weights)."""
    taps = [float(t) for t in taps]
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"{fn}: {name} has {len(taps)} taps, the kernel "
                         f"takes 1 to {MAX_TAPS}")
    r = len(taps) // 2
    kept = [(i - r, t) for i, t in enumerate(taps) if t != 0.0]
    off = (ctypes.c_int * MAX_TAPS)(*[o for o, _ in kept])
    w = (ctypes.c_float * MAX_TAPS)(*[t for _, t in kept])
    return len(kept), off, w


def pack_filter(img, taps_y, taps_x, x_first: bool = False,
                stride: int = 1) -> FilterLaunch:
    """Checks a launch of ``csrc/separable_filter.cu`` and packs its
    arguments; raises on what the kernel does not take: TypeError on a
    dtype (f32 only), ValueError on an image that is not (H, W) and
    contiguous, more than 9 taps a pass, or a stride other than 1 or 2."""
    fn = "separable_filter"
    H, W = _image(fn, img)
    if stride not in (1, 2):
        raise ValueError(f"{fn}: stride {stride}; the kernel takes 1 or 2")
    ny, offy, wy = _taps(fn, "taps_y", taps_y)
    nx, offx, wx = _taps(fn, "taps_x", taps_x)
    return FilterLaunch(img.data_ptr(), H, W, stride, int(bool(x_first)),
                        ny, offy, wy, nx, offx, wx)


def separable_filter(img, taps_y, taps_x, x_first: bool = False,
                     stride: int = 1):
    """Separable FIR over an edge-replicated image (see
    :func:`separable_filter_plain`). CPU tensors take the plain version;
    CUDA tensors one kernel launch."""
    if device_of(img, "separable_filter").type == "cpu":
        return separable_filter_plain(img, taps_y, taps_x, x_first, stride)
    a = pack_filter(img, taps_y, taps_x, x_first, stride)
    out = torch.empty((-(-a.H // stride), -(-a.W // stride)),
                      dtype=torch.float32, device=img.device)
    launch.run("separable_filter", (*a, out.data_ptr()), separable_filter,
               (a.H, a.W, stride), img.device)
    return out


# launches of the kernel (a launch inside a CUDA graph counts on each
# replay), how many at each (H, W, stride), and how many from each
# (thread name, CUDA stream handle)
separable_filter.launches = 0
separable_filter.shapes = collections.Counter()
separable_filter.origins = collections.Counter()


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img, sigma: float = 1.0, radius: int = 2):
    """Separable Gaussian blur."""
    k = gaussian_kernel1d(sigma, radius)
    return separable_filter(img, k, k)


def box_filter(img, size: int = 3):
    k = np.full(size, 1.0 / size, np.float32)
    return separable_filter(img, k, k)


SCHARR_SMOOTH = [3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0]
SCHARR_DIFF = [-0.5, 0.0, 0.5]


def scharr_gradients_plain(img):
    """Scharr's two gradients in plain PyTorch: gx the y smoothing, then
    the x difference, gy the x smoothing, then the y difference."""
    gx = separable_filter_plain(img, SCHARR_SMOOTH, SCHARR_DIFF)
    gy = separable_filter_plain(img, SCHARR_DIFF, SCHARR_SMOOTH,
                                x_first=True)
    return gx, gy


def pack_scharr(img) -> Tuple[int, int, int]:
    """Checks a launch of the Scharr kernel and returns its arguments but
    the outputs and the stream (the image's pointer, H, W); raises
    TypeError on a dtype (f32 only), ValueError on an image that is not
    (H, W) and contiguous."""
    H, W = _image("scharr_gradients", img)
    return img.data_ptr(), H, W


def scharr_gradients(img):
    """Scharr x/y gradients (OpenCV 3/10/3 kernel, scaled 1/32 so gradient
    units stay in intensity-per-pixel). Separable: [3,10,3]/16 ⊗ [-1,0,1]/2.
    CPU tensors take :func:`scharr_gradients_plain`; CUDA tensors one
    launch for both."""
    if device_of(img, "scharr_gradients").type == "cpu":
        return scharr_gradients_plain(img)
    a = pack_scharr(img)
    gx, gy = torch.empty_like(img), torch.empty_like(img)
    launch.run("separable_filter", (*a, gx.data_ptr(), gy.data_ptr()),
               scharr_gradients, a[1:], img.device,
               fn="separable_scharr_launch")
    return gx, gy


# launches of the kernel (as separable_filter's)
scharr_gradients.launches = 0
scharr_gradients.shapes = collections.Counter()
scharr_gradients.origins = collections.Counter()

PYR_TAPS = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def pyr_down(img):
    """Gaussian 5-tap blur + 2x decimation (cv::pyrDown equivalent)."""
    return separable_filter(img, PYR_TAPS, PYR_TAPS, stride=2)


def build_pyramid_plain(img, levels: int) -> List[torch.Tensor]:
    """The pyramid in plain PyTorch: each level ``pyr_down``'s plain
    version of the one above."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(separable_filter_plain(pyr[-1], PYR_TAPS, PYR_TAPS,
                                          stride=2))
    return pyr


# levels one launch of the pyramid kernel writes (csrc/separable_filter.cu's
# kMaxOut)
PYR_LEVELS_PER_LAUNCH = 3


def pyramid_plan(levels: int) -> List[Tuple[int, int]]:
    """The pyramid kernel's launches for ``levels`` levels: (the level it
    reads, the levels below it that it writes), each from the deepest level
    the launch before wrote."""
    plan, src, left = [], 0, levels - 1
    while left > 0:
        n = min(left, PYR_LEVELS_PER_LAUNCH)
        plan.append((src, n))
        src, left = src + n, left - n
    return plan


def pyramid_shapes(H: int, W: int, levels: int) -> List[Tuple[int, int]]:
    """Each level's (H, W), the base first: ceil halves, as pyr_down's."""
    shapes = [(H, W)]
    for _ in range(levels - 1):
        H, W = -(-H // 2), -(-W // 2)
        shapes.append((H, W))
    return shapes


def pack_pyramid(img, levels: int):
    """Checks the launches of the pyramid kernel for ``levels`` levels of
    ``img`` and returns (the levels' shapes, :func:`pyramid_plan`); raises
    TypeError on a dtype (f32 only) or levels that are not an int,
    ValueError on an image that is not (H, W) and contiguous, or fewer than
    one level."""
    fn = "build_pyramid"
    H, W = _image(fn, img)
    if isinstance(levels, bool) or not isinstance(levels, (int, np.integer)):
        raise TypeError(f"{fn}: levels must be an int")
    if levels < 1:
        raise ValueError(f"{fn}: {levels} levels; at least 1")
    return pyramid_shapes(H, W, int(levels)), pyramid_plan(int(levels))


def build_pyramid(img, levels: int) -> List[torch.Tensor]:
    """Image pyramid, level 0 = full resolution (levels = nklt_pyr_lvl + 1);
    each level a contiguous tensor of its own. CPU tensors take
    :func:`build_pyramid_plain`; CUDA tensors one launch for up to three
    levels below the base (:func:`pyramid_plan`)."""
    if device_of(img, "build_pyramid").type == "cpu":
        return build_pyramid_plain(img, levels)
    shapes, plan = pack_pyramid(img, levels)
    pyr = [img] + [torch.empty(s, dtype=torch.float32, device=img.device)
                   for s in shapes[1:]]
    for src, n in plan:
        outs = [pyr[src + k].data_ptr() for k in range(1, n + 1)]
        outs += [None] * (PYR_LEVELS_PER_LAUNCH - n)
        launch.run("separable_filter", (pyr[src].data_ptr(), *shapes[src],
                                        n, *outs),
                   build_pyramid, (*shapes[src], n), img.device,
                   fn="separable_pyramid_launch")
    return pyr


# launches of the kernel, how many at each (H, W, levels written) of the
# level read, and from each (thread name, CUDA stream handle)
build_pyramid.launches = 0
build_pyramid.shapes = collections.Counter()
build_pyramid.origins = collections.Counter()


# --------------------------------------------------------------------------
# CLAHE
# --------------------------------------------------------------------------

def clahe_plain(img, clip_limit: float = 3.0,
                tiles: Tuple[int, int] = (8, 8), nbins: int = 256):
    """Contrast-limited adaptive histogram equalization
    (cv::createCLAHE(clip, (8,8)) semantics) in plain PyTorch: per-tile
    clipped histograms → CDF LUTs → bilinear LUT interpolation. Input f32
    in [0, 255]; output same range.
    """
    if img.is_cuda:
        clahe_plain.cuda_runs += 1
    H, W = img.shape
    ty, tx = tiles
    th, tw = -(-H // ty), -(-W // tx)  # ceil tile size
    padded = F.pad(img[None, None], (0, tx * tw - W, 0, ty * th - H),
                   mode="replicate")[0, 0]

    bins = torch.clamp(padded.to(torch.int64), 0, nbins - 1)
    tiles_img = bins.reshape(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(
        ty * tx, th * tw)
    hist = torch.zeros((ty * tx, nbins), dtype=torch.float32,
                       device=img.device)
    hist.scatter_add_(1, tiles_img, torch.ones_like(tiles_img,
                                                    dtype=torch.float32))

    npx = th * tw
    limit = max(clip_limit * npx / nbins, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=1,
                       keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins

    cdf = torch.cumsum(hist, dim=1)
    cdf = (cdf - cdf[:, :1]) / torch.clamp(cdf[:, -1:] - cdf[:, :1], min=1.0)
    luts = (cdf * (nbins - 1.0)).reshape(ty, tx, nbins).to(img.dtype)

    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=img.dtype, device=img.device),
        torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")
    fy = (yy - th / 2.0 + 0.5) / th
    fx = (xx - tw / 2.0 + 0.5) / tw
    y0 = torch.clamp(torch.floor(fy).long(), 0, ty - 1)
    x0 = torch.clamp(torch.floor(fx).long(), 0, tx - 1)
    y1 = torch.clamp(y0 + 1, 0, ty - 1)
    x1 = torch.clamp(x0 + 1, 0, tx - 1)
    wy = torch.clamp(fy - y0, 0.0, 1.0)
    wx = torch.clamp(fx - x0, 0.0, 1.0)

    b = torch.clamp(img.to(torch.int64), 0, nbins - 1)
    v00 = luts[y0, x0, b]
    v01 = luts[y0, x1, b]
    v10 = luts[y1, x0, b]
    v11 = luts[y1, x1, b]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


# calls on CUDA tensors (the card runs the kernels instead)
clahe_plain.cuda_runs = 0

MAX_BINS = 1024   # csrc/clahe.cu's kMaxBins


def scan_log_threads(num_rows: int, row_size: int) -> int:
    """log2 of the threads a row that ``torch.cumsum`` over the last
    dimension takes on the card: ATen's
    ``get_log_num_threads_x_inner_scan`` (ATen/native/cuda/ScanUtils.cuh),
    in its uint32 arithmetic."""
    lx = max(row_size - 1, 0).bit_length()
    ly = max(num_rows - 1, 0).bit_length()
    lx = ((9 + lx - ly) & 0xFFFFFFFF) // 2
    return min(max(4, lx), 9)


class ClaheLaunch(NamedTuple):
    """The arguments of ``clahe_launch`` but the output and the stream."""
    img: int
    H: int
    W: int
    ty: int
    tx: int
    nbins: int
    limit: float
    log_x: int


def pack_clahe(img, clip_limit: float = 3.0,
               tiles: Tuple[int, int] = (8, 8),
               nbins: int = 256) -> ClaheLaunch:
    """Checks a launch of ``csrc/clahe.cu`` and packs its arguments; raises
    on what the kernels do not take: TypeError on a dtype (f32 only) or a
    clip limit that is a tensor, ValueError on an image that is not (H, W)
    and contiguous, fewer than 16 tiles, or bins that are not a multiple of
    4 from 128 to 1024 (the shapes whose excess ``torch.sum`` adds in the
    order the kernel follows)."""
    fn = "clahe"
    H, W = _image(fn, img)
    if isinstance(clip_limit, torch.Tensor):
        raise TypeError(f"{fn}: clip_limit must be a Python number")
    ty, tx = (int(t) for t in tiles)
    if (ty < 1 or tx < 1 or ty * tx < 16 or nbins % 4
            or not 128 <= nbins <= MAX_BINS):
        raise ValueError(f"{fn}: tiles {tiles}, nbins {nbins}")
    th, tw = -(-H // ty), -(-W // tx)
    # the plain version's limit, a Python float the card rounds to f32
    limit = max(clip_limit * (th * tw) / nbins, 1.0)
    return ClaheLaunch(img.data_ptr(), H, W, ty, tx, nbins,
                       float(np.float32(limit)),
                       scan_log_threads(ty * tx, nbins))


def clahe(img, clip_limit: float = 3.0, tiles: Tuple[int, int] = (8, 8),
          nbins: int = 256):
    """CLAHE (see :func:`clahe_plain`). CPU tensors take the plain version;
    CUDA tensors one launch of ``csrc/clahe.cu`` (one kernel: each blend
    cell's tiles' LUTs, then its pixels)."""
    if device_of(img, "clahe").type == "cpu":
        return clahe_plain(img, clip_limit, tiles, nbins)
    a = pack_clahe(img, clip_limit, tiles, nbins)
    out = torch.empty((a.H, a.W), dtype=torch.float32, device=img.device)
    launch.run("clahe", (*a, out.data_ptr()), clahe, (a.H, a.W), img.device)
    return out


# launches of the kernel (a launch inside a CUDA graph counts on each
# replay), how many at each (H, W), and how many from each (thread name,
# CUDA stream handle)
clahe.launches = 0
clahe.shapes = collections.Counter()
clahe.origins = collections.Counter()
