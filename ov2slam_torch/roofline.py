"""What the card is, and the least time it could take for a piece of work.

The published peaks of one NVIDIA H100 SXM (dense rates, at its 700 W
power limit), the card's name and power limit as ``nvidia-smi`` reads
them, and the bounds the benches and ``chip_smoke.py`` hold measured times
against: the fb-KLT call's, and the bytes a distributed-BA reduction
carries. A card set below 700 W runs slower under load, so every share of
these peaks is reported beside the power limit read on that run. Imports
numpy only; torch where a function asks the card.
"""

from __future__ import annotations

import subprocess

import numpy as np

# H100 SXM published peaks (dense): HBM rate, int8 tensor-core rate, f32
# outside the tensor cores (the solvers run with TF32 off), and the SM
# clock at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOP_PER_S = 67e12
SM_CLOCK_HZ = 1.98e9


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_record(dev):
    """What a result names as its device: ``"cpu"``, or the card's name
    (``torch.cuda.get_device_name``), power limit in W (``nvidia-smi``)
    and the number of cards."""
    import torch

    if dev.type != "cuda":
        return "cpu"
    limit = nvidia_smi_line().rsplit(",", 1)[1].strip()
    return dict(name=torch.cuda.get_device_name(dev),
                power_limit_w=float(limit.split()[0]),
                count=torch.cuda.device_count())


def reduction_bytes(Kw: int) -> int:
    """Bytes one LM iteration of the distributed BA all-reduces across
    processes: Hpp, bp, S_corr, b_corr and the two costs, summed in f64."""
    return 8 * (Kw * 36 + Kw * 6 + Kw * Kw * 36 + Kw * 6 + 2)


def _bound(ops, nbytes):
    """A bound's record: its f32 operations and bytes, and the larger of
    their times at ``F32_FLOP_PER_S`` and ``HBM_BYTES_PER_S`` as bound_ms,
    with bound_by the one that sets it."""
    t_ops, t_bytes = ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(ops=int(ops), bytes=int(nbytes),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


# the dependent chain of one keypoint in csrc/klt_track.cu, in SM cycles:
# one Gauss-Newton step (the steps of a keypoint are sequential), and the
# per-level setup that a level which steps adds before its first step,
# both measured on an NVIDIA H100 80GB HBM3 at its 700 W limit by
# chip_smoke.py's klt_step_latency (one keypoint: iters 30 against 1 for
# the step, iters 1 against 0, less one step, for the setup), at
# SM_CLOCK_HZ: 635 and 27-37 cycles. The kernel before cp.async patches
# and per-window instantiations took 883-893 cycles a step.
KLT_CHAIN_CYCLES = 635
KLT_SETUP_CYCLES = 32


def fb_klt_bound(kps, shapes, win: int = 9, iters: int = 30,
                 margin: int = 5, back_levels: int = 1, steps=None):
    """The least time of one KLT call: ``len(shapes)`` forward levels and
    ``back_levels`` backward ones (``fb_klt_track``; 0 for ``klt_track``),
    ``entry()``'s call by default.

    - f32 operations per keypoint and level pass: the (win+2)² template
      sampled bilinearly (8 a pixel), the gradients and the 2x2 gradient
      matrix (10 a window pixel); the (win+2·margin)² search patch sits at
      an integer offset and is copied, so it counts as bytes only; per
      step the window resampled (8), the difference (1) and the two sums
      (4) over win² pixels, and the 12 of the step. ``steps``, the LK
      steps each keypoint took over all its passes (the kernel's count),
      counts what the call's data needed; without it every pass takes
      ``iters``;
    - bytes: the pixels the patches touch (the template's footprint one
      pixel wider for the bilinear taps, the union over keypoints, the
      patches placed at the keypoints), 4 B each, read once; keypoints
      and priors in, positions and status out;
    - the dependent chain: a keypoint's levels and steps are sequential,
      so a one-kernel KLT takes at least, for the keypoint with the most
      steps, its passes x ``KLT_SETUP_CYCLES`` plus its steps x
      ``KLT_CHAIN_CYCLES`` at the SM clock.
    Returns ops, bytes, bound_ms (the larger of the first two, over the
    f32 and HBM rates), bound_by and chain_estimate_ms."""
    kps = np.asarray(kps, np.float64)
    n, r = len(kps), win // 2
    T, S = win + 2, win + 2 * margin
    touched = {}

    def mark(img, lvl, top_left, P):
        H, W = shapes[lvl]
        m = touched.setdefault((img, lvl), np.zeros((H, W), bool))
        for x, y in np.floor(top_left).astype(int):
            m[max(y, 0):max(y + P, 0), max(x, 0):max(x + P, 0)] = True

    for lvl in range(len(shapes)):
        k = kps / 2.0 ** lvl
        mark("prev", lvl, k - (r + 1), T + 1)
        mark("cur", lvl, k - r - margin, S)
    for lvl in range(back_levels):           # the backward pass
        k = kps / 2.0 ** lvl
        mark("cur", lvl, k - (r + 1), T + 1)
        mark("prev", lvl, k - r - margin, S)
    passes = len(shapes) + back_levels
    if steps is None:
        n_steps, most = n * passes * iters, passes * iters
    else:
        steps = np.asarray(steps, np.int64)
        n_steps, most = int(steps.sum()), int(steps.max(initial=0))
    px = int(sum(int(m.sum()) for m in touched.values()))
    nbytes = 4 * px + n * (8 + 8 + 1) + n * (8 + 1)
    ops = (n * passes * (T * T * 8 + win * win * 10)
           + n_steps * (win * win * 13 + 12))
    return dict(**_bound(ops, nbytes), pixels_read=px, steps=n_steps,
                chain_estimate_ms=1e3 * (passes * KLT_SETUP_CYCLES
                                         + most * KLT_CHAIN_CYCLES)
                / SM_CLOCK_HZ)


# f32 operations of the pieces of csrc/essential_ransac.cu, counted from
# its loops (a multiply-add is two, a division, square root, sine or cosine
# one): one evaluation of cos^10(t) p(tan t) (a sincos, two runs of ten
# products, eleven multiply-adds and products); a 5-point sample before the
# root search (the 5x9 design, the Householder QR of its transpose and four
# columns of Q, the 9 deg-2 products C, the 10 constraint rows, the 10x10
# LU and its 10 back substitutions, B(z) and det B); the back substitution
# of one root (six polynomial values, x, y, E and its norm); an 8-point
# sample (the 8x9 design, its QR, one column of Q, E^T E, at most 12 Jacobi
# sweeps of three rotations, the rank-2 projection); one Sampson distance
# and its score
RANSAC_EVAL_OPS = 2 + 20 + 33
RANSAC_FIVE_OPS = (90 + sum(2 * (9 - i) + 4 * (9 - i) * (4 - i) + 4
                            for i in range(5))
                   + 4 * sum(4 * (9 - i) for i in range(5))
                   + 9 * 3 * (32 + 10) + (3 * (2 * 32 + 10 + 80 + 20)
                                          + 9 * (4 * 80 + 40 + 30))
                   + sum(2 * (9 - k) * (19 - k) + (9 - k) for k in range(10))
                   + 10 * 10 * 11 + 3 * 3 * 5 + 9 * (2 * 2 * 4 * 5 + 22)
                   + 3 * (2 * 2 * 11 + 2 * 5 * 11 + 22))
RANSAC_ROOT_OPS = 6 * 10 + 12 + 9 * 8 + 10
RANSAC_EIGHT_OPS = (144 + sum(2 * (9 - i) + 4 * (9 - i) * (7 - i) + 4
                              for i in range(8))
                    + sum(4 * (9 - i) for i in range(8)) + 54
                    + 12 * 3 * 60 + 9 * 4 + 9 * 6 + 9)
SAMPSON_OPS = 3 * 4 + 2 * 4 + 4 + 1 + 7 + 1 + 3


def essential_ransac_bound(n: int, n5: int, n8: int, roots: int,
                           scored: int, steps=None):
    """The least time of one ``essential_ransac`` call on N = ``n`` rows
    with ``n5`` 5-point and ``n8`` 8-point samples, at this data's work:
    ``roots`` bisected roots (sign changes kept) over the 5-point samples,
    ``steps`` bisection steps over them (each root's steps up to its
    bracket's fixed point, that step included: a step that leaves a
    bracket as it was repeats itself for good; the kernel counts them,
    ``essential.launch(..., steps=True)``; None counts all 60 a root) and
    ``scored`` candidates that were ok and finite (the others are not
    scored).

    - f32 operations: every sample's hypotheses (``RANSAC_FIVE_OPS``, the
      512-point grid at ``RANSAC_EVAL_OPS``, one evaluation and a midpoint
      a bisection step (a bracket's lower end is a grid point, already
      evaluated), the back substitution; ``RANSAC_EIGHT_OPS``), a Sampson
      distance and its score for every row of every scored candidate and
      for the winner's mask, and the argmax over the candidates;
    - bytes: the rows (two f32 pairs and the mask byte), the samples
      (int64) and the 512-point grid read once, E, the mask and the count
      written once;
    - the dependent chain (not a bound: see chip_smoke's one-sample call):
      a sample's QR, LU and det B on one warp, then each root's search on a
      warp in rounds of five steps, one evaluation a round.
    Returns ops, bytes, bound_ms, bound_by."""
    if steps is None:
        steps = 60 * roots
    ops = (n5 * (RANSAC_FIVE_OPS + 512 * RANSAC_EVAL_OPS)
           + steps * (RANSAC_EVAL_OPS + 2) + roots * RANSAC_ROOT_OPS
           + n8 * RANSAC_EIGHT_OPS + (scored + 1) * n * SAMPSON_OPS
           + (10 * n5 + n8))
    nbytes = n * 17 + 8 * (5 * n5 + 8 * n8) + 4 * 512 + 36 + n + 8
    return _bound(ops, nbytes)


# f32 operations of csrc/pnp_refine.cu per row and pass (the point
# centred and rotated, the projection and its residual, chi2, the Huber
# weight and cost, the 2x6 Jacobian, the 21 entries of H and 6 of g) and
# per iteration on one thread (H + damping, the 6x6 LU with its
# substitutions, se3_exp with the left Jacobian, the composition)
PNP_ROW_OPS = 3 + 36 + 14 + 3 + 10 + 24 + 21 * 6 + 6 * 4 + 2
PNP_GATE_OPS = 3 + 36 + 14 + 3 + 4
PNP_SOLVE_OPS = 18 + sum(2 * (5 - k) * (7 - k) + (5 - k) for k in range(6)) \
    + 36 + 120 + 60


def pnp_refine_bound(n: int, iters: int):
    """The least time of one ``pnp_refine`` call on N = ``n`` rows with
    ``iters`` LM iterations: f32 operations of (iters + 1) passes over the
    rows (the start and each candidate pose), the final chi2 gate and the
    iterations' solves; bytes of the pose, points (3 f32), pixels (2 f32)
    and mask read once, the pose, mask and cost written once. Returns
    ops, bytes, bound_ms, bound_by."""
    ops = ((iters + 1) * n * PNP_ROW_OPS + n * PNP_GATE_OPS
           + iters * PNP_SOLVE_OPS)
    nbytes = 28 + n * (12 + 8 + 1) + 28 + n + 4
    return _bound(ops, nbytes)


# f32 operations of csrc/ba_normal_eq.cu per observation row: the landmark
# through its anchor (3 divisions, two rotations, the anchor's inverse),
# the observer's and the right camera's rotations, the projection and its
# residual, the 2x3 projection Jacobian through R_rl, the observer's 2x6
# (a 2x3 by 3x3 product), R_cw and R_wc_a from their quaternions, J_Xw,
# the anchor's 3x6 and 2x6 products, the inverse depth's, chi2, the Huber
# weight and cost, the gauge; and per entry summed (w J_l^T J_r: 6 a 6x6
# entry, 6 a pose or (landmark, pose) entry, 5 a landmark's two sums)
BA_ROW_OPS = (3 + 2 * 33 + 3 + 33 + 3 + 33 + 3 + 10 + 2 + 8 + 30 + 30
              + 2 * 27 + 30 + 45 + 60 + 21 + 10 + 3 + 10 + 24 + 3)
BA_COST_ROW_OPS = 3 + 2 * 33 + 3 + 33 + 3 + 33 + 3 + 10 + 2 + 3 + 10 + 1
BA_SUM_OPS = 4 * 36 * 6 + 2 * 6 * 6 + 2 * 6 * 6 + 10 + 1


def ba_normal_eq_bound(Kw: int, Lw: int, O: int, cost: bool = False):
    """The least time of one ``ba_normal_eq`` launch at Kw poses, Lw
    landmark rows and O observation rows. The normal equations: each row's
    terms (``BA_ROW_OPS``) and its entries in the sorted bins
    (``BA_SUM_OPS``: four 6x6 blocks, two pose and two (landmark, pose)
    entries, the landmark's and the cost's sums); bytes of the state, the
    rows and the calibration read once, and of Hpp, bp, Z (every (landmark,
    pose) entry, zeros included), Hrr, brho and the cost written once. The
    bins' sorted permutations and offsets and the per-row record between
    the kernel's two passes are its own traffic, not the function's. With
    ``cost``, the cost mode: the rows' residuals and robust cost, the
    candidate and current states read, the accept test's state written.
    Returns ops, bytes, bound_ms, bound_by."""
    state = 28 * Kw + 4 * Lw + 8 * Lw + 8 * Lw
    rows = O * (8 + 8 + 8 + 1 + 4)
    cal = 4 * 4 + 28
    if cost:
        ops = O * BA_COST_ROW_OPS + 2 * (7 * Kw + Lw)
        nbytes = (state + rows + cal + 28 * Kw + 4 * Lw + 8
                  + 28 * Kw + 4 * Lw + 8)
    else:
        ops = O * (BA_ROW_OPS + BA_SUM_OPS)
        nbytes = (state + 4 * Kw + rows + cal + 144 * Kw * Kw + 24 * Kw
                  + 24 * Lw * Kw + 8 * Lw + 4)
    return _bound(ops, nbytes)


def ba_schur_step_bound(Kw: int, Lw: int):
    """The least time of ``ba_schur_step``'s two launches at Kw poses and
    Lw landmark rows (the GEMM and the LU between them are library calls,
    timed apart): f32 operations of the damping, Zn (a division an entry),
    b (a product and a sum an entry of Z), the layout of S, the
    back-substitution (the same for dx) and each pose's exponential and
    composition (~150); bytes of Hpp, bp, Z, Hrr, brho, λ, the free flags,
    the state and the solve's dx read once, and of S, Zn, Hrr_d, b and the
    candidate state written once. Returns ops, bytes, bound_ms,
    bound_by."""
    n = 6 * Kw
    ops = (4 * Lw + Lw * n + 2 * Lw * n + 3 * n * n + 2 * Lw * n + 4 * Lw
           + 150 * Kw)
    nbytes = (4 * Kw * Kw * 36 + 4 * n + 4 * Lw * n + 8 * Lw + 4 + 4 * Kw
              + 28 * Kw + 4 * Lw + 4 * n
              + 4 * n * n + 4 * Lw * n + 4 * Lw + 4 * n + 28 * Kw + 4 * Lw)
    return _bound(ops, nbytes)


# one f32 addition waiting on the one before it (the FADD latency, SM
# cycles): the dependent step of local BA's sums, each summed from 0 one
# entry after another in the order that fixes its bits. An entry of a bin
# in csrc/ba_normal_eq.cu's sums (a shared load and an addition), a
# landmark of a b chain in csrc/ba_schur_step.cu's prepare.
BA_ADD_CYCLES = 4


def ba_normal_eq_chain(longest_bin: int) -> float:
    """The least time of ``ba_normal_eq``'s normal-equations launch set by
    its longest chain: the busiest bin's entries (a diagonal (pose, pose)
    bin's, which holds every other bin's share of its pose) one dependent
    addition each at ``SM_CLOCK_HZ``. Returns ms."""
    return 1e3 * longest_bin * BA_ADD_CYCLES / SM_CLOCK_HZ


def ba_schur_step_chain(Lw: int, chains: int) -> float:
    """The least time of the Schur step's prepare launch set by its b
    chains: each output of b is ``chains`` chains (the kernel's own count,
    ``ba_invdepth.SCHUR_B_CHAINS``), one over every ``chains``-th of the
    ``Lw`` landmarks, one dependent addition a landmark, then the chains'
    partial sums added in order. Returns ms."""
    steps = -(-Lw // chains) + chains
    return 1e3 * steps * BA_ADD_CYCLES / SM_CLOCK_HZ


def lu_solve_bound(n: int):
    """The least time of ``torch.linalg.solve_ex`` on one n x n f32 system
    with one right-hand side: an LU with partial pivoting (~2/3 n^3
    operations) and the two triangular solves (2 n^2); bytes of the matrix
    and the vector read once and the solution written once. Returns ops,
    bytes, bound_ms, bound_by."""
    ops = 2 * n ** 3 // 3 + 2 * n * n
    nbytes = 4 * n * n + 4 * n + 4 * n
    return _bound(ops, nbytes)


# f32 operations of one radtan distortion in csrc/undistort_points.cu, a
# torch operation of the plain version each (r^2 3, the radial factor 5,
# 2 p1 and 2 p2, x_d 9, y_d 9), and the fixed-point steps the front end
# runs (`_undistort_px`'s default in models/frontend_step.py)
RADTAN_OPS = 3 + 5 + 2 + 9 + 9
UNDIST_ITERS = 8


def undistort_points_bound(n: int):
    """The least time of one ``undistort_points`` launch on ``n`` points
    with radtan distortion: its f32 operations (the normalisation, 2 a
    coordinate; ``UNDIST_ITERS`` fixed-point steps, each a distortion and
    two subtractions a coordinate; the way back to pixels, 2 a
    coordinate); bytes of the points read once, the pixels written once
    and the calibration (8 floats) read once. Returns ops, bytes,
    bound_ms, bound_by."""
    return _bound(n * (4 + UNDIST_ITERS * (RADTAN_OPS + 4) + 4),
                  16 * n + 32)


def undistort_normalize_bound(n: int, select: bool = True,
                              ref: bool = True, pair: bool = True):
    """The least time of one tail launch (``undistort_normalize``) on
    ``n`` rows with radtan distortion: ``undistort_points_bound``'s
    operations, the tracks' normalisation (2 a coordinate) and, with
    ``ref``, the reference rows' (the select and the pair mask are no
    f32 operations); bytes of the rows read once (8 a row; with
    ``select`` the old pixels and the status, 9 more; with ``ref`` 8; with
    ``pair`` the reference mask, 1), the outputs written once (und and xr,
    16 a row; tracked 8, xl 8, pair 1) and the calibration (8 floats, 4
    more with ``ref``) read once. Returns ops, bytes, bound_ms,
    bound_by."""
    ops = 4 + UNDIST_ITERS * (RADTAN_OPS + 4) + 4 + 4 + 4 * ref
    row = 8 + 16 + 17 * select + 16 * ref + 2 * pair
    return _bound(n * ops, n * row + 32 + 16 * ref)


def separable_filter_bound(H: int, W: int, ny: int, nx: int, stride: int):
    """The least time of one ``separable_filter`` launch, y first, on an
    (H, W) f32 image with ``ny`` and ``nx`` non-zero taps at ``stride``: a
    product and a sum a tap at the first pass's pixels the output needs
    (the kept rows, every column) and at the output's; bytes of the image
    read once and the output written once. Returns ops, bytes, bound_ms,
    bound_by."""
    Ho, Wo = -(-H // stride), -(-W // stride)
    return _bound(2 * (ny * Ho * W + nx * Ho * Wo), 4 * (H * W + Ho * Wo))


def pyramid_bound(H: int, W: int, levels: int):
    """The least time of ``build_pyramid`` at ``levels`` levels of an (H,
    W) f32 image: each level below the base a 5-tap filter of the one
    above at stride 2 (``separable_filter_bound``'s operations); bytes of
    the image read once and each level below it written once (a level is
    an output, and the next level's input only on the chip). Returns ops,
    bytes, bound_ms, bound_by."""
    ops, px = 0, H * W
    for _ in range(levels - 1):
        Ho, Wo = -(-H // 2), -(-W // 2)
        ops += 2 * (5 * Ho * W + 5 * Ho * Wo)
        H, W = Ho, Wo
        px += H * W
    return _bound(ops, 4 * px)


def scharr_pair_bound(H: int, W: int):
    """The least time of ``scharr_gradients`` on an (H, W) f32 image: each
    gradient a 3-tap and a 2-tap pass (the zero tap skipped) at every
    pixel; bytes of the image read once and both gradients written once.
    Returns ops, bytes, bound_ms, bound_by."""
    return _bound(2 * 2 * (3 + 2) * H * W, 4 * 3 * H * W)


# f32 operations of csrc/clahe.cu: a pixel of the padded tiles' histogram
# (the cast, the clamp, the count); a bin's clip, excess, spread, scan sum
# and LUT entry (the excess 3, the clipped count 2, the scan 1, the LUT 3);
# an output pixel's blend (its tile coordinates 3 each, floor, clamps and
# weights 5 each, the LUT index 2, the four weighted values 8, 3 sums);
# at the front end's 8x8 tiles of 256 bins
CLAHE_HIST_OPS = 3
CLAHE_BIN_OPS = 3 + 2 + 1 + 3
CLAHE_PIXEL_OPS = 2 * 3 + 2 * 5 + 2 + 2 + 8 + 3
CLAHE_TILES, CLAHE_BINS = 8, 256


def clahe_bound(H: int, W: int):
    """The least time of one ``clahe`` call (both kernels) on an (H, W) f32
    image: the operations above; bytes of the image read once and the
    output written once (the tiles' LUTs are the call's own scratch).
    Returns ops, bytes, bound_ms, bound_by."""
    t = CLAHE_TILES
    padded = t * -(-H // t) * t * -(-W // t)
    ops = (padded * CLAHE_HIST_OPS + t * t * CLAHE_BINS * CLAHE_BIN_OPS
           + H * W * CLAHE_PIXEL_OPS)
    return _bound(ops, 8 * H * W)


# a voxel's f32 operations in csrc/tsdf.cu's integration (compares, min,
# max and selects one each): its centre 3 a coordinate; uv and uuv 3 each
# a coordinate; pc 5 a coordinate; the front test and zs 2; u and v 3
# each; their rounding and clamps 3 each; the image test 4; the depth's
# tests 3; sdf and its test 2; the observation and its clamp 3; the 1/z^2
# weight 4 (with const_weight none) and its select 1; w_new and the
# denominator 2; the tsdf 4; the weight's clamp 1; the colour 4 a channel
TSDF_VOXEL_OPS = 9 + 9 + 9 + 15 + 2 + 6 + 6 + 4 + 3 + 2 + 3 + 5 + 2 + 4 + 1
TSDF_INV_DEPTH_OPS = 4
TSDF_COLOR_OPS = 12
# a voxel's sweep: six neighbours' additions and six minimums
ESDF_VOXEL_OPS = 12


def tsdf_integrate_bound(V: int, H: int, W: int, color: bool = True,
                         const_weight: bool = False):
    """The least time of one ``tsdf_integrate`` launch over ``V`` voxels
    from an (H, W) depth image: the operations above; bytes of the tsdf
    and weight (and colour) read and written once, 16 (40) a voxel, and
    of the depth (and colour) image read once. Every voxel is written,
    in the frustum or not (the plain version rewrites them all). Returns
    ops, bytes, bound_ms, bound_by."""
    ops = V * (TSDF_VOXEL_OPS - const_weight * TSDF_INV_DEPTH_OPS
               + color * TSDF_COLOR_OPS)
    return _bound(ops, V * (16 + 24 * color) + H * W * (4 + 12 * color))


def esdf_sweep_bound(V: int, sweeps: int = 1):
    """The least time of ``sweeps`` ESDF sweeps over ``V`` voxels, one
    launch each: the grid read once and written once a sweep, 8 bytes a
    voxel, and 12 operations a voxel. Returns ops, bytes, bound_ms,
    bound_by."""
    return _bound(sweeps * V * ESDF_VOXEL_OPS, sweeps * 8 * V)
