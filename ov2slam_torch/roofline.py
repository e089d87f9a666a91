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
    t_ops, t_bytes = ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(ops=ops, bytes=nbytes, pixels_read=px, steps=n_steps,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                chain_estimate_ms=1e3 * (passes * KLT_SETUP_CYCLES
                                         + most * KLT_CHAIN_CYCLES)
                / SM_CLOCK_HZ)
