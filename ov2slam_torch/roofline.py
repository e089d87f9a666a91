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


# an estimate, not a measurement: the cycles one Gauss-Newton step of one
# keypoint takes on an SM, the steps of a keypoint being sequential,
# summed from guessed latencies of the window's bilinear samples from
# shared memory at the step's flow (~30), the products (~10), a cross-lane
# sum of two values over 81 pixels (5 shuffle levels, ~25 each) and the
# 2x2 update with its convergence test (~35)
KLT_CHAIN_CYCLES = 200


def fb_klt_bound(kps, shapes, win: int = 9, iters: int = 30,
                 margin: int = 5):
    """The least time of one ``fb_klt_track`` call (``entry()``'s): 4
    forward levels and the backward base level, ``iters`` steps each.

    - f32 operations per keypoint and level pass: the (win+2)² template
      and (win+2·margin)² search patches sampled bilinearly (8 a pixel),
      the gradients and the 2x2 gradient matrix (10 a window pixel); per
      step the window resampled (8), the difference (1) and the two sums
      (4) over win² pixels, and the 12 of the step;
    - bytes: the pixels the patches touch (each patch's footprint one
      pixel wider for the bilinear taps, the union over keypoints, the
      patches placed at the keypoints), 4 B each, read once; keypoints
      and priors in, positions and status out;
    - an estimate of the dependent chain: a keypoint's steps are
      sequential, so a one-kernel KLT takes level passes x iters x the
      cycles of one step at the SM clock, with ``KLT_CHAIN_CYCLES`` (an
      estimate, not measured) for those cycles.
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
            m[max(y, 0):max(y + P + 1, 0), max(x, 0):max(x + P + 1, 0)] = \
                True

    for lvl in range(len(shapes)):
        k = kps / 2.0 ** lvl
        mark("prev", lvl, k - (r + 1), T)
        mark("cur", lvl, k - r - margin, S)
    mark("cur", 0, kps - (r + 1), T)        # the backward pass
    mark("prev", 0, kps - r - margin, S)
    passes = len(shapes) + 1
    px = int(sum(int(m.sum()) for m in touched.values()))
    nbytes = 4 * px + n * (8 + 8 + 1) + n * (8 + 1)
    ops = n * passes * (T * T * 8 + win * win * 10 + S * S * 8
                        + iters * (win * win * 13 + 12))
    t_ops, t_bytes = ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(ops=ops, bytes=nbytes, pixels_read=px,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                chain_estimate_ms=1e3 * passes * iters * KLT_CHAIN_CYCLES
                / SM_CLOCK_HZ)
