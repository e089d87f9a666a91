"""Place-recognition descriptor scoring: the CUDA kernel and its plain
versions.

Port of ``ov2slam_tpu/ops/pallas_hamming.py``. For every stored keyframe m:

    score[m] = #{valid query descriptors whose minimum Hamming distance to
                 a valid descriptor of m is <= match_bits}
               / max(#valid query descriptors, 1)

Descriptors are BRIEF-256, packed as 8 int32 words (uint32 bit patterns) or
unpacked by :func:`unpack_pm1` to 256 int8 values in {-1, +1} (0 for an
invalid row), where Ham(a, b) = (256 - <a, b>) / 2 exactly.

- :func:`match_scores_bits` takes the ±1 operands, as the place index holds
  its store. On a CUDA tensor it launches ``csrc/hamming_score.cu`` (int8
  ``wgmma`` with a fused per-query max) or raises; on a CPU tensor it runs
  :func:`match_scores_bits_plain`.
- :func:`match_scores` takes packed words: on the card it unpacks both
  operands and launches the same kernel; on the CPU it runs
  :func:`match_scores_plain` (XOR + popcount), the independent check.

Invalid stored rows are masked by their flag on every path, never by their
zeroed values, so any ``match_bits`` < 257 is taken. The counts are
integers and the one division is IEEE f32, so all paths agree bit for bit.
"""

from __future__ import annotations

import collections
import threading

import torch

from .. import kernels

N_WORDS = 8
N_BITS = 256


def unpack_pm1(desc, valid):
    """(..., 8) int32 packed descriptors, (...) bool → (..., 256) int8 in
    {-1, +1}, rows where ``valid`` is False all 0. Word w, bit b (little
    endian) goes to column 32·w + b, the JAX package's order."""
    bits = torch.arange(32, dtype=torch.int32, device=desc.device)
    b = (desc[..., None] >> bits) & 1                    # (..., 8, 32)
    pm1 = (2 * b - 1).to(torch.int8).reshape(*desc.shape[:-1], N_BITS)
    return pm1 * valid[..., None].to(torch.int8)


def _popcount_rows(x):
    """Σ over the last dim of the popcounts of int32 words, byte by byte
    (uint8 SWAR: no step overflows and no int64 widening) → int32."""
    b = x.view(torch.uint8)
    b = b - ((b >> 1) & 0x55)
    b = (b & 0x33) + ((b >> 2) & 0x33)
    b = (b + (b >> 4)) & 0x0F
    return b.sum(-1, dtype=torch.int32)


def _scores(hits, q_valid):
    nq = torch.clamp(q_valid.sum(), min=1).to(torch.float32)
    return hits.to(torch.float32) / nq


def match_scores_plain(store_desc, store_valid, q_desc, q_valid,
                       match_bits: int):
    """(M, N, 8) int32, (M, N) bool, (Nq, 8) int32, (Nq,) bool → (M,) f32,
    in plain PyTorch (XOR + popcount + min over every stored row, invalid
    rows at distance 257), a few stored keyframes at a time."""
    if store_desc.is_cuda:
        match_scores_plain.cuda_runs += 1
    M, N, _ = store_desc.shape
    Nq = q_desc.shape[0]
    best = torch.full((M, Nq), 257, dtype=torch.int32,
                      device=store_desc.device)
    chunk = max(1, (1 << 22) // max(1, Nq * N * N_WORDS))
    for c0 in range(0, M if N else 0, chunk):
        x = torch.bitwise_xor(q_desc[None, :, None, :],
                              store_desc[c0:c0 + chunk, None, :, :])
        d = _popcount_rows(x)                          # (C, Nq, N)
        d = torch.where(store_valid[c0:c0 + chunk, None, :], d,
                        torch.full_like(d, 257))
        best[c0:c0 + chunk] = d.min(dim=-1).values
    hits = ((best <= match_bits) & q_valid[None, :]).sum(-1)
    return _scores(hits, q_valid)


match_scores_plain.cuda_runs = 0


def match_scores_bits_plain(store_pm1, store_valid, q_pm1, q_valid,
                            match_bits: int):
    """(M, N, 256) int8 ±1, (M, N) bool, (Nq, 256) int8 ±1, (Nq,) bool →
    (M,) f32, in plain PyTorch: the dot products of the ±1 operands (in
    float32, which holds every partial sum, integers of magnitude <= 256,
    exactly; PyTorch has no int32 matrix product on CUDA), invalid stored
    columns at -257, the max over N, the test >= 256 - 2·match_bits, a few
    stored keyframes at a time."""
    if store_pm1.is_cuda:
        match_scores_bits_plain.cuda_runs += 1
    M, N, _ = store_pm1.shape
    Nq = q_pm1.shape[0]
    q = q_pm1.to(torch.float32)
    best = torch.full((M, Nq), -257, dtype=torch.int32,
                      device=store_pm1.device)
    chunk = max(1, (1 << 24) // max(1, Nq * N))
    for c0 in range(0, M if N else 0, chunk):
        dots = torch.matmul(store_pm1[c0:c0 + chunk].to(torch.float32),
                            q.T)                         # (C, N, Nq)
        dots = torch.where(store_valid[c0:c0 + chunk, :, None], dots,
                           torch.full_like(dots, -257.0))
        best[c0:c0 + chunk] = dots.amax(dim=1).to(torch.int32)
    hits = ((best >= N_BITS - 2 * match_bits) & q_valid[None, :]).sum(-1)
    return _scores(hits, q_valid)


match_scores_bits_plain.cuda_runs = 0


def _check(fn, tensors, dev):
    for name, t, dt in tensors:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{fn}: {name} must be {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def match_scores_bits(store_pm1, store_valid, q_pm1, q_valid,
                      match_bits: int):
    """(M, N, 256) int8 ±1, (M, N) bool, (Nq, 256) int8 ±1, (Nq,) bool →
    (M,) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (any M, N and Nq; ``match_bits`` < 257)."""
    dev = store_pm1.device
    if dev.type == "cpu":
        return match_scores_bits_plain(store_pm1, store_valid, q_pm1,
                                       q_valid, match_bits)
    if dev.type != "cuda":
        raise ValueError(f"match_scores_bits: unsupported device {dev}")
    M, N, K = store_pm1.shape
    Nq = q_pm1.shape[0]
    if K != N_BITS or q_pm1.shape != (Nq, N_BITS):
        raise ValueError("match_scores_bits: rows must be 256 values")
    if store_valid.shape != (M, N) or q_valid.shape != (Nq,):
        raise ValueError("match_scores_bits: valid masks do not match")
    _check("match_scores_bits",
           (("store_pm1", store_pm1, torch.int8),
            ("store_valid", store_valid, torch.bool),
            ("q_pm1", q_pm1, torch.int8),
            ("q_valid", q_valid, torch.bool)), dev)
    if store_pm1.data_ptr() % 16 or q_pm1.data_ptr() % 16:
        raise ValueError("match_scores_bits: rows must be 16-byte aligned")
    if not 0 <= int(match_bits) < 257:
        raise ValueError("match_scores_bits: match_bits out of range")
    if M == 0 or N == 0 or Nq == 0:
        # nothing to launch: no stored row or no query row can match
        return torch.zeros(M, dtype=torch.float32, device=dev)
    out = torch.empty(M, dtype=torch.float32, device=dev)
    counts = torch.zeros(3 * M, dtype=torch.int32, device=dev)
    lib = kernels.load("hamming_score")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hamming_score_launch(
            store_pm1.data_ptr(), store_valid.data_ptr(), q_pm1.data_ptr(),
            q_valid.data_ptr(), M, N, Nq, int(match_bits),
            counts.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hamming_score launch failed: code {rc}")
    match_scores_bits.launches += 1
    match_scores_bits.shapes[(M, N, Nq)] += 1
    match_scores_bits.origins[(threading.current_thread().name, stream)] += 1
    return out


# launches of the kernel, how many at each (M, N, Nq), and how many from
# each (thread name, CUDA stream handle)
match_scores_bits.launches = 0
match_scores_bits.shapes = collections.Counter()
match_scores_bits.origins = collections.Counter()


def match_scores(store_desc, store_valid, q_desc, q_valid, match_bits: int):
    """(M, N, 8) int32, (M, N) bool, (Nq, 8) int32, (Nq,) bool → (M,) f32.

    CPU tensors take :func:`match_scores_plain`; CUDA tensors are unpacked
    to ±1 and scored by the kernel (:func:`match_scores_bits`)."""
    dev = store_desc.device
    if dev.type == "cpu":
        return match_scores_plain(store_desc, store_valid, q_desc, q_valid,
                                  match_bits)
    if dev.type != "cuda":
        raise ValueError(f"match_scores: unsupported device {dev}")
    M, N, W = store_desc.shape
    Nq = q_desc.shape[0]
    if W != N_WORDS or q_desc.shape != (Nq, N_WORDS):
        raise ValueError("match_scores: descriptors must be (..., 8) words")
    if store_valid.shape != (M, N) or q_valid.shape != (Nq,):
        raise ValueError("match_scores: valid masks do not match")
    _check("match_scores",
           (("store_desc", store_desc, torch.int32),
            ("q_desc", q_desc, torch.int32)), dev)
    return match_scores_bits(unpack_pm1(store_desc, store_valid), store_valid,
                             unpack_pm1(q_desc, q_valid), q_valid, match_bits)
