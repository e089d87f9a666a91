"""Place-recognition descriptor scoring: the CUDA kernel and its plain
version.

Port of ``ov2slam_tpu/ops/pallas_hamming.py``. For every stored keyframe m:

    score[m] = #{valid query descriptors whose minimum Hamming distance to
                 a valid descriptor of m is <= match_bits}
               / max(#valid query descriptors, 1)

Descriptors are BRIEF-256 packed as 8 int32 words (uint32 bit patterns);
there is no ±1 unpacking. On a CUDA tensor :func:`match_scores` launches
``csrc/hamming_score.cu`` (one CTA per stored keyframe, XOR + popcount) or
raises; on a CPU tensor it runs :func:`match_scores_plain`. The counts are
integers and the one division is IEEE f32, so kernel and plain version
agree bit for bit.
"""

from __future__ import annotations

import torch

from .. import kernels

N_WORDS = 8


def _popcount_rows(x):
    """Σ over the last dim of the popcounts of int32 words, byte by byte
    (uint8 SWAR: no step overflows and no int64 widening) → int32."""
    b = x.view(torch.uint8)
    b = b - ((b >> 1) & 0x55)
    b = (b & 0x33) + ((b >> 2) & 0x33)
    b = (b + (b >> 4)) & 0x0F
    return b.sum(-1, dtype=torch.int32)


def match_scores_plain(store_desc, store_valid, q_desc, q_valid,
                       match_bits: int):
    """(M, N, 8) int32, (M, N) bool, (Nq, 8) int32, (Nq,) bool → (M,) f32,
    in plain PyTorch (XOR + popcount + min over every stored row, invalid
    rows at distance 257), a few stored keyframes at a time."""
    if store_desc.is_cuda:
        match_scores_plain.cuda_runs += 1
    M, N, _ = store_desc.shape
    Nq = q_desc.shape[0]
    best = torch.empty((M, Nq), dtype=torch.int32, device=store_desc.device)
    chunk = max(1, (1 << 22) // max(1, Nq * N * N_WORDS))
    for c0 in range(0, M, chunk):
        x = torch.bitwise_xor(q_desc[None, :, None, :],
                              store_desc[c0:c0 + chunk, None, :, :])
        d = _popcount_rows(x)                          # (C, Nq, N)
        d = torch.where(store_valid[c0:c0 + chunk, None, :], d,
                        torch.full_like(d, 257))
        best[c0:c0 + chunk] = d.min(dim=-1).values
    hits = ((best <= match_bits) & q_valid[None, :]).sum(-1)
    nq = torch.clamp(q_valid.sum(), min=1).to(torch.float32)
    return hits.to(torch.float32) / nq


match_scores_plain.cuda_runs = 0


def match_scores(store_desc, store_valid, q_desc, q_valid, match_bits: int):
    """(M, N, 8) int32, (M, N) bool, (Nq, 8) int32, (Nq,) bool → (M,) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (any M; ``match_bits`` < 257)."""
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
    for name, t, dt in (("store_desc", store_desc, torch.int32),
                        ("store_valid", store_valid, torch.bool),
                        ("q_desc", q_desc, torch.int32),
                        ("q_valid", q_valid, torch.bool)):
        if t.device != dev:
            raise ValueError(f"match_scores: {name} is on {t.device}")
        if t.dtype != dt:
            raise TypeError(f"match_scores: {name} must be {dt}")
        if not t.is_contiguous():
            raise ValueError(f"match_scores: {name} must be contiguous")
    if store_desc.data_ptr() % 16 or q_desc.data_ptr() % 16:
        raise ValueError("match_scores: descriptors must be 16-byte aligned")
    if not 0 <= int(match_bits) < 257:
        raise ValueError("match_scores: match_bits out of range")
    out = torch.empty(M, dtype=torch.float32, device=dev)
    if M == 0:
        return out
    lib = kernels.load("hamming_score")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hamming_score_launch(
            store_desc.data_ptr(), store_valid.data_ptr(), q_desc.data_ptr(),
            q_valid.data_ptr(), M, N, Nq, int(match_bits), out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"hamming_score launch failed: cudaError {rc}")
    match_scores.launches += 1
    return out


match_scores.launches = 0
