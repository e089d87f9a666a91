"""Hamming-distance descriptor matching, fully batched.

Port of ``ov2slam_tpu/ops/matching.py`` (the reference's brute-force
knnMatch and the projection-guided BRIEF matching of `Mapper::matchToMap`).
Descriptors are (N, 8) int32 words holding uint32 bit patterns; distances
are one (N, M, 8) XOR + popcount reduction.
"""

from __future__ import annotations

import torch

N_BITS = 256


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR in int64, so no
    step overflows); returns int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def hamming_matrix(desc_a, desc_b):
    """(N, 8) x (M, 8) int32 words → (N, M) int32 Hamming distances."""
    x = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return popcount32(x).sum(-1).to(torch.int32)


def _best_two(D):
    best_idx = torch.argmin(D, dim=1)
    best = torch.gather(D, 1, best_idx[:, None])[:, 0]
    D2 = D.clone()
    D2[torch.arange(D.shape[0], device=D.device), best_idx] = N_BITS + 1
    second = torch.min(D2, dim=1).values
    return best_idx, best, second


def knn_match_2nn(desc_a, valid_a, desc_b, valid_b, max_dist_bits,
                  ratio: float = 0.85):
    """2-NN Hamming matching with Lowe ratio + absolute distance gate:
    keep a→b matches where best < ratio * second-best and best ≤ max bits.

    Returns idx_b (N,) int64 best match in b (or -1), dist (N,) int32.
    """
    D = hamming_matrix(desc_a, desc_b)
    D = torch.where(valid_b[None, :], D, torch.full_like(D, N_BITS + 1))
    best_idx, best, second = _best_two(D)
    ok = (
        valid_a
        & (best <= max_dist_bits)
        & (best.to(torch.float32) < ratio * second.to(torch.float32))
    )
    return torch.where(ok, best_idx, torch.full_like(best_idx, -1)), best


def mutual_match(desc_a, valid_a, desc_b, valid_b, max_dist_bits):
    """Mutual (cross-check) nearest-neighbor matching."""
    D = hamming_matrix(desc_a, desc_b)
    D = torch.where(valid_a[:, None] & valid_b[None, :], D,
                    torch.full_like(D, N_BITS + 1))
    best_ab = torch.argmin(D, dim=1)
    best_ba = torch.argmin(D, dim=0)
    d = torch.gather(D, 1, best_ab[:, None])[:, 0]
    mutual = best_ba[best_ab] == torch.arange(D.shape[0], device=D.device)
    ok = mutual & (d <= max_dist_bits) & valid_a
    return torch.where(ok, best_ab, torch.full_like(best_ab, -1)), d


def projection_match(
    proj_px, proj_valid, proj_desc,
    kp_px, kp_valid, kp_desc,
    max_px_dist, max_dist_bits, ratio: float = 0.9,
):
    """Projection-guided descriptor matching: for each projected map point,
    consider only current keypoints within ``max_px_dist`` pixels and pick
    the best BRIEF match with a 2-NN ratio test over that neighborhood.

    Returns idx (L,) matched kp index or -1; dist (L,) int32.
    """
    D = hamming_matrix(proj_desc, kp_desc)
    px_d2 = torch.sum((proj_px[:, None, :] - kp_px[None, :, :]) ** 2, dim=-1)
    near = px_d2 <= max_px_dist * max_px_dist
    gate = near & kp_valid[None, :] & proj_valid[:, None]
    D = torch.where(gate, D, torch.full_like(D, N_BITS + 1))
    best_idx, best, second = _best_two(D)
    ok = (
        proj_valid
        & (best <= max_dist_bits)
        & ((best.to(torch.float32) < ratio * second.to(torch.float32))
           | (second > N_BITS))
    )
    return torch.where(ok, best_idx, torch.full_like(best_idx, -1)), best
