"""Deterministic segmented sums for the solvers' normal equations.

``index_add_`` on a CUDA tensor sums with atomics, in a different order on
every run, and a SLAM trajectory grows those last-bit differences into
centimetres of endpoint error between two runs of one sequence. Here the
rows are sorted by bin once per problem (a stable sort) and each bin's
rows are added by a segmented reduction in one fixed order, on every run.
"""

from __future__ import annotations

import torch


class SegmentSum:
    """Σ of rows into ``n`` bins by ``idx`` (int64, values in [0, n)):
    ``SegmentSum(idx, n)(v)`` equals ``zeros(n, ...).index_add_(0, idx, v)``
    up to the order of the additions, which is fixed. Rows where ``drop``
    (bool) is true go to no bin: they are sorted after the last one, into
    a bin of their own that is summed and cut off (``lengths`` counts it,
    ``n + 1`` entries)."""

    def __init__(self, idx: torch.Tensor, n: int, drop=None):
        self.n = n
        if drop is not None:
            idx = torch.where(drop, n, idx)
            n += 1
        self.perm = torch.argsort(idx, stable=True)
        # a count by index_add_ rather than bincount, which reads the
        # largest index back to the host (no readback: a CUDA graph can
        # hold the sort)
        self.lengths = torch.zeros(n, dtype=torch.long,
                                   device=idx.device).index_add_(
            0, idx, torch.ones_like(idx, dtype=torch.long))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(v[self.perm], "sum",
                                    lengths=self.lengths, axis=0,
                                    unsafe=True)[:self.n]
