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
    up to the order of the additions, which is fixed."""

    def __init__(self, idx: torch.Tensor, n: int):
        self.perm = torch.argsort(idx, stable=True)
        self.lengths = torch.bincount(idx, minlength=n)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(v[self.perm], "sum",
                                    lengths=self.lengths, axis=0,
                                    unsafe=True)
