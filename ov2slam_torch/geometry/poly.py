"""Branch-free closed-form cubic/quartic root finders (batched).

Port of ``ov2slam_tpu/geometry/poly.py``: Cardano + Ferrari in real
arithmetic with ``where``-masked case selection, followed by Newton polish.
Kneip P3P needs the real roots of a quartic.
"""

from __future__ import annotations

import torch

_TINY = 1e-14


def _cbrt(x):
    """Real cube root, sign-preserving."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def solve_cubic_real(p, q, r):
    """One real root of z³ + p z² + q z + r = 0 (batched scalars): the
    largest real root (best conditioned pivot for Ferrari)."""
    p2 = p * p
    A = q - p2 / 3.0
    B = r - p * q / 3.0 + 2.0 * p * p2 / 27.0
    disc = (B / 2.0) ** 2 + (A / 3.0) ** 3

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_single = _cbrt(-B / 2.0 + sq) + _cbrt(-B / 2.0 - sq)

    m = torch.sqrt(torch.clamp(-A / 3.0, min=_TINY))
    cos_phi = torch.clamp(
        3.0 * B / (2.0 * A * torch.where(m > 0, m, torch.ones_like(m))),
        -1.0, 1.0)
    phi = torch.arccos(cos_phi)
    t_triple = 2.0 * m * torch.cos(phi / 3.0)

    t = torch.where(disc > 0, t_single, t_triple)
    return t - p / 3.0


def solve_quartic_real(a, b, c, d, newton_iters: int = 2):
    """Real roots of x⁴ + a x³ + b x² + c x + d = 0 (batched coefficients).

    Returns ``(roots (..., 4), valid (..., 4) bool)``. Invalid slots hold a
    duplicated real root (safe to evaluate downstream; mask with ``valid``).
    """
    a2 = a * a
    p = b - 3.0 * a2 / 8.0
    q = c - a * b / 2.0 + a * a2 / 8.0
    r = d - a * c / 4.0 + a2 * b / 16.0 - 3.0 * a2 * a2 / 256.0

    m = solve_cubic_real(p, p * p / 4.0 - r, -q * q / 8.0)
    m = torch.clamp(m, min=_TINY)
    s = torch.sqrt(2.0 * m)

    half = p / 2.0 + m
    qq = q / (2.0 * s)
    d1 = s * s / 4.0 - (half + qq)
    d2 = s * s / 4.0 - (half - qq)

    sq1 = torch.sqrt(torch.clamp(d1, min=0.0))
    sq2 = torch.sqrt(torch.clamp(d2, min=0.0))
    y = torch.stack(
        [s / 2.0 + sq1, s / 2.0 - sq1, -s / 2.0 + sq2, -s / 2.0 - sq2],
        dim=-1)
    valid = torch.stack([d1 >= 0, d1 >= 0, d2 >= 0, d2 >= 0], dim=-1)
    x = y - a[..., None] / 4.0

    A_, B_, C_, D_ = a[..., None], b[..., None], c[..., None], d[..., None]
    for _ in range(newton_iters):
        f = (((x + A_) * x + B_) * x + C_) * x + D_
        deriv = ((4.0 * x + 3.0 * A_) * x + 2.0 * B_) * x + C_
        step = f / torch.where(deriv.abs() < _TINY,
                               torch.full_like(deriv, _TINY), deriv)
        x = torch.where(valid, x - step, x)
    return x, valid
