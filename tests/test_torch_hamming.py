"""Parity: the place scorer (ov2slam_torch/ops/hamming.py) and PlaceIndex
against ov2slam_tpu.

The scores are integer counts over one IEEE f32 division on every path, so
every comparison here is exact (atol 0): the port's plain scorer, JAX's
XLA ``_match_scores`` and JAX's Pallas kernel in interpret mode. The CUDA
kernel is held to the plain version on the card (skipped without one).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_torch.loopclosure.index import PlaceIndex as TIndex
from ov2slam_torch.ops import hamming as th
from ov2slam_tpu.core.image import gaussian_blur
from ov2slam_tpu.loopclosure.index import PlaceIndex as JIndex
from ov2slam_tpu.loopclosure.index import _match_scores as j_match_scores
from ov2slam_tpu.ops.brief import describe_brief
from ov2slam_tpu.ops.detect import detect_single_scale
from ov2slam_tpu.ops.pallas_hamming import match_scores_pallas

torch.set_num_threads(1)


def _case(seed, M, N, Nq, p_valid=0.8, q_from=None):
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 2**32, (M, N, 8), dtype=np.uint32)
    sv = rng.random((M, N)) < p_valid
    if q_from is None:
        q = rng.integers(0, 2**32, (Nq, 8), dtype=np.uint32)
    else:
        q = store[q_from][:Nq].copy()
        flips = rng.integers(0, 256, (Nq, 12))     # near-duplicates
        for b in range(flips.shape[1]):
            w, bit = flips[:, b] // 32, flips[:, b] % 32
            q[np.arange(Nq), w] ^= (np.uint32(1) << bit.astype(np.uint32))
    qv = rng.random(Nq) < 0.9
    return store, sv, q, qv


def _port(store, sv, q, qv, bits):
    return th.match_scores(
        torch.as_tensor(store.view(np.int32)), torch.as_tensor(sv),
        torch.as_tensor(q.view(np.int32)), torch.as_tensor(qv), bits).numpy()


@pytest.mark.parametrize("bits", [0, 48, 127])
def test_plain_scores_equal_xla_and_pallas(bits):
    store, sv, q, qv = _case(3, 32, 128, 96, q_from=7)
    sv[5] = False                                  # all-invalid keyframe
    ref = np.asarray(j_match_scores(
        jnp.asarray(store), jnp.asarray(sv), jnp.asarray(q), jnp.asarray(qv),
        jnp.int32(bits)))
    pal = np.asarray(match_scores_pallas(
        jnp.asarray(store), jnp.asarray(sv), jnp.asarray(q), jnp.asarray(qv),
        bits, interpret=True))
    got = _port(store, sv, q, qv, bits)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    assert got[5] == 0.0
    if bits >= 48:
        assert got[7] == got.max() and got[7] > 0.5


def test_edge_cases_all_invalid_query_and_ragged_m():
    # M not a multiple of 8 (the port takes any M); compare on the
    # padded-to-16 store against JAX, whose extra rows are invalid
    store, sv, q, qv = _case(4, 13, 64, 40)
    pad = 16 - 13
    store_p = np.concatenate([store, np.zeros((pad, 64, 8), np.uint32)])
    sv_p = np.concatenate([sv, np.zeros((pad, 64), bool)])
    ref = np.asarray(j_match_scores(
        jnp.asarray(store_p), jnp.asarray(sv_p), jnp.asarray(q),
        jnp.asarray(qv), jnp.int32(100)))
    np.testing.assert_array_equal(_port(store, sv, q, qv, 100), ref[:13])
    # an all-invalid query scores 0 everywhere (divides by max(0, 1))
    zero = _port(store, sv, q, np.zeros_like(qv), 100)
    np.testing.assert_array_equal(zero, np.zeros(13, np.float32))
    # an empty store
    assert _port(store[:0], sv[:0], q, qv, 48).shape == (0,)


def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs in chip_smoke.py)")
    store, sv, q, qv = _case(5, 37, 256, 200, q_from=3)
    dev = torch.device("cuda")
    args = (torch.as_tensor(store.view(np.int32), device=dev),
            torch.as_tensor(sv, device=dev),
            torch.as_tensor(q.view(np.int32), device=dev),
            torch.as_tensor(qv, device=dev))
    for bits in (0, 48, 127):
        k = th.match_scores(*args, bits)
        p = th.match_scores_plain(*args, bits)
        torch.cuda.synchronize()
        assert torch.equal(k, p)


# ------------------------------------------------------- PlaceIndex #

@functools.lru_cache(maxsize=None)
def _desc(seed_a, seed_b=None, alpha=1.0, shift=0):
    """BRIEF descriptors of a synthetic place (as test_loopclosure.py)."""
    rng_a = np.random.default_rng(seed_a)
    base = rng_a.uniform(0, 255, (160, 200))
    if seed_b is not None:
        rng_b = np.random.default_rng(seed_b)
        base = alpha * base + (1 - alpha) * rng_b.uniform(0, 255, (160, 200))
    img = np.array(gaussian_blur(jnp.asarray(base.astype(np.float32)),
                                 2.0, 4))
    if shift:
        img = np.roll(img, int(shift), axis=1)
    kps, _, ok = detect_single_scale(
        jnp.asarray(img), jnp.zeros((1, 2)), jnp.zeros(1, bool),
        0.01, cell_size=20, max_out=128)
    d, dok = describe_brief(jnp.asarray(img), kps, ok)
    return np.array(d), np.array(dok)


def _revisit(ix):
    for i in range(40):
        ix.add(i, *_desc(1000 + i))
    q = _desc(1005, shift=3)
    return [ix.query(*q), ix.query(*q)]


def _novel(ix):
    for i in range(20):
        ix.add(i, *_desc(2000 + i))
    q = _desc(9999)
    return [ix.query(*q), ix.query(*q)]


def _recent(ix):
    for i in range(8):
        ix.add(i, *_desc(42))
    return [ix.query(*_desc(42)), ix.query(*_desc(42))]


def _covisible(ix):
    for i in range(10):
        ix.add(i, *_desc(43))
    ex = set(range(10))
    return [ix.query(*_desc(43), exclude=ex),
            ix.query(*_desc(43), exclude=ex)]


def _alias(ix):
    kf = 0
    for i in range(8):
        ix.add(kf, *_desc(500, 900, 1.0, 2 * i)); kf += 1
    for i in range(8):
        ix.add(kf, *_desc(7000 + i, 7100 + i, 0.5)); kf += 1
    for i in range(8):
        ix.add(kf, *_desc(500, 901, 0.7, 2 * i)); kf += 1
    out = []
    for i in range(4):
        d = _desc(500, 900, 1.0, 2 * i + 1)
        out.append(ix.query(*d))
        ix.add(kf, *d); kf += 1
    return out


def _compact(ix):
    # more keyframes than the capacity: rows are compacted (oldest eighth
    # dropped) and the device store is rewritten
    for i in range(40):
        ix.add(i, *_desc(3000 + i % 20))
    return [ix.query(*_desc(3005)), ix.query(*_desc(3005)),
            list(ix.kf_ids)]


SCENARIOS = {
    "revisit": (dict(capacity=64, recent_mask=10, min_score=0.2), _revisit),
    "novel": (dict(capacity=64, recent_mask=5, min_score=0.2), _novel),
    "recent": (dict(capacity=64, recent_mask=10, min_score=0.2), _recent),
    "covisible": (dict(capacity=64, recent_mask=2, min_score=0.2),
                  _covisible),
    "alias": (dict(capacity=64, recent_mask=4, island_radius=2,
                   min_score=0.2), _alias),
    "compact": (dict(capacity=32, recent_mask=4, min_score=0.2), _compact),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_place_index_matches_jax(name):
    kw, run = SCENARIOS[name]
    j = run(JIndex(**kw))
    t = run(TIndex(**kw, device="cpu"))
    assert t == j
    if name == "revisit":
        assert t[0][0] == -1 and t[1][0] == 5 and t[1][1] > 0.2
    if name in ("novel", "recent", "covisible"):
        assert t[1][0] == -1
    if name == "alias":
        hits = [c for c, _ in t if c >= 0]
        assert hits and all(h < 8 for h in hits)
