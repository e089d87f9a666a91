"""Parity: the port's relocalizer (``ov2slam_torch/models/relocalizer.py``)
and ``PlaceIndex.query_best`` against ``ov2slam_tpu``, on state carried
over from the JAX package (``ov2slam_torch.interop``).

``query_best`` scores are integer counts over one f32 division: exact.
The relocalizer's RANSAC draws from each package's own stream, so it is
compared by outcome, as tests/test_relocalization.py states it: both
relocalize, both land within the test's 0.05 m / 0.05 rad of the truth,
and within 0.01 m / 0.01 rad of each other (the PnP refinement converges to
the same pose from either sample stream).

The full-size gates of tests/test_relocalization.py run on the port under
``slow``.
"""

import numpy as np
import pytest
import torch

from ov2slam_torch import interop
from ov2slam_torch.models.frontend import FrontEnd as TFrontEnd
from ov2slam_torch.models.relocalizer import Relocalizer as TRelocalizer
from ov2slam_torch.models.slam import SlamManager as TSlam
from ov2slam_tpu.loopclosure.index import PlaceIndex as JIndex
from ov2slam_tpu.utils import lie_np
from tests.test_torch_slam import port_config

torch.set_num_threads(1)


def carried_index(jx, device="cpu"):
    n = len(jx.kf_ids)
    return interop.place_index(jx._desc[:n], jx._valid[:n], jx.kf_ids,
                               jx.kf_seqs, jx.capacity, device=device,
                               recent_mask=jx.recent_mask,
                               island_radius=jx.island_radius,
                               min_score=jx.min_score,
                               match_bits=jx.match_bits)


def test_query_best_matches_reference(rng):
    """Top-k over every stored row (no recency mask), stale rows never
    returned, on a carried index: the same keyframes and scores."""
    n, N = 14, 96
    desc = rng.integers(0, 2**32, (n, N, 8), dtype=np.uint32)
    valid = rng.random((n, N)) < 0.9
    jx = JIndex(32, recent_mask=10, match_bits=48)
    for i in range(n):
        jx.add(100 + i, desc[i], valid[i], seq=i)
    tx = carried_index(jx)
    # the query: keyframe 5's rows with 6 bits flipped, half of them
    # Nq = N / 2 rows, as the relocalizer queries its fresh detections
    q = desc[5, : N // 2].copy()
    for _ in range(6):
        w = rng.integers(0, 8, N // 2)
        q[np.arange(N // 2), w] ^= np.left_shift(
            np.uint32(1), rng.integers(0, 32, N // 2).astype(np.uint32))
    qv = rng.random(N // 2) < 0.9
    a = jx.query_best(q, qv, top_k=3)
    b = tx.query_best(q, qv, top_k=3)
    assert a == b and a[0][0] == 105 and len(a) == 3
    # a recycled slot (its seq moved on) is stale and never comes back
    seqs = np.arange(200)
    seqs[105] = 99

    def lookup(ids):
        return seqs[ids]

    a = jx.query_best(q, qv, top_k=3, seq_lookup=lookup)
    b = tx.query_best(q, qv, top_k=3, seq_lookup=lookup)
    assert a == b and 105 not in [k for k, _ in b]
    assert tx.query_best(q, qv, top_k=n + 5) == jx.query_best(q, qv,
                                                             top_k=n + 5)
    empty = interop.place_index(desc[:0], valid[:0], [], [], 16,
                                device="cpu")
    assert empty.query_best(q, qv) == []


@pytest.fixture(scope="module")
def reloc_state():
    """The JAX package after 30 frames of test_relocalization.py's
    sequence (seed 11), its loop closer and relocalizer on."""
    from ov2slam_tpu.io.synthetic import generate_sequence
    from ov2slam_tpu.models.slam import SlamManager as JSlam

    seq = generate_sequence(n_frames=40, stereo=True, width=376, height=240,
                            n_points=2500, seed=11, speed=0.05)
    cfg = seq.make_config(use_loop_closer=True, reloc_min_interval_s=0.0)
    j = JSlam(cfg)
    for i in range(30):
        j.process_frame(seq.images_left[i], seq.images_right[i],
                        float(seq.times[i]))
    return seq, cfg, j


def _lose_and_show(fe, seq, i):
    fe.frame.valid[:] = False
    fe.frame.lmids[:] = -1
    fe.preprocess(seq.images_left[i])
    fe.frame.time = float(seq.times[i])


def test_direct_relocalization_as_reference(reloc_state):
    """test_relocalization.py::test_direct_relocalization_recovers_pose on
    both packages from the same map and index: total tracking loss, then
    a view seen before (frame 10)."""
    seq, cfg, j = reloc_state
    assert j.map.n_keyframes >= 2
    tcfg = port_config(cfg)
    t = TSlam(tcfg, device="cpu")
    m = interop.map_store(vars(j.map), tcfg)
    gen = torch.Generator().manual_seed(44)
    fe = TFrontEnd(tcfg, t.cam_l, m, gen)
    fe._quality, fe._fast_th = j.frontend._quality, j.frontend._fast_th
    reloc = TRelocalizer(tcfg, t.cam_l, m, carried_index(
        j.loop_closer.index), gen)

    _lose_and_show(j.frontend, seq, 10)
    _lose_and_show(fe, seq, 10)
    assert j.relocalizer.try_relocalize(j.frontend)
    assert reloc.try_relocalize(fe)
    assert reloc.n_relocs == 1
    gt = seq.gt_poses[10].astype(np.float64)
    T_j = j.frontend.frame.T_wc.astype(np.float64)
    T_t = fe.frame.T_wc.astype(np.float64)
    for T in (T_j, T_t):
        rot, tr = lie_np.pose_distance(T, gt)
        assert tr < 0.05 and rot < 0.05, (tr, rot)
    rot, tr = lie_np.pose_distance(T_t, T_j)
    assert tr < 0.01 and rot < 0.01, (tr, rot)
    # the frame is restored with live 3D landmark observations, resting
    # on the candidate keyframe
    assert fe.frame.n_valid >= 10
    lm = fe.frame.lmids[fe.frame.valid]
    assert (m.lm_valid[lm] & m.lm_is3d[lm]).all()
    assert m.kf_valid[fe.frame.kf_id]
    assert abs(fe.frame.n_valid - j.frontend.frame.n_valid) <= max(
        3, 0.1 * j.frontend.frame.n_valid)


def test_featureless_frame_fails_fast(reloc_state):
    """A blank frame fails at the detection gate, before the wall-clock
    backoff arms (the JAX package's order)."""
    seq, cfg, j = reloc_state
    tcfg = port_config(cfg)
    t = TSlam(tcfg, device="cpu")
    m = interop.map_store(vars(j.map), tcfg)
    gen = torch.Generator().manual_seed(44)
    fe = TFrontEnd(tcfg, t.cam_l, m, gen)
    reloc = TRelocalizer(tcfg, t.cam_l, m, carried_index(
        j.loop_closer.index), gen)
    blank = np.zeros_like(seq.images_left[0], dtype=np.float32)
    fe.preprocess(blank)
    assert not reloc.try_relocalize(fe)
    assert reloc._last_attempt_t < 0 and reloc.n_relocs == 0


def test_full_reset_moves_relocalizer_and_index_to_the_new_map(reloc_state):
    """A full reset (the mono bootstrap restart) discards the map: the
    relocalizer and the loop closer follow the new one and the place index
    forgets the old keyframes, so a later attempt cannot restore the old
    map's landmarks into the new map's front end (the JAX package keeps
    them; ROADMAP Queue 3)."""
    seq, cfg, j = reloc_state
    t = TSlam(port_config(cfg), device="cpu")
    m = interop.map_store(vars(j.map), t.cfg)
    t.map = m
    for part in (t.frontend, t.mapper, t.estimator, t.loop_closer,
                 t.relocalizer):
        part.map = m
    t.loop_closer.index = t.relocalizer.index = carried_index(
        j.loop_closer.index)
    fe = t.frontend
    fe._quality, fe._fast_th = j.frontend._quality, j.frontend._fast_th
    # on the carried map the lost view relocalizes
    _lose_and_show(fe, seq, 10)
    assert t.relocalizer.try_relocalize(fe)

    t._reset(full=True)
    assert t.map is not m and t.map.n_keyframes == 0
    assert t.relocalizer.map is t.map and t.loop_closer.map is t.map
    assert t.relocalizer.index is t.loop_closer.index
    assert t.loop_closer.index.kf_ids == []
    assert t.estimator.lc_kf_id == -1
    # the same view after the reset: nothing of the old map comes back
    fe._quality, fe._fast_th = j.frontend._quality, j.frontend._fast_th
    _lose_and_show(fe, seq, 10)
    assert not t.relocalizer.try_relocalize(fe)
    assert t.relocalizer.n_relocs == 1
    assert (fe.frame.lmids == -1).all() and fe.frame.kf_id < 0
    q = np.zeros((cfg.max_kps, 8), np.uint32)
    assert t.loop_closer.index.query_best(q, np.ones(cfg.max_kps, bool)) == []


def _prefix(sm, seq, n):
    for i in range(n):
        sm.process_frame(seq.images_left[i], seq.images_right[i],
                         time=float(seq.times[i]))


@pytest.mark.slow
@pytest.mark.parametrize("case", ["direct", "blackout", "off"])
def test_port_meets_relocalization_gates(case):
    """The three tests of tests/test_relocalization.py, on the port."""
    from ov2slam_torch.io.synthetic import generate_sequence

    seed = {"direct": 11, "blackout": 12, "off": 13}[case]
    seq = generate_sequence(n_frames=40 if case != "off" else 30,
                            stereo=True, width=376, height=240,
                            n_points=2500, seed=seed, speed=0.05)
    cfg = seq.make_config(use_loop_closer=True, reloc_min_interval_s=0.0,
                          use_relocalizer=case != "off")
    sm = TSlam(cfg, device="cpu")
    blank = np.zeros((240, 376), np.float32)
    if case == "direct":
        _prefix(sm, seq, 30)
        assert sm.relocalizer is not None and sm.map.n_keyframes >= 2
        _lose_and_show(sm.frontend, seq, 10)
        assert sm.relocalizer.try_relocalize(sm.frontend)
        assert sm.relocalizer.n_relocs == 1
        rot, tr = lie_np.pose_distance(
            sm.frontend.frame.T_wc.astype(np.float64),
            seq.gt_poses[10].astype(np.float64))
        assert tr < 0.05 and rot < 0.05
        assert sm.frontend.frame.n_valid >= 10
        lm = sm.frontend.frame.lmids[sm.frontend.frame.valid]
        assert (sm.map.lm_valid[lm] & sm.map.lm_is3d[lm]).all()
    elif case == "blackout":
        _prefix(sm, seq, 25)
        n_kfs = sm.map.n_keyframes
        assert n_kfs >= 2
        for k in range(3):
            sm.process_frame(blank, blank, time=float(seq.times[25]) + 0.01 * k)
        assert sm.map.n_keyframes == n_kfs
        T = sm.process_frame(seq.images_left[20], seq.images_right[20],
                             time=float(seq.times[25]) + 0.05)
        assert sm.relocalizer.n_relocs >= 1
        rot, tr = lie_np.pose_distance(np.array(T, np.float64),
                                       seq.gt_poses[20].astype(np.float64))
        assert tr < 0.05 and rot < 0.05
        for i in range(21, 30):
            T = sm.process_frame(seq.images_left[i], seq.images_right[i],
                                 time=float(seq.times[25]) + 0.05 * (i - 19))
        assert np.linalg.norm(np.array(T)[4:7] - seq.gt_poses[29][4:7]) < 0.1
    else:
        assert sm.relocalizer is None
        _prefix(sm, seq, 20)
        for k in range(2):
            sm.process_frame(blank, blank, time=float(seq.times[20]) + 0.01 * k)
        assert sm.n_resets >= 1


def test_xyz_local_ba_from_carried_state(reloc_state):
    """The estimator's xyz branch (``use_inv_depth=False``) from the same
    map and window on both packages: f32 solves with differently ordered
    sums agree to 1e-3 on poses and landmark positions, and the same
    landmarks survive the culling (the ``vv`` rule on ``obs_valid``)."""
    import copy
    import dataclasses

    from ov2slam_torch.models.estimator import Estimator as TEstimator
    from ov2slam_tpu.models.estimator import Estimator as JEstimator

    seq, cfg, j = reloc_state
    cfg = dataclasses.replace(cfg, use_inv_depth=False)
    jm = copy.deepcopy(j.map)
    tcfg = port_config(cfg)
    t = TSlam(tcfg, device="cpu")
    tm = interop.map_store(vars(jm), tcfg)
    kf = int(np.nonzero(jm.kf_valid)[0][np.argmax(jm.kf_seq[jm.kf_valid])])
    n_j = JEstimator(cfg, j.cam_l, j.cam_r, jm).local_ba(kf)
    n_t = TEstimator(tcfg, t.cam_l, t.cam_r, tm).local_ba(kf)
    assert n_t == n_j > 20
    np.testing.assert_allclose(tm.kf_poses[tm.kf_valid],
                               jm.kf_poses[jm.kf_valid], atol=1e-3)
    live = jm.lm_valid & jm.lm_is3d
    np.testing.assert_array_equal(tm.lm_valid & tm.lm_is3d, live)
    np.testing.assert_allclose(tm.lm_pos[live], jm.lm_pos[live], rtol=1e-3,
                               atol=1e-3)
