"""The port's dataset readers, map checkpoints, runner viewer and CLI.

- test_io.py's KITTI and TartanAir reader cases on the port; frames and
  ground truth equal between the packages on the same directories;
- test_mapstore.py's checkpoint round trip on the port, and a map saved by
  either package loaded into the other's ``MapStore``;
- the runner writes ``viewer.html``, and logs a warning (never raises)
  when the export fails;
- ``python -m ov2slam_torch.run_slam --kitti ... --device cpu`` over a
  small KITTI-layout directory: the report's keys, the result files, the
  viewer and the saved map.
"""

import json
import logging

import numpy as np
import pytest
import torch

import chip_smoke
from ov2slam_torch import run_slam
from ov2slam_torch.io import runner
from ov2slam_torch.io.kitti import KittiDataset
from ov2slam_torch.io.synthetic import generate_sequence
from ov2slam_torch.io.tartanair import TartanAirDataset
from ov2slam_torch.mapping import checkpoint as tckpt
from ov2slam_torch.mapping.store import MapStore
from ov2slam_torch.models.slam import SlamManager
from ov2slam_torch.utils.config import SlamConfig
from ov2slam_tpu.io.kitti import KittiDataset as JKittiDataset
from ov2slam_tpu.io.tartanair import TartanAirDataset as JTartanAirDataset
from ov2slam_tpu.mapping import checkpoint as jckpt
from ov2slam_tpu.mapping.store import MapStore as JMapStore
from ov2slam_tpu.utils.config import SlamConfig as JSlamConfig

torch.set_num_threads(1)


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr.astype("uint8")).save(path)


@pytest.fixture
def kitti_dir(tmp_path, rng):
    seq = tmp_path / "sequences" / "07"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    (tmp_path / "poses").mkdir()
    n = 4
    for i in range(n):
        img = rng.uniform(0, 255, (48, 64))
        _write_png(seq / "image_0" / f"{i:06d}.png", img)
        _write_png(seq / "image_1" / f"{i:06d}.png", img)
    (seq / "times.txt").write_text("".join(f"{0.1*i:.6f}\n"
                                           for i in range(n)))
    rows = []
    for i in range(n):
        M = np.hstack([np.eye(3), [[0.5 * i], [0.0], [0.0]]])
        rows.append(" ".join(f"{v:.6e}" for v in M.reshape(-1)))
    (tmp_path / "poses" / "07.txt").write_text("\n".join(rows) + "\n")
    return tmp_path


@pytest.fixture
def tartanair_dir(tmp_path, rng):
    (tmp_path / "image_left").mkdir()
    (tmp_path / "image_right").mkdir()
    n = 3
    for i in range(n):
        img = rng.uniform(0, 255, (32, 40))
        _write_png(tmp_path / "image_left" / f"{i:06d}_left.png", img)
        _write_png(tmp_path / "image_right" / f"{i:06d}_right.png", img)
    rows = [f"{0.1*i:.6f} 0.0 0.0 0.0 0.0 0.0 1.0" for i in range(n)]
    (tmp_path / "pose_left.txt").write_text("\n".join(rows) + "\n")
    return tmp_path


def test_kitti_reader(kitti_dir):
    ds = KittiDataset(str(kitti_dir), "07")
    assert len(ds) == 4 and ds.stereo
    frames = list(ds)
    assert frames[0][0].shape == (48, 64)
    assert frames[1][1] is not None
    assert abs(frames[2][2] - 0.2) < 1e-9
    times, poses = ds.ground_truth()
    assert poses.shape == (4, 7)
    np.testing.assert_allclose(poses[2, 4], 1.0, atol=1e-6)
    np.testing.assert_allclose(poses[0, 0], 1.0, atol=1e-6)


def test_tartanair_reader(tartanair_dir):
    ds = TartanAirDataset(str(tartanair_dir))
    assert len(ds) == 3 and ds.stereo
    frames = list(ds)
    assert frames[0][1] is not None
    times, poses = ds.ground_truth()
    assert poses.shape == (3, 7)
    np.testing.assert_allclose(poses[:, 0], 1.0)
    np.testing.assert_allclose(poses[1, 4], 0.1, atol=1e-6)


def _same_dataset(t, j):
    assert len(t) == len(j) and t.stereo == j.stereo
    for (tl, tr, tt), (jl, jr, jt) in zip(t, j):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
        assert tt == jt
    for a, b in zip(t.ground_truth(), j.ground_truth()):
        np.testing.assert_array_equal(a, b)


def test_readers_equal_between_packages(tmp_path):
    seq = generate_sequence(n_frames=5, stereo=True, width=96, height=64,
                            n_points=200, seed=2, kind="arc")
    chip_smoke.write_kitti_dir(seq, str(tmp_path / "kitti"))
    chip_smoke.write_tartanair_dir(seq, str(tmp_path / "tartan"))
    k = str(tmp_path / "kitti")
    _same_dataset(KittiDataset(k, "00"), JKittiDataset(k, "00"))
    _same_dataset(KittiDataset(k, "00", stereo=False),
                  JKittiDataset(k, "00", stereo=False))
    t = str(tmp_path / "tartan")
    _same_dataset(TartanAirDataset(t), JTartanAirDataset(t))
    # the writers keep the ground truth: same positions, and the same
    # rotations up to the quaternion's sign
    _, poses = KittiDataset(k, "00").ground_truth()
    np.testing.assert_allclose(poses[:, 4:], seq.gt_poses[:, 4:], atol=1e-9)
    dots = np.abs((poses[:, :4] * seq.gt_poses[:, :4]).sum(1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-9)
    _, poses = TartanAirDataset(t).ground_truth()
    np.testing.assert_allclose(poses, seq.gt_poses, atol=1e-9)


# ---------------------------------------------------------------------- #
# map checkpoints
# ---------------------------------------------------------------------- #

def _add_kf(store, time, lmids=None, stereo=False):
    N = store.N
    lm_slots = np.full(N, -1, np.int32)
    if lmids is not None:
        lm_slots[: len(lmids)] = lmids
    px = np.random.default_rng(int(time * 100)).uniform(
        0, 400, (N, 2)).astype(np.float32)
    desc = np.zeros((N, 8), np.uint32)
    T = np.concatenate([[1, 0, 0, 0], [time, 0, 0]]).astype(np.float32)
    if stereo:
        st = lm_slots >= 0
        return store.add_keyframe(time, T, lm_slots, px, desc,
                                  is_stereo=st, rpx=px - [5.0, 0.0])
    return store.add_keyframe(time, T, lm_slots, px, desc)


def _filled(store):
    lm = store.new_landmarks(12)
    store.set_landmark_positions(
        lm, np.random.default_rng(1).random((12, 3)).astype(np.float32))
    k0 = _add_kf(store, 0.0, lmids=lm, stereo=True)
    k1 = _add_kf(store, 1.0, lmids=lm[:6])
    return store, lm, k0, k1


def test_checkpoint_roundtrip(tmp_path):
    store, lm, k0, k1 = _filled(MapStore(SlamConfig(max_keyframes=32,
                                                    max_landmarks=512)))
    p = tmp_path / "map.npz"
    tckpt.save_map(store, str(p))

    fresh = MapStore(SlamConfig(max_keyframes=32, max_landmarks=512))
    tckpt.load_map(fresh, str(p))
    assert fresh.n_keyframes == 2
    assert fresh.n_landmarks_3d == 12
    np.testing.assert_array_equal(fresh.obs_lmid, store.obs_lmid)
    np.testing.assert_array_equal(fresh.kf_poses, store.kf_poses)
    assert set(fresh.landmark_observers(lm[0])) == {k0, k1}
    nxt = fresh.new_landmarks(1)[0]
    assert nxt == lm[-1] + 1

    small = MapStore(SlamConfig(max_keyframes=8, max_landmarks=64))
    with pytest.raises(ValueError):
        tckpt.load_map(small, str(p))


def _same_map(a, b):
    for name in tckpt._ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for name in tckpt._SCALARS + tckpt._FREELISTS:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_across_packages(tmp_path, direction):
    kw = dict(max_keyframes=32, max_landmarks=512)
    if direction == "jax_to_port":
        src, save = JMapStore(JSlamConfig(**kw)), jckpt.save_map
        dst, load = MapStore(SlamConfig(**kw)), tckpt.load_map
    else:
        src, save = MapStore(SlamConfig(**kw)), tckpt.save_map
        dst, load = JMapStore(JSlamConfig(**kw)), jckpt.load_map
    src, lm, _, _ = _filled(src)
    src.remove_keyframe(_add_kf(src, 2.0))     # a free-list entry
    p = str(tmp_path / "map.npz")
    save(src, p)
    load(dst, p)
    _same_map(dst, src)
    assert dst._free_kf and dst.n_keyframes == 2


# ---------------------------------------------------------------------- #
# runner viewer, and the command line
# ---------------------------------------------------------------------- #

def _small_seq():
    return generate_sequence(n_frames=12, stereo=True, width=376,
                             height=240, n_points=2500, seed=11, speed=0.05)


def _small_cfg(seq):
    return seq.make_config(max_keyframes=32, max_landmarks=4096,
                           use_fast=False, use_singlescale_detector=True,
                           max_dist=30)


def test_runner_writes_viewer_and_logs_a_failed_export(tmp_path, caplog,
                                                       monkeypatch):
    seq = _small_seq()
    cfg = _small_cfg(seq)
    res = runner.run_sequence(cfg, seq, slam=SlamManager(cfg, device="cpu"),
                              out_dir=str(tmp_path / "ok"))
    assert res.n_processed == 12
    html = (tmp_path / "ok" / "viewer.html").read_text()
    data = json.loads(html.split("window.SLAM_DATA=")[1]
                      .split(";</script>")[0])
    assert len(data["traj"]) == 12 and len(data["frusta"]) >= 1

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(runner, "export_html_viewer", broken)
    with caplog.at_level(logging.WARNING, logger=runner.__name__):
        res = runner.run_sequence(cfg, seq,
                                  slam=SlamManager(cfg, device="cpu"),
                                  out_dir=str(tmp_path / "broken"))
    assert res.ate is not None and res.n_processed == 12
    assert (tmp_path / "broken" / "ov2slam_traj.txt").exists()
    assert not (tmp_path / "broken" / "viewer.html").exists()
    msgs = [r.getMessage() for r in caplog.records
            if r.levelno == logging.WARNING]
    assert any("viewer" in m and "disk full" in m for m in msgs), msgs


def test_cli_over_a_kitti_directory(tmp_path, capsys):
    seq = _small_seq()
    chip_smoke.write_kitti_dir(seq, str(tmp_path / "kitti"))
    chip_smoke.write_reference_yaml(_small_cfg(seq), str(tmp_path / "c.yaml"))
    out = tmp_path / "out"
    report, slam = run_slam.main([
        "--kitti", str(tmp_path / "kitti"), "--config",
        str(tmp_path / "c.yaml"), "--out", str(out), "--save-map",
        str(tmp_path / "map.npz"), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == report
    assert set(report) == {"frames", "processed", "dropped", "keyframes",
                           "closures", "wall_s", "fps", "ate_m",
                           "ate_scaled_m"}
    assert report["frames"] == report["processed"] == 12
    assert report["ate_m"] is not None and report["ate_m"] < 0.1
    assert slam.device == torch.device("cpu")
    for f in chip_smoke.RESULT_FILES[:3] + ("viewer.html",):
        assert (out / f).exists(), f
    fresh = MapStore(slam.cfg)
    tckpt.load_map(fresh, str(tmp_path / "map.npz"))
    _same_map(fresh, slam.map)
    assert fresh.n_keyframes == report["keyframes"]
