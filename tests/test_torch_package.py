"""Package rules of ov2slam_torch: no JAX, no ov2slam_tpu, GPU by default.

- every file under ov2slam_torch/, chip_smoke.py, trace_slice.py and
  closure_stages.py imports neither ``jax`` nor ``ov2slam_tpu`` (checked on
  the syntax tree);
- the package imports on a host without CUDA;
- ``resolve_device(None)`` raises when no GPU is present, and the entry
  points that take a device refuse to fall back to the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ov2slam_torch")
FORBIDDEN = ("jax", "jaxlib", "ov2slam_tpu")


def _sources():
    out = [os.path.join(ROOT, f) for f in
           ("chip_smoke.py", "trace_slice.py", "closure_stages.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_slice_index_shapes():
    # the place-index shapes chip_smoke holds the kernel at, built from
    # each slice's config without rendering its sequence
    import chip_smoke

    assert chip_smoke.slice_index_shape("A") == (128, 512)
    assert chip_smoke.slice_index_shape("B") == (2048, 1024)


def test_slices_c_and_d():
    """Slice C is mono and slice D stereo with rectification and xyz BA,
    both at 752x480 with the relocalizer on and unpaced; slice D's frame
    script is test_pipeline_relocalizes_after_blackout's: 25 frames, 3
    blank ones, the revisit of frame 20, then frames 21-29."""
    import types

    import numpy as np

    import chip_smoke
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.utils import profiles

    for name, stereo in (("C", False), ("D", True)):
        kw = chip_smoke.slice_configs()[name][0]
        assert (kw["width"], kw["height"], kw["stereo"]) == (752, 480, stereo)
        cfg = chip_smoke.slice_config(name, synthetic.stream_sequence(
            **kw, realism=None), profiles)
        assert cfg.use_loop_closer and cfg.use_relocalizer and cfg.do_full_ba
        assert cfg.reloc_min_interval_s == 0.0 and cfg.use_clahe
        assert cfg.stereo == stereo
        assert cfg.do_stereo_rect == (not cfg.use_inv_depth) == stereo

    n = 40
    seq = types.SimpleNamespace(
        images_left=[np.full((4, 6), i, np.float32) for i in range(n)],
        images_right=[np.full((4, 6), -i, np.float32) for i in range(n)],
        times=np.arange(n) * 0.05, width=6, height=4)
    frames = chip_smoke.slice_frames("D", seq)
    assert len(frames) == 38
    assert [f[3] for f in frames] == (list(range(25)) + [None] * 3 + [20]
                                      + list(range(21, 30)))
    assert all(not f[0].any() and not f[1].any() for f in frames[25:28])
    times = [f[2] for f in frames]
    assert all(b > a for a, b in zip(times, times[1:]))
    assert len(chip_smoke.slice_frames("C", seq)) == n


def test_slices_e_and_f():
    """Slice E is slice B's sequence and config with the chained front end
    (the asynchronous manager runs it, its loop closer on); slice F is the
    paced-arrival test's stream with the fast profile, whose loop closer
    is off."""
    import chip_smoke
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.utils import profiles

    confs = chip_smoke.slice_configs()
    assert confs["E"][0] == confs["B"][0]
    assert confs["F"][0] == dict(n_frames=110, stereo=True, width=752,
                                 height=480, n_points=8000, seed=0,
                                 kind="arc", speed=0.05)
    cfgs = {}
    for name in ("B", "E", "F"):
        cfgs[name] = chip_smoke.slice_config(name, synthetic.stream_sequence(
            **confs[name][0], realism=None), profiles)
    for name in ("E", "F"):
        assert cfgs[name].pipelined_frontend
        assert cfgs[name].pipeline_depth == 2
    assert not cfgs["B"].pipelined_frontend
    assert cfgs["E"].use_loop_closer and not cfgs["E"].use_relocalizer
    assert cfgs["E"].max_kps == cfgs["B"].max_kps == 512
    assert not cfgs["F"].use_loop_closer


def test_slices_g_and_h(monkeypatch):
    """Slice G is the CARLA rig: six 800x600 90-degree RGB-D cameras yawed
    60 degrees apart over 30 one-metre rig steps (180 integrations) into a
    640x640x64 grid; its ray caster gives the analytic depth of the ground
    and of a box face, and its analytic distance measures the surfaces.
    Slice H replays slice A's loop at KITTI's 1241x376 and slice F's arc
    at 640x480."""
    import numpy as np

    import chip_smoke
    from ov2slam_torch.utils import lie_np

    g = chip_smoke.SLICE_G
    assert g["dims"] == (640, 640, 64) and np.prod(g["dims"]) == 26214400
    assert (g["voxel"], g["trunc"], g["min_ray"], g["max_ray"]) == (
        0.1, 0.3, 0.5, 10.0)
    K = chip_smoke.rig_intrinsics()
    np.testing.assert_allclose(K[0], [400.0, 0.0, 400.0])
    poses = chip_smoke.rig_poses()
    assert len(poses) == 180
    axes = np.array([lie_np.pose_to_matrix(T)[:3, 2] for T in poses[:6]])
    np.testing.assert_allclose(axes[:, 2], 0.0, atol=1e-12)
    yaws = np.degrees(np.arctan2(axes[:, 1], axes[:, 0])) % 360
    np.testing.assert_allclose(yaws, [0, 60, 120, 180, 240, 300], atol=1e-9)
    np.testing.assert_allclose(poses[6][4:] - poses[0][4:], [1.0, 0, 0])

    # one box straight ahead of the first camera, rendered small
    monkeypatch.setitem(g, "width", 80)
    monkeypatch.setitem(g, "height", 60)
    K = chip_smoke.rig_intrinsics()
    T = poses[0]
    x0 = float(T[4])
    scene = dict(box_lo=np.array([[x0 + 4.0, -1.0, 0.0]]),
                 box_hi=np.array([[x0 + 5.0, 1.0, 3.0]]),
                 box_rgb=np.array([[200.0, 10.0, 10.0]]),
                 ground_rgb=np.array([90.0, 90.0, 90.0]))
    depth, rgb = chip_smoke.render_rgbd(scene, T, K, "cpu")
    assert depth.shape == (60, 80) and rgb.shape == (60, 80, 3)
    assert float(depth[30, 40]) == pytest.approx(4.0, abs=1e-5)
    assert rgb[30, 40].tolist() == [200.0, 10.0, 10.0]
    # a ground pixel below the box: depth = height * f / (v - cy)
    v = 59
    assert float(depth[v, 5]) == pytest.approx(
        g["cam_height"] * K[1, 1] / (v - K[1, 2]), rel=1e-5)
    assert not torch.isfinite(depth[0, 0])      # sky
    d = chip_smoke.surface_distance(
        np.array([[x0 + 3.9, 0.0, 1.0], [x0 + 4.5, 0.0, 3.2],
                  [x0, 5.0, 0.25]]), scene)
    np.testing.assert_allclose(d, [0.1, 0.2, 0.25], atol=1e-9)

    h = chip_smoke.SLICE_H
    assert (h["kitti"]["width"], h["kitti"]["height"]) == (1241, 376)
    assert (h["tartanair"]["width"], h["tartanair"]["height"]) == (640, 480)
    scene = chip_smoke.street_scene()
    assert 20 <= len(scene["box_lo"]) <= 40
    lo_y, hi_y = scene["box_lo"][:, 1], scene["box_hi"][:, 1]
    assert (np.sign(lo_y) == np.sign(hi_y)).all()         # off the road
    assert (np.minimum(np.abs(lo_y), np.abs(hi_y)) >= 3.5).all()


def test_package_imports_without_cuda():
    # a fresh interpreter with CUDA hidden: every module imports, and
    # nothing imports jax along the way
    code = (
        "import sys, pkgutil, importlib, ov2slam_torch\n"
        "for m in pkgutil.walk_packages(ov2slam_torch.__path__,"
        " 'ov2slam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'ov2slam_tpu'))"
        " for k in sys.modules), 'jax imported'\n"
        "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_resolve_device_requires_gpu(monkeypatch):
    from ov2slam_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_default_to_gpu(monkeypatch, tmp_path):
    from ov2slam_torch.io.synthetic import generate_sequence
    from ov2slam_torch.loopclosure.index import PlaceIndex
    from ov2slam_torch.models.slam import SlamManager

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlaceIndex(16)
    cfg = generate_sequence(n_frames=2, width=96, height=64,
                            n_points=50).make_config(use_relocalizer=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlamManager(cfg)

    import numpy as np

    from ov2slam_torch import run_slam
    from ov2slam_torch.entry import entry
    from ov2slam_torch.io.rgbd import fuse_rgbd_frames
    from ov2slam_torch.mapping.tsdf import TsdfVolume

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TsdfVolume(origin=np.zeros(3), dims=(4, 4, 4))
    K = np.array([[50.0, 0, 8], [0, 50.0, 6], [0, 0, 1]])
    frame = (np.ones((12, 16), np.float32), None, K,
             np.array([1.0, 0, 0, 0, 0, 0, 0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuse_rgbd_frames([frame])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_slam.main(["--synthetic", "arc", "--frames", "2", "--out",
                       str(tmp_path)])
    # an explicit "cpu" is the only way onto the CPU
    assert TsdfVolume(origin=np.zeros(3), dims=(4, 4, 4),
                      device="cpu").tsdf.device.type == "cpu"
    assert fuse_rgbd_frames([frame], device="cpu")[0].shape == (48, 3)
    assert entry(device="cpu")[1][2].device.type == "cpu"


def test_entry_matches_the_jax_entry():
    """``entry(device="cpu")`` tracks the JAX ``entry()``'s arrays (the same
    seed-0 noise images and keypoints) as the JAX function does, at
    test_torch_klt.py's tolerance: status equal on >= 97% of keypoints,
    positions within 0.01 px where both succeed. On two independent noise
    images no keypoint passes the residual gate in either package, so the
    forward positions (before the gates) are also compared: within 0.01 px
    on >= 90% of keypoints."""
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__
    from ov2slam_torch.entry import entry, entry_arrays
    from ov2slam_torch.ops import klt as tklt
    from ov2slam_tpu.ops import klt as jklt

    torch.set_num_threads(1)
    jfn, jargs = __graft_entry__.entry()
    tfn, targs = entry(device="cpu")
    img0, img1, kps = entry_arrays()
    np.testing.assert_array_equal(np.asarray(jargs[0][0]), img0)
    np.testing.assert_array_equal(np.asarray(jargs[1][0]), img1)
    np.testing.assert_array_equal(np.asarray(jargs[2]), kps)
    for jl, tl in zip(jargs[0] + jargs[1], targs[0] + targs[1]):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3)
    jpx, jst = (np.asarray(a) for a in jfn(*jargs))
    tpx, tst = (a.numpy() for a in tfn(*targs))
    assert tpx.shape == (256, 2) and tst.shape == (256,)
    assert (tst == jst).mean() >= 0.97
    both = tst & jst
    np.testing.assert_allclose(tpx[both], jpx[both], atol=0.01)
    jf = np.asarray(jklt.klt_track(*jargs, win=9, iters=30)[0])
    tf = tklt.klt_track(*targs, win=9, iters=30)[0].numpy()
    assert (np.abs(tf - jf).max(1) <= 0.01).mean() >= 0.9


def test_unsupported_configurations_raise():
    """Every configuration of the port's path constructs on the CPU: the
    pipelined front end at depths 1 and 2 (synchronous and asynchronous
    managers), mono, the relocalizer, xyz BA, full BA and image
    rectification; the asynchronous manager, like the synchronous one,
    raises without a GPU when no device is named."""
    from ov2slam_torch.io.synthetic import generate_sequence
    from ov2slam_torch.models.pipeline import AsyncSlamManager
    from ov2slam_torch.models.slam import SlamManager

    seq = generate_sequence(n_frames=2, width=96, height=64, n_points=50)
    for depth in (1, 2):
        cfg = seq.make_config(pipelined_frontend=True, pipeline_depth=depth)
        slam = SlamManager(cfg, device="cpu")
        assert len(slam.frontend._stage._bufs) == depth + 1
        slam = AsyncSlamManager(cfg, device="cpu")
        assert slam.worker_stream is None and slam._worker.is_alive()
        slam.close()
        assert not slam._worker.is_alive()
    for over in (dict(use_relocalizer=True, use_loop_closer=True),
                 dict(do_full_ba=True), dict(use_inv_depth=False),
                 dict(do_stereo_rect=True)):
        slam = SlamManager(seq.make_config(**over), device="cpu")
        assert (slam.relocalizer is not None) == bool(
            over.get("use_relocalizer"))
    mono = generate_sequence(n_frames=2, stereo=False, width=96, height=64,
                             n_points=50)
    slam = SlamManager(mono.make_config(), device="cpu")
    assert slam.cam_r is None and not slam.frontend.initialized
    import threading

    n_threads = threading.active_count()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncSlamManager(seq.make_config(pipelined_frontend=True))
    assert threading.active_count() == n_threads   # no worker was started


def test_cuda_kernel_wrapper_refuses_cpu_fallback():
    # a CUDA tensor must reach the kernel or raise; CPU tensors take the
    # plain version, counted separately from kernel launches
    from ov2slam_torch.ops import hamming

    n0 = hamming.match_scores_bits.launches
    s = torch.zeros((3, 4, 8), dtype=torch.int32)
    v = torch.ones((3, 4), dtype=torch.bool)
    out = hamming.match_scores(s, v, s[0], v[0], 48)
    assert out.tolist() == [1.0, 1.0, 1.0]
    pm1 = hamming.unpack_pm1(s, v)
    out = hamming.match_scores_bits(pm1, v, pm1[0], v[0], 48)
    assert out.tolist() == [1.0, 1.0, 1.0]
    assert hamming.match_scores_bits.launches == n0
    with pytest.raises(ValueError):
        hamming.match_scores(s.to("meta"), v.to("meta"), s[0].to("meta"),
                             v[0].to("meta"), 48)
    with pytest.raises(ValueError):
        hamming.match_scores_bits(pm1.to("meta"), v.to("meta"),
                                  pm1[0].to("meta"), v[0].to("meta"), 48)


def test_kernel_library_rebuilt_when_an_included_header_changes(
        tmp_path, monkeypatch):
    # a library is stale when its .cu or any csrc header it includes,
    # directly or through another header, is newer; other headers and
    # system includes do not count
    from ov2slam_torch import kernels

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n')
    (csrc / "a.cuh").write_text('#pragma once\n  #include "b.cuh"\n')
    (csrc / "b.cuh").write_text("#pragma once\n")
    (csrc / "other.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    assert kernels._stale("k")                      # nothing built yet
    lib = build / "libk.so"
    lib.write_bytes(b"")
    for p in csrc.iterdir():
        os.utime(p, (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not kernels._stale("k")
    os.utime(csrc / "other.cuh", (3000, 3000))
    assert not kernels._stale("k")
    os.utime(csrc / "b.cuh", (3000, 3000))
    assert kernels._stale("k")
