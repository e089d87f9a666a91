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


def test_entry_points_default_to_gpu(monkeypatch):
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


def test_unsupported_configurations_raise():
    from ov2slam_torch.io.synthetic import generate_sequence
    from ov2slam_torch.models.slam import SlamManager

    seq = generate_sequence(n_frames=2, width=96, height=64, n_points=50)
    for over in (dict(use_relocalizer=True, use_loop_closer=True),
                 dict(pipelined_frontend=True, use_relocalizer=False),
                 dict(do_full_ba=True, use_relocalizer=False),
                 dict(use_inv_depth=False, use_relocalizer=False)):
        with pytest.raises(NotImplementedError):
            SlamManager(seq.make_config(**over), device="cpu")
    mono = generate_sequence(n_frames=2, stereo=False, width=96, height=64,
                             n_points=50)
    with pytest.raises(NotImplementedError, match="mono"):
        SlamManager(mono.make_config(use_relocalizer=False), device="cpu")


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
