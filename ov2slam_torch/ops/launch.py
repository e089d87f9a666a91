"""Argument checks shared by the wrappers of the hand-written kernels that
take tensors of any layout (``ops/klt.py``, ``geometry/essential.py``,
``solvers/pnp_refine.py``, ``core/camera.py``, ``core/image.py``), and the
launch call that counts on :func:`graphs.count_launch` (:func:`run`: the
KLT, local BA's two libraries and the image and camera kernels).

A wrapper takes CPU tensors to its plain version and launches its kernel
on CUDA tensors; before a launch it checks every input here and raises on
what the kernel does not take: TypeError on a dtype (an f64 tensor where the
kernel reads f32), ValueError on another device, on a layout the kernel
does not read (not contiguous, or rows whose values are not adjacent), on a
shape, and on sizes above what the kernel is sized for.
"""

from __future__ import annotations

import numbers

import torch

from .. import graphs, kernels


def device_of(t: torch.Tensor, fn: str) -> torch.device:
    """``t``'s device, or ValueError where no wrapper runs (only the CPU,
    which takes the plain version, and CUDA)."""
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    return dev


def check(fn: str, name: str, t: torch.Tensor, dtype, dev, shape=None,
          rows: bool = False) -> int:
    """Checks one tensor input of a launch; returns its row stride in
    elements (``rows``: a 2-D tensor whose rows hold adjacent values and
    may lie any distance apart, as a column view of a packed state does;
    otherwise it must be contiguous and the stride is its row length)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if t.device != dev:
        raise ValueError(f"{fn}: {name} is on {t.device}, the inputs on "
                         f"{dev}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, not {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if rows:
        if t.dim() != 2 or (t.shape[0] > 1 and t.shape[1] > 1 and (
                t.stride(1) != 1 or t.stride(0) < t.shape[1])):
            raise ValueError(f"{fn}: {name} must be rows of adjacent "
                             "values")
        return t.stride(0) if t.shape[0] > 1 else t.shape[1]
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    return t.shape[-1] if t.dim() > 1 else 1


def scalar(fn: str, name: str, x, dev):
    """A scalar the kernel reads: a Python number (passed by value) or a
    one-element f32 tensor on the inputs' device (read there, so that the
    host never waits for it). Returns (device pointer or None, value)."""
    if isinstance(x, torch.Tensor):
        check(fn, name, x, torch.float32, dev)
        if x.numel() != 1:
            raise ValueError(f"{fn}: {name} must have one element")
        return x.data_ptr(), 0.0
    if not isinstance(x, numbers.Real):
        raise TypeError(f"{fn}: {name} must be a number or a tensor")
    return None, float(x)


def number(fn: str, name: str, x) -> float:
    """A host-side number (never a tensor: reading one would wait for the
    device)."""
    if isinstance(x, torch.Tensor) or not isinstance(x, numbers.Real):
        raise TypeError(f"{fn}: {name} must be a Python number")
    return float(x)


def run(lib: str, args, wrapper, key, dev, fn: str = None) -> None:
    """Calls kernel library ``lib``'s launch function ``fn`` (its first,
    ``kernels._SIGNATURES``', by default) with ``args`` and the current
    stream of ``dev``; raises if it returns an error code, and counts one
    launch on ``wrapper`` at ``key`` (:func:`graphs.count_launch`: inside a
    capture, at each replay)."""
    fn_name = fn or kernels._SIGNATURES[lib][0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(kernels.load(lib), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{lib} launch failed: code {rc}")
    graphs.count_launch(wrapper, key, stream)
