"""Device resolution and the port's numeric policy.

``resolve_device(None)`` is the GPU and raises when there is none: the port
never falls back to the CPU on its own. Only an explicit ``"cpu"`` gives the
CPU, which is what the parity tests pass.

:func:`record_event` and :func:`wait_event` order work across CUDA streams
(the asynchronous manager's front end and worker each run on their own);
on the CPU they do nothing.

TF32 is turned off for matmuls and cuDNN: the bundle-adjustment solvers need
full f32 normal equations (the JAX package's distributed Schur BA diverged
at reduced matmul precision), and image filters written as convolutions
would otherwise run in TF32 through cuDNN.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def set_precision_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda`` (raises without a GPU); otherwise the device
    named. Turns TF32 off either way."""
    set_precision_policy()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ov2slam_torch: no CUDA device is available; pass "
                "device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ov2slam_torch: CUDA requested but unavailable")
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def record_event(device: torch.device) -> Optional["torch.cuda.Event"]:
    """An event recorded on the current stream of ``device`` (None on the
    CPU): what was enqueued so far on that stream is before it."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def wait_event(ev: Optional["torch.cuda.Event"], device=None) -> None:
    """Make the current stream (of ``device``, or of the event's device)
    wait for ``ev`` without blocking the host; None is a no-op."""
    if ev is not None:
        torch.cuda.current_stream(device).wait_event(ev)


def stream_context(stream: Optional["torch.cuda.Stream"]):
    """``torch.cuda.stream(stream)``, or a no-op context for None."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)
