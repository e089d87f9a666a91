"""Device resolution and the port's numeric policy.

``resolve_device(None)`` is the GPU and raises when there is none: the port
never falls back to the CPU on its own. Only an explicit ``"cpu"`` gives the
CPU, which is what the parity tests pass.

TF32 is turned off for matmuls and cuDNN: the bundle-adjustment solvers need
full f32 normal equations (the JAX package's distributed Schur BA diverged
at reduced matmul precision), and image filters written as convolutions
would otherwise run in TF32 through cuDNN.
"""

from __future__ import annotations

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
