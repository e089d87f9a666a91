"""The port's flagship computation as one callable: ``entry()``.

Counterpart of ``__graft_entry__.py::entry`` at the repository's root: the
front end's forward-backward pyramidal KLT (``ops/klt.py::fb_klt_track``,
``win=9, iters=30``) of 256 keypoints over two 4-level pyramids of 752x480
noise images made from seed 0 — the same arrays as the JAX package's
``entry()``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.image import build_pyramid
from .device import resolve_device
from .ops.klt import fb_klt_track


def entry_arrays():
    """The numpy inputs of ``entry()``: two (480, 752) f32 images and 256
    keypoints, drawn from ``default_rng(0)`` in the JAX ``entry()``'s
    order."""
    rng = np.random.default_rng(0)
    img0 = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    img1 = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    kps = rng.uniform([30, 30], [720, 450], (256, 2)).astype(np.float32)
    return img0, img1, kps


def fb_klt_entry(pyr0, pyr1, kps, priors, valid):
    """``fb_klt_track`` at the front end's window and iteration count."""
    return fb_klt_track(pyr0, pyr1, kps, priors, valid, win=9, iters=30)


def entry(device=None):
    """Returns ``(fn, args)``: ``fn(*args)`` tracks the keypoints from one
    pyramid into the other on ``device`` (``None`` = the GPU) and returns
    (tracked (256, 2), status (256,))."""
    dev = resolve_device(device)
    img0, img1, kps = entry_arrays()
    pyr0 = tuple(build_pyramid(torch.as_tensor(img0, device=dev), 4))
    pyr1 = tuple(build_pyramid(torch.as_tensor(img1, device=dev), 4))
    k = torch.as_tensor(kps, device=dev)
    valid = torch.ones(256, dtype=torch.bool, device=dev)
    return fb_klt_entry, (pyr0, pyr1, k, k, valid)
