"""ov2slam_torch — the PyTorch/CUDA port of ``ov2slam_tpu`` for one NVIDIA
Hopper GPU.

The layout mirrors ``ov2slam_tpu`` module for module (``ops/klt.py`` ↔
``ops/klt.py``), so each parity test names the pair it checks. Entry points
take a ``device`` argument; ``None`` means the GPU and raises without one
(see :mod:`ov2slam_torch.device`). Hand-written kernels live in ``csrc/``
and are built on first use by :mod:`ov2slam_torch.kernels`.
"""

__version__ = "0.1.0"
