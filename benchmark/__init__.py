"""The benchmark of ``ov2slam_torch`` on one NVIDIA H100 (see README.md)."""
