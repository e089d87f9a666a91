"""Published peaks of one NVIDIA H100 (SXM, dense rates, at its 700 W
limit) and the least time of the kernels whose roofline share the
benchmark reports, from their shapes alone.

A frozen copy of the program's ``roofline.tsdf_integrate_bound``: the
benchmark keeps its own yardstick, so that no change to the program can
move it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OPS_PER_S = 1979e12

# a voxel's f32 operations in one projective TSDF update (compares, min,
# max and selects one each): its centre 3 a coordinate; the rotation's
# two cross products 3 each a coordinate; the camera point 5 a
# coordinate; the front test and the safe depth 2; u and v 3 each; their
# rounding and clamps 3 each; the image test 4; the depth's tests 3; sdf
# and its test 2; the observation and its clamp 3; the 1/z^2 weight 4 (none
# with a constant weight) and its select 1; the new weight and the
# denominator 2; the tsdf 4; the weight's clamp 1; the colour 4 a channel
TSDF_VOXEL_OPS = 9 + 9 + 9 + 15 + 2 + 6 + 6 + 4 + 3 + 2 + 3 + 5 + 2 + 4 + 1
TSDF_INV_DEPTH_OPS = 4
TSDF_COLOR_OPS = 12


def bound(ops: float, nbytes: float) -> dict:
    """The larger of the operations' time at the f32 peak and the bytes'
    time at the HBM peak, in ms, and which of the two sets it."""
    t_ops, t_bytes = ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(ops=int(ops), bytes=int(nbytes),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def tsdf_integrate_bound(V: int, H: int, W: int, color: bool = True,
                         const_weight: bool = False) -> dict:
    """One projective integration of an (H, W) depth frame (and colour)
    into a dense grid of ``V`` voxels: every voxel's tsdf and weight (and
    colour) read and written once, 16 (40) bytes a voxel, and the frame
    read once, 4 (16) bytes a pixel. Every voxel is written, in the
    camera's view or not: the update poisons voxels under NaN depth and
    rewrites the rest."""
    ops = V * (TSDF_VOXEL_OPS - const_weight * TSDF_INV_DEPTH_OPS
               + color * TSDF_COLOR_OPS)
    return bound(ops, V * (16 + 24 * color) + H * W * (4 + 12 * color))
