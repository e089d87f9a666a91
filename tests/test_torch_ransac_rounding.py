"""The RANSAC kernel's 5-point constraint stage keeps the roots of the
loop-closure samples in ``ransac_rounding.py`` (where the stage in f32 lost
one by 1.9e-3): its CPU mirror, with the stage in f64 as the kernel runs
it, lands each within 1e-4 of the f64 plain solve."""

import torch

import ransac_rounding

torch.set_num_threads(1)


def test_f64_constraint_stage_keeps_the_loop_closure_roots():
    errs = ransac_rounding.root_errors("f64")
    assert len(errs) == len(ransac_rounding.SAMPLES)
    assert max(errs) <= 1e-4, errs
