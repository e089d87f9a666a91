"""The stereo flight draws each chunk of views from the points near its
stretch of the path alone, and that leaves every frame as drawing all of
them does."""

import numpy as np

from benchmark.scenes import stereo_seq


def test_the_culled_render_draws_what_all_points_draw(monkeypatch,
                                                      one_thread):
    seq = dict(width=188, height=120, n_frames=3 * stereo_seq.CHUNK + 5,
               n_points=1500, max_depth=20.0, speed=0.3, baseline=0.11,
               fps=20.0)
    culled = stereo_seq.StereoSequence(seq, 2 ** 33 + 5)
    monkeypatch.setattr(stereo_seq, "Z_MARGIN", 1e9)
    every = stereo_seq.StereoSequence(seq, 2 ** 33 + 5)
    assert len(culled.left) == seq["n_frames"]
    for a, b in zip(culled.left + culled.right, every.left + every.right):
        assert np.array_equal(a, b)
    assert np.mean([(f != 40).mean() for f in culled.left]) > 0.05
