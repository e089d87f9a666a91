"""A stereo camera flying a long, gently weaving path through a field of
textured splats, rendered from a seed with exact ground truth.

The scene and its splats are those of the program's ``io/synthetic.py``
(the ``arc`` trajectory of its slices F and H, no photometric realism):
points drawn uniformly in a box 10 m (5 m vertically) beyond the path,
each with an intensity and its own smoothed 9x9 pattern, bilinearly
placed at its projection; EuRoC's focal length (458 px at 752 px) and an
11 cm baseline. Points farther than ``max_depth`` along the view are not
drawn, so that a view holds as many as one inside the program's loop
scene, whose box ends some 20 m ahead. The frames are rendered in set-up on ``device`` with
torch (the patches summed by a deterministic ``index_put_``) and kept on
the host as 8-bit images, as a dataset stores them. The path never comes
back on itself, so a session's window holds no revisit until it has run
through every frame.
"""

from __future__ import annotations

import numpy as np

from . import lie

PATCH = 9
CHUNK = 32    # frames rendered at once on the device
# metres of world z beyond a chunk's camera centres, behind and past
# max_depth, within which every point a view can draw lies: the path yaws
# and pitches by under 0.1 rad and the box reaches 12 m to the side
Z_MARGIN = 4.0


def make_patterns(n_points: int, seed: int, size: int = PATCH) -> np.ndarray:
    """Each point's own random patch, smoothed by [1 2 1] / 4 along both
    axes (zero beyond the patch) and tapered to zero at its edge."""
    rng = np.random.default_rng(seed)
    pats = rng.uniform(-1.0, 1.0, size=(n_points, size, size)).astype(
        np.float32)
    for axis in (1, 2):
        p = np.pad(pats, [(0, 0)] + [(1, 1) if a == axis else (0, 0)
                                     for a in (1, 2)])
        lo = [slice(None)] * 3
        mid = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis], mid[axis], hi[axis] = (slice(0, -2), slice(1, -1),
                                         slice(2, None))
        pats = (0.25 * p[tuple(lo)] + 0.5 * p[tuple(mid)]
                + 0.25 * p[tuple(hi)]).astype(np.float32)
    w1 = np.hanning(size + 2)[1:-1].astype(np.float32)
    return pats * w1[None, :, None] * w1[None, None, :]


def arc_trajectory(n_frames: int, speed: float) -> np.ndarray:
    """(F, 7) T_wc of a forward path along z that weaves in x and y and
    yaws and pitches gently, starting at the origin."""
    poses = []
    for i in range(n_frames):
        s = i * speed
        t = np.array([0.6 * np.sin(0.3 * s), 0.15 * np.sin(0.2 * s), s])
        q = lie.quat_mul(lie.so3_exp(np.array([0.0, 0.08 * np.sin(0.25 * s),
                                               0.0])),
                         lie.so3_exp(np.array([0.04 * np.sin(0.2 * s + 1.0),
                                               0.0, 0.0])))
        poses.append(np.concatenate([q, t]))
    return np.stack(poses).astype(np.float64)


class StereoSequence:
    """The scene and its frames: ``left[i]``, ``right[i]`` (uint8 numpy),
    ``gt[i]`` (T_wc of the left camera), ``K``, ``T_lr`` (the right camera
    in the left's frame), ``width``, ``height``."""

    def __init__(self, seq: dict, seed: int, device="cpu"):
        import torch

        n, W, H = seq["n_frames"], seq["width"], seq["height"]
        rng = np.random.default_rng(seed)
        f = 458.0 * W / 752.0
        self.K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2],
                           [0.0, 0.0, 1.0]])
        self.width, self.height = W, H
        self.max_depth = seq["max_depth"]
        self.gt = arc_trajectory(n, seq["speed"])
        span = self.gt[:, 4:7]
        lo = span.min(0) - np.array([10.0, 5.0, 10.0])
        hi = span.max(0) + np.array([10.0, 5.0, 10.0])
        P = seq["n_points"]
        points = rng.uniform(lo, hi, size=(P, 3))
        inten = rng.uniform(60.0, 200.0, size=P)
        self.T_lr = np.concatenate([[1.0, 0, 0, 0],
                                    [seq["baseline"], 0.0, 0.0]])
        dev = torch.device(device)
        pts = torch.as_tensor(points, device=dev)
        pat = torch.as_tensor(
            make_patterns(P, seed=seed + 1)
            * inten[:, None, None].astype(np.float32), device=dev)
        # a chunk of views draws only points near its stretch of the path:
        # those are taken in their own order, so the sums are the same
        by_z = np.argsort(points[:, 2], kind="stable")
        z_sorted = points[by_z, 2]
        M_rl = lie.pose_to_matrix(lie.pose_inverse(self.T_lr))
        M_cw = lie.pose_to_matrix(lie.pose_inverse(self.gt))     # (n, 4, 4)
        views = np.stack([M_cw, M_rl[None] @ M_cw], 1).reshape(-1, 4, 4)
        det = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        self.left, self.right = [], []
        try:
            for c in range(0, n, CHUNK):
                cz = span[c:c + CHUNK, 2]
                i0, i1 = np.searchsorted(
                    z_sorted, [cz.min() - Z_MARGIN,
                               cz.max() + self.max_depth + Z_MARGIN])
                near = torch.as_tensor(np.sort(by_z[i0:i1]), device=dev)
                frames = self._render(views[2 * c:2 * (c + CHUNK)],
                                      pts[near], pat[near]).cpu().numpy()
                self.left += list(frames[0::2])
                self.right += list(frames[1::2])
        finally:
            torch.use_deterministic_algorithms(det)

    def _render(self, M_cw: np.ndarray, pts, pats):
        """Views (B, 4, 4) of points ``pts`` (P, 3) with patterns ``pats``
        as (B, H, W) uint8 tensors: background 40, every point in front
        (0.3 < z < max_depth) and wholly inside the image splatted,
        clipped to [0, 255] and rounded."""
        import torch

        W, H, K = self.width, self.height, self.K
        M = torch.as_tensor(M_cw, device=pts.device)
        B = M.shape[0]
        pc = torch.einsum("bij,pj->bpi", M[:, :3, :3], pts) \
            + M[:, None, :3, 3]
        z = pc[..., 2]
        u = pc[..., 0] / z * K[0, 0] + K[0, 2]
        v = pc[..., 1] / z * K[1, 1] + K[1, 2]
        S, half = PATCH, PATCH // 2 + 1
        b, p = torch.nonzero((z > 0.3) & (z < self.max_depth)
                             & (u >= half) & (u < W - half)
                             & (v >= half) & (v < H - half), as_tuple=True)
        u, v = u[b, p], v[b, p]
        iu, iv = torch.floor(u), torch.floor(v)
        fu = (u - iu).float()[:, None, None]
        fv = (v - iv).float()[:, None, None]
        pat = pats[p]
        padded = torch.zeros((len(p), S + 1, S + 1), device=pat.device)
        padded[:, :S, :S] += (1 - fu) * (1 - fv) * pat
        padded[:, :S, 1:] += fu * (1 - fv) * pat
        padded[:, 1:, :S] += (1 - fu) * fv * pat
        padded[:, 1:, 1:] += fu * fv * pat
        off = torch.arange(S + 1, device=pat.device)
        ys = iv.long()[:, None, None] - S // 2 + off[None, :, None]
        xs = iu.long()[:, None, None] - S // 2 + off[None, None, :]
        flat = b[:, None, None] * (H * W) + ys * W + xs
        img = torch.full((B * H * W,), 40.0, device=pat.device)
        img.index_put_((flat.reshape(-1),), padded.reshape(-1),
                       accumulate=True)
        return torch.round(img.clamp(0.0, 255.0)).to(
            torch.uint8).view(B, H, W)
