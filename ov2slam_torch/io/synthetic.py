"""Synthetic ground-truthed sequences for tests and benchmarks.

The reference verifies itself only by replaying EuRoC rosbags
(`benchmark_scripts/euroc_bench.sh`); no dataset ships with this
environment, so we render deterministic synthetic sequences with exact
ground truth instead: a 3D "star field" of Gaussian splats observed by a
camera on a smooth trajectory. Texture-rich, full parallax, works for
mono and stereo, and ATE against ground truth is exact.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..utils import lie_np as lie
from ..utils.config import CameraConfig, SlamConfig


@dataclasses.dataclass
class RealismParams:
    """Photometric / dynamic-scene realism knobs for rendered sequences.

    The reference validates on real EuRoC imagery (rolling exposure, sensor
    noise, vignetting, people walking through the V-rooms); no dataset ships
    in this environment, so long rendered sequences take that role and these
    knobs re-introduce the photometric nuisances real footage has. All
    effects are deterministic per (seed, frame index).
    """

    noise_std: float = 0.0        # Gaussian read-noise sigma (gray levels)
    exposure_amp: float = 0.0     # gain modulation amplitude (e.g. 0.25)
    exposure_period_s: float = 8.0
    bias_amp: float = 0.0         # additive black-level drift (gray levels)
    vignette: float = 0.0         # corner falloff fraction (e.g. 0.35)
    n_occluders: int = 0          # moving textured foreground discs
    occluder_radius: float = 0.45  # meters
    seed: int = 7


DEFAULT_REALISM = RealismParams(
    noise_std=2.0, exposure_amp=0.18, bias_amp=4.0, vignette=0.3,
    n_occluders=4)


def make_patterns(n_points: int, seed: int = 1234,
                  size: int = 9) -> np.ndarray:
    """Per-landmark appearance patterns: smoothed random patches, so each
    feature has a *distinctive* local appearance (required for descriptor
    matching / place recognition to be meaningful — identical Gaussian
    blobs make every BRIEF descriptor ambiguous)."""
    rng = np.random.default_rng(seed)
    pats = rng.uniform(-1.0, 1.0, size=(n_points, size, size)).astype(
        np.float32)
    # light smoothing so subpixel bilinear placement stays consistent
    k = np.array([0.25, 0.5, 0.25], np.float32)
    pats = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="same"), 1, pats)
    pats = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="same"), 2, pats)
    # taper edges to zero to avoid splat seams
    w1 = np.hanning(size + 2)[1:-1].astype(np.float32)
    pats *= w1[None, :, None] * w1[None, None, :]
    return pats


def render_splats(
    points_cam: np.ndarray,
    intensities: np.ndarray,
    K: np.ndarray,
    width: int,
    height: int,
    patterns: Optional[np.ndarray] = None,
    background: float = 40.0,
) -> np.ndarray:
    """Render 3D points (camera frame) as textured splats. Returns (H, W) f32.

    Subpixel-accurate: each point's pattern is bilinearly placed at its
    projected (float) pixel position, so KLT can recover subpixel motion
    and each feature keeps a distinctive appearance across frames.
    """
    img = np.full((height, width), background, np.float32)
    z = points_cam[:, 2]
    vis_mask = z > 0.3
    vis = np.nonzero(vis_mask)[0]
    pts = points_cam[vis]
    inten = intensities[vis]
    u = pts[:, 0] / pts[:, 2] * K[0, 0] + K[0, 2]
    v = pts[:, 1] / pts[:, 2] * K[1, 1] + K[1, 2]
    S = 9 if patterns is None else patterns.shape[1]
    half = S // 2 + 1
    inb = (u >= half) & (u < width - half) & (v >= half) & (v < height - half)
    vis, u, v, inten = vis[inb], u[inb], v[inb], inten[inb]

    if patterns is None:
        patterns_sel = make_patterns(1, size=S)[np.zeros(len(vis), int)]
    else:
        patterns_sel = patterns[vis]

    iu = np.floor(u).astype(np.int32)
    iv = np.floor(v).astype(np.int32)
    fu = (u - iu).astype(np.float32)
    fv = (v - iv).astype(np.float32)

    # bilinear placement: pad pattern to (S+1, S+1) and mix 4 shifts
    P = patterns_sel * inten[:, None, None].astype(np.float32)
    padded = np.zeros((len(vis), S + 1, S + 1), np.float32)
    w00 = ((1 - fu) * (1 - fv))[:, None, None]
    w01 = (fu * (1 - fv))[:, None, None]
    w10 = ((1 - fu) * fv)[:, None, None]
    w11 = (fu * fv)[:, None, None]
    padded[:, :S, :S] += w00 * P
    padded[:, :S, 1:] += w01 * P
    padded[:, 1:, :S] += w10 * P
    padded[:, 1:, 1:] += w11 * P

    off = np.arange(S + 1)
    oy, ox = np.meshgrid(off, off, indexing="ij")
    ys = (iv[:, None, None] - S // 2 + oy[None]).reshape(-1)
    xs = (iu[:, None, None] - S // 2 + ox[None]).reshape(-1)
    np.add.at(img, (ys, xs), padded.reshape(-1))
    return np.clip(img, 0.0, 255.0)


def _vignette_map(width: int, height: int, strength: float) -> np.ndarray:
    """Radial gain map: 1 at center, (1 - strength) at the far corner."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    r2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / (cx ** 2 + cy ** 2)
    return (1.0 - strength * r2).astype(np.float32)


def _occluder_tracks(rp: RealismParams, gt: np.ndarray):
    """Per-occluder world-space motion: a base point near the trajectory
    plus sinusoidal drift — returns a callable t -> (n_occ, 3) positions."""
    rng = np.random.default_rng(rp.seed + 77)
    n = rp.n_occluders
    traj = gt[:, 4:7]
    # anchor each occluder near a trajectory sample, pushed a little
    # forward/lateral so it crosses the field of view
    idx = rng.integers(0, len(gt), size=n)
    base = traj[idx] + rng.uniform([-2.0, -1.2, 2.5], [2.0, 1.2, 6.0],
                                   size=(n, 3))
    amp = rng.uniform(0.3, 1.2, size=(n, 3))
    omega = rng.uniform(0.15, 0.6, size=(n, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(n, 3))
    inten = rng.uniform(70.0, 190.0, size=n)
    tex_phase = rng.uniform(0, 2 * np.pi, size=(n, 2))

    def at(t: float) -> np.ndarray:
        return base + amp * np.sin(omega * t + phase)

    return at, inten, tex_phase


def _render_occluders(img: np.ndarray, pts_cam: np.ndarray,
                      inten: np.ndarray, tex_phase: np.ndarray,
                      K: np.ndarray, radius: float) -> None:
    """Paint textured foreground discs over ``img`` (in place).

    Discs carry low-frequency texture so the tracker *can* latch onto them
    — the realistic failure mode dynamic objects cause (features that move
    with the object, not the world) — and they occlude background splats by
    simple overwrite (they sit closer than the splat shell)."""
    h, w = img.shape
    order = np.argsort(-pts_cam[:, 2])  # far first so near discs win
    for j in order:
        z = pts_cam[j, 2]
        if z < 0.5:
            continue
        u = pts_cam[j, 0] / z * K[0, 0] + K[0, 2]
        v = pts_cam[j, 1] / z * K[1, 1] + K[1, 2]
        # cap each disc at ~18% of frame width: dynamic objects should
        # degrade tracking locally, not black out the whole view
        rpx = min(K[0, 0] * radius / z, 0.18 * w)
        if rpx < 2 or u + rpx < 0 or u - rpx >= w or v + rpx < 0 \
                or v - rpx >= h:
            continue
        x0 = max(int(u - rpx), 0)
        x1 = min(int(u + rpx) + 1, w)
        y0 = max(int(v - rpx), 0)
        y1 = min(int(v + rpx) + 1, h)
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        mask = (xx - u) ** 2 + (yy - v) ** 2 < rpx * rpx
        tex = inten[j] + 28.0 * (
            np.sin(0.35 * xx + tex_phase[j, 0])
            * np.sin(0.31 * yy + tex_phase[j, 1]))
        region = img[y0:y1, x0:x1]
        region[mask] = tex[mask]


def _apply_photometrics(img: np.ndarray, frame_idx: int, t: float,
                        rp: RealismParams,
                        vmap: Optional[np.ndarray],
                        view: int = 0) -> np.ndarray:
    out = img
    if rp.exposure_amp or rp.bias_amp:
        w = 2 * np.pi * t / max(rp.exposure_period_s, 1e-6)
        gain = 1.0 + rp.exposure_amp * np.sin(w)
        bias = rp.bias_amp * np.sin(0.63 * w + 1.1)
        out = gain * out + bias
    if vmap is not None:
        out = out * vmap
    if rp.noise_std > 0:
        # independent read-noise realization per stereo view: a shared
        # field would correlate left/right noise and favorably bias
        # stereo matching vs a real sensor pair
        nrng = np.random.default_rng(
            rp.seed * 100003 + 2 * frame_idx + view)
        out = out + nrng.normal(0.0, rp.noise_std,
                                size=out.shape).astype(np.float32)
    return np.clip(out, 0.0, 255.0).astype(np.float32)


@dataclasses.dataclass
class SyntheticSequence:
    """A rendered sequence with exact ground truth."""

    times: np.ndarray                # (F,)
    gt_poses: np.ndarray             # (F, 7) T_wc (left cam in world)
    images_left: List[np.ndarray]
    images_right: Optional[List[np.ndarray]]
    K: np.ndarray                    # (3, 3)
    T_lr: Optional[np.ndarray]       # (7,) right-in-left extrinsic
    points: np.ndarray               # (P, 3) world landmarks
    width: int
    height: int

    @property
    def stereo(self) -> bool:
        return self.images_right is not None

    def camera_config(self) -> Tuple[CameraConfig, Optional[CameraConfig]]:
        left = CameraConfig(
            model="pinhole", width=self.width, height=self.height,
            fx=float(self.K[0, 0]), fy=float(self.K[1, 1]),
            cx=float(self.K[0, 2]), cy=float(self.K[1, 2]),
            dist=(0.0, 0.0, 0.0, 0.0),
            T_body_cam=np.eye(4))
        right = None
        if self.T_lr is not None:
            M = np.array(lie.pose_to_matrix(self.T_lr))
            right = CameraConfig(
                model="pinhole", width=self.width, height=self.height,
                fx=float(self.K[0, 0]), fy=float(self.K[1, 1]),
                cx=float(self.K[0, 2]), cy=float(self.K[1, 2]),
                dist=(0.0, 0.0, 0.0, 0.0),
                T_body_cam=M)
        return left, right

    def make_config(self, **overrides) -> SlamConfig:
        left, right = self.camera_config()
        cfg = SlamConfig(
            mono=not self.stereo, stereo=self.stereo,
            cam_left=left, cam_right=right)
        # keep the reference's feature DENSITY at reduced resolutions:
        # its protocol is nmaxdist=50 at 752 px width (160 grid cells,
        # `slam_params.cpp:107-110`); a quarter-res render with the same
        # pixel pitch would track 1/4 the features and fail turns the
        # reference survives
        cfg.max_dist = max(20, int(round(50 * self.width / 752)))
        # pixel-unit parallax gate likewise assumes the reference's 752 px
        # width (focal scales with width here): the same ANGULAR parallax
        # is half the pixels at half the resolution
        cfg.init_parallax = max(8.0, cfg.init_parallax * self.width / 752)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg.validate()


def make_trajectory(n_frames: int, kind: str = "arc",
                    speed: float = 0.04) -> np.ndarray:
    """Smooth camera trajectory (F, 7), z forward, starting at origin."""
    poses = []
    for i in range(n_frames):
        s = i * speed
        if kind == "arc":
            t = np.array([0.6 * np.sin(0.3 * s), 0.15 * np.sin(0.2 * s), s])
            yaw = 0.08 * np.sin(0.25 * s)
            pitch = 0.04 * np.sin(0.2 * s + 1.0)
            q = np.array(lie.quat_mul(
                lie.so3_exp(np.array([0.0, yaw, 0.0])),
                lie.so3_exp(np.array([pitch, 0.0, 0.0]))))
        elif kind == "forward":
            t = np.array([0.0, 0.0, s])
            q = np.array([1.0, 0, 0, 0])
        elif kind == "loop":
            # closed circular loop in xz-plane, camera looking along motion
            r = n_frames * speed / (2 * np.pi)
            a = s / r
            t = np.array([r * np.sin(a), 0.0, r * (1 - np.cos(a))])
            q = np.array(lie.so3_exp(np.array([0.0, a, 0.0])))
        elif kind == "revisit":
            # TWO laps of a closed loop: the second lap revisits every
            # viewpoint of the first — the loop-closure-rich trajectory the
            # reference exercises on EuRoC V-room sequences
            r = n_frames * speed / (4 * np.pi)
            a = s / r
            t = np.array([r * np.sin(a), 0.03 * np.sin(0.5 * a),
                          r * (1 - np.cos(a))])
            q = np.array(lie.so3_exp(np.array([0.0, a, 0.0])))
        elif kind == "revisit_y":
            # same two-lap loop with the second lap at a different height:
            # revisits the place but not the exact viewpoint (tests LC
            # geometric verification rather than frame-identity matching)
            r = n_frames * speed / (4 * np.pi)
            a = s / r
            lap = a / (2 * np.pi)
            t = np.array([r * np.sin(a), 0.25 * min(lap, 1.0),
                          r * (1 - np.cos(a))])
            q = np.array(lie.so3_exp(np.array([0.0, a, 0.0])))
        elif kind == "lawnmower":
            # survey sweeps: straight rows along +/-z joined by semicircular
            # 180-degree turns (C1-continuous, arc-length parameterized) —
            # adjacent rows see the same structure from opposite headings,
            # the covisibility pattern the reference hits on KITTI streets
            n_rows = 4
            period = n_frames * speed / n_rows   # arc length per row+turn
            turn_r = min(0.5, 0.15 * period)     # turn radius
            row_len = period - np.pi * turn_r    # straight-segment length
            row = int(s // period)
            u = s - row * period
            x0 = 2.0 * turn_r * row              # row lateral offset
            if row % 2 == 0:                     # heading +z
                if u < row_len:
                    t = np.array([x0, 0.0, u])
                    yaw = 0.0
                else:                            # left turn at z = row_len
                    phi = (u - row_len) / turn_r
                    t = np.array([x0 + turn_r * (1 - np.cos(phi)), 0.0,
                                  row_len + turn_r * np.sin(phi)])
                    yaw = phi
            else:                                # heading -z
                if u < row_len:
                    t = np.array([x0, 0.0, row_len - u])
                    yaw = np.pi
                else:                            # right turn at z = 0
                    phi = (u - row_len) / turn_r
                    t = np.array([x0 + turn_r * (1 - np.cos(phi)), 0.0,
                                  -turn_r * np.sin(phi)])
                    yaw = np.pi - phi
            t[1] = 0.06 * np.sin(0.5 * s)        # gentle altitude bob
            q = np.array(lie.so3_exp(np.array([0.0, yaw, 0.0])))
        else:
            raise ValueError(kind)
        poses.append(np.concatenate([q, t]))
    return np.stack(poses).astype(np.float64)


class _SceneRenderer:
    """Shared world state + per-frame rendering for eager and streaming
    sequence generation. Holds the landmark field, stereo extrinsic, and
    (optionally) realism state — vignette map, occluder tracks."""

    def __init__(self, n_frames: int, stereo: bool, width: int, height: int,
                 n_points: int, seed: int, kind: str, speed: float,
                 baseline: float, fps: float,
                 realism: Optional[RealismParams]):
        rng = np.random.default_rng(seed)
        self.width, self.height = width, height
        # EuRoC-like FOV at ANY resolution: focal scales with width
        # (fx=458 @ 752 px). A fixed focal at reduced resolution would
        # halve the field of view and cripple the geometry conditioning.
        f = 458.0 * width / 752.0
        self.K = np.array([[f, 0.0, width / 2],
                           [0.0, f, height / 2],
                           [0.0, 0.0, 1.0]])
        self.gt = make_trajectory(n_frames, kind=kind, speed=speed)
        self.times = np.arange(n_frames) / fps
        self.stereo = stereo
        self.realism = realism

        # landmarks in a thick shell around the whole trajectory. The
        # padding must be deep in EVERY direction the camera can face:
        # trajectories with heading reversals (lawnmower, revisit) look
        # backwards along -z and outwards along ±x at row ends, and a
        # shallow scene there leaves the view nearly empty — the detector
        # then fills cells with sensor-noise corners and the map poisons
        # itself with noise-triangulated landmarks.
        traj_span = self.gt[:, 4:7]
        lo = traj_span.min(0) - np.array([10.0, 5.0, 10.0])
        hi = traj_span.max(0) + np.array([10.0, 5.0, 10.0])
        self.points = rng.uniform(lo, hi, size=(n_points, 3))
        self.inten = rng.uniform(60.0, 200.0, size=n_points)
        self.patterns = make_patterns(n_points, seed=seed + 1)

        self.T_lr = None
        if stereo:
            self.T_lr = np.concatenate(
                [[1.0, 0, 0, 0], [baseline, 0.0, 0.0]]).astype(np.float64)
            self._M_rl = np.array(
                lie.pose_to_matrix(lie.pose_inverse(self.T_lr)))

        self._vmap = None
        self._occ_at = None
        if realism is not None:
            if realism.vignette > 0:
                self._vmap = _vignette_map(width, height, realism.vignette)
            if realism.n_occluders > 0:
                self._occ_at, self._occ_inten, self._occ_tex = \
                    _occluder_tracks(realism, self.gt)

    def _render_view(self, i: int, t: float, M_cw: np.ndarray,
                     view: int = 0) -> np.ndarray:
        pc = (M_cw[:3, :3] @ self.points.T).T + M_cw[:3, 3]
        img = render_splats(pc, self.inten, self.K, self.width, self.height,
                            patterns=self.patterns)
        rp = self.realism
        if rp is not None:
            if self._occ_at is not None:
                occ_w = self._occ_at(t)
                occ_c = (M_cw[:3, :3] @ occ_w.T).T + M_cw[:3, 3]
                _render_occluders(img, occ_c, self._occ_inten, self._occ_tex,
                                  self.K, rp.occluder_radius)
            img = _apply_photometrics(img, i, t, rp, self._vmap, view)
        return img

    def render_frame(self, i: int) -> Tuple[np.ndarray,
                                            Optional[np.ndarray]]:
        """Render frame ``i`` -> (left, right-or-None), each (H, W) f32."""
        t = float(self.times[i])
        M_cw = np.array(lie.pose_to_matrix(lie.pose_inverse(self.gt[i])))
        left = self._render_view(i, t, M_cw)
        right = None
        if self.stereo:
            right = self._render_view(i, t, self._M_rl @ M_cw, view=1)
        return left, right


@dataclasses.dataclass
class SyntheticStream:
    """Lazily-rendered sequence: frames are generated one at a time, so
    1,000–2,000-frame 752x480 validation runs (the scale of EuRoC MH
    sequences the reference replays, `benchmark_scripts/euroc_bench.sh`)
    don't need the whole image stack in memory (~1.4 GB/1k stereo frames).

    Quacks like :class:`SyntheticSequence` for config/gt purposes and
    iterates as ``(left, right, t)`` tuples, the ``run_sequence`` frame
    protocol."""

    _renderer: _SceneRenderer

    @property
    def times(self) -> np.ndarray:
        return self._renderer.times

    @property
    def gt_poses(self) -> np.ndarray:
        return self._renderer.gt

    @property
    def K(self) -> np.ndarray:
        return self._renderer.K

    @property
    def T_lr(self) -> Optional[np.ndarray]:
        return self._renderer.T_lr

    @property
    def points(self) -> np.ndarray:
        return self._renderer.points

    @property
    def width(self) -> int:
        return self._renderer.width

    @property
    def height(self) -> int:
        return self._renderer.height

    @property
    def stereo(self) -> bool:
        return self._renderer.stereo

    def __len__(self) -> int:
        return len(self._renderer.times)

    def __iter__(self):
        for i in range(len(self)):
            left, right = self._renderer.render_frame(i)
            yield left, right, float(self._renderer.times[i])

    def frame(self, i: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        return self._renderer.render_frame(i)

    camera_config = SyntheticSequence.camera_config
    make_config = SyntheticSequence.make_config


def stream_sequence(
    n_frames: int = 1000,
    stereo: bool = True,
    width: int = 752,
    height: int = 480,
    n_points: int = 6000,
    seed: int = 0,
    kind: str = "arc",
    speed: float = 0.04,
    baseline: float = 0.11,
    fps: float = 20.0,
    realism: Optional[RealismParams] = DEFAULT_REALISM,
) -> SyntheticStream:
    """Long-sequence generator with photometric realism ON by default —
    the validation tier standing in for EuRoC replay (VERDICT r1 item 1)."""
    return SyntheticStream(_SceneRenderer(
        n_frames, stereo, width, height, n_points, seed, kind, speed,
        baseline, fps, realism))


def generate_sequence(
    n_frames: int = 30,
    stereo: bool = True,
    width: int = 752,
    height: int = 480,
    n_points: int = 6000,
    seed: int = 0,
    kind: str = "arc",
    speed: float = 0.04,
    baseline: float = 0.11,
    fps: float = 20.0,
    realism: Optional[RealismParams] = None,
) -> SyntheticSequence:
    r = _SceneRenderer(n_frames, stereo, width, height, n_points, seed,
                       kind, speed, baseline, fps, realism)
    imgs_l, imgs_r = [], [] if stereo else None
    for i in range(n_frames):
        left, right = r.render_frame(i)
        imgs_l.append(left)
        if stereo:
            imgs_r.append(right)

    return SyntheticSequence(
        times=r.times,
        gt_poses=r.gt,
        images_left=imgs_l,
        images_right=imgs_r,
        K=r.K, T_lr=r.T_lr, points=r.points, width=width, height=height)
