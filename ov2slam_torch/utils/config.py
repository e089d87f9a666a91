"""SLAM configuration — the TPU-native equivalent of the reference's
``SlamParams`` (`include/slam_params.hpp:44-163`, `src/slam_params.cpp:29-174`).

Key differences from the reference:
- A frozen-ish dataclass instead of a mutable global; *run state* flags that
  the reference stuffed into SlamParams (``blocalba_is_on_``, ``bvision_init_``,
  ``breset_req_`` — `slam_params.hpp:59-63`) live in the pipeline state
  objects instead.
- Derived static capacities (max keypoints per frame, grid dims) are computed
  once here (mirroring `slam_params.cpp:107-110`) and become the *static
  shapes* of every jitted computation.
- The YAML loader accepts the reference's OpenCV-style YAML files verbatim
  (``%YAML 1.0`` header, ``!!opencv-matrix`` tags), so all of
  ``parameters_files/{fast,average,accurate}/...`` work unchanged.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

import numpy as np
import yaml


def _opencv_matrix_constructor(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    data = np.array(mapping["data"], dtype=np.float64)
    return data.reshape(mapping["rows"], mapping["cols"])


class _OpenCVYamlLoader(yaml.SafeLoader):
    pass


_OpenCVYamlLoader.add_constructor(
    "tag:yaml.org,2002:opencv-matrix", _opencv_matrix_constructor
)
# OpenCV writes bare `!!opencv-matrix` which resolves to the tag above already;
# some files use the explicit local form.
_OpenCVYamlLoader.add_constructor("!opencv-matrix", _opencv_matrix_constructor)


def load_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV FileStorage YAML file into a plain dict."""
    with open(path, "r") as f:
        text = f.read()
    # Strip the OpenCV `%YAML 1.0` directive + `---` which PyYAML rejects
    # (it only accepts YAML 1.1/1.2 directives).
    text = re.sub(r"^%YAML[^\n]*\n", "", text)
    return yaml.load(text, Loader=_OpenCVYamlLoader) or {}


@dataclasses.dataclass
class CameraConfig:
    """Per-camera intrinsics/extrinsics (reference: `slam_params.hpp:77-99`)."""

    model: str = "pinhole"  # "pinhole" | "fisheye"
    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    # radtan: [k1 k2 p1 p2]; fisheye(kannala-brandt-4): [k1 k2 k3 k4]
    dist: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    # body-from-camera extrinsic, 4x4 row-major (reference `body_T_cam{0,1}`)
    T_body_cam: Optional[np.ndarray] = None


@dataclasses.dataclass
class SlamConfig:
    """All run parameters. Field names follow the reference YAML keys
    (`src/slam_params.cpp:29-167`) with the Hungarian prefixes dropped."""

    # --- mode -------------------------------------------------------------
    mono: bool = True
    stereo: bool = False
    slam_mode: bool = True          # vs pure VO (reference `slam_mode`)
    force_realtime: bool = False
    debug: bool = False
    log_timings: bool = False
    use_loop_closer: bool = False   # `buse_loop_closer`
    # beyond-reference: map-preserving relocalization after tracking loss
    # (requires the loop closer's place index); falls back to the
    # reference's reset when off or unsuccessful
    use_relocalizer: bool = True
    # pipelined front-end: the per-frame device readback resolves one
    # frame late, overlapped with the next dispatch (the throughput mode;
    # per-frame results lag by one frame — see SlamManager.process_frame)
    pipelined_frontend: bool = False
    # frames in flight when pipelined: 1 = host-packed lag-1; >=2 = the
    # device-chained recurrence (state never returns to host between
    # frames; readbacks trail by `depth` frames and never block)
    pipeline_depth: int = 2
    # async mode: max seconds the arrival thread blocks when the worker
    # owes mapping for >1 keyframe. Offline (unpaced) feeding wants a
    # long wait (bounded-memory absorb, like the reference's growing
    # input queue without force_realtime); a real-time paced source
    # should keep it ~1 frame interval and let the INPUT drop frames
    # instead (`force_realtime`, `ov2slam.cpp:292-299`)
    backpressure_wait_s: float = 10.0

    # --- cameras ----------------------------------------------------------
    cam_left: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    cam_right: Optional[CameraConfig] = None
    do_stereo_rect: bool = False    # `bdo_stereo_rect`
    alpha: float = 0.0
    do_undist: bool = False         # `bdo_undist`

    # --- feature extraction ----------------------------------------------
    use_shi_tomasi: bool = False
    use_fast: bool = True
    use_brief: bool = True
    use_singlescale_detector: bool = False
    max_dist: int = 50              # `nmaxdist` px — 1 kp per cell of this size
    fast_th: int = 10               # `nfast_th`
    max_quality: float = 0.001      # `dmaxquality`

    # --- preprocessing ----------------------------------------------------
    use_clahe: bool = False
    clahe_val: float = 3.0

    # --- KLT ---------------------------------------------------------------
    do_klt: bool = True
    klt_use_prior: bool = True
    track_keyframetoframe: bool = False
    klt_win_size: int = 9           # `nklt_win_size`
    klt_pyr_lvl: int = 3            # `nklt_pyr_lvl` (levels above base)
    max_iter: int = 30              # `nmax_iter`
    max_px_precision: float = 0.01  # `fmax_px_precision`
    max_fbklt_dist: float = 0.5     # forward-backward check threshold
    klt_err: float = 30.0           # min-eigenvalue/error gate (`nklt_err`)
    # 3D/2D split tracking (`visual_front_end.cpp:187-271`): 3D kps with a
    # projected prior run the BASE level only; 2D kps and prior failures
    # get the full pyramid, compacted into a half-capacity batch
    # (ops/klt.fb_klt_track_split). DEFAULT OFF: measured on TPU v5e the
    # fused step is epipolar-RANSAC-dominated (KLT 1.9 ms of 4.9 ms), so
    # the split's level-loop savings buy ~0 fps, while base-level-only
    # tracking of 3D kps costs accuracy on rotation-heavy sequences
    # (loop endpoint err 0.06 -> 0.18 m) — the reference's motivation
    # (halving CPU level-loop work, a real win single-kp-at-a-time)
    # doesn't transfer to batched fixed-shape dispatch.
    klt_3d2d_split: bool = False
    klt_split_frac: float = 0.5     # pyramid-batch capacity / max_kps

    # --- matching ----------------------------------------------------------
    do_track_localmap: bool = True
    max_desc_dist: float = 0.2      # fraction of descriptor bits
    max_proj_pxdist: float = 2.0

    # --- geometric filtering / RANSAC --------------------------------------
    do_epipolar: bool = True
    do_p3p: bool = True
    do_random: bool = True          # `bdo_random`
    ransac_iter: int = 100
    ransac_err: float = 3.0
    init_parallax: float = 20.0     # `finit_parallax` px

    # --- BA / solver --------------------------------------------------------
    max_reproj_err: float = 3.0
    use_inv_depth: bool = True
    robust_mono_th: float = 5.9915
    use_sparse_schur: bool = True
    use_dogleg: bool = False
    use_subspace_dogleg: bool = False
    use_nonmonotic_step: bool = False
    apply_l2_after_robust: bool = True
    min_cov_score: int = 25         # `nmin_covscore`
    kf_filtering_ratio: float = 0.9
    do_full_ba: bool = False

    # --- loop closure (index params mirror `lcdetector.h:42-60`) ----------
    lc_recent_mask: int = 30        # exclude latest-KF window (ref p=100 imgs)
    # skip new closures for this many KFs after a successful one
    lc_cooldown_kfs: int = 5
    # while lost, space relocalization attempts at least this far
    # apart in wall time (attempts are multi-dispatch and run on the
    # arrival thread; a paced source must not drown in them)
    reloc_min_interval_s: float = 0.25
    lc_min_score: float = 0.25
    lc_match_bits: int = 48
    lc_island_radius: int = 3

    # --- TPU-native capacities (static shapes; no reference equivalent —
    # the reference allocates dynamically, we size arrays once) -------------
    max_kps_factor: float = 1.25    # slack over the grid-derived kp budget
    max_keyframes: int = 2048       # map capacity
    max_landmarks: int = 65536
    local_ba_max_kfs: int = 32      # local BA window capacity
    local_ba_max_obs: int = 8192
    ba_iters: int = 5               # LM iterations (ref: 5 it, `optimizer.cpp:460`)
    pnp_iters: int = 10             # motion-only PnP LM iterations
    posegraph_iters: int = 10       # `optimizer.cpp:2445`
    full_posegraph_iters: int = 100 # `optimizer.cpp:2824`

    # ------------------------------------------------------------------ #
    @property
    def grid_cells(self) -> Tuple[int, int]:
        """Occupancy-grid dims (cells_y, cells_x); `slam_params.cpp:107-110`."""
        w, h = self.cam_left.width, self.cam_left.height
        return (math.ceil(h / self.max_dist), math.ceil(w / self.max_dist))

    @property
    def max_kps(self) -> int:
        """Static per-frame keypoint capacity = #grid cells (one kp/cell),
        padded up for alignment. Mirrors `nbmaxkps_` (`slam_params.cpp:110`)."""
        gy, gx = self.grid_cells
        n = int(math.ceil(gy * gx * self.max_kps_factor))
        return ((n + 127) // 128) * 128  # lane-align for TPU kernels

    @property
    def klt_levels(self) -> int:
        """Total pyramid levels = nklt_pyr_lvl + 1 (base)."""
        return self.klt_pyr_lvl + 1

    @property
    def klt_split_sub(self) -> int:
        """Static pyramid-subset capacity for the 3D/2D split tracker
        (0 = split disabled); lane-aligned like max_kps."""
        if not self.klt_3d2d_split:
            return 0
        n = int(math.ceil(self.max_kps * self.klt_split_frac))
        return min(self.max_kps, ((n + 127) // 128) * 128)

    def validate(self) -> "SlamConfig":
        if self.stereo and self.cam_right is None:
            raise ValueError("stereo mode requires cam_right")
        if self.mono == self.stereo:
            raise ValueError("exactly one of mono/stereo must be set")
        return self


_CAM_KEYS = {
    "model": "Camera.model_{s}",
    "width": "Camera.{s}_nwidth",
    "height": "Camera.{s}_nheight",
}

# reference key -> (our field, type)
_PARAM_MAP = {
    "debug": ("debug", bool),
    "log_timings": ("log_timings", bool),
    "mono": ("mono", bool),
    "stereo": ("stereo", bool),
    "force_realtime": ("force_realtime", bool),
    "slam_mode": ("slam_mode", bool),
    "buse_loop_closer": ("use_loop_closer", bool),
    "bdo_stereo_rect": ("do_stereo_rect", bool),
    "alpha": ("alpha", float),
    "bdo_undist": ("do_undist", bool),
    "finit_parallax": ("init_parallax", float),
    "use_shi_tomasi": ("use_shi_tomasi", bool),
    "use_fast": ("use_fast", bool),
    "use_brief": ("use_brief", bool),
    "use_singlescale_detector": ("use_singlescale_detector", bool),
    "nmaxdist": ("max_dist", int),
    "nfast_th": ("fast_th", int),
    "dmaxquality": ("max_quality", float),
    "use_clahe": ("use_clahe", bool),
    "fclahe_val": ("clahe_val", float),
    "do_klt": ("do_klt", bool),
    "klt_use_prior": ("klt_use_prior", bool),
    "btrack_keyframetoframe": ("track_keyframetoframe", bool),
    "nklt_win_size": ("klt_win_size", int),
    "nklt_pyr_lvl": ("klt_pyr_lvl", int),
    "nmax_iter": ("max_iter", int),
    "fmax_px_precision": ("max_px_precision", float),
    "fmax_fbklt_dist": ("max_fbklt_dist", float),
    "nklt_err": ("klt_err", float),
    "bdo_track_localmap": ("do_track_localmap", bool),
    "fmax_desc_dist": ("max_desc_dist", float),
    "fmax_proj_pxdist": ("max_proj_pxdist", float),
    "doepipolar": ("do_epipolar", bool),
    "dop3p": ("do_p3p", bool),
    "bdo_random": ("do_random", bool),
    "nransac_iter": ("ransac_iter", int),
    "fransac_err": ("ransac_err", float),
    "fmax_reproj_err": ("max_reproj_err", float),
    "buse_inv_depth": ("use_inv_depth", bool),
    "robust_mono_th": ("robust_mono_th", float),
    "use_sparse_schur": ("use_sparse_schur", bool),
    "use_dogleg": ("use_dogleg", bool),
    "use_subspace_dogleg": ("use_subspace_dogleg", bool),
    "use_nonmonotic_step": ("use_nonmonotic_step", bool),
    "apply_l2_after_robust": ("apply_l2_after_robust", bool),
    "nmin_covscore": ("min_cov_score", int),
    "fkf_filtering_ratio": ("kf_filtering_ratio", float),
    "do_full_ba": ("do_full_ba", bool),
}


def _load_camera(d: dict, side: str) -> CameraConfig:
    s = "left" if side == "l" else "right"
    cam = CameraConfig(
        model=str(d.get(f"Camera.model_{s}", "pinhole")),
        width=int(d.get(f"Camera.{s}_nwidth", 752)),
        height=int(d.get(f"Camera.{s}_nheight", 480)),
        fx=float(d.get(f"Camera.fx{side}", 458.654)),
        fy=float(d.get(f"Camera.fy{side}", 457.296)),
        cx=float(d.get(f"Camera.cx{side}", 367.215)),
        cy=float(d.get(f"Camera.cy{side}", 248.375)),
        dist=(
            float(d.get(f"Camera.k1{side}", 0.0)),
            float(d.get(f"Camera.k2{side}", 0.0)),
            float(d.get(f"Camera.p1{side}", 0.0)),
            float(d.get(f"Camera.p2{side}", 0.0)),
        ),
    )
    key = "body_T_cam0" if side == "l" else "body_T_cam1"
    if key in d:
        cam.T_body_cam = np.asarray(d[key], dtype=np.float64).reshape(4, 4)
    return cam


# keys that are parsed but whose non-default values are NOT honored by
# this implementation (see PARITY.md "Known gaps"): loading a config that
# sets one away from the value whose behavior we implement warns once.
# value = (the behavior we implement, explanation)
_UNHONORED = {
    "do_klt": (True, "KLT tracking is the only front-end tracker"),
    "bdo_random": (
        True, "RANSAC uses counter-based PRNG keys; runs are "
        "reproducible per-seed regardless of this flag"),
    "use_brief": (True, "BRIEF description is always on"),
    "use_dogleg": (False, "the trust region is LM accept/reject damping"),
    "use_subspace_dogleg": (False, "see use_dogleg"),
    "use_nonmonotic_step": (False, "LM steps are strictly monotone"),
    "use_sparse_schur": (
        True, "the Schur path is dense on-chip for local windows and "
        "matrix-free PCG at fullBA scale; this flag does not switch it"),
}
_warned_keys: set = set()


def load_config(path: str) -> SlamConfig:
    """Load a reference-format parameter YAML into a SlamConfig."""
    import warnings

    d = load_opencv_yaml(path)
    cfg = SlamConfig()
    for ref_key, (field, typ) in _PARAM_MAP.items():
        if ref_key in d:
            setattr(cfg, field, typ(d[ref_key]))
    for key, (implemented, why) in _UNHONORED.items():
        if key in d and bool(int(d[key])) != implemented \
                and key not in _warned_keys:
            _warned_keys.add(key)
            warnings.warn(
                f"config key '{key}={d[key]}' is parsed but not honored: "
                f"{why}", stacklevel=2)
    cfg.cam_left = _load_camera(d, "l")
    if cfg.stereo:
        cfg.cam_right = _load_camera(d, "r")
    return cfg.validate()
