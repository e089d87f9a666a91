"""Speed/accuracy profiles.

The reference ships three curated profiles per dataset
(`parameters_files/{fast,average,accurate}/...`); their deltas (survey §5:
detector type, CLAHE, loop closure, keypoint density, P3P usage, KF
filtering ratio) are applied here programmatically so any base config —
a loaded reference YAML or a synthetic one — can be switched between
profiles without duplicating files.
"""

from __future__ import annotations

from .config import SlamConfig


def apply_profile(cfg: SlamConfig, profile: str) -> SlamConfig:
    """Mutates and returns cfg with the named profile's settings."""
    if profile == "fast":
        # `parameters_files/fast/euroc/euroc_stereo.yaml`
        cfg.use_fast = True
        cfg.use_singlescale_detector = False
        cfg.use_shi_tomasi = False
        cfg.max_dist = 50
        cfg.use_clahe = False
        cfg.use_loop_closer = False
        cfg.do_p3p = True
        cfg.kf_filtering_ratio = 0.9
        cfg.force_realtime = True
    elif profile == "average":
        # `parameters_files/average/...`: gftt detector, CLAHE off, LC on
        cfg.use_fast = False
        cfg.use_singlescale_detector = False
        cfg.use_shi_tomasi = True
        cfg.max_dist = 45
        cfg.use_clahe = False
        cfg.use_loop_closer = True
        cfg.do_p3p = True
        cfg.kf_filtering_ratio = 0.92
    elif profile == "accurate":
        # `parameters_files/accurate/euroc/euroc_stereo.yaml`
        cfg.use_fast = False
        cfg.use_singlescale_detector = True
        cfg.use_shi_tomasi = False
        cfg.max_dist = 35
        cfg.use_clahe = True
        cfg.use_loop_closer = True
        cfg.do_p3p = False
        cfg.kf_filtering_ratio = 0.95
        cfg.force_realtime = False
    else:
        raise ValueError(f"unknown profile {profile!r} "
                         "(expected fast|average|accurate)")
    return cfg
