"""The benchmark's cells at sizes a CPU test run holds: the same files, the
sizes cut, every other key as committed."""

from benchmark import common


def fuse_cell() -> dict:
    cell = common.workload("carla_rig.fuse")
    cfg = cell["config_file"]
    cfg["rig"].update(width=80, height=60, steps=4)
    cfg["grid"].update(dims=[48, 48, 12], voxel=1.25,
                       origin=[-30.0, -30.0, -0.5])
    cell["traffic"]["trace_seconds"] = 0.5
    cell["check"]["voxels"] = 8192
    return cell


def fleet_cell(sessions: int = 1) -> dict:
    cell = common.workload("euroc_stereo.fleet")
    cell["config_file"]["sequence"].update(width=376, height=240,
                                           n_frames=80, n_points=1700)
    cell["traffic"].update(sessions=sessions, warmup_frames=30,
                           sample_within=12, samples_per_session=2,
                           trace_seconds=1.0)
    cell["check"]["ate_segment_frames"] = 5
    return cell
