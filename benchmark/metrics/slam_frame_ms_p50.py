"""The median latency (ms) of ``SlamManager.process_frame`` over every
frame of every session that ended in the window after the trace closed,
pooled."""

from benchmark import common


def read(obs):
    ms = obs.get("frame_ms") or []
    return common.quantile(ms, 0.5) if ms else None
