"""A keyframe's local bundle adjustment (the program's ``Profiler`` scope
``3.LocalBA``), mean host ms a solve, pooled over the sessions, over the
window after the trace closed; nothing where no keyframe was solved."""


def read(obs):
    s = (obs.get("scopes") or {}).get("3.LocalBA")
    return s["mean_ms"] if s else None
