"""A loop-closure candidate's processing (the program's ``Profiler`` scope
``4.LC_ProcessCandidate``: verification, and on a closure the pose graph),
mean host ms a candidate, pooled over the sessions, over the window after
the trace closed; nothing where no candidate came."""


def read(obs):
    s = (obs.get("scopes") or {}).get("4.LC_ProcessCandidate")
    return s["mean_ms"] if s else None
