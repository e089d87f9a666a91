"""The front end's dispatch of a frame (the program's ``Profiler`` scope
``0.FE_dispatch``: upload, CLAHE, pyramid, KLT, the tracks' tail, RANSAC
and PnP launched), mean host ms a frame, pooled over the sessions, over
the window after the trace closed."""


def read(obs):
    s = (obs.get("scopes") or {}).get("0.FE_dispatch")
    return s["mean_ms"] if s else None
