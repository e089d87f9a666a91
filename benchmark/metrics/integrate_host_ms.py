"""Host ms from a ``TsdfVolume.integrate`` call to its return (the pose's
inverse, the launch's checks and packing, the ctypes launch), averaged
over every call the traced run made after its trace closed: the calls are
timed one by one, and their sum spans seconds."""


def read(obs):
    ms = (obs.get("host_ms") or {}).get("integrate") or []
    return sum(ms) / len(ms) if ms else None
