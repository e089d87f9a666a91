"""Device kernels a SLAM frame: every kernel that started in the traced
window, of every session's process, over the frames the sessions
processed while traced."""


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr.get("frames") or not tr["kernels"]:
        return None
    return len(tr["kernels"]) / tr["frames"]
