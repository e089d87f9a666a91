"""The share of the fusion cell's traced window, in %, in which no device
operation ran (kernels, copies and sets; one process)."""

from benchmark import common


def read(obs):
    return common.idle_share(obs.get("trace"))
