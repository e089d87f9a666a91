"""The share of the fleet's traced window, in %, in which no device
operation of any session's process ran (their busy intervals merged on
one clock)."""

from benchmark import common


def read(obs):
    return common.idle_share(obs.get("trace"))
