"""The device's idle share of the traced frames, in %: 1 − the seconds in
which some operation ran on the device over the window's length."""

from benchmark.metrics import idle_share


def read(trace):
    return idle_share(trace)
