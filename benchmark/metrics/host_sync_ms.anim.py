"""Milliseconds an animation frame the host blocked in CUDA calls that wait
for the device (stream, event and device synchronisation, and copies),
over the traced animation frames."""

from benchmark.metrics import host_sync_ms


def read(trace):
    return host_sync_ms(trace)
