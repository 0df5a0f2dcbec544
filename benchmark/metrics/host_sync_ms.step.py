"""Milliseconds a step the host blocked in CUDA calls that wait for the
device (stream, event and device synchronisation, and copies: a copy to
pageable host memory blocks inside cudaMemcpyAsync), over the traced steps."""

from benchmark.metrics import host_sync_ms


def read(trace):
    return host_sync_ms(trace)
