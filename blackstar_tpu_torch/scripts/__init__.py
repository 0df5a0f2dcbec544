"""Measurement scripts of the port, each run as ``python -m
blackstar_tpu_torch.scripts.<name>``. Importing one runs and builds
nothing."""

import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn()`` over ``reps`` warm
    calls, from CUDA events (each call launched from the host)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn()`` at the device's steady
    state: ``reps`` calls captured as one CUDA graph, replayed once warm and
    then ``replays`` times between CUDA events. No host launch sits between
    two calls, so this is the device's time per call, the counterpart of a
    jitted loop on a TPU. ``fn`` must not wait for the card; tensors it
    allocates come from the graph's own pool, which is freed with it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)
