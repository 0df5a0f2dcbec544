"""Measurement scripts of the port, each run as ``python -m
blackstar_tpu_torch.scripts.<name>``. Importing one runs and builds
nothing."""

import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn()`` over ``reps`` warm
    calls, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
