"""Per-layer metrics: one reader a metric, ``<name>.py`` in this folder,
found by the metric's name in ``BENCHMARK.json``.

A reader is a module with ``read(trace) -> float | None`` over the traced
sub-window (:class:`benchmark.trace.Trace`). It returns None when the trace
holds nothing for it to read, and the harness then leaves the metric out of
the line. The helpers below are what the readers here share.
"""

from __future__ import annotations

from typing import Optional

from benchmark.peaks import F32_FLOPS
from benchmark.trace import HOST_SYNCS
from benchmark.workcount import per_ray_step


def roofline_share(trace, kernels, exclude, ops_key: str) -> Optional[float]:
    """A kernel's share of its roofline, in %: the least time the card could
    take for the operations these inputs need (the reference's ray-steps of
    exactly the profiled frames or steps, times ``per_ray_step()[ops_key]``,
    over the float32 peak), over the kernel's summed device time. The march
    is bound by operations (it reads and writes a few dozen bytes a ray for
    hundreds of steps), so the bytes' bound is not the larger."""
    seconds = trace.kernel_seconds(kernels, exclude)
    steps = trace.extra.get("ray_steps")
    if not seconds or not steps:
        return None
    return 100.0 * steps * per_ray_step()[ops_key] / F32_FLOPS / seconds


def idle_share(trace) -> Optional[float]:
    """The device's idle share of the window, in %."""
    if trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def host_sync_ms(trace) -> Optional[float]:
    """Milliseconds a unit the host spent in calls that wait for the device."""
    if not trace.units:
        return None
    return 1e3 * trace.host_seconds(HOST_SYNCS) / trace.units
