"""The traced sub-window: torch.profiler over a few steady units.

:func:`profiled` runs a callable under ``torch.profiler`` (CPU and CUDA
activities) inside a ``bench.window`` span of the benchmark's own, and
returns a :class:`Trace`: the device's operations (kernels, copies, sets)
and the host's events on one timeline, clipped to the span. Per-layer
metrics (``benchmark/metrics/``) read it; the harness adds the device's
busy seconds, the window's length and the breakdown to the result line.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
# Host calls that block until the device has done something: the
# synchronising calls, and the copies (a copy to pageable host memory
# blocks inside cudaMemcpyAsync).
HOST_SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync")


@dataclass
class Trace:
    window: Tuple[float, float]  # the span's start and end, microseconds
    device_ops: List[Tuple[str, float, float]]  # (name, start, end) us
    host_ops: List[Tuple[str, float, float]]  # (name, start, end) us
    units: int  # frames or steps the window ran
    extra: Dict[str, float] = field(default_factory=dict)  # counted afterwards (ray_steps)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _intervals(self):
        w0, w1 = self.window
        return sorted((max(s, w0), min(e, w1)) for _, s, e in self.device_ops if e > w0 and s < w1)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the operations' intervals within the window)."""
        total, cur_s, cur_e = 0.0, None, None
        for s, e in self._intervals():
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def kernel_seconds(self, parts, exclude=()) -> float:
        """Summed device seconds of the operations whose name holds one of
        ``parts`` and none of ``exclude``."""
        return 1e-6 * sum(e - s for n, s, e in self.device_ops
                          if any(p in n for p in parts) and not any(x in n for x in exclude))

    def host_seconds(self, names) -> float:
        """Summed seconds of the host events named exactly one of ``names``."""
        return 1e-6 * sum(e - s for n, s, e in self.host_ops if n in names)

    def device_op_table(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for n, s, e in self.device_ops:
            by[n] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gap_table(self, top: int = 10) -> List[list]:
        """The device's idle time in the window, by the innermost host event
        under way at the middle of each gap."""
        w0, w1 = self.window
        gaps, last = [], w0
        for s, e in self._intervals():
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if w1 > last:
            gaps.append((last, w1))
        # Sweep the gaps by their middles; a max-heap by start holds the host
        # events begun so far, and the innermost one under way is its top once
        # the events that ended before the middle are popped.
        host = sorted((s, e, n) for n, s, e in self.host_ops if n != WINDOW_SPAN)
        heap, k = [], 0
        by = defaultdict(float)
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (s + e)
            while k < len(host) and host[k][0] <= mid:
                heapq.heappush(heap, (-host[k][0], host[k][1], host[k][2]))
                k += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            by[heap[0][2] if heap else "(no host event)"] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def profiled(fn, units: int, device) -> Tuple[Trace, Optional[object]]:
    """Run ``fn()`` under torch.profiler inside the window span; returns the
    Trace and ``fn``'s result. ``units`` is how many frames or steps
    ``fn`` runs on ``device`` (the CPU only in tests)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device.type == "cuda"
    sync = (lambda: __import__("torch").cuda.synchronize(device)) if on_card else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            out = fn()
            sync()
    dev, host, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.name, s, t))
        else:
            host.append((e.name, s, t))
            if e.name == WINDOW_SPAN:
                window = (s, t)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(window=window, device_ops=dev, host_ops=host, units=units), out
