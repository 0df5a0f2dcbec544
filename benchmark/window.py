"""Whole-window arithmetic of the end-to-end metrics.

A window runs whole units (frames, fit jobs, animation passes) until the
run's seconds have passed, so its length is the host clock from its start
to the end of its last unit. A time per unit is that length over the units
delivered in it: never a median of chunks. A percentile is of every unit's
latency in the window.
"""

from __future__ import annotations

import math
import random
from typing import Sequence


def per_unit_ms(start: float, end: float, units: int) -> float:
    """Milliseconds per unit of a window from ``start`` to ``end`` (seconds)."""
    if units <= 0:
        raise ValueError("a window delivered no unit")
    return 1e3 * (end - start) / units


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0..1) of ``values``, linear between the two
    nearest order statistics."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    x = q * (len(s) - 1)
    lo = math.floor(x)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (x - lo) * (s[hi] - s[lo])


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``seed`` (Algorithm R). ``offer(i, make)`` calls ``make()`` only
    for an item it keeps, so items that are dropped cost nothing."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []  # (index, item)
        self.seen = 0

    def offer(self, index, make):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((index, make()))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (index, make())
