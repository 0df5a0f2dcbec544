"""Stills, as users render them: one client, one frame at a time.

Each frame is ``render.render_image(cfg, grid, device=...)``: camera rays,
the march (B1), the stars (B3), the composite, bloom, and the float image
copied to the host. Its camera is the scene's, rotated about the y axis by
an angle the seed draws, uniform in [0°, 360°): the sky moves, the hole and
the disk do not, so every frame marches the same number of steps.

Traffic parameters: ``check_frames`` (the frames of a run the reference
checks, drawn from the seed), ``trace_frames`` (the frames under the
profiler in a traced run), ``warm_seconds`` (the warm-up's least length).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.runners import common
from benchmark.reference.render import srgb8
from benchmark.reference.scene import camera_dict, rotate_y, scene_file, with_camera
from benchmark.trace import profiled
from benchmark.window import Reservoir, per_unit_ms, percentile

WARM_ANGLES = (0.0, 180.0)  # the same warm-up for every seed


class Session:
    def __init__(self, cell, seed: int, device, size=None, stars=None, trace_units=None):
        self.cell, self.device, self.stars = cell, device, stars
        self.trace_units = int(trace_units or cell.traffic["trace_frames"])
        self.contents = common.contents(cell, size)
        self.scene = scene_file(self.contents)
        self.grid = common.program_grid(cell, device, stars)
        self.rng = np.random.default_rng(seed)
        self.sample = Reservoir(int(cell.traffic["check_frames"]), seed)
        self.traced = []
        self.attempted = self.failed = 0
        # Warm-up: frames at fixed angles, the same for every seed, for at
        # least ``warm_seconds`` and at least one frame at each warm-up angle.
        # Two frames were too few: windows of 2 s right after them read a 95th
        # percentile of 16-19 ms where 10 s windows read 10-11.
        warm_until = time.perf_counter() + float(cell.traffic.get("warm_seconds", 0))
        k = 0
        while k < len(WARM_ANGLES) or time.perf_counter() < warm_until:
            self._frame(WARM_ANGLES[k % len(WARM_ANGLES)])
            k += 1
        common.sync(device)

    def _frame(self, angle: float) -> np.ndarray:
        from blackstar_tpu_torch.config import Config
        from blackstar_tpu_torch.render import render_image

        d = dict(self.contents, camera=camera_dict(rotate_y(self.scene.camera, angle)))
        return render_image(Config.from_dict(common.program_scene(self.cell, d)), self.grid,
                            device=self.device)

    def _angle(self) -> float:
        return float(self.rng.uniform(0.0, 360.0))

    def window(self, seconds: float) -> dict:
        lat, n = [], 0
        start = time.perf_counter()
        while True:
            angle = self._angle()
            t0 = time.perf_counter()
            img = self._frame(angle)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            self.sample.offer(angle, lambda: img)
            n += 1
            if t1 - start >= seconds:
                break
        self.attempted = n
        # The tail is reported for a cell that lists it; the default still's
        # runs split between ~10 and ~18 ms on it, too wide for a bound.
        return {"frame_ms": per_unit_ms(start, t1, n), "frame_p95_ms": 1e3 * percentile(lat, 0.95)}

    def trace(self):
        self.traced = [self._angle() for _ in range(self.trace_units)]

        def run():
            for a in self.traced:
                img = self._frame(a)
                self.sample.offer(a, lambda: img)

        tr, _ = profiled(run, len(self.traced), self.device)
        self.attempted = len(self.traced)
        return tr

    def release(self) -> None:
        self.grid = None

    def _scene(self, angle):
        return with_camera(self.scene, rotate_y(self.scene.camera, angle))

    def check(self):
        self.reference = common.ReferenceFrames(self.cell, self.device, stars=self.stars)
        numbers = []
        for angle, img in self.sample.items:
            program = srgb8(torch.as_tensor(img, device=self.device))
            numbers.append(common.frame_numbers(program, self.reference.rgb8(self._scene(angle))))
        checks, self.failed = common.worst(numbers, self.cell.limits)
        return checks

    def counted(self) -> dict:
        return {"ray_steps": sum(self.reference.ray_steps(self._scene(a)) for a in self.traced)}
