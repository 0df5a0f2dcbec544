"""Keyframe animations rendered on the card, in whole passes.

With ``write_png`` true a pass is ``video.render_animation`` into one
directory under ``TMPDIR`` (the keyframe cameras interpolated on the card,
each frame rendered, bloomed, encoded to 8 bits and copied to the host,
then written by the native PNG pool at its default threads); with it false a pass is
``video.frames``, each frame dropped after its copy to the host. Each pass
rotates both keyframe cameras (position, look-at point, up vector) about
the y axis by an angle the seed draws: the sky moves, the hole and the
disk do not, so every pass marches the same steps.

Traffic parameters: ``write_png``, ``check_frames``
(frames the reference checks, drawn from the seed: of the last pass's
PNGs, or of every frame delivered), ``trace_frames`` (frames under the
profiler in a traced run of ``video.frames``; a traced run of the PNG mix
profiles one whole pass).
"""

from __future__ import annotations

import os
import random
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.runners import common
from benchmark.pngread import read_png
from benchmark.reference.scene import (animation_camera, animation_file, camera_dict,
                                       rotate_y, rotated_animation, with_camera)
from benchmark.trace import profiled
from benchmark.window import Reservoir, per_unit_ms

OUT_NAME = "blackstar-bench-png"  # the pass's directory under TMPDIR


class Session:
    def __init__(self, cell, seed: int, device, size=None, stars=None, frames=None,
                 trace_units=None):
        self.cell, self.device, self.stars, self.seed = cell, device, stars, seed
        self.trace_units = int(trace_units or cell.traffic.get("trace_frames", 0))
        self.contents = common.contents(cell, size)
        if frames is not None:
            self.contents["nFrames"] = int(frames)
        self.anim = animation_file(self.contents)
        self.png = bool(cell.traffic["write_png"])
        self.out_dir = os.path.join(tempfile.gettempdir(), OUT_NAME)
        self.grid = common.program_grid(cell, device, stars)
        self.rng = np.random.default_rng(seed)
        self.sample = Reservoir(int(cell.traffic["check_frames"]), seed)
        self.traced = []
        self.attempted = self.failed = 0
        self._pass(0.0, n_frames=3)  # the same warm-up for every seed
        common.sync(device)

    def _program_anim(self, angle: float, n_frames=None):
        from blackstar_tpu_torch.animation import Animation

        d = common.program_scene(self.cell, self.contents)
        d["keyframes"] = [dict(k, camera=camera_dict(rotate_y(self.anim.keys[j][1], angle)))
                          for j, k in enumerate(sorted(d["keyframes"],
                                                       key=lambda k: float(k["time"])))]
        if n_frames is not None:
            d["nFrames"] = n_frames
        return Animation.from_dict(d)

    def _pass(self, angle: float, n_frames=None, keep=None) -> int:
        """One pass of the animation; ``keep(angle, index, rgb8)`` sees each
        frame of ``video.frames``. Returns the frames delivered."""
        from blackstar_tpu_torch import video

        anim = self._program_anim(angle, n_frames)
        if self.png:
            paths = video.render_animation(anim, self.out_dir, star_grid=self.grid,
                                           device=self.device)
            return len(paths)
        n = 0
        for i, rgb8 in video.frames(anim, star_grid=self.grid, device=self.device):
            if keep is not None:
                keep(angle, i, rgb8)
            n += 1
        return n

    def _keep(self, angle, i, rgb8):
        self.sample.offer((angle, i), lambda: rgb8.copy())

    def _angle(self) -> float:
        return float(self.rng.uniform(0.0, 360.0))

    def window(self, seconds: float) -> dict:
        n = 0
        start = time.perf_counter()
        while True:
            angle = self._angle()
            n += self._pass(angle, keep=self._keep)
            end = time.perf_counter()
            if end - start >= seconds:
                break
        self.attempted = n
        if self.png:
            self._sample_pngs(angle)
        ms = per_unit_ms(start, end, n)
        # The PNG mix reports it as frame_ms, the dropped-frames mix as
        # anim_frame_ms (BENCHMARK.json: their spreads differ); the harness
        # keeps the one the cell lists.
        return {"frame_ms": ms, "anim_frame_ms": ms}

    def _sample_pngs(self, angle: float) -> None:
        """The check's sample: frames of the last pass, read back from disk."""
        from blackstar_tpu_torch.video import frame_path

        n = self.anim.n_frames
        for i in sorted(random.Random(self.seed).sample(range(n), min(self.sample.k, n))):
            path = frame_path(self.out_dir, "frame", n, i)
            self.sample.items.append(((angle, i), read_png(path)))

    def trace(self):
        if self.png:
            angle = self._angle()
            tr, n = profiled(lambda: self._pass(angle), self.anim.n_frames, self.device)
            self._sample_pngs(angle)
            self.attempted = n
            return tr
        from blackstar_tpu_torch import video

        angle = self._angle()
        count = self.trace_units
        it = video.frames(self._program_anim(angle), star_grid=self.grid, device=self.device)
        for _ in range(2):  # into the pass's steady state
            i, rgb8 = next(it)
            self._keep(angle, i, rgb8)

        def run():
            for _ in range(count):
                i, rgb8 = next(it)
                self.traced.append((angle, i))
                self._keep(angle, i, rgb8)

        tr, _ = profiled(run, count, self.device)
        it.close()
        self.attempted = count + 2
        return tr

    def release(self) -> None:
        self.grid = None
        shutil.rmtree(self.out_dir, ignore_errors=True)

    def _scene(self, angle, i):
        cam = animation_camera(rotated_animation(self.anim, angle), i)
        return with_camera(self.anim.scene, cam)

    def check(self):
        self.reference = common.ReferenceFrames(self.cell, self.device, stars=self.stars)
        numbers = []
        for (angle, i), rgb8 in self.sample.items:
            program = torch.as_tensor(np.ascontiguousarray(rgb8), device=self.device)
            numbers.append(common.frame_numbers(program, self.reference.rgb8(self._scene(angle, i))))
        checks, self.failed = common.worst(numbers, self.cell.limits)
        return checks

    def counted(self) -> dict:
        if not self.traced:
            return {}
        return {"ray_steps": sum(self.reference.ray_steps(self._scene(a, i))
                                 for a, i in self.traced)}
