"""Fit jobs as the fit CLI runs them, back to back.

Each job is ``fit.fit_scene``: ``steps`` Adam steps at learning rate
``lr``, every differentiable leaf trainable, no pyramid, from the scene's
own parameters seen from a seed-drawn azimuth (the camera rotated about the
y axis), towards a target the reference renders at set-up: the same scene
before bloom with ``diskOuter`` and ``starIntensity`` moved by the
traffic's offsets. The four targets (each offset up or down) are rendered
at set-up and the jobs take them in turn, in an order the seed draws: a
job's steps cost what the fit's path makes them cost, so every seed runs
the same four paths. The offsets' sizes are fixed, because a target drawn
at the start itself leaves a loss that the float32 rays at the photon
sphere dominate. A step is the training forward (B1's
checkpointing variant, B3), the backward (B2, B4) and Adam. Steps are
counted through the job's callback, which adds no sync.

The first job of a run is the one checked: its first step's loss, the
first gradient as Adam holds it after that step (``exp_avg / (1 − β₁)``)
and the parameters' change in it, against the reference taking the same
step (``follow_steps`` of them: PERF.md says why one).

Traffic parameters: ``steps``, ``lr``, ``disk_outer_offset`` and
``star_intensity_offset`` (the target's), ``follow_steps``,
``trace_steps`` (the length of the one job run under the profiler in a
traced run, which is also the job checked there).
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import replace

import numpy as np
import torch

from benchmark.runners import common
from benchmark.reference import fit as rfit
from benchmark.reference import render as ref
from benchmark.reference.scene import camera_dict, rotate_y, scene_file, with_camera
from benchmark.trace import profiled
from benchmark.window import per_unit_ms

BETA1 = 0.9
# A leaf counts in the change only if the reference's gradient of it is at
# least this share of the median leaf's: below it a leaf moves by round-off.
MOVING = 1e-3


class Session:
    def __init__(self, cell, seed: int, device, size=None, stars=None, steps=None,
                 trace_units=None):
        from blackstar_tpu_torch.config import Config

        self.cell, self.device, self.stars = cell, device, stars
        t = cell.traffic
        self.steps = int(steps if steps is not None else t["steps"])
        self.lr = float(t["lr"])
        self.follow = int(t["follow_steps"])
        self.trace_units = int(trace_units or t["trace_steps"])
        self.contents, self.scene, target_scenes = fit_inputs(cell, seed, size)
        self.cfg = Config.from_dict(common.program_scene(cell, self.contents))
        self.grid = common.program_grid(cell, device, stars)
        self.reference = common.ReferenceFrames(cell, device, stars=stars)
        self.targets = [self.reference.linear(ts, with_bloom=False).float()
                        for ts in target_scenes]
        self.captured = None
        self.traced_params = []
        self.attempted = self.failed = 0
        self._job(2)  # warm-up: the same call, two steps
        common.sync(device)

    def _job(self, steps, on_step=None, target=0):
        from blackstar_tpu_torch.fit import fit_scene

        return fit_scene(self.cfg.params(self.device), self.cfg.static(),
                         self.targets[target % len(self.targets)], self.grid, steps=steps,
                         learning_rate=self.lr, callback=on_step)

    def _capture(self):
        """A callback that keeps what the check needs of one job, and the
        dict it fills."""
        from blackstar_tpu_torch.config import param_leaves

        got = {}

        def on_step(i, state, loss):
            leaves = [v for _, v in param_leaves(state.params)]
            if i == 0:
                got["names"] = [n for n, _ in param_leaves(state.params)]
                got["m"] = [state.optimizer.state[v]["exp_avg"].detach().clone()
                            if v in state.optimizer.state else torch.zeros_like(v.detach())
                            for v in leaves]
            if i == self.follow - 1:
                got["params"] = [v.detach().clone() for v in leaves]

        return on_step, got

    def window(self, seconds: float) -> dict:
        done = [0]
        capture, got = self._capture()

        def first_job(i, state, loss):
            capture(i, state, loss)
            done[0] += 1

        def count(i, state, loss):
            done[0] += 1

        start = time.perf_counter()
        jobs = 0
        while True:
            _, losses = self._job(self.steps, first_job if jobs == 0 else count, jobs)
            if jobs == 0:
                got["losses"] = losses[:self.follow]
            jobs += 1
            end = time.perf_counter()
            if end - start >= seconds:
                break
        self.captured = got
        self.attempted = jobs
        return {"step_ms": per_unit_ms(start, end, done[0])}

    def trace(self):
        from blackstar_tpu_torch.config import param_leaves

        n = self.trace_units
        capture, got = self._capture()
        start = [v.detach().clone() for _, v in param_leaves(self.cfg.params(self.device))]
        self.traced_params = [start]

        def on_step(i, state, loss):
            capture(i, state, loss)
            if i < n - 1:
                self.traced_params.append([v.detach().clone() for _, v in
                                           param_leaves(state.params)])

        tr, (_, losses) = profiled(lambda: self._job(n, on_step), n, self.device)
        got["losses"] = losses[:self.follow]
        self.captured = got
        self.attempted = 1
        return tr

    def release(self) -> None:
        self.grid = None

    def check(self):
        got = self.captured
        if got["names"] != ["." + n for n in ref.LEAVES]:
            raise RuntimeError(f"the program's leaves {got['names']} are not {ref.LEAVES}")
        from blackstar_tpu_torch.config import param_leaves

        p0 = ref.scene_params(self.scene, self.device, torch.float64)
        r = rfit.follow(self.scene, p0, self.reference.sky, self.targets[0],
                        cap=self.reference.cap, steps=self.follow, lr=self.lr)
        start = [v.double() for _, v in param_leaves(self.cfg.params(self.device))]
        numbers = fit_numbers(got, r, start)
        checks = [{"name": k, "value": v, "limit": float(self.cell.limits[k])}
                  for k, v in sorted(numbers.items())]
        self.failed = int(any(c["value"] > c["limit"] for c in checks))
        return checks

    def counted(self) -> dict:
        """The reference's ray-steps at the parameters each traced step
        started from."""
        return {"ray_steps": sum(
            self.reference.ray_steps(self.scene, ref.Params.from_leaves([v.double() for v in x]))
            for x in self.traced_params)}


def fit_inputs(cell, seed: int, size=None):
    """The seed's fit: the scene file's contents with the camera rotated, the
    reference's scene of it, and the four targets' scenes in the seed's
    order."""
    t = cell.traffic
    rng = np.random.default_rng(seed)
    d = common.contents(cell, size)
    base = scene_file(d)
    cam = rotate_y(base.camera, float(rng.uniform(0.0, 360.0)))
    d["camera"] = camera_dict(cam)
    scene = with_camera(base, cam)
    targets = [replace(scene, disk_outer=scene.disk_outer + a * t["disk_outer_offset"],
                       star_intensity=scene.star_intensity + b * t["star_intensity_offset"])
               for a in (1.0, -1.0) for b in (1.0, -1.0)]
    return d, scene, [targets[i] for i in rng.permutation(len(targets))]


def fit_numbers(got: dict, r, start) -> dict:
    """The fit's numbers, of its first step (PERF.md says why the later
    steps are not compared):

    * ``first_loss_gap``: the relative gap of the first step's loss;
    * ``median_grad_gap``: over the leaves, the median of the gap between
      the norms of the program's and the reference's first gradients, each
      over the larger of the reference leaf's norm and the median leaf's;
    * ``first_change_gap``: the worst gap, the same way, between the norms
      of each leaf's change in the first step, over the leaves the
      reference's gradient moves (at least ``MOVING`` of the median
      leaf's)."""
    ln = rfit.norm
    first_loss_gap = abs(got["losses"][0] - r.losses[0]) / abs(r.losses[0])
    g_prog = [ln(m) / (1 - BETA1) for m in got["m"]]
    g_ref = [ln(g) for g in r.first_grad]
    med_g = statistics.median(g_ref)
    median_grad_gap = statistics.median(abs(a - b) / max(b, med_g)
                                        for a, b in zip(g_prog, g_ref))
    moving = [i for i, b in enumerate(g_ref) if b >= MOVING * med_g]
    d_prog = [ln(got["params"][i].double() - start[i]) for i in moving]
    d_ref = [ln(r.change[i]) for i in moving]
    med_d = statistics.median(d_ref)
    first_change_gap = max(abs(a - b) / max(b, med_d) for a, b in zip(d_prog, d_ref))
    out = {"first_loss_gap": first_loss_gap, "median_grad_gap": median_grad_gap,
           "first_change_gap": first_change_gap}
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}
