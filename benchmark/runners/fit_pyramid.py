"""Pyramid fit jobs, as ``fit --pyramid K`` runs them, back to back.

Each job is the fit runner's (:mod:`benchmark.runners.fit`: the same
seed-drawn camera, the same four targets taken in turn, the same steps,
learning rate, warm-up, window and trace) with ``pyramid=K`` passed to
``fit.fit_scene``: the loss adds K box-blurred comparison levels (radii 4,
8, 16, …), whose target levels ``fit_scene`` blurs once a job. The first
job's first step is checked against the reference taking the same step
with the same loss (:mod:`benchmark.reference.pyramid`), by the fit's
numbers (``fit.fit_numbers``).

:meth:`Session.counted` adds, beside the ray-steps, the blurs the traced
job ran, read off the program's counters before and after it:
``pyramid_blurs`` (``fit.image_loss.pyramid_blurs``, the rendered image's)
and ``target_blurs`` (``fit.target_pyramid.blurs``), each left out where
the program has no such counter (a program older than the counters runs
the cell all the same, since its ``fit_scene`` takes ``pyramid=`` too, and
its traced run then reports no pyramid metric); and ``image_bytes``, the
bytes of one image in the configuration's precision.

Traffic parameters: the fit runner's, and ``pyramid``.
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference import fit as rfit
from benchmark.reference import pyramid as rpyr
from benchmark.reference import render as ref
from benchmark.runners import fit


def _counters() -> dict:
    from blackstar_tpu_torch import fit as program

    got = {"pyramid_blurs": getattr(program.image_loss, "pyramid_blurs", None),
           "target_blurs": getattr(program.target_pyramid, "blurs", None)}
    return {k: v for k, v in got.items() if v is not None}


class Session(fit.Session):
    def __init__(self, cell, seed: int, device, **kw):
        self.pyramid = int(cell.traffic["pyramid"])
        self.blurs = {}
        super().__init__(cell, seed, device, **kw)

    def _job(self, steps, on_step=None, target=0):
        from blackstar_tpu_torch.fit import fit_scene

        return fit_scene(self.cfg.params(self.device), self.cfg.static(),
                         self.targets[target % len(self.targets)], self.grid, steps=steps,
                         learning_rate=self.lr, callback=on_step, pyramid=self.pyramid)

    def trace(self):
        before = _counters()
        tr = super().trace()
        after = _counters()
        self.blurs = {k: after[k] - before[k] for k in after}
        return tr

    def check(self):
        got = self.captured
        if got["names"] != ["." + n for n in ref.LEAVES]:
            raise RuntimeError(f"the program's leaves {got['names']} are not {ref.LEAVES}")
        from blackstar_tpu_torch.config import param_leaves

        p0 = ref.scene_params(self.scene, self.device, torch.float64)
        r = rfit.follow(self.scene, p0, self.reference.sky, self.targets[0],
                        cap=self.reference.cap, steps=self.follow, lr=self.lr,
                        loss=functools.partial(rpyr.loss_and_grad, pyramid=self.pyramid))
        start = [v.double() for _, v in param_leaves(self.cfg.params(self.device))]
        numbers = fit.fit_numbers(got, r, start)
        checks = [{"name": k, "value": v, "limit": float(self.cell.limits[k])}
                  for k, v in sorted(numbers.items())]
        self.failed = int(any(c["value"] > c["limit"] for c in checks))
        return checks

    def counted(self) -> dict:
        width, height = self.contents["scene"]["resolution"]
        itemsize = 4 if self.cell.config["dtype"] == "float32" else 8
        return dict(super().counted(), **self.blurs, image_bytes=width * height * 3 * itemsize)
