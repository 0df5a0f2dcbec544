"""Numerics checking: where did a render's NaN or Inf come from?

The port of ``blackstar_tpu/debug.py``. The JAX package instruments the
whole render with ``checkify``; here the render runs stage by stage, as
``render.render`` runs it (on a CUDA device through the kernels B1 and B3,
on the CPU through their plain versions), and each stage's output is
checked before the next one starts. Use it when a scene renders black or
garbage, to find which stage the numbers died in.

The JAX package's ``render_hlo`` (the compiled program's text) has no
counterpart: there is no compiled program to print. ``render --profile``
(a torch.profiler trace) and ``scripts/kernel_sass.py`` (the kernels'
registers and SASS) stand for it.
"""

from __future__ import annotations

import torch

from blackstar_tpu_torch.camera import generate_ray_components
from blackstar_tpu_torch.config import SceneParams, StaticConfig
from blackstar_tpu_torch.ops.filters import supersample
from blackstar_tpu_torch.render import composite, run_march, star_layer

STAGES = ("rays", "march", "stars", "composite", "supersample")


def _check(stage: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            bad = int((~torch.isfinite(t)).sum())
            raise ValueError(f"non-finite values after the {stage} stage: {bad} of "
                             f"{t.numel()} elements are NaN or Inf")


def checked_render(params: SceneParams, static: StaticConfig, star_grid=None) -> torch.Tensor:
    """Render the linear-RGB image (H, W, 3), before bloom, as
    ``render.render`` does; raises ValueError naming the first stage of
    :data:`STAGES` whose output holds a NaN or an Inf."""
    dt = static.tdtype
    rw, rh = static.render_width, static.render_height
    pos0, planes = generate_ray_components(params.camera, rw, rh, dtype=dt)
    _check("rays", pos0, *planes)
    res = run_march(pos0, planes, params, static)
    _check("march", res.acc_rgba, res.vel)
    bottom = star_layer(res, params, star_grid, dt, width=rw)
    _check("stars", bottom)
    img = composite(res.acc_rgba, bottom).reshape(rh, rw, 3)
    _check("composite", img)
    if static.supersampling:
        img = supersample(img)
        _check("supersample", img)
    return img
