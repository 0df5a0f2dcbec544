"""Differentiable march: kernel B1 forward, kernel B2 backward.

The port of ``blackstar_tpu/ops/march_diff.py``: a
``torch.autograd.Function`` whose forward is :func:`march_cuda` (B1 on a
CUDA device, the plain march on the CPU) and whose backward is
:func:`march_adjoint_cuda` (B2 on a CUDA device, the plain hand-derived
adjoint on the CPU). Both compute what reverse-mode autograd through the
plain march computes (``tests/test_torch_march_vjp.py``).

On a CUDA device the forward launches B1's checkpointing variant and saves
what it wrote, each ray's state before every 16th advancing step (an
``(n_segments, 7, N)`` tensor, 2.1 GB at 1080p in float32) and its
advancing-step count, for B2: the march runs once per training step, and
the checkpoints live from the forward to the backward.

``status`` and ``steps`` are integer outputs, marked non-differentiable.
``safe`` enters comparisons only and gets no gradient. The disk colour
enters as linear RGB, so its gradient reaches ``disk.color_hsi`` through
autograd of ``hsi_to_rgb`` outside the Function.
"""

from __future__ import annotations

import torch

from blackstar_tpu_torch.color import hsi_to_rgb
from blackstar_tpu_torch.config import SceneParams, StaticConfig
from blackstar_tpu_torch.geodesic import CKPT_VALUES, MarchResult, n_segments
from blackstar_tpu_torch.ops.march_adjoint_cuda import march_adjoint_cuda
from blackstar_tpu_torch.ops.march_cuda import march_cuda


class MarchFunction(torch.autograd.Function):
    """(pos0, vx, vy, vz, mass, inner, outer, opacity, disk_rgb, safe) →
    (acc_rgba, vel, status, steps). ``static`` and ``params`` ride along
    as non-tensor arguments: the forward march reads the scene from
    ``params``, whose mass, disk radii and opacity are the Function's
    inputs and whose disk colour gives ``disk_rgb`` (:func:`march_diff`
    builds the arguments so)."""

    @staticmethod
    def forward(ctx, static, params, pos0, vx, vy, vz, mass, inner, outer, opacity,
                disk_rgb, safe):
        ckpt = ray_steps = None
        if vx.device.type == "cuda":
            n = vx.shape[0]
            ckpt = torch.empty((n_segments(static.max_steps), CKPT_VALUES, n),
                               dtype=static.tdtype, device=vx.device)
            ray_steps = torch.empty((n,), dtype=torch.int32, device=vx.device)
        res = march_cuda(pos0, (vx, vy, vz), params, static, safe, ray_steps=ray_steps,
                         checkpoints=ckpt)
        ctx.static = static
        ctx.save_for_backward(pos0, vx, vy, vz, mass, inner, outer, opacity, disk_rgb, safe,
                              ckpt, ray_steps)
        ctx.mark_non_differentiable(res.status, res.steps)
        return res.acc_rgba, res.vel, res.status, res.steps

    @staticmethod
    def backward(ctx, g_acc, g_vel, _g_status, _g_steps):
        (pos0, vx, vy, vz, mass, inner, outer, opacity, disk_rgb, safe, ckpt,
         ray_steps) = ctx.saved_tensors
        g = march_adjoint_cuda(pos0, (vx, vy, vz), g_acc, g_vel, mass=mass, inner=inner,
                               outer=outer, opacity=opacity, disk_rgb=disk_rgb, safe=safe,
                               static=ctx.static, checkpoints=ckpt, ray_steps=ray_steps)
        gv = g.vel0
        return (None, None, g.pos0.to(pos0.dtype),
                gv[:, 0].to(vx.dtype), gv[:, 1].to(vy.dtype), gv[:, 2].to(vz.dtype),
                g.mass.to(mass.dtype), g.inner.to(inner.dtype), g.outer.to(outer.dtype),
                g.opacity.to(opacity.dtype), g.disk_rgb.to(disk_rgb.dtype), None)


def march_diff(pos0: torch.Tensor, vel0, params: SceneParams, static: StaticConfig,
               safe: torch.Tensor) -> MarchResult:
    """Differentiable march of ``vel0`` (three (N,) planes or an (N, 3)
    array) from the shared camera position ``pos0`` (3,)."""
    planes = tuple(vel0) if isinstance(vel0, (tuple, list)) else tuple(vel0.unbind(-1))
    disk = params.disk
    disk_rgb = hsi_to_rgb(disk.color_hsi.to(static.tdtype))
    acc, vel, status, steps = MarchFunction.apply(
        static, params, pos0, *planes, params.mass, disk.inner, disk.outer, disk.opacity,
        disk_rgb, safe)
    return MarchResult(acc_rgba=acc, vel=vel, status=status, steps=steps)
