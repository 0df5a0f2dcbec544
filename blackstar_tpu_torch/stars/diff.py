"""Differentiable star stage: kernel B3 forward, kernel B4 backward.

The port of ``blackstar_tpu/stars/diff.py``: a ``torch.autograd.Function``
over the UNCLAMPED per-ray star sums. Its forward is
:func:`star_lookup_cuda` with the clamp off (B3 on a CUDA device, the plain
lookup on the CPU); its backward is :func:`star_lookup_vjp_cuda` (B4 on a
CUDA device, the plain hand-derived :meth:`StarGrid.lookup_vjp` on the CPU).

The clamp ``min(acc, 1)`` (StarMap.hs:115) and the escape mask stay outside
the Function as ordinary autograd operations, so the cotangents reach the
backward with both folded in. The clamp is ``torch.minimum`` against a
tensor of ones, whose gradient splits 0.5/0.5 at a tie as ``lax.min``'s
does (``torch.clamp`` would pass it all through).

The grid's tables are scene data, not parameters: a table that requires
grad is refused outright rather than given a silent zero gradient.
"""

from __future__ import annotations

import torch

from blackstar_tpu_torch.stars.grid import StarGrid
from blackstar_tpu_torch.stars.lookup_cuda import star_lookup_cuda, star_lookup_vjp_cuda


class StarFunction(torch.autograd.Function):
    """(vel, intensity, saturation) → unclamped star sums (N, 3); ``grid``
    and ``active`` ride along without gradients."""

    @staticmethod
    def forward(ctx, grid, vel, intensity, saturation, active, width=None):
        ctx.grid, ctx.width = grid, width
        ctx.save_for_backward(vel, intensity, saturation, active)
        return star_lookup_cuda(grid, vel, intensity, saturation, active, clamp=False,
                                width=width)

    @staticmethod
    def backward(ctx, g):
        vel, intensity, saturation, active = ctx.saved_tensors
        gvel, g_i, g_s = star_lookup_vjp_cuda(ctx.grid, vel, intensity, saturation, active, g,
                                              width=ctx.width)
        return (None, gvel.to(vel.dtype), g_i.to(intensity.dtype), g_s.to(saturation.dtype),
                None, None)


def lookup_diff(grid: StarGrid, vel: torch.Tensor, intensity: torch.Tensor,
                saturation: torch.Tensor, active: torch.Tensor, width=None) -> torch.Tensor:
    """Clamped, escape-masked star colours (N, 3) of the ray directions
    ``vel`` (N, 3), differentiable w.r.t. ``vel``, ``intensity`` and
    ``saturation``: the same values as ``star_lookup_cuda(..., active)``,
    with the gradients of ``jax.grad`` through the JAX package's lookup.
    ``width`` is the kernels' layout hint (``star_lookup_cuda``)."""
    if active is None:
        raise ValueError("lookup_diff needs an explicit (N,) bool active mask "
                         "(torch.ones(n, dtype=torch.bool) if every ray is live)")
    if any(t.requires_grad for t in (grid.cell_data, grid.ovf_data)):
        raise ValueError("lookup_diff: the star grid's tables are catalogue data and take "
                         "no gradient; detach them (requires_grad=False)")
    dt = vel.dtype
    unclamped = StarFunction.apply(grid, vel, intensity.to(dt), saturation.to(dt), active,
                                   width)
    out = torch.minimum(unclamped, torch.ones((), dtype=dt, device=vel.device))
    return torch.where(active[:, None], out, torch.zeros((), dtype=dt, device=vel.device))
