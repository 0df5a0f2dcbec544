"""Sharded rendering: ray data parallelism over ``torch.distributed`` ranks.

The port of ``blackstar_tpu/parallel/render.py``; the pipeline is
``render.render`` with a ``mesh``. Each rank makes its own rays from the
replicated camera (no ray is scattered), marches them through the march
kernel B1 (``march_diff`` with ``differentiable``: B1 forward, B2
backward), shades them through the star kernel B3 (``lookup_diff``: B3
forward, B4 backward), and the shards are gathered only at the end, so
every rank holds the whole image. Supersampling runs after the gather, as
in the JAX package.

Load balance: rays near the photon ring march for hundreds of steps while
sky rays escape in tens, and the hard rays cluster in the frame. So the
frame is dealt round-robin, as the JAX package deals it, but in bands of
``BAND_ROWS`` whole rows: rank d takes bands d, d+D, d+2D, … of D ranks.
Hard and easy rays still interleave across the ranks, and each shard is
itself a row-major frame of the full width, so the star kernels keep their
8×4 pixel tiles (``stars.lookup_cuda.launch_shape``; the JAX package deals
groups of 4 pixels, a size tuned for its TPU star lookup). A ragged tail
(rows not a multiple of ``BAND_ROWS``·D) is padded with copies of the last
row, whose results are thrown away.

Every stage is per ray, so a sharded image equals the unsharded one bit
for bit (``camera.generate_rays_at`` makes each ray as
``generate_ray_components`` does).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from blackstar_tpu_torch.config import SceneParams, StaticConfig
from blackstar_tpu_torch.parallel.mesh import Mesh, make_mesh

BAND_ROWS = 4  # rows a band: the star kernels' warp tile height (lookup_cuda.WARP_TILE)


def shard_rows(height: int, mesh: Mesh) -> torch.Tensor:
    """The frame rows rank ``mesh.rank`` renders, in order: its bands'
    rows, the ragged tail clamped to the last row. Every rank gets the
    same count, ``ceil(ceil(height / BAND_ROWS) / D) · BAND_ROWS``."""
    n_bands = -(-height // BAND_ROWS)
    per = -(-n_bands // mesh.size)
    bands = mesh.rank + mesh.size * torch.arange(per)
    rows = (bands[:, None] * BAND_ROWS + torch.arange(BAND_ROWS)).reshape(-1)
    return rows.clamp(max=height - 1)


def shard_pixels(height: int, width: int, mesh: Mesh) -> torch.Tensor:
    """The flat row-major pixel ids of :func:`shard_rows`' rows, on the
    mesh's device: a row-major frame of the full width."""
    rows = shard_rows(height, mesh).to(mesh.device)
    return (rows[:, None] * width + torch.arange(width, device=mesh.device)).reshape(-1)


class GatherShards(torch.autograd.Function):
    """(rows · width, C) shard of every rank → the (height, width, C) image
    on every rank: one all-gather, then the deal undone. The backward
    returns this rank's rows of the image gradient with no communication:
    every rank holds the same loss of the same image, so the gradient is
    replicated already (``torch.distributed.nn.functional.all_gather``
    would sum it over the ranks, D times too large)."""

    @staticmethod
    def forward(ctx, shard, mesh: Mesh, height: int, width: int):
        parts = [torch.empty_like(shard) for _ in range(mesh.size)]
        dist.all_gather(parts, shard.contiguous())
        c = shard.shape[-1]
        per = shard.shape[0] // (width * BAND_ROWS)  # bands a rank
        img = (torch.stack(parts).reshape(mesh.size, per, BAND_ROWS, width, c)
               .transpose(0, 1).reshape(per * mesh.size * BAND_ROWS, width, c))
        ctx.mesh, ctx.per = mesh, per
        return img[:height].contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, per = ctx.mesh, ctx.per
        height, width, c = g.shape
        full = g.new_zeros((per * mesh.size * BAND_ROWS, width, c))
        full[:height] = g
        mine = full.reshape(per, mesh.size, BAND_ROWS, width, c)[:, mesh.rank]
        return mine.reshape(-1, c), None, None, None


def render_sharded(params: SceneParams, static: StaticConfig, star_grid=None, *,
                   mesh: Optional[Mesh] = None, differentiable: bool = False) -> torch.Tensor:
    """:func:`blackstar_tpu_torch.render.render` sharded over ``mesh``
    (default: every rank of the default group, on the parameters' device):
    every rank returns the whole image, equal to the unsharded one. With
    ``differentiable`` the parameter gradients of a rank are its rays'
    share, which the caller sums over the ranks (``fit.make_train_step``
    with ``mesh``)."""
    from blackstar_tpu_torch.render import render  # render imports this module

    if mesh is None:
        mesh = make_mesh(params.mass.device)
    return render(params, static, star_grid, mesh=mesh, differentiable=differentiable)
