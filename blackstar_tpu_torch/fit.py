"""Differentiable scene fitting (inverse rendering) — the training path.

The port of ``blackstar_tpu/fit.py``: an L2 image loss (optionally over a
box-blur pyramid), Adam, and a loop that gradient-descends the scene
parameters toward a target image. On a CUDA device each step runs the
march kernel B1 and the star kernel B3 forward and their backward kernels
B2 (the march adjoint) and B4 (the star VJP); on the CPU their plain
PyTorch versions.

Adam is ``torch.optim.Adam`` with optax ``adam``'s defaults (b1 0.9, b2
0.999, eps 1e-8). A leaf that the mask freezes gets a zero gradient, and
Adam then moves it by exactly zero, as optax's does.

With a ``mesh`` (``parallel.make_mesh``) the render is sharded over the
ranks (``render.render`` with ``mesh``): every rank holds the whole image and
the same loss, its backward yields its rays' share of each parameter
gradient, and one all-reduce sums the shares (what the JAX package's
``shard_map`` transpose does with its psum), so every rank's Adam takes
the same step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from blackstar_tpu_torch.config import (SceneParams, StaticConfig, param_leaves,
                                        params_from_leaves)
from blackstar_tpu_torch.ops.filters import pyramid_blur
from blackstar_tpu_torch.render import render

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class TrainState(NamedTuple):
    params: SceneParams  # leaves are leaf tensors that require grad
    optimizer: torch.optim.Optimizer
    step: int


def image_loss(params: SceneParams, static: StaticConfig, target, star_grid=None, *,
               mesh=None, pyramid: int = 0) -> torch.Tensor:
    """Mean-squared error between the rendered linear-RGB image (rendered
    through the differentiable path; with a ``mesh``, sharded over its
    ranks) and a target.

    ``pyramid > 0`` adds box-blurred comparison levels (radii 4, 8, 16, …)
    that give long-range gradients where rendered and target structures
    barely overlap. ``target`` may be the tuple of precomputed levels that
    :func:`target_pyramid` returns; else its levels are blurred here.

    The levels run inside the profiler span ``fit.pyramid`` (the forward
    only: autograd runs their backward later), and
    ``image_loss.pyramid_blurs`` counts the blurs of the rendered image.
    """
    img = render(params, static, star_grid, mesh=mesh, differentiable=True)
    levels = None
    if isinstance(target, (tuple, list)):
        levels = list(target)
        pyramid = len(levels) - 1
        target = levels[0]
    target = target.to(img.dtype)
    loss = torch.mean((img - target) ** 2)
    if pyramid:
        with record_function("fit.pyramid"):
            if levels is None:
                levels = target_pyramid(target, pyramid)
            for k in range(pyramid):
                tb = levels[k + 1].to(img.dtype)
                loss = loss + torch.mean((pyramid_blur(img, 4 << k) - tb) ** 2)
            image_loss.pyramid_blurs += pyramid
            loss = loss / (1 + pyramid)
    return loss


image_loss.pyramid_blurs = 0  # box blurs of rendered images (one a level a loss)


def target_pyramid(target: torch.Tensor, pyramid: int):
    """The blurred comparison levels of a constant target (radii 4, 8, …),
    computed once; pass the tuple to :func:`image_loss` as the target.
    Runs inside the profiler span ``fit.target_pyramid``;
    ``target_pyramid.blurs`` counts its blurs."""
    with record_function("fit.target_pyramid"):
        levels = (target,) + tuple(pyramid_blur(target, 4 << k) for k in range(pyramid))
    target_pyramid.blurs += pyramid
    return levels


target_pyramid.blurs = 0  # box blurs of targets


def trainable_mask(params: SceneParams, predicate) -> SceneParams:
    """A SceneParams of 0/1 tensors selecting the leaves to optimise.
    ``predicate`` receives the dotted leaf path (``".disk.outer"``,
    ``".camera.fov"``, …) and returns True for a trainable leaf."""
    return params_from_leaves(
        torch.ones_like(v) if predicate(path) else torch.zeros_like(v)
        for path, v in param_leaves(params))


def init_train_state(params: SceneParams, learning_rate: float = 1e-2) -> TrainState:
    """Fresh trainable copies of the parameter leaves and an Adam over them."""
    leaves = [v.detach().clone().requires_grad_(True) for _, v in param_leaves(params)]
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS)
    return TrainState(params=params_from_leaves(leaves), optimizer=opt, step=0)


def allreduce_grads(params: SceneParams, mesh) -> None:
    """Sum the leaves' gradients over the ranks of ``mesh`` in place: the
    leaves that have one, flattened into one buffer, one all-reduce."""
    leaves = [v for _, v in param_leaves(params) if v.grad is not None]
    if not leaves:
        return
    buf = torch.cat([v.grad.reshape(-1) for v in leaves])
    torch.distributed.all_reduce(buf)
    for v, g in zip(leaves, buf.split([v.numel() for v in leaves])):
        v.grad.copy_(g.view_as(v.grad))


def make_train_step(static: StaticConfig, star_grid=None, *, mesh=None,
                    grad_mask: Optional[SceneParams] = None, pyramid: int = 0):
    """A ``(state, target[, star_grid]) -> (state, loss)`` update step: the
    loss and its gradients w.r.t. every leaf (with a ``mesh``, sharded and
    summed over its ranks), the mask, one Adam step. The loss comes back as
    a 0-d tensor on the device (no host sync)."""
    masks = None if grad_mask is None else [m for _, m in param_leaves(grad_mask)]

    def train_step(state: TrainState, target, grid=star_grid):
        state.optimizer.zero_grad(set_to_none=True)
        loss = image_loss(state.params, static, target, grid, mesh=mesh, pyramid=pyramid)
        loss.backward()
        if mesh is not None:
            allreduce_grads(state.params, mesh)
        if masks is not None:
            for (_, leaf), m in zip(param_leaves(state.params), masks):
                if leaf.grad is not None:
                    leaf.grad.mul_(m)
        state.optimizer.step()
        return TrainState(state.params, state.optimizer, state.step + 1), loss.detach()

    return train_step


def fit_scene(params: SceneParams, static: StaticConfig, target, star_grid=None, *,
              steps: int = 100, learning_rate: float = 1e-2, callback=None, mesh=None,
              grad_mask: Optional[SceneParams] = None, pyramid: int = 0):
    """Gradient-descend the scene parameters toward a target image.

    Returns ``(params, losses)``. ``grad_mask`` (see :func:`trainable_mask`)
    restricts which leaves move; ``pyramid`` adds multi-scale loss levels;
    ``mesh`` shards each step over its ranks (:func:`make_train_step`).
    The losses stay on the device during the loop and are fetched once at
    the end; ``callback(i, state, loss)`` receives the device loss.
    """
    state = init_train_state(params, learning_rate)
    if pyramid and not isinstance(target, (tuple, list)):
        target = target_pyramid(target, pyramid)
    step_fn = make_train_step(static, mesh=mesh, grad_mask=grad_mask, pyramid=pyramid)
    losses = []
    for i in range(steps):
        state, loss = step_fn(state, target, star_grid)
        if callback is not None:
            callback(i, state, loss)
        losses.append(loss)
    fitted = params_from_leaves(v.detach() for _, v in param_leaves(state.params))
    return fitted, (torch.stack(losses).cpu().tolist() if losses else [])


def save_params(params: SceneParams, path: str) -> None:
    """Checkpoint the parameters to ``.npz`` in the JAX package's layout
    (``n`` and ``leaf_<i>`` in its flatten order), so either package reads
    the other's file."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves = [v.detach().cpu().numpy() for _, v in param_leaves(params)]
    np.savez(path, n=len(leaves), **{f"leaf_{i}": v for i, v in enumerate(leaves)})


def load_params(path: str, device) -> SceneParams:
    """Restore a :func:`save_params` (or JAX package) checkpoint onto
    ``device``, in the stored leaves' dtype."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        leaves = [torch.as_tensor(z[f"leaf_{i}"], device=device) for i in range(int(z["n"]))]
    return params_from_leaves(leaves)
