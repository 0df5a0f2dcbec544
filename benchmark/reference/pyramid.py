"""The plain reference of a pyramid fit's loss and its gradient.

The loss of ``fit --pyramid K``: the mean squared difference between the
scene's linear RGB before bloom and a target, plus, for each level
``k < K``, the same mean between the two images each box-blurred once at
radius ``r = 4 << k`` (4, 8, 16 for K = 3), the sum over ``1 + K``. A blur
is the upstream's one pass (``ImageFilters.hs``): the mean of the
zero-padded window of width ``2r + 1``, horizontally then vertically. The
gradient of every scene number is autograd's through
:mod:`benchmark.reference.render`. Plug :func:`loss_and_grad` into
:func:`benchmark.reference.fit.follow` as its ``loss`` (bound to a
``pyramid`` with ``functools.partial``). No departure from the semantics of
the program's loss. Nothing here imports the program.

The window mean is the sum of the window's shifted copies of the padded
image, not ``reference.render.box_blur``: that blur's pooling is right
forward, but its gradient on the card is wrong at every pixel (PyTorch
2.11, CUDA 12.8), so nothing may differentiate it there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.render import Params, render_linear
from benchmark.reference.scene import Scene


def window_mean(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """The mean over ``[i − r, i + r]`` along ``axis``, pixels outside the
    image reading as zero."""
    n = x.shape[axis]
    xp = F.pad(x, [0, 0] * (x.dim() - 1 - axis) + [r, r])
    acc = xp.narrow(axis, 0, n)
    for s in range(1, 2 * r + 1):
        acc = acc + xp.narrow(axis, s, n)
    return acc / (2 * r + 1)


def blur(img: torch.Tensor, r: int) -> torch.Tensor:
    """One pass of the box blur of an (H, W, C) image."""
    return window_mean(window_mean(img, r, 1), r, 0)


def pyramid_loss(img: torch.Tensor, target: torch.Tensor, pyramid: int) -> torch.Tensor:
    """The loss of an (H, W, 3) image against a target of the same shape."""
    target = target.to(img.dtype)
    loss = torch.mean((img - target) ** 2)
    for k in range(pyramid):
        r = 4 << k
        loss = loss + torch.mean((blur(img, r) - blur(target, r)) ** 2)
    return loss / (1 + pyramid)


def loss_and_grad(scene: Scene, p: Params, sky, target: torch.Tensor, *, cap: int,
                  pyramid: int):
    """(loss, [gradient of each leaf]) at the parameters ``p``."""
    leaves = [v.detach().clone().requires_grad_(True) for v in p.leaves()]
    img, _ = render_linear(scene, Params.from_leaves(leaves), sky, cap=cap, grad=True,
                           with_bloom=False)
    loss = pyramid_loss(img, target, pyramid)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, grads)]
    return loss.detach(), grads
