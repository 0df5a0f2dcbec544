"""The plain reference of a fit: the image loss, its gradient and Adam.

The loss is the mean of the squared difference between the scene's linear
RGB before bloom and a target image; its gradient with respect to every
scene number is autograd's through :mod:`benchmark.reference.render` (the
march in checkpointed segments, so a 1080p frame fits on the card). Adam
is written out: ``m ← β₁m + (1−β₁)g``, ``v ← β₂v + (1−β₂)g²``,
``p ← p − lr·(m/(1−β₁ᵗ)) / (√(v/(1−β₂ᵗ)) + ε)`` with β₁ 0.9, β₂ 0.999,
ε 1e-8. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

from benchmark.reference.render import Params, render_linear
from benchmark.reference.scene import Scene

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def loss_and_grad(scene: Scene, p: Params, sky, target: torch.Tensor, *, cap: int):
    """(loss, [gradient of each leaf]) at the parameters ``p``."""
    leaves = [v.detach().clone().requires_grad_(True) for v in p.leaves()]
    q = Params.from_leaves(leaves)
    img, _ = render_linear(scene, q, sky, cap=cap, grad=True, with_bloom=False)
    loss = torch.mean((img - target.to(img.dtype)) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, grads)]
    return loss.detach(), grads


class Followed(NamedTuple):
    losses: List[float]  # the loss at each step's parameters
    first_grad: List[torch.Tensor]  # each leaf's gradient at the first step
    change: List[torch.Tensor]  # each leaf's change over the steps


def follow(scene: Scene, p: Params, sky, target, *, cap: int, steps: int, lr: float,
           loss=loss_and_grad) -> Followed:
    """``steps`` Adam steps from ``p``, as a fit takes them; ``loss`` gives
    the loss and the leaves' gradients at a step's parameters."""
    x = [v.detach().clone() for v in p.leaves()]
    start = [v.clone() for v in x]
    m = [torch.zeros_like(v) for v in x]
    v2 = [torch.zeros_like(v) for v in x]
    losses, first = [], None
    for t in range(1, steps + 1):
        value, g = loss(scene, Params.from_leaves(x), sky, target, cap=cap)
        losses.append(float(value))
        if first is None:
            first = g
        for i in range(len(x)):
            m[i] = BETA1 * m[i] + (1 - BETA1) * g[i]
            v2[i] = BETA2 * v2[i] + (1 - BETA2) * g[i] * g[i]
            mhat = m[i] / (1 - BETA1 ** t)
            vhat = v2[i] / (1 - BETA2 ** t)
            x[i] = x[i] - lr * mhat / (torch.sqrt(vhat) + EPS)
    return Followed(losses, first, [a - b for a, b in zip(x, start)])


def norm(t: torch.Tensor) -> float:
    return math.sqrt(float((t.double() ** 2).sum()))
