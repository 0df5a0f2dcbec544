"""Operations a ray-step needs, derived from the reference's own step.

The march kernel B1 advances a ray by one classic RK4 step of the photon
ODE and tests the state before it (``|p|²`` against the horizon and the
escape radius); the adjoint kernel B2 reverses one such step: it replays
the step forward from a checkpoint and takes the step's vector-Jacobian
product with respect to the position, the velocity and the step's
coefficient ``−1.5·rs·h²``.

The counts are not written by hand: :func:`count_ops` runs the reference's
RK4 step (``reference.render._rk4``) on one ray under a dispatch mode that
counts the floating-point operations of each ATen call:

* one per output element for the elementwise arithmetic in
  :data:`ELEMENTWISE` (``add``, ``mul``, ``div``, ``sqrt``, …; a fused
  multiply-add counts two);
* ``n_in − n_out`` additions for a sum;
* nothing for comparisons, selects, copies, views and broadcasts.

So ``B1 = ops(RK4 step) + ops(|p|²)`` and
``B2 = ops(RK4 step) + ops(its backward)``, the backward as autograd
computes it. The disk is left out of both: it costs a few dozen operations
only at the steps that cross the disk plane, a ray's two or three out of
hundreds. PERF.md gives the result beside the hand counts used before
(128 and 310).
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ELEMENTWISE = {"add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1, "sqrt": 1, "rsqrt": 1,
               "pow": 1, "sin": 1, "cos": 1, "exp": 1, "log": 1, "reciprocal": 1,
               "addcmul": 2, "addcdiv": 2, "rsub": 1}
REDUCTIONS = {"sum"}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ELEMENTWISE and isinstance(out, torch.Tensor):
            self.ops += ELEMENTWISE[name] * out.numel()
        elif name in REDUCTIONS and isinstance(out, torch.Tensor):
            self.ops += args[0].numel() - out.numel()
        return out


def count_ops(fn) -> int:
    """Floating-point operations of ``fn()`` by the rules above."""
    with _Counter() as c:
        fn()
    return c.ops


def _ray():
    pos = torch.tensor([[0.3, 1.0, -20.0]], dtype=torch.float64, requires_grad=True)
    vel = torch.tensor([[0.1, -0.05, 0.99]], dtype=torch.float64, requires_grad=True)
    coef = torch.tensor([-1.5 * 0.1], dtype=torch.float64, requires_grad=True)
    return pos, vel, coef


@functools.lru_cache(maxsize=None)
def per_ray_step() -> dict:
    """``{"B1": ops a forward ray-step, "B2": ops a reversed ray-step,
    "rk4": the RK4 step alone, "rk4_backward": its reverse alone}``."""
    from benchmark.reference.render import _rk4

    pos, vel, coef = _ray()
    h = 0.3
    rk4 = count_ops(lambda: _rk4(pos, vel, coef, h))
    test = count_ops(lambda: (pos * pos).sum(-1))
    new_pos, new_vel = _rk4(pos, vel, coef, h)
    gp, gv = torch.ones_like(new_pos), torch.ones_like(new_vel)
    back = count_ops(lambda: torch.autograd.grad((new_pos, new_vel), (pos, vel, coef),
                                                 (gp, gv)))
    return {"B1": rk4 + test, "B2": rk4 + back, "rk4": rk4, "rk4_backward": back}
