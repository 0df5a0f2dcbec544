"""Wrapper of the march adjoint kernel B2 (``csrc/march_adjoint.cu``).

The kernel replaces the TPU Pallas kernel
``blackstar_tpu/ops/march_adjoint_pallas.py::_adjoint_kernel``; see the
source's header for its design and what bounds it. It starts from the
checkpoints and advancing-step counts that the forward kernel B1 wrote
(``march_cuda(..., checkpoints=, ray_steps=)``). Its plain PyTorch twin
is :func:`blackstar_tpu_torch.ops.march_vjp.march_adjoint_from_checkpoints`;
:func:`~blackstar_tpu_torch.ops.march_vjp.march_adjoint_reference` computes
the same from the march's inputs alone.

:func:`march_adjoint_cuda` takes a plain path for rays on the CPU,
launches the kernel for rays on a CUDA device, and raises for anything
else. It never falls back from the kernel to the plain version.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from blackstar_tpu_torch.config import StaticConfig
from blackstar_tpu_torch.geodesic import CKPT_VALUES, n_segments, scene_scalars, step_scalars
from blackstar_tpu_torch.ops import _build
from blackstar_tpu_torch.ops._build import D, I, L, P
from blackstar_tpu_torch.ops.march_vjp import (AdjointGrads, march_adjoint_from_checkpoints,
                                               march_adjoint_reference)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "march_adjoint.cu")
# No multiply-add contraction, as the forward kernel B1: the replay takes
# the shared step (march_step.cuh) as B1 does and must pass through B1's
# states bit for bit (see the source's header).
FLAGS = ("-fmad=false",)
THREADS = 128  # kThreads in the source: one block's rays, one row of partials
N_PARTIALS = 10

LIBRARY = _build.Library(SOURCE, FLAGS, {
    "bs_march_adjoint": _build.Entry((P,) * 6 + (L,) + (D,) * 17 + (I, I) + (P,) * 4,
                                     dtyped=True),
})


def march_adjoint_cuda(pos0: torch.Tensor, vel0, cot_acc: torch.Tensor,
                       cot_vel: torch.Tensor, *, mass, inner, outer, opacity, disk_rgb,
                       safe, static: StaticConfig, checkpoints: Optional[torch.Tensor] = None,
                       ray_steps: Optional[torch.Tensor] = None) -> AdjointGrads:
    """Gradients of the march outputs w.r.t. its inputs, given the
    cotangents ``cot_acc`` (N, 4) and ``cot_vel`` (N, 3): kernel B2 on a
    CUDA device, a plain adjoint on the CPU.

    ``pos0``: (3,) camera position; ``vel0``: three (N,) direction planes or
    an (N, 3) array; the scene scalars 0-d tensors and ``disk_rgb`` (3,).
    ``checkpoints`` (n_segments, 7, N) and ``ray_steps`` (N,) int32 are what
    the forward march of these rays wrote (``march_cuda(...,
    checkpoints=, ray_steps=)``): the kernel's inputs, required on a CUDA
    device. On the CPU, :func:`march_adjoint_from_checkpoints` takes them
    and, without them, :func:`march_adjoint_reference` computes the same.
    The kernel's ``vel0`` gradient is an (N, 3) view of its plane-major
    output.
    """
    planes = tuple(vel0) if isinstance(vel0, (tuple, list)) else tuple(vel0.unbind(-1))
    dev = planes[0].device
    if dev.type == "cpu":
        kw = dict(h=static.step_size, max_steps=static.max_steps, mass=mass, inner=inner,
                  outer=outer, opacity=opacity, disk_rgb=disk_rgb, safe=safe,
                  disk_on=static.disk_on, cot_acc=cot_acc, cot_vel=cot_vel)
        if checkpoints is None:
            return march_adjoint_reference(pos0, torch.stack(planes, dim=-1), **kw)
        return march_adjoint_from_checkpoints(pos0, torch.stack(planes, dim=-1), checkpoints,
                                              ray_steps, **kw)
    if dev.type != "cuda":
        raise ValueError(f"march_adjoint_cuda: unsupported device {dev}")

    dt = static.tdtype
    n = planes[0].shape[0]
    if len(planes) != 3 or any(p.shape != (n,) or p.device != dev for p in planes):
        raise ValueError("march_adjoint_cuda: expected three (N,) direction planes on one device")
    if pos0.shape != (3,) or cot_acc.shape != (n, 4) or cot_vel.shape != (n, 3):
        raise ValueError(f"march_adjoint_cuda: pos0 {tuple(pos0.shape)}, cot_acc "
                         f"{tuple(cot_acc.shape)}, cot_vel {tuple(cot_vel.shape)} do not fit "
                         f"{n} rays")
    if checkpoints is None or ray_steps is None:
        raise ValueError("march_adjoint_cuda: the kernel starts from the forward march's "
                         "checkpoints and ray_steps")
    _build.check_tensor("march_adjoint_cuda: checkpoints", checkpoints,
                        (n_segments(static.max_steps), CKPT_VALUES, n), dt, dev)
    _build.check_tensor("march_adjoint_cuda: ray_steps", ray_steps, (n,), torch.int32, dev)
    planes = [p.to(dt).contiguous() for p in planes]
    # One (7, N) plane-major cotangent block: vel xyz, then RGBA.
    cot = torch.cat([cot_vel.t(), cot_acc.t()]).to(device=dev, dtype=dt).contiguous()

    gvel = torch.empty((3, n), dtype=dt, device=dev)
    status = torch.empty((n,), dtype=torch.int32, device=dev)
    if not n:
        zero = torch.zeros((), dtype=dt, device=dev)
        return AdjointGrads(pos0=torch.zeros(3, dtype=dt, device=dev), vel0=gvel.t(),
                            mass=zero, inner=zero, outer=zero, opacity=zero,
                            disk_rgb=torch.zeros(3, dtype=dt, device=dev), status=status)
    blocks = -(-n // THREADS)
    partials = torch.empty((blocks, N_PARTIALS), dtype=dt, device=dev)

    hs = step_scalars(static.step_size, dt)
    scene = scene_scalars(dt, mass, safe, inner, outer, opacity, disk_rgb, pos0)
    LIBRARY.call("bs_march_adjoint", *(p.data_ptr() for p in planes), cot.data_ptr(),
                 checkpoints.data_ptr(), ray_steps.data_ptr(), n, *hs, *scene,
                 static.max_steps, int(static.disk_on), gvel.data_ptr(), status.data_ptr(),
                 partials.data_ptr(), dtype=dt, device=dev)
    march_adjoint_cuda.launches += 1
    part = partials.sum(dim=0)
    return AdjointGrads(pos0=part[7:10], vel0=gvel.t(), mass=part[0], inner=part[1],
                        outer=part[2], opacity=part[3], disk_rgb=part[4:7], status=status)


march_adjoint_cuda.launches = 0  # kernel launches: shows the backward went through B2
