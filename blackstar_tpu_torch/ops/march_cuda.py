"""Wrapper of the forward march kernel B1 (``csrc/march.cu``).

The kernel replaces the TPU Pallas kernel
``blackstar_tpu/ops/march_pallas.py::_march_kernel``; see the source's
header for what it computes and what bounds it. Its plain PyTorch twin is
:func:`blackstar_tpu_torch.geodesic.march`.

:func:`march_cuda` takes the plain path for rays on the CPU, launches the
kernel for rays on a CUDA device, and raises for anything else. It never
falls back from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from blackstar_tpu_torch.color import hsi_to_rgb
from blackstar_tpu_torch.config import SceneParams, StaticConfig
from blackstar_tpu_torch.geodesic import CKPT_VALUES, MarchResult, march, n_segments
from blackstar_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "march.cu")
# No multiply-add contraction: the step fuses only where march_step.cuh
# writes a fused multiply-add, so this build and B2's round the shared step
# alike; see the source's header.
FLAGS = ("-fmad=false",)

_P, _D = ctypes.c_void_p, ctypes.c_double
_ARGTYPES = ([_P, _P, _P, ctypes.c_int64] + [_D] * 14
             + [ctypes.c_int, ctypes.c_int] + [_P] * 6)
_ENTRY = {torch.float32: "bs_march_f32", torch.float64: "bs_march_f64"}


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load(SOURCE, FLAGS)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def march_cuda(pos0: torch.Tensor, vel0, params: SceneParams,
               static: StaticConfig, safe_distance: torch.Tensor, *,
               ray_steps: Optional[torch.Tensor] = None,
               checkpoints: Optional[torch.Tensor] = None) -> MarchResult:
    """March rays to termination: kernel B1 on a CUDA device, the plain
    march on the CPU.

    ``pos0``: (3,) shared camera position; ``vel0``: three flat (N,)
    direction planes (``camera.generate_ray_components``) or an (N, 3)
    array. Two optional outputs, written by the kernel on the card:
    ``ray_steps``, an (N,) int32 tensor, receives each ray's count of
    advancing RK4 steps; ``checkpoints``, an (n_segments, 7, N) tensor of
    the march's dtype, selects B1's checkpointing variant, which writes
    what the adjoint kernel B2 starts from (the entries
    ``geodesic.march_checkpointed`` gives, where a ray reached them; the
    rest are left as they were). The result's ``acc_rgba`` and ``vel`` are
    (N, 4) and (N, 3) views of the kernel's plane-major output.
    """
    planes = tuple(vel0) if isinstance(vel0, (tuple, list)) else tuple(vel0.unbind(-1))
    dev = planes[0].device
    if dev.type == "cpu":
        if ray_steps is not None or checkpoints is not None:
            raise ValueError("march_cuda: ray_steps and checkpoints are written by the kernel, "
                             "on a CUDA device")
        return march(pos0, torch.stack(planes, dim=-1), params, static, safe_distance)
    if dev.type != "cuda":
        raise ValueError(f"march_cuda: unsupported device {dev}")

    dt = static.tdtype
    if pos0.shape != (3,):
        raise ValueError(f"march_cuda: pos0 must be the shared (3,) camera position, got {tuple(pos0.shape)}")
    planes = [p.to(dt).contiguous() for p in planes]
    n = planes[0].shape[0]
    if len(planes) != 3 or any(p.shape != (n,) or p.device != dev for p in planes):
        raise ValueError("march_cuda: expected three (N,) direction planes on one device")

    out = torch.empty((7, n), dtype=dt, device=dev)
    status = torch.empty((n,), dtype=torch.int32, device=dev)
    steps = torch.zeros((1,), dtype=torch.int32, device=dev)
    if ray_steps is not None:
        _build.check_tensor("march_cuda: ray_steps", ray_steps, (n,), torch.int32, dev)
    if checkpoints is not None:
        _build.check_tensor("march_cuda: checkpoints", checkpoints,
                            (n_segments(static.max_steps), CKPT_VALUES, n), dt, dev)
    if n:
        disk = params.disk
        # The step and its half and sixth, evaluated on the host exactly as
        # the plain march evaluates them.
        h = torch.tensor(static.step_size, dtype=dt)
        # The scene scalars cross to the host in one copy (one sync).
        scene = torch.cat([
            torch.stack([params.mass.to(dt), safe_distance.to(dt), disk.inner.to(dt),
                         disk.outer.to(dt), disk.opacity.to(dt)]),
            hsi_to_rgb(disk.color_hsi.to(dt)),
            pos0.to(dt),
        ]).tolist()
        scalars = [h.item(), (h / 2).item(), (h / 6).item(), *scene]
        fn = getattr(build(), _ENTRY[dt])
        code = fn(*(p.data_ptr() for p in planes), n, *scalars,
                  static.max_steps, int(static.disk_on),
                  out.data_ptr(), status.data_ptr(), steps.data_ptr(),
                  0 if ray_steps is None else ray_steps.data_ptr(),
                  0 if checkpoints is None else checkpoints.data_ptr(),
                  _build.stream_handle(dev))
        _build.check(code, "march kernel")
        march_cuda.launches += 1
    return MarchResult(acc_rgba=out[3:7].t(), vel=out[0:3].t(), status=status,
                       steps=steps[0])


march_cuda.launches = 0  # kernel launches: shows the render went through B1
