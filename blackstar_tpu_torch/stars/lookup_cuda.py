"""Wrapper of the per-ray star lookup kernel B3 (``csrc/star_lookup.cu``).

The kernel computes :meth:`blackstar_tpu_torch.stars.grid.StarGrid.lookup`
(its plain PyTorch twin) per ray on the card; it stands for the JAX
package's XLA star stage ``blackstar_tpu/stars/grid.py::StarGrid._lookup_block``,
which has no Pallas kernel. See the source's header for what bounds it.

:func:`star_lookup_cuda` takes the plain path for rays on the CPU, launches
the kernel for rays on a CUDA device, and raises for anything else. It never
falls back from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional

import torch

from blackstar_tpu_torch.ops import _build
from blackstar_tpu_torch.stars.grid import StarGrid

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "star_lookup.cu")
# No multiply-add contraction: each f32 operation rounds as the plain
# version's does (the PSF is sensitive to it; see the source's header).
FLAGS = ("-fmad=false",)

_P, _D, _I = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
_ARGTYPES = ([_P, _P, _P, _P, ctypes.c_int64, _P, _P, _P] + [_D] * 6
             + [_I] * 5 + [_P, _P])
_ENTRY = {torch.float32: "bs_star_lookup_f32", torch.float64: "bs_star_lookup_f64"}


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load(SOURCE, FLAGS)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def star_lookup_cuda(grid: StarGrid, vel: torch.Tensor, intensity: torch.Tensor,
                     saturation: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Star colour (N, 3) for ray directions ``vel`` (N, 3): kernel B3 on a
    CUDA device, :meth:`StarGrid.lookup` on the CPU. ``active`` (N,) bool
    marks the escaped rays; the others get 0. The kernel's result is an
    (N, 3) view of its plane-major output."""
    dev = vel.device
    if dev.type == "cpu":
        return grid.lookup(vel, intensity, saturation, active)
    if dev.type != "cuda":
        raise ValueError(f"star_lookup_cuda: unsupported device {dev}")

    dt = vel.dtype
    n = vel.shape[0]
    if vel.shape != (n, 3):
        raise ValueError(f"star_lookup_cuda: vel must be (N, 3), got {tuple(vel.shape)}")
    if grid.dtype != dt or grid.device != dev:
        raise ValueError(f"star_lookup_cuda: grid is {grid.dtype} on {grid.device}, "
                         f"rays are {dt} on {dev}")
    planes = vel.t().contiguous()  # no copy for the march's plane-major output
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    if active.shape != (n,) or active.dtype != torch.bool or active.device != dev:
        raise ValueError("star_lookup_cuda: active must be an (N,) bool tensor on the rays' device")
    active = active.contiguous()
    tables = (grid.cell_data, grid.ovf_data, grid.ovf_octets)
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tables):
        raise ValueError("star_lookup_cuda: grid tables must be contiguous and 16-byte aligned")

    if not (n and grid.n_stars):
        return torch.zeros((n, 3), dtype=dt, device=dev)
    out = torch.empty((3, n), dtype=dt, device=dev)  # the kernel writes every element
    a, r2lim, inv2w2 = grid.psf_constants(dt)
    shading = torch.stack([intensity.to(dt), saturation.to(dt)]).tolist()  # one sync
    fn = getattr(build(), _ENTRY[dt])
    code = fn(planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(),
              active.data_ptr(), n,
              grid.cell_data.data_ptr(), grid.ovf_data.data_ptr(),
              grid.ovf_octets.data_ptr(),
              *shading, a, r2lim, inv2w2, math.pi / grid.n_rings,
              grid.n_rings, grid.n_cols, grid.pad_k,
              grid.ovf_data.shape[1] // 8, int(grid.fast_cells_ok(dt)),
              out.data_ptr(), _build.stream_handle(dev))
    _build.check(code, "star lookup kernel")
    star_lookup_cuda.launches += 1
    return out.t()


star_lookup_cuda.launches = 0  # kernel launches: shows the render went through B3
