"""Wrappers of the per-ray star lookup kernel B3 and the star VJP kernel
B4 (both in ``csrc/star_lookup.cu``, on the row walk of
``csrc/star_walk.cuh``).

B3 computes :meth:`blackstar_tpu_torch.stars.grid.StarGrid.lookup` (its
plain PyTorch twin) per ray on the card; it stands for the JAX package's
XLA star stage ``blackstar_tpu/stars/grid.py::StarGrid._lookup_block``,
which has no Pallas kernel. B4 computes :meth:`StarGrid.lookup_vjp`, the
reverse of the unclamped sums; it stands for the JAX package's
hand-derived star VJP (``StarGrid._slot_math`` gradient mode, driven by
``blackstar_tpu/stars/diff.py``). See the source's header for what bounds
them.

Each wrapper takes the plain path for rays on the CPU, launches its kernel
for rays on a CUDA device, and raises for anything else. It never falls
back from the kernel to the plain version, and on the card it reads no
value back from the device: the kernels read the intensity and saturation
there.
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

_P, _D, _I, _L = ctypes.c_void_p, ctypes.c_double, ctypes.c_int, ctypes.c_int64
# Rays, their count and the width hint, then the grid (tables, the 0-d
# intensity and saturation on the card, constants, sizes).
_GRID_ARGTYPES = [_P] * 5 + [_D] * 4 + [_I] * 5
_ARGTYPES = [_P] * 4 + [_L, _I] + _GRID_ARGTYPES + [_I, _P, _P]
_VJP_ARGTYPES = [_P] * 5 + [_L, _I] + _GRID_ARGTYPES + [_P, _P, _P]
_ENTRY = {torch.float32: "bs_star_lookup_f32", torch.float64: "bs_star_lookup_f64"}
_VJP_ENTRY = {torch.float32: "bs_star_vjp_f32", torch.float64: "bs_star_vjp_f64"}
THREADS = 128  # threads per block (kThreads in star_walk.cuh): 4 warps
WARP_TILE = (8, 4)  # the pixels a warp takes with the width hint (kTileW x kTileH)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load(SOURCE, FLAGS)
    for entries, argtypes in ((_ENTRY, _ARGTYPES), (_VJP_ENTRY, _VJP_ARGTYPES)):
        for name in entries.values():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def launch_shape(n: int, width: Optional[int] = None):
    """``(width argument, blocks)`` of a launch over ``n`` rays: the width
    hint is taken when the rays are a row-major ``width`` × ``n / width``
    frame (each warp an 8×4 pixel tile), else 0 (32 consecutive rays a
    warp). The hint decides which thread takes which ray, never a result."""
    w = int(width) if width and n and n % int(width) == 0 else 0
    if w:
        tw, th = WARP_TILE
        warps = -(-w // tw) * -(-(n // w) // th)
    else:
        warps = -(-n // 32)
    return w, -(-warps // (THREADS // 32))


def thread_rays(n: int, width: Optional[int] = None) -> torch.Tensor:
    """The ray each lane of each warp of the launch takes, ``(warps, 32)``
    int64, −1 where a lane takes none: the mirror of ``ray_of`` in
    ``csrc/star_walk.cuh``."""
    w, blocks = launch_shape(n, width)
    warp = torch.arange(blocks * (THREADS // 32))[:, None]
    lane = torch.arange(32)
    if w:
        tw, th = WARP_TILE
        tiles_x = -(-w // tw)
        x = (warp % tiles_x) * tw + lane % tw
        y = (warp // tiles_x) * th + lane // tw
        return torch.where((x < w) & (y < n // w), y * w + x, -1)
    i = warp * 32 + lane
    return torch.where(i < n, i, -1)


def _checked(grid: StarGrid, vel: torch.Tensor, active: Optional[torch.Tensor], what: str):
    """Validate the rays and the grid for a launch; returns the direction
    planes (3, N) and the (N,) bool mask."""
    dev, dt, n = vel.device, vel.dtype, vel.shape[0]
    if vel.shape != (n, 3):
        raise ValueError(f"{what}: vel must be (N, 3), got {tuple(vel.shape)}")
    if grid.dtype != dt or grid.device != dev:
        raise ValueError(f"{what}: grid is {grid.dtype} on {grid.device}, "
                         f"rays are {dt} on {dev}")
    planes = vel.t().contiguous()  # no copy for the march's plane-major output
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    if active.shape != (n,) or active.dtype != torch.bool or active.device != dev:
        raise ValueError(f"{what}: active must be an (N,) bool tensor on the rays' device")
    tables = (grid.cell_data, grid.ovf_data, grid.ovf_octets)
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tables):
        raise ValueError(f"{what}: grid tables must be contiguous and 16-byte aligned")
    return planes, active.contiguous()


def _grid_args(grid: StarGrid, dt, dev, intensity, saturation, what: str):
    """The kernels' grid arguments, and the 0-d intensity and saturation on
    the card that they point to (the caller keeps them until the launch is
    queued). Nothing here waits for the device."""
    shading = []
    for name, v in (("intensity", intensity), ("saturation", saturation)):
        if v.numel() != 1 or v.device != dev:
            raise ValueError(f"{what}: {name} must be a one-element tensor on {dev}, "
                             f"got {tuple(v.shape)} on {v.device}")
        shading.append(v.reshape(()).to(dt).contiguous())
    a, r2lim, inv2w2 = grid.psf_constants(dt)
    args = (grid.cell_data.data_ptr(), grid.ovf_data.data_ptr(), grid.ovf_octets.data_ptr(),
            shading[0].data_ptr(), shading[1].data_ptr(), a, r2lim, inv2w2,
            math.pi / grid.n_rings, grid.n_rings, grid.n_cols, grid.pad_k,
            grid.ovf_data.shape[1] // 8, int(grid.fast_cells_ok(dt)))
    return args, shading


def star_lookup_cuda(grid: StarGrid, vel: torch.Tensor, intensity: torch.Tensor,
                     saturation: torch.Tensor, active: Optional[torch.Tensor] = None,
                     clamp: bool = True, width: Optional[int] = None) -> torch.Tensor:
    """Star colour (N, 3) for ray directions ``vel`` (N, 3): kernel B3 on a
    CUDA device, :meth:`StarGrid.lookup` on the CPU. ``active`` (N,) bool
    marks the escaped rays; the others get 0. ``clamp=False`` returns the
    unclamped sums. ``width``, the frame's width when the rays are a
    row-major frame, lets each warp take an 8×4 pixel tile (fewer distinct
    table rows); it changes no result. On the card ``intensity`` and
    ``saturation`` stay there (the kernel reads them), so the call never
    waits for the device. The kernel's result is an (N, 3) view of its
    plane-major output."""
    dev = vel.device
    if dev.type == "cpu":
        return grid.lookup(vel, intensity, saturation, active, clamp=clamp)
    if dev.type != "cuda":
        raise ValueError(f"star_lookup_cuda: unsupported device {dev}")

    dt, n = vel.dtype, vel.shape[0]
    planes, active = _checked(grid, vel, active, "star_lookup_cuda")
    if not (n and grid.n_stars):
        return torch.zeros((n, 3), dtype=dt, device=dev)
    out = torch.empty((3, n), dtype=dt, device=dev)  # the kernel writes every element
    args, _shading = _grid_args(grid, dt, dev, intensity, saturation, "star_lookup_cuda")
    hint, _ = launch_shape(n, width)
    fn = getattr(build(), _ENTRY[dt])
    code = fn(planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(),
              active.data_ptr(), n, hint, *args, int(clamp), out.data_ptr(),
              _build.stream_handle(dev))
    _build.check(code, "star lookup kernel")
    star_lookup_cuda.launches += 1
    return out.t()


star_lookup_cuda.launches = 0  # kernel launches: shows the render went through B3


def star_lookup_vjp_cuda(grid: StarGrid, vel: torch.Tensor, intensity: torch.Tensor,
                         saturation: torch.Tensor, active: torch.Tensor, w: torch.Tensor,
                         width: Optional[int] = None):
    """Reverse of the unclamped lookup for the cotangents ``w`` (N, 3):
    ``(∂L/∂vel (N, 3), ∂L/∂intensity, ∂L/∂saturation)``. Kernel B4 on a
    CUDA device, :meth:`StarGrid.lookup_vjp` on the CPU; ``width`` as for
    :func:`star_lookup_cuda`. The kernel's ``vel`` gradient is an (N, 3)
    view of its plane-major output."""
    dev = vel.device
    if dev.type == "cpu":
        return grid.lookup_vjp(vel, intensity, saturation, active, w)
    if dev.type != "cuda":
        raise ValueError(f"star_lookup_vjp_cuda: unsupported device {dev}")

    dt, n = vel.dtype, vel.shape[0]
    planes, active = _checked(grid, vel, active, "star_lookup_vjp_cuda")
    if w.shape != (n, 3) or w.device != dev:
        raise ValueError(f"star_lookup_vjp_cuda: w must be (N, 3) on the rays' device, "
                         f"got {tuple(w.shape)} on {w.device}")
    zero = torch.zeros((), dtype=dt, device=dev)
    if not (n and grid.n_stars):
        return torch.zeros((n, 3), dtype=dt, device=dev), zero, zero
    wp = w.t().to(dt).contiguous()
    gvel = torch.empty((3, n), dtype=dt, device=dev)
    hint, blocks = launch_shape(n, width)
    partials = torch.empty((blocks, 2), dtype=dt, device=dev)
    args, _shading = _grid_args(grid, dt, dev, intensity, saturation, "star_lookup_vjp_cuda")
    fn = getattr(build(), _VJP_ENTRY[dt])
    code = fn(planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(),
              active.data_ptr(), wp.data_ptr(), n, hint, *args,
              gvel.data_ptr(), partials.data_ptr(), _build.stream_handle(dev))
    _build.check(code, "star VJP kernel")
    star_lookup_vjp_cuda.launches += 1
    g = partials.sum(dim=0)
    return gvel.t(), g[0], g[1]


star_lookup_vjp_cuda.launches = 0  # kernel launches: shows the backward went through B4
