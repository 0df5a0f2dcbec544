"""Top-level rendering pipeline.

Mirrors the reference flow (Raytracer.hs:53-75 + app/Main.hs:105-123):

    rays = camera grid              (generateRay,   Raytracer.hs:40-51)
    march to termination            (colorize/rk4,  Raytracer.hs:69-134)
    celestial-sphere star shading   (starLookup,    StarMap.hs:93-115)
    composite bottom layer          (blend,         Raytracer.hs:34-37)
    supersample (optional)          (ImageFilters.hs:88-97)
    bloom (optional)                (ImageFilters.hs:80-86)

The device of the scene parameters decides the path: on a CUDA device the
march is kernel B1 and the star lookup kernel B3; on the CPU both are their
plain PyTorch versions. The kernel wrappers make that choice, nothing else.

``differentiable=True`` is the training path: the march runs through
``ops.march_diff`` (B1 forward, the adjoint B2 backward) and the stars
through ``stars.diff`` (B3 forward, the star VJP B4 backward). The camera
rays, the composite, ``supersample`` and ``safe_distance`` are plain tensor
code that autograd differentiates as it is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from blackstar_tpu_torch.camera import generate_ray_components, generate_rays_at
from blackstar_tpu_torch.config import Config, SceneParams, StaticConfig, apply_preview
from blackstar_tpu_torch.geodesic import ACTIVE, ESCAPED, HORIZON, MarchResult
from blackstar_tpu_torch.ops.filters import bloom, supersample
from blackstar_tpu_torch.ops.march_cuda import march_cuda
from blackstar_tpu_torch.ops.march_diff import march_diff
from blackstar_tpu_torch.parallel.render import GatherShards, shard_pixels
from blackstar_tpu_torch.stars.diff import lookup_diff
from blackstar_tpu_torch.stars.lookup_cuda import star_lookup_cuda


class RenderStats(NamedTuple):
    """Per-render ray statistics (0-d tensors on the render's device)."""

    steps: torch.Tensor  # () int32 — loop iterations executed
    escaped_frac: torch.Tensor  # () fraction of rays that escaped
    horizon_frac: torch.Tensor  # () fraction captured by the horizon
    truncated_frac: torch.Tensor  # () fraction still active at the step cap


def safe_distance(params: SceneParams, dtype) -> torch.Tensor:
    """``max((50·rs)², 2·|camPos|²)`` (Raytracer.hs:59-60).

    The reference hard-codes rs=1; with the mass extension the floor scales
    with rs, bitwise-identical at mass=1."""
    p = params.camera.position.to(dtype)
    rs = params.mass.to(dtype)
    return torch.maximum((50.0 * rs) ** 2, 2.0 * torch.dot(p, p))


def star_layer(res: MarchResult, params: SceneParams, star_grid, dt,
               differentiable: bool = False, width=None) -> torch.Tensor:
    """The bottom layer (N, 3): celestial-sphere stars for escaped rays,
    black for horizon-captured and step-cap-truncated rays
    (Raytracer.hs:88-95). ``width``, the frame's width when the rays are
    its pixels in row-major order, is the star kernels' layout hint (no
    result depends on it)."""
    escaped = res.status == ESCAPED
    if star_grid is None:
        return torch.zeros((res.vel.shape[0], 3), dtype=dt, device=res.vel.device)
    lookup = lookup_diff if differentiable else star_lookup_cuda
    star_rgb = lookup(
        star_grid, res.vel,
        params.stars.intensity.to(dt), params.stars.saturation.to(dt),
        escaped, width=width,
    )
    return torch.where(escaped[:, None], star_rgb, torch.zeros((), dtype=dt, device=star_rgb.device))


def composite(acc_rgba: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """The bottom layer under the accumulated disk RGBA (blend,
    Raytracer.hs:34-37)."""
    return acc_rgba[:, :3] + bottom * (1.0 - acc_rgba[:, 3:4])


def shade(res: MarchResult, params: SceneParams, star_grid, dt,
          differentiable: bool = False, width=None) -> torch.Tensor:
    """Composite the bottom layer (:func:`star_layer`) under the
    accumulated disk RGBA."""
    return composite(res.acc_rgba, star_layer(res, params, star_grid, dt, differentiable, width))


def run_march(pos0, vel0, params: SceneParams, static: StaticConfig, *,
              differentiable: bool = False) -> MarchResult:
    """March the rays: kernel B1 for rays on a CUDA device, the plain march
    for rays on the CPU (``ops.march_cuda.march_cuda`` decides); with
    ``differentiable`` through the autograd Function of ``ops.march_diff``."""
    safe = safe_distance(params, static.tdtype)
    march = march_diff if differentiable else march_cuda
    return march(pos0, vel0, params, static, safe)


def render(params: SceneParams, static: StaticConfig, star_grid=None, *, mesh=None,
           differentiable: bool = False, with_stats: bool = False):
    """Render the linear-RGB image (H, W, 3) on the parameters' device —
    before bloom, like ``Raytracer.render``. ``differentiable`` takes the
    training path (module docstring). With a ``mesh`` (``parallel.
    make_mesh``) this rank renders its shard of the rays and every rank
    returns the whole image (``parallel.render``: the deal and the gather);
    the statistics are then not available."""
    dt = static.tdtype
    rw, rh = static.render_width, static.render_height
    if mesh is None:
        pos0, vel0 = generate_ray_components(params.camera, rw, rh, dtype=dt)
    elif with_stats:
        raise ValueError("render: with_stats is not available with a mesh")
    else:
        pos0, vel0 = generate_rays_at(params.camera, shard_pixels(rh, rw, mesh), rw, rh, dtype=dt)
    res = run_march(pos0, vel0, params, static, differentiable=differentiable)
    rgb = shade(res, params, star_grid, dt, differentiable, width=rw)
    img = rgb.reshape(rh, rw, 3) if mesh is None else GatherShards.apply(rgb, mesh, rh, rw)
    if static.supersampling:
        img = supersample(img)
    if with_stats:
        stats = RenderStats(
            steps=res.steps,
            escaped_frac=(res.status == ESCAPED).float().mean(),
            horizon_frac=(res.status == HORIZON).float().mean(),
            truncated_frac=(res.status == ACTIVE).float().mean(),
        )
        return img, stats
    return img


def render_rgb(params: SceneParams, static: StaticConfig, star_grid=None) -> torch.Tensor:
    """Full pipeline including bloom (the CLI flow, app/Main.hs:105-123)."""
    img = render(params, static, star_grid)
    return bloom(img, params.bloom_strength.to(img.dtype), static.bloom_divider)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array of the same shape and dtype. A CPU tensor is
    returned as ``t.numpy()``. A CUDA tensor is copied, on its device's
    current stream, into a block of page-locked memory of its own from
    PyTorch's caching host allocator, and the call waits for that copy
    alone. The array owns its block, which goes back to the allocator's
    cache when the array dies, so later calls reuse it and never write into
    an array handed out before."""
    if t.device.type == "cpu":
        return t.numpy()
    if t.device.type != "cuda":
        raise ValueError(f"_to_host: unsupported device {t.device}")
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    done.synchronize()
    render_image.pinned_copies += 1
    return out.numpy()


def render_image(cfg: Config, star_grid=None, *, device, preview: bool = False) -> np.ndarray:
    """Config -> numpy linear RGB image rendered on ``device``, bloom
    included when the scene enables it (the reference skips the blur when
    bloomStrength == 0, app/Main.hs:113-118).

    Rendered on a CUDA device, the image reaches the host through
    :func:`_to_host`: each call returns its own array, in page-locked
    memory. A caller that keeps many frames pins that much host memory, about
    32 MB a 1080p float32 frame (the allocator's power-of-two block)."""
    base = apply_preview(cfg) if preview else cfg
    params = base.params(device)
    static = base.static()
    fn = render_rgb if base.scene.bloom_strength != 0.0 else render
    return _to_host(fn(params, static, star_grid))


render_image.pinned_copies = 0  # images copied to the host through pinned memory
