"""Pinhole camera / sight-ray generation.

Reference semantics: ``generateRay`` (Raytracer.hs:40-51) builds the 3×3
rotation of `linear`'s ``lookAt`` view matrix, transposes it, and applies it
to the direction ``(fov·(x/w − 0.5), fov·(0.5 − y/h)·h/w, −1)``, normalised.
Pixel coordinates are the raw integer indices (no half-pixel centring), in
row-major ``(y, x)`` order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from blackstar_tpu_torch.config import CameraParams


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _film_coords(fov, xs, ys, width, height):
    """Film-plane offsets for pixel coordinates (Raytracer.hs:48-50):
    cx = fov·(x/w − 0.5), cy = fov·(0.5 − y/h)·h/w."""
    w = torch.tensor(width, dtype=xs.dtype, device=xs.device)
    h = torch.tensor(height, dtype=xs.dtype, device=xs.device)
    cx = fov * (xs / w - 0.5)
    cy = fov * (0.5 - ys / h) * h / w
    return cx, cy


def look_at_rotation(position: torch.Tensor, look_at: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Rows (xa, ya, −za) of the `linear` ``lookAt`` matrix (Raytracer.hs:46).

    za = normalize(center − eye); xa = normalize(za × up); ya = xa × za.
    """
    za = _normalize(look_at - position)
    xa = _normalize(torch.linalg.cross(za, up))
    ya = torch.linalg.cross(xa, za)
    return torch.stack([xa, ya, -za], dim=0)


def _camera_basis(cam: CameraParams, dtype):
    """The camera position, fov and rotation rows at ``dtype``."""
    pos = cam.position.to(dtype)
    fov = cam.fov.to(dtype)
    rot = look_at_rotation(cam.position, cam.look_at, cam.up).to(dtype)
    return pos, fov, rot


def _setup(cam: CameraParams, width: int, height: int, dtype):
    dev = cam.position.device
    pos, fov, rot = _camera_basis(cam, dtype)
    xs = torch.arange(width, dtype=dtype, device=dev)
    ys = torch.arange(height, dtype=dtype, device=dev)
    cx, cy = _film_coords(fov, xs, ys, width, height)
    return pos, rot, cx, cy


def generate_rays(
    cam: CameraParams, width: int, height: int, dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial photon states for every pixel: ``(pos, vel)`` with shapes
    ((3,), (H·W, 3)), the shared camera position and unit ray directions in
    row-major (y, x) pixel order, on the camera parameters' device."""
    pos, rot, cx, cy = _setup(cam, width, height, dtype)
    # vel = normalize(transpose(rot) @ (cx, cy, -1)) = cx·xa + cy·ya + za
    xa, ya, nza = rot[0], rot[1], rot[2]  # nza = -za
    dirs = (
        cx[None, :, None] * xa[None, None, :]
        + cy[:, None, None] * ya[None, None, :]
        - nza[None, None, :]
    )  # (H, W, 3)
    return pos, _normalize(dirs).reshape(height * width, 3)


def generate_ray_components(
    cam: CameraParams, width: int, height: int, dtype=torch.float32
):
    """Like :func:`generate_rays` but returns ``(pos, (vx, vy, vz))`` with
    three contiguous flat (H·W,) direction planes — the layout the march
    kernel reads."""
    pos, rot, cx, cy = _setup(cam, width, height, dtype)
    planes = _direction_planes(rot, cx[None, :], cy[:, None])  # (1, W) and (H, 1)
    n = height * width
    return pos, tuple(p.reshape(n) for p in planes)


def _direction_planes(rot, cx, cy):
    """Unit ray directions ``(dx, dy, dz)`` of film offsets ``cx``, ``cy``
    (broadcast against each other), normalised by ``rsqrt`` of the summed
    squares: one elementwise arithmetic for every caller, so a ray's bits do
    not depend on which of them made it."""
    xa, ya, nza = rot[0], rot[1], rot[2]
    dx = cx * xa[0] + cy * ya[0] - nza[0]
    dy = cx * xa[1] + cy * ya[1] - nza[1]
    dz = cx * xa[2] + cy * ya[2] - nza[2]
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv, dy * inv, dz * inv


def generate_rays_at(cam: CameraParams, pixel_ids: torch.Tensor, width: int, height: int,
                     dtype=torch.float32):
    """Like :func:`generate_ray_components` for a subset of the pixels:
    ``(pos, (vx, vy, vz))`` with three (N,) planes for the flat row-major
    pixel ids ``pixel_ids`` (N,) of a ``width`` × ``height`` frame, on the
    camera parameters' device. Each ray equals, bit for bit, the one
    :func:`generate_ray_components` makes for its pixel (the same
    elementwise arithmetic), so a sharded frame equals the unsharded one.
    The sharded renderer makes each rank's rays with it from the replicated
    camera, so no ray crosses between ranks."""
    pos, fov, rot = _camera_basis(cam, dtype)
    ids = pixel_ids.to(device=cam.position.device, dtype=torch.int64)
    xs = (ids % width).to(dtype)
    ys = (ids // width).to(dtype)
    cx, cy = _film_coords(fov, xs, ys, width, height)
    return pos, _direction_planes(rot, cx, cy)
