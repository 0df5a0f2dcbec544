"""The plain reference renderer: the upstream semantics in plain PyTorch.

Follows flannelhead/blackstar (``src/Raytracer.hs``, ``src/StarMap.hs``,
``src/ImageFilters.hs``) as the scalar float64 description of it does:

* camera rays: ``normalize(cx·xa + cy·ya + za)`` with ``za`` towards the
  look-at point, ``xa = normalize(za × up)``, ``ya = xa × za``,
  ``cx = fov·(x/w − 0.5)``, ``cy = fov·(0.5 − y/h)·h/w`` at integer pixels;
* each ray marches the pseudo-Cartesian Schwarzschild photon ODE
  ``v' = −1.5·rs·h²·p/|p|⁵, p' = v`` (``h² = |p₀ × v₀|²``) by classic RK4
  of step ``stepSize``; before each step the ray ends at the horizon
  (``|p|² < rs²``, black) or past the escape radius
  (``|p|² > max((50·rs)², 2·|camPos|²)``, the stars in its direction);
  a step whose ``y`` changes sign with the crossing radius² (linear in
  ``y``) inside the disk blends ``sin(π·((rOut − r)/(rOut − rIn))²)``
  times the disk colour, opacity times that as alpha, under what the ray
  has gathered (front to back); a ray still marching at the step cap is
  black;
* stars (``reference.stars``), the composite, the 2×2 supersample, bloom
  (three passes of a zero-padded box blur of radius ``width // divider``,
  horizontal then vertical, added with the bloom strength) and the sRGB
  encode to 8 bits (half to even).

Every function takes its precision from its inputs, so the same code is
the float64 reference and, in bfloat16, the lower-precision control. The
march compacts the rays that are still marching every ``SEG`` steps; with
``grad`` it runs each segment under ``torch.utils.checkpoint``, so the
backward of a whole frame fits on the card. Nothing here imports the
program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.scene import Scene

SEG = 8  # steps between two compactions of the marching rays
# The scene's parameters, by the names of the program's leaves.
LEAVES = ("camera.position", "camera.look_at", "camera.up", "camera.fov", "disk.inner",
          "disk.outer", "disk.opacity", "disk.color_hsi", "stars.intensity",
          "stars.saturation", "bloom_strength", "mass")


@dataclass
class Params:
    """The scene's numbers as tensors (leaves of :data:`LEAVES`, in order)."""
    position: torch.Tensor
    look_at: torch.Tensor
    up: torch.Tensor
    fov: torch.Tensor
    disk_inner: torch.Tensor
    disk_outer: torch.Tensor
    disk_opacity: torch.Tensor
    disk_hsi: torch.Tensor
    star_intensity: torch.Tensor
    star_saturation: torch.Tensor
    bloom_strength: torch.Tensor
    mass: torch.Tensor

    def leaves(self):
        return [getattr(self, f.name) for f in fields(self)]

    @classmethod
    def from_leaves(cls, leaves):
        return cls(*leaves)


def scene_params(scene: Scene, device, dtype, requires_grad: bool = False) -> Params:
    c = scene.camera
    values = (c.position, c.look_at, c.up, c.fov, scene.disk_inner, scene.disk_outer,
              scene.disk_opacity, scene.disk_hsi, scene.star_intensity, scene.star_saturation,
              scene.bloom_strength, scene.mass)
    return Params(*(torch.tensor(v, dtype=dtype, device=device, requires_grad=requires_grad)
                    for v in values))


class Marched(NamedTuple):
    acc: torch.Tensor  # (N, 4) disk colour and alpha gathered front to back
    vel: torch.Tensor  # (N, 3) direction at the end (the stars' for escaped rays)
    status: torch.Tensor  # (N,) int8: 0 still marching at the cap, 1 escaped, 2 horizon
    steps: torch.Tensor  # (N,) int32 RK4 steps the ray advanced


def hsi_to_rgb(h, s, i):
    """HSI (hue in [0, 1)) to RGB by hue thirds, saturation and intensity
    unclamped (Graphics.ColorSpace's HSI model); stacked on a last axis."""
    third = 2.0 * math.pi / 3.0
    hp = h * (2.0 * math.pi)
    sector = torch.clamp(torch.floor(hp / third), 0, 2)
    a = hp - sector * third
    is_ = i * s
    lo = i - is_
    first = i + is_ * torch.cos(a) / torch.cos(math.pi / 3.0 - a)
    last = 2.0 * i + is_ - first
    pick = lambda a0, a1, a2: torch.where(sector == 0, a0, torch.where(sector == 1, a1, a2))
    return torch.stack([pick(first, lo, last), pick(last, first, lo), pick(lo, last, first)],
                       dim=-1)


def _normalize(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def camera_rays(p: Params, width: int, height: int) -> torch.Tensor:
    """Unit directions (H·W, 3) of the pixels in row-major order."""
    za = _normalize(p.look_at - p.position)
    xa = _normalize(torch.linalg.cross(za, p.up))
    ya = torch.linalg.cross(xa, za)
    dt, dev = p.position.dtype, p.position.device
    xs = torch.arange(width, dtype=torch.float64, device=dev) / width - 0.5
    ys = 0.5 - torch.arange(height, dtype=torch.float64, device=dev) / height
    cx = p.fov * xs.to(dt)
    cy = p.fov * ys.to(dt) * (height / width)
    d = cx[None, :, None] * xa + cy[:, None, None] * ya + za
    return _normalize(d).reshape(height * width, 3)


def _rk4(pos, vel, coef, h):
    def accel(q):
        r2 = (q * q).sum(-1)
        return (coef / (r2 * r2 * torch.sqrt(r2)))[:, None] * q

    k1v, k1p = accel(pos), vel
    k2v, k2p = accel(pos + (h / 2) * k1p), vel + (h / 2) * k1v
    k3v, k3p = accel(pos + (h / 2) * k2p), vel + (h / 2) * k2v
    k4v, k4p = accel(pos + h * k3p), vel + h * k3v
    return (pos + (h / 6) * (k1p + 2 * k2p + 2 * k3p + k4p),
            vel + (h / 6) * (k1v + 2 * k2v + 2 * k3v + k4v))


def march_step(pos, vel, acc, status, nsteps, coef, *, h, rs2, safe, disk):
    """One step of every ray, decided on the state before it: the ray ends
    at the horizon or past the escape radius, else advances by RK4 and,
    when the step crosses the disk plane inside the disk, blends the disk
    under what it has gathered. Ended rays keep their state."""
    r2 = (pos * pos).sum(-1)
    active = status == 0
    horizon = active & (r2 < rs2)
    escaped = active & ~horizon & (r2 > safe)
    cont = active & ~horizon & ~escaped
    new_pos, new_vel = _rk4(pos, vel, coef, h)
    if disk is not None:
        inner, outer, opacity, rgb = disk
        y0, y1 = pos[:, 1], new_pos[:, 1]
        r2n = (new_pos * new_pos).sum(-1)
        cross = torch.sign(y0) != torch.sign(y1)
        denom = torch.where(cross, y1 - y0, torch.ones_like(y0))
        r2ave = (y1 * r2 - y0 * r2n) / denom
        hit = cont & cross & (r2ave > inner * inner) & (r2ave < outer * outer)
        r = torch.sqrt(torch.where(hit, r2ave, 0.5 * (inner * inner + outer * outer)))
        frac = (outer - r) / (outer - inner)
        k = torch.sin(math.pi * frac * frac)
        layer = torch.cat([rgb * k[:, None], (k * opacity)[:, None]], dim=-1)
        acc = torch.where(hit[:, None], acc + layer * (1.0 - acc[:, 3:4]), acc)
    status = torch.where(horizon, 2, torch.where(escaped, 1, status)).to(status.dtype)
    keep = cont[:, None]
    return (torch.where(keep, new_pos, pos), torch.where(keep, new_vel, vel), acc, status,
            nsteps + cont.to(nsteps.dtype))


def _segment(k, kw, pos, vel, acc, status, nsteps, coef):
    for _ in range(k):
        pos, vel, acc, status, nsteps = march_step(pos, vel, acc, status, nsteps, coef, **kw)
    return pos, vel, acc, status, nsteps


def march(p: Params, dirs: torch.Tensor, *, step: float, cap: int, disk_on: bool,
          grad: bool = False) -> Marched:
    """March every ray of ``dirs`` (N, 3) from the camera to its end or the
    step cap."""
    n, dt, dev = dirs.shape[0], dirs.dtype, dirs.device
    pos = p.position.expand(n, 3)
    vel = dirs
    cr = torch.linalg.cross(pos, vel)
    coef = -1.5 * p.mass * (cr * cr).sum(-1)
    mass = p.mass.detach()
    kw = dict(h=step, rs2=mass * mass,
              safe=torch.maximum((50.0 * mass) ** 2,
                                 2.0 * (p.position.detach() ** 2).sum()),
              disk=((p.disk_inner, p.disk_outer, p.disk_opacity, hsi_to_rgb(*p.disk_hsi))
                    if disk_on else None))
    idx = torch.arange(n, device=dev)
    acc = torch.zeros((n, 4), dtype=dt, device=dev)
    status = torch.zeros((n,), dtype=torch.int8, device=dev)
    nsteps = torch.zeros((n,), dtype=torch.int32, device=dev)
    parts = []
    done = 0
    while idx.numel():
        k = min(SEG, cap - done)
        if k > 0:
            args = (pos, vel, acc, status, nsteps, coef)
            if grad:
                pos, vel, acc, status, nsteps = checkpoint(_segment, k, kw, *args,
                                                           use_reentrant=False)
            else:
                pos, vel, acc, status, nsteps = _segment(k, kw, *args)
            done += k
        fin = status != 0 if done < cap else torch.ones_like(status, dtype=torch.bool)
        ended = torch.nonzero(fin).squeeze(1)
        if ended.numel():
            parts.append((idx[ended], acc[ended], vel[ended], status[ended], nsteps[ended]))
        left = torch.nonzero(~fin).squeeze(1)
        idx, pos, vel, acc, status, nsteps, coef = (
            t[left] for t in (idx, pos, vel, acc, status, nsteps, coef))
    order = torch.cat([q[0] for q in parts])
    out = [torch.cat([q[j] for q in parts]) for j in range(1, 5)]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    return Marched(*(t[inv] for t in out))


def shade(p: Params, m: Marched, sky) -> torch.Tensor:
    """Linear RGB (N, 3): the stars under the disk for escaped rays, black
    under it for the rest."""
    escaped = m.status == 1
    bottom = torch.zeros_like(m.vel)
    if sky is not None:
        ids = torch.nonzero(escaped).squeeze(1)
        stars = sky.lookup(m.vel[ids], p.star_intensity, p.star_saturation)
        bottom = bottom.index_copy(0, ids, stars)
    return m.acc[:, :3] + bottom * (1.0 - m.acc[:, 3:4])


def supersample(img: torch.Tensor) -> torch.Tensor:
    h, w, c = img.shape
    return img.reshape(h // 2, 2, w // 2, 2, c).mean(dim=(1, 3))


def box_blur(img: torch.Tensor, r: int, passes: int = 3) -> torch.Tensor:
    """Zero-padded box blur of width ``2r + 1``, each pass horizontal then
    vertical, of an (H, W, C) image."""
    if r <= 0:
        return img
    x = img.permute(0, 2, 1)  # (H, C, W)
    for _ in range(passes):
        x = F.avg_pool1d(x, 2 * r + 1, stride=1, padding=r, count_include_pad=True)
        x = F.avg_pool1d(x.permute(2, 1, 0), 2 * r + 1, stride=1, padding=r,
                         count_include_pad=True).permute(2, 1, 0)
    return x.permute(0, 2, 1)


def bloom(img: torch.Tensor, strength, divider: int) -> torch.Tensor:
    return img + strength * box_blur(img, img.shape[1] // divider)


def render_linear(scene: Scene, p: Params, sky, *, cap: int, grad: bool = False,
                  with_bloom: bool = True):
    """The frame's linear RGB (H, W, 3) at the precision of ``p``; with
    ``with_bloom`` the scene's bloom is applied when its strength is not 0.
    Returns the image and the rays' march."""
    rw, rh = scene.render_size
    m = march(p, camera_rays(p, rw, rh), step=scene.step, cap=cap,
              disk_on=scene.disk_opacity != 0.0, grad=grad)
    img = shade(p, m, sky).reshape(rh, rw, 3)
    if scene.supersampling:
        img = supersample(img)
    if with_bloom and scene.bloom_strength != 0.0:
        img = bloom(img, p.bloom_strength, scene.bloom_divider)
    return img, m


def srgb8(linear: torch.Tensor) -> torch.Tensor:
    """sRGB gamma, clamped to [0, 1], to 8 bits rounding half to even."""
    x = linear.double()
    s = torch.where(x < 0.0031308, 12.92 * x,
                    1.055 * torch.clamp(x, min=0.0031308) ** (1.0 / 2.4) - 0.055)
    return torch.round(torch.clamp(s, 0.0, 1.0) * 255.0).to(torch.uint8)
