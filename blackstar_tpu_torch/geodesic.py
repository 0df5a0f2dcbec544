"""Batched null-geodesic marching in Schwarzschild spacetime — the plain
PyTorch reference march.

Physics per the reference (Raytracer.hs:113-134): photons follow the
pseudo-Cartesian Schwarzschild ODE

    d(vel)/dt = -1.5 · rs · h² / |pos|⁵ · pos,      d(pos)/dt = vel,

with ``h² = |pos × vel|²`` the conserved squared angular momentum computed
once per ray (Raytracer.hs:73), integrated with classic fixed-step RK4.
``mass`` is the Schwarzschild radius rs (the reference hard-codes 1).

Every ray advances in lock-step through a capped masked loop. Per-step
classification on the *pre-step* state (``findColor``, Raytracer.hs:88-102):

  1. ``r² < rs²``        -> horizon: terminal, opaque black
  2. ``r² > safe``       -> escaped: terminal, star colour looked up later
                            from the ray's frozen velocity
  3. disk-plane crossing -> blend a translucent layer front-to-back and keep
                            marching (sign(y) flip with the crossing radius²
                            linearly interpolated in y, Raytracer.hs:96-102)

Terminated rays freeze their state; the loop stops once every ray is done
or the cap is reached. This is the CPU path and the yardstick of the march
kernel (``ops/march_cuda.py``); it syncs with the device once per step.
:func:`march_checkpointed` is the same march keeping what the march adjoint
starts from: the yardstick of the march kernel's checkpointing variant.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from blackstar_tpu_torch.color import blend_over, hsi_to_rgb
from blackstar_tpu_torch.config import SceneParams, StaticConfig

# Ray status codes.
ACTIVE = 0
ESCAPED = 1
HORIZON = 2

# Adjoint checkpoints: a ray's state (px py pz vx vy vz alpha) before every
# SEG_LEN-th advancing step (kSeg in ops/csrc/march.cu and march_adjoint.cu).
SEG_LEN = 16
CKPT_VALUES = 7


def n_segments(max_steps: int) -> int:
    """Checkpoint segments of a march capped at ``max_steps``."""
    return max(1, -(-max_steps // SEG_LEN))


class StepScalars(NamedTuple):
    """The step size and the products of it that the step and its VJP use,
    each rounded once in the march's dtype on the host (Python floats that
    the dtype represents exactly), as the kernels receive them."""

    h: float
    hh: float  # h / 2
    h6: float  # h / 6
    hh6: float  # h·h / 6
    h_hh: float  # h · (h/2)
    hh_hh: float  # (h/2)²


def step_scalars(step_size: float, dtype: torch.dtype) -> StepScalars:
    h = torch.tensor(step_size, dtype=dtype)
    hh = h / 2
    return StepScalars(*(float(v) for v in (h, hh, h / 6, h * h / 6.0, h * hh, hh * hh)))


def scene_scalars(dtype: torch.dtype, mass, safe, inner, outer, opacity, disk_rgb,
                  pos0) -> list:
    """The march kernels' scene scalars as host floats in the march's
    dtype, in the order of their C interfaces: mass, safe distance, disk
    inner and outer radius, opacity, disk RGB (3,), camera position (3,).
    They cross to the host in one copy (one sync)."""
    return torch.cat([
        torch.stack([t.to(dtype) for t in (mass, safe, inner, outer, opacity)]),
        disk_rgb.to(dtype), pos0.to(dtype),
    ]).tolist()


class MarchResult(NamedTuple):
    acc_rgba: torch.Tensor  # (N, 4) front-to-back accumulated disk colour
    vel: torch.Tensor  # (N, 3) frozen velocity (escape direction for ESCAPED)
    status: torch.Tensor  # (N,) int32: ACTIVE (truncated) / ESCAPED / HORIZON
    steps: torch.Tensor  # () int32 loop iterations executed


class CheckpointedMarch(NamedTuple):
    result: MarchResult
    # (n_segments, 7, N): (px py pz vx vy vz alpha) of ray i before its
    # advancing step k = SEG_LEN·s, for every k < ray_steps[i]; zero where
    # the ray ended before step SEG_LEN·s.
    checkpoints: torch.Tensor
    ray_steps: torch.Tensor  # (N,) int32 advancing RK4 steps of each ray


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # Written out left to right, one operation per step, so the march kernel
    # (built without multiply-add contraction) rounds exactly as this does.
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # Component by component, for the same reason as _rowdot.
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def rk4_step(
    pos: torch.Tensor, vel: torch.Tensor, h, h2: torch.Tensor, mass
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One classic RK4 step of the photon ODE (Raytracer.hs:113-134).

    ``pos``/``vel`` are (..., 3); ``h2`` is (...,) per-ray conserved angular
    momentum; ``h`` the step size; ``mass`` the Schwarzschild radius rs.
    """
    coef = -1.5 * mass * h2  # (...,)

    def f(p, v):
        r2 = _rowdot(p, p)
        r5 = r2 * r2 * torch.sqrt(r2)
        acc = (coef / r5)[..., None] * p
        return acc, v  # (d vel, d pos)

    k1v, k1p = f(pos, vel)
    k2v, k2p = f(pos + (h / 2) * k1p, vel + (h / 2) * k1v)
    k3v, k3p = f(pos + (h / 2) * k2p, vel + (h / 2) * k2v)
    k4v, k4p = f(pos + h * k3p, vel + h * k3v)
    new_vel = vel + (h / 6) * (k1v + 2 * k2v + 2 * k3v + k4v)
    new_pos = pos + (h / 6) * (k1p + 2 * k2p + 2 * k3p + k4p)
    return new_pos, new_vel


def _march_step(state, *, h, h2, mass, safe, disk_on, disk_rgb, disk):
    """One masked step for all rays: RK4 + classify + composite + freeze.

    The classifier evaluates on the *pre-step* state (old position radius and
    old velocity) exactly like ``findColor`` receiving ``crd'`` before
    ``newCrd`` (Raytracer.hs:79-81, :88-102). Returns the new state and the
    mask of the rays this step advanced.
    """
    pos, vel, acc, status = state

    new_pos, new_vel = rk4_step(pos, vel, h, h2, mass)

    r2 = _rowdot(pos, pos)
    active = status == ACTIVE
    rs2 = mass * mass
    hit_horizon = active & (r2 < rs2)
    hit_escape = active & ~(r2 < rs2) & (r2 > safe)
    cont = active & ~hit_horizon & ~hit_escape

    if disk_on:
        inner2 = disk.inner * disk.inner
        outer2 = disk.outer * disk.outer
        y = pos[:, 1]
        y2 = new_pos[:, 1]
        r2n = _rowdot(new_pos, new_pos)
        sign_flip = torch.sign(y) != torch.sign(y2)
        denom = y2 - y
        denom_safe = torch.where(sign_flip, denom, torch.ones_like(denom))
        r2ave = (y2 * r2 - y * r2n) / denom_safe
        hit_disk = (
            cont
            & (disk.opacity != 0)
            & sign_flip
            & (r2ave > inner2)
            & (r2ave < outer2)
        )
        # Guard sqrt for masked rays with an in-range dummy radius.
        r2ave_safe = torch.where(hit_disk, r2ave, 0.5 * (inner2 + outer2))
        r = torch.sqrt(r2ave_safe)
        # Radial profile sin(π·((rOuter−r)/(rOuter−rInner))²) (Raytracer.hs:104-111)
        frac = (disk.outer - r) / (disk.outer - disk.inner)
        intensity = torch.sin(math.pi * frac * frac)
        layer = torch.cat(
            [disk_rgb[None, :] * intensity[:, None],
             (intensity * disk.opacity)[:, None]],
            dim=-1,
        )
        acc = torch.where(hit_disk[:, None], blend_over(acc, layer), acc)

    status = torch.where(
        hit_horizon,
        HORIZON,
        torch.where(hit_escape, ESCAPED, status),
    ).to(torch.int32)
    upd = cont[:, None]
    pos = torch.where(upd, new_pos, pos)
    vel = torch.where(upd, new_vel, vel)
    return (pos, vel, acc, status), cont


def march(
    pos0: torch.Tensor,
    vel0: torch.Tensor,
    params: SceneParams,
    static: StaticConfig,
    safe_distance: torch.Tensor,
) -> MarchResult:
    """March a batch of rays to termination.

    ``pos0``: (3,) shared camera position or (N, 3); ``vel0``: (N, 3) unit
    directions. ``safe_distance`` is the squared escape radius
    (``max(50², 2|camPos|²)``, Raytracer.hs:59-60). ``steps`` counts loop
    iterations: one more than the step at which the last ray terminated,
    or the cap.
    """
    return _march(pos0, vel0, params, static, safe_distance, False).result


def march_checkpointed(pos0: torch.Tensor, vel0: torch.Tensor, params: SceneParams,
                       static: StaticConfig, safe_distance: torch.Tensor) -> CheckpointedMarch:
    """:func:`march`, keeping each ray's checkpoints and advancing-step
    count from the same steps: what the march kernel's checkpointing
    variant writes for the adjoint (:class:`CheckpointedMarch`)."""
    return _march(pos0, vel0, params, static, safe_distance, True)


def _march(pos0, vel0, params, static, safe_distance, keep_checkpoints) -> CheckpointedMarch:
    march.calls += 1
    dt = static.tdtype
    vel0 = vel0.to(dt)
    pos0 = torch.broadcast_to(pos0.to(dt), vel0.shape)
    n = vel0.shape[0]
    dev = vel0.device

    # Conserved angular momentum per ray (Raytracer.hs:73).
    cr = _cross(pos0, vel0)
    h2 = _rowdot(cr, cr)

    disk = params.disk
    step_kw = dict(
        # A host scalar: ``h / 2`` and ``h / 6`` round by true division on
        # the host whatever the rays' device, as the march kernel's
        # wrapper evaluates them too.
        h=torch.tensor(static.step_size, dtype=dt),
        h2=h2,
        mass=params.mass.to(dt),
        safe=safe_distance.to(dt),
        disk_on=static.disk_on,
        disk_rgb=hsi_to_rgb(disk.color_hsi.to(dt)),
        disk=type(disk)(inner=disk.inner.to(dt), outer=disk.outer.to(dt),
                        opacity=disk.opacity.to(dt),
                        color_hsi=disk.color_hsi.to(dt)),
    )

    state = (pos0, vel0, torch.zeros((n, 4), dtype=dt, device=dev),
             torch.zeros((n,), dtype=torch.int32, device=dev))
    ckpt = ray_steps = None
    if keep_checkpoints:
        ckpt = torch.zeros((n_segments(static.max_steps), CKPT_VALUES, n), dtype=dt, device=dev)
        ray_steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    steps = 0
    while steps < static.max_steps and bool((state[3] == ACTIVE).any()):
        pre = state
        state, cont = _march_step(state, **step_kw)
        if keep_checkpoints:
            if steps % SEG_LEN == 0:
                vals = torch.cat([pre[0], pre[1], pre[2][:, 3:4]], dim=1).t()
                ckpt[steps // SEG_LEN] = torch.where(cont, vals, 0)
            ray_steps += cont.to(torch.int32)
        steps += 1

    pos, vel, acc, status = state
    res = MarchResult(acc_rgba=acc, vel=vel, status=status,
                      steps=torch.tensor(steps, dtype=torch.int32, device=dev))
    return CheckpointedMarch(res, ckpt, ray_steps)


march.calls = 0  # plain-path call count (march, march_checkpointed): which march a run took
