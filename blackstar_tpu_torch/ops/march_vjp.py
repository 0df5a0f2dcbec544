"""Hand-derived adjoint of the geodesic march — the plain PyTorch version
of the adjoint kernel B2 (``csrc/march_adjoint.cu``).

The port of ``blackstar_tpu/ops/march_vjp.py``: the exact reverse of the
masked march step (masks are constants, cotangents flow only through the
selected branch of every ``where``), written on ``(N,)`` component planes:

  * the RK4 VJP in the fused-stage closed form (``rk4_vjp``);
  * event masks (horizon / escape / disk) recomputed from a primal replay;
  * the front-to-back disk blend VJP (cotangents into the crossing
    geometry, the disk parameters and the running alpha);
  * the ``h² = |pos₀×vel₀|²`` chain into the camera position and the ray
    directions.

The primal replay (``rk4_fwd``, ``step_primal``) follows the forward march
kernel B1 and the plain march (``geodesic.rk4_step``) operation for
operation — ``r⁻⁵`` as ``coef / (r²·r²·√r²)``, the same tableau order, the
step's half and sixth rounded on the host — where the JAX package took
``r⁻⁵`` by ``rsqrt`` powers. So a replayed ray takes the path the forward
rendered, bit for bit, in float32 as in float64, and the gradient is the
gradient of that frame. The VJP formulas follow the JAX package's as
written. :func:`march_adjoint_reference` is the adjoint from nothing but
the march's inputs; :func:`march_adjoint_from_checkpoints` computes the same
gradients from the forward march's checkpoints, as B2 does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from blackstar_tpu_torch.geodesic import (ACTIVE, ESCAPED, HORIZON, SEG_LEN, StepScalars,
                                         step_scalars)


class Dot3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return Dot3(self.x + o.x, self.y + o.y, self.z + o.z)

    def scale(self, s):
        return Dot3(s * self.x, s * self.y, s * self.z)

    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z


def _accel(p: Dot3, coef):
    """a(p) = coef·p/|p|⁵, with |p|⁵ = r²·r²·√r² as the forward march takes it."""
    r2 = p.dot(p)
    return p.scale(coef / (r2 * r2 * torch.sqrt(r2)))


def _accel_vjp(p: Dot3, coef, abar: Dot3):
    """VJP of a(p) = coef·p·r2^{-5/2} w.r.t. (p, coef):

    p̄ = coef·r2^{-5/2}·ā − 5·coef·r2^{-7/2}·(p·ā)·p,  c̄oef = (p·ā)·r2^{-5/2}
    """
    r2 = p.dot(p)
    inv = torch.rsqrt(r2)
    inv5 = inv * (inv * inv) * (inv * inv)
    pa = p.dot(abar)
    pbar = abar.scale(coef * inv5) + p.scale(-5.0 * coef * inv5 / r2 * pa)
    return pbar, pa * inv5


def rk4_fwd(p: Dot3, v: Dot3, hs: StepScalars, coef):
    """One classic RK4 step of the photon ODE, in the forward march's
    operation order (``geodesic.rk4_step``, ``march.cu``)."""
    k1 = _accel(p, coef)
    q2 = p + v.scale(hs.hh)
    u2 = v + k1.scale(hs.hh)
    k2 = _accel(q2, coef)
    q3 = p + u2.scale(hs.hh)
    u3 = v + k2.scale(hs.hh)
    k3 = _accel(q3, coef)
    q4 = p + u3.scale(hs.h)
    u4 = v + k3.scale(hs.h)
    k4 = _accel(q4, coef)
    new_p = p + (((v + u2.scale(2.0)) + u3.scale(2.0)) + u4).scale(hs.h6)
    new_v = v + (((k1 + k2.scale(2.0)) + k3.scale(2.0)) + k4).scale(hs.h6)
    return new_p, new_v


def _jtp(q: Dot3, kbar: Dot3, coef):
    """q̄ = J(q)ᵀk̄ for J = a'(q) = s·I + c·q qᵀ (symmetric), and the
    stage's c̄oef contribution."""
    r2 = q.dot(q)
    inv = torch.rsqrt(r2)
    inv2 = inv * inv
    inv5 = inv * inv2 * inv2
    pa = q.dot(kbar)
    s = coef * inv5
    qbar = kbar.scale(s) + q.scale(-5.0 * s * inv2 * pa)
    return qbar, pa * inv5


def rk4_vjp(p: Dot3, v: Dot3, hs: StepScalars, coef, pbar_out: Dot3, vbar_out: Dot3):
    """VJP of one RK4 step, (p̄', v̄') → (p̄, v̄, c̄oef), in the fused-stage
    closed form of the JAX package's ``rk4_vjp``. With the stage velocities
    eliminated (A = (h²/6)p̄' + (h/3)v̄'):

        k̄₄ = (h/6)v̄'              q̄₄ = J₄k̄₄
        k̄₂ = A + (h²/2)q̄₄         q̄₂ = J₂k̄₂
        k̄₃ = A                     q̄₃ = J₃k̄₃
        k̄₁ = (h²/6)p̄'+(h/6)v̄'+(h²/4)q̄₃        q̄₁ = J₁k̄₁
        p̄  = p̄' + q̄₁+q̄₂+q̄₃+q̄₄
        v̄  = v̄' + h·p̄' + (h/2)(q̄₂+q̄₃) + h·q̄₄

    The stage positions are recomputed from (p, v) with the forward's
    arithmetic, so they equal the replay's.
    """
    k1 = _accel(p, coef)
    q2 = p + v.scale(hs.hh)
    u2 = v + k1.scale(hs.hh)
    k2 = _accel(q2, coef)
    q3 = p + u2.scale(hs.hh)
    u3 = v + k2.scale(hs.hh)
    q4 = p + u3.scale(hs.h)

    q4bar, cb4 = _jtp(q4, vbar_out.scale(hs.h6), coef)
    a_ = Dot3(*(hs.hh6 * pb + (2.0 * hs.h6) * vb for pb, vb in zip(pbar_out, vbar_out)))
    q2bar, cb2 = _jtp(q2, a_ + q4bar.scale(hs.h_hh), coef)
    q3bar, cb3 = _jtp(q3, a_, coef)
    k1b = a_ + vbar_out.scale(-hs.h6) + q3bar.scale(hs.hh_hh)
    q1bar, cb1 = _jtp(p, k1b, coef)

    pbar = pbar_out + q1bar + q2bar + q3bar + q4bar
    q23 = q2bar + q3bar
    vbar = Dot3(*(vo + hs.h * po + hs.hh * q + hs.h * q4
                  for vo, po, q, q4 in zip(vbar_out, pbar_out, q23, q4bar)))
    return pbar, vbar, (cb1 + cb2) + (cb3 + cb4)


class StepConsts(NamedTuple):
    """Per-march constants: 0-d tensors except the per-ray ``coef``."""

    hs: StepScalars
    coef: torch.Tensor  # (N,) = −1.5·mass·h²
    rs2: torch.Tensor
    safe: torch.Tensor
    in2: torch.Tensor
    out2: torch.Tensor
    mid: torch.Tensor
    inner: torch.Tensor
    outer: torch.Tensor
    opacity: torch.Tensor
    rgb0: torch.Tensor
    rgb1: torch.Tensor
    rgb2: torch.Tensor


class AdjointCarry(NamedTuple):
    """Reverse-sweep state: cotangents and per-ray parameter partials."""

    pbar: Dot3
    vbar: Dot3
    arbar: torch.Tensor
    agbar: torch.Tensor
    abbar: torch.Tensor
    aabar: torch.Tensor
    coef_bar: torch.Tensor
    inner_bar: torch.Tensor
    outer_bar: torch.Tensor
    opacity_bar: torch.Tensor
    rgb0_bar: torch.Tensor
    rgb1_bar: torch.Tensor
    rgb2_bar: torch.Tensor


def _step_masks(status, r2, rs2, safe):
    active = status == ACTIVE
    is_h = r2 < rs2
    is_e = r2 > safe
    return active & is_h, active & is_e & ~is_h, active & ~(is_h | is_e)


def alpha_shade(cand, r2, r2n, y, ny, acc_a, c: StepConsts):
    """Apply one (candidate-masked) disk crossing to the running alpha, in
    the forward march's operation order."""
    ds = torch.where(cand, ny - y, torch.ones_like(y))
    r2ave = (ny * r2 - y * r2n) / ds
    hit = cand & (r2ave > c.in2) & (r2ave < c.out2)
    r = torch.sqrt(torch.where(hit, r2ave, c.mid))
    frac = (c.outer - r) / (c.outer - c.inner)
    intensity = torch.sin(math.pi * frac * frac)
    return torch.where(hit, acc_a + intensity * c.opacity * (1.0 - acc_a), acc_a)


def step_primal(p: Dot3, v: Dot3, acc_a, status, c: StepConsts, *, disk_on: bool):
    """One primal march step: position, velocity, alpha and status (the RGB
    accumulators are the identity under the blend and the adjoint needs
    none of them)."""
    np_, nv = rk4_fwd(p, v, c.hs, c.coef)
    r2 = p.dot(p)
    hit_h, hit_e, cont = _step_masks(status, r2, c.rs2, c.safe)
    if disk_on:
        r2n = np_.dot(np_)
        flip = torch.sign(p.y) != torch.sign(np_.y)
        # On a sign flip the crossing radius² is a convex combination of r²
        # and r²', so a step with both ends outside the annulus cannot hit.
        may_hit = ~(((r2 > c.out2) & (r2n > c.out2)) | ((r2 < c.in2) & (r2n < c.in2)))
        cand = cont & (c.opacity != 0) & flip & may_hit
        acc_a = alpha_shade(cand, r2, r2n, p.y, np_.y, acc_a, c)
    status = status + 2 * hit_h.to(torch.int32) + hit_e.to(torch.int32)
    p = Dot3(*(torch.where(cont, a, b) for a, b in zip(np_, p)))
    v = Dot3(*(torch.where(cont, a, b) for a, b in zip(nv, v)))
    return p, v, acc_a, status


def step_vjp(p: Dot3, v: Dot3, acc_a, status, c: StepConsts, carry: AdjointCarry,
             *, disk_on: bool, post_p: Dot3 = None) -> AdjointCarry:
    """Reverse of :func:`step_primal` given the pre-step primal state.

    ``post_p``, the step's frozen post-step position (the next step's
    pre-state), skips the recomputation of the step; where the step froze
    (``cont`` false) it differs from the recomputed one, but everything
    derived from it is masked by ``cont`` or multiplied by a zero cotangent.
    """
    np_ = rk4_fwd(p, v, c.hs, c.coef)[0] if post_p is None else post_p
    r2 = p.dot(p)
    _, _, cont = _step_masks(status, r2, c.rs2, c.safe)
    zero = torch.zeros_like(p.x)

    # Reverse of p' = where(cont, np, p); v' = where(cont, nv, v).
    np_bar = Dot3(*(torch.where(cont, b, zero) for b in carry.pbar))
    pbar = Dot3(*(torch.where(cont, zero, b) for b in carry.pbar))
    nv_bar = Dot3(*(torch.where(cont, b, zero) for b in carry.vbar))
    vbar = Dot3(*(torch.where(cont, zero, b) for b in carry.vbar))
    r2_bar = zero
    aabar = carry.aabar
    ib, ob, opb = carry.inner_bar, carry.outer_bar, carry.opacity_bar
    r0b, r1b, r2b_ = carry.rgb0_bar, carry.rgb1_bar, carry.rgb2_bar

    if disk_on:
        r2n = np_.dot(np_)
        flip = torch.sign(p.y) != torch.sign(np_.y)
        ds = torch.where(flip, np_.y - p.y, torch.ones_like(p.y))
        r2ave = (np_.y * r2 - p.y * r2n) / ds
        hit = cont & (c.opacity != 0) & flip & (r2ave > c.in2) & (r2ave < c.out2)
        r = torch.sqrt(torch.where(hit, r2ave, c.mid))
        frac = (c.outer - r) / (c.outer - c.inner)
        intensity = torch.sin(math.pi * frac * frac)
        one_m = 1.0 - acc_a
        hitf = hit.to(p.x.dtype)

        rgb_dot = carry.arbar * c.rgb0 + carry.agbar * c.rgb1 + carry.abbar * c.rgb2
        # acc_c' = acc_c + hit·I·rgb_c·(1−a); acc_a' = a + hit·I·op·(1−a)
        ibar = hitf * one_m * (rgb_dot + aabar * c.opacity)
        opb = opb + hitf * aabar * intensity * one_m
        r0b = r0b + hitf * carry.arbar * intensity * one_m
        r1b = r1b + hitf * carry.agbar * intensity * one_m
        r2b_ = r2b_ + hitf * carry.abbar * intensity * one_m
        aabar = aabar * (1.0 - hitf * intensity * c.opacity) - hitf * intensity * rgb_dot

        # I = sin(π·frac²); frac = (outer − r)/(outer − inner); r = √r2ave
        frac_bar = ibar * torch.cos(math.pi * frac * frac) * (2.0 * math.pi * frac)
        denom = c.outer - c.inner
        r_bar = -frac_bar / denom
        ob = ob + frac_bar * (r - c.inner) / (denom * denom)
        ib = ib + frac_bar * frac / denom
        r2ave_bar = torch.where(hit, r_bar * 0.5 / r, zero)
        # r2ave = (y2·r2 − y·r2n)/ds, ds = y2 − y on crossing lanes
        y2_bar = r2ave_bar * (r2 - r2ave) / ds
        y_bar = r2ave_bar * (r2ave - r2n) / ds
        r2_bar = r2_bar + r2ave_bar * np_.y / ds
        r2n_bar = -r2ave_bar * p.y / ds
        np_bar = np_bar + np_.scale(2.0 * r2n_bar)
        np_bar = Dot3(np_bar.x, np_bar.y + y2_bar, np_bar.z)
        pbar = Dot3(pbar.x, pbar.y + y_bar, pbar.z)

    pbar = pbar + p.scale(2.0 * r2_bar)
    pb, vb, cb = rk4_vjp(p, v, c.hs, c.coef, np_bar, nv_bar)
    return AdjointCarry(
        pbar=pbar + pb, vbar=vbar + vb,
        arbar=carry.arbar, agbar=carry.agbar, abbar=carry.abbar, aabar=aabar,
        coef_bar=carry.coef_bar + cb,
        inner_bar=ib, outer_bar=ob, opacity_bar=opb,
        rgb0_bar=r0b, rgb1_bar=r1b, rgb2_bar=r2b_,
    )


class AdjointGrads(NamedTuple):
    """Gradients of the march outputs (acc_rgba, final vel) w.r.t. its
    inputs, and the replayed status of every ray."""

    pos0: torch.Tensor  # (3,)
    vel0: torch.Tensor  # (N, 3)
    mass: torch.Tensor  # ()
    inner: torch.Tensor  # ()
    outer: torch.Tensor  # ()
    opacity: torch.Tensor  # ()
    disk_rgb: torch.Tensor  # (3,)
    status: torch.Tensor  # (N,) int32, as the forward march classified


def _consts(p0b, v0, hs, mass, inner, outer, opacity, disk_rgb, safe):
    """The march constants of a batch of rays, and the angular-momentum
    cross product ``c = p0×v0`` with ``h² = |c|²`` that the adjoint closes."""
    cx = p0b[:, 1] * v0[:, 2] - p0b[:, 2] * v0[:, 1]
    cy = p0b[:, 2] * v0[:, 0] - p0b[:, 0] * v0[:, 2]
    cz = p0b[:, 0] * v0[:, 1] - p0b[:, 1] * v0[:, 0]
    h2 = cx * cx + cy * cy + cz * cz
    c = StepConsts(
        hs=hs, coef=-1.5 * mass * h2, rs2=mass * mass, safe=safe,
        in2=inner * inner, out2=outer * outer,
        mid=0.5 * (inner * inner + outer * outer),
        inner=inner, outer=outer, opacity=opacity,
        rgb0=disk_rgb[0], rgb1=disk_rgb[1], rgb2=disk_rgb[2],
    )
    return c, (cx, cy, cz, h2)


def _initial_carry(cot_acc, cot_vel) -> AdjointCarry:
    zero = torch.zeros_like(cot_vel[:, 0])
    return AdjointCarry(
        pbar=Dot3(zero, zero, zero), vbar=Dot3(*cot_vel.unbind(-1)),
        arbar=cot_acc[:, 0], agbar=cot_acc[:, 1], abbar=cot_acc[:, 2], aabar=cot_acc[:, 3],
        coef_bar=zero, inner_bar=zero, outer_bar=zero, opacity_bar=zero,
        rgb0_bar=zero, rgb1_bar=zero, rgb2_bar=zero,
    )


def _close(carry: AdjointCarry, p0b, v0, mass, cross):
    """Close the ``h²`` chain: per-ray vel0̄ (n, 3) and the 10 partials
    summed over the rays."""
    cx, cy, cz, h2 = cross
    # coef = −1.5·mass·h²;  h² = |p0×v0|²:  v̄0 += 2·h̄2·(c×p0), p̄0 += 2·h̄2·(v0×c)
    h2_bar = -1.5 * mass * carry.coef_bar
    v0bar = torch.stack([
        carry.vbar.x + 2.0 * h2_bar * (cy * p0b[:, 2] - cz * p0b[:, 1]),
        carry.vbar.y + 2.0 * h2_bar * (cz * p0b[:, 0] - cx * p0b[:, 2]),
        carry.vbar.z + 2.0 * h2_bar * (cx * p0b[:, 1] - cy * p0b[:, 0]),
    ], dim=-1)
    p0bar = (
        carry.pbar.x + 2.0 * h2_bar * (v0[:, 1] * cz - v0[:, 2] * cy),
        carry.pbar.y + 2.0 * h2_bar * (v0[:, 2] * cx - v0[:, 0] * cz),
        carry.pbar.z + 2.0 * h2_bar * (v0[:, 0] * cy - v0[:, 1] * cx),
    )
    partials = torch.stack([
        -1.5 * h2 * carry.coef_bar, carry.inner_bar, carry.outer_bar, carry.opacity_bar,
        carry.rgb0_bar, carry.rgb1_bar, carry.rgb2_bar, *p0bar,
    ]).sum(dim=1)
    return v0bar, partials


def _adjoint_chunk(pos0, v0, cot_acc, cot_vel, hs, max_steps, disk_on, mass, inner,
                   outer, opacity, disk_rgb, safe):
    """Adjoint of one batch of rays: per-ray vel0̄ (n, 3), the 10 per-ray
    partials summed over the batch, and the replayed status."""
    n = v0.shape[0]
    p0b = pos0.expand(n, 3)
    c, cross = _consts(p0b, v0, hs, mass, inner, outer, opacity, disk_rgb, safe)

    # Forward replay, storing every pre-step state. It stops once every ray
    # of the batch has terminated: later steps are the identity for the
    # adjoint (cont is false, no cotangent flows through them).
    state = (Dot3(*p0b.unbind(-1)), Dot3(*v0.unbind(-1)),
             torch.zeros((n,), dtype=v0.dtype, device=v0.device),
             torch.zeros((n,), dtype=torch.int32, device=v0.device))
    pres = []
    while len(pres) < max_steps and bool((state[3] == ACTIVE).any()):
        pres.append(state)
        state = step_primal(*state, c, disk_on=disk_on)
    status = state[3]

    carry = _initial_carry(cot_acc, cot_vel)
    post_p = state[0]
    for p, v, acc_a, st in reversed(pres):
        carry = step_vjp(p, v, acc_a, st, c, carry, disk_on=disk_on, post_p=post_p)
        post_p = p

    v0bar, partials = _close(carry, p0b, v0, mass, cross)
    return v0bar, partials, status


def _as_tensors(like, *values):
    return (torch.as_tensor(t, dtype=like.dtype, device=like.device) for t in values)


def march_adjoint_reference(pos0, vel0, *, h: float, max_steps: int, mass, inner, outer,
                            opacity, disk_rgb, safe, disk_on: bool, cot_acc, cot_vel,
                            chunk: int = 1 << 18) -> AdjointGrads:
    """Gradients of the march outputs (acc_rgba, final vel) w.r.t. every
    differentiable input, derived by hand — what reverse-mode autograd of
    ``geodesic.march`` computes, and what kernel B2 computes.

    ``pos0`` (3,); ``vel0`` and ``cot_vel`` (N, 3); ``cot_acc`` (N, 4);
    the scene scalars 0-d tensors and ``disk_rgb`` (3,), all on the rays'
    device (plain numbers are taken as such). Rays go in ``chunk``-sized batches, so the stored pre-step
    states (8 planes per ray and step) stay bounded.
    """
    march_adjoint_reference.calls += 1
    dt = vel0.dtype
    dev = vel0.device
    hs = step_scalars(h, dt)
    pos0, mass, inner, outer, opacity, disk_rgb, safe = _as_tensors(
        vel0, pos0, mass, inner, outer, opacity, disk_rgb, safe)
    cot_acc = cot_acc.to(dt)
    cot_vel = cot_vel.to(dt)
    n = vel0.shape[0]
    v0bars, statuses = [], []
    partials = torch.zeros((10,), dtype=dt, device=dev)
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        v0bar, part, st = _adjoint_chunk(pos0, vel0[sl], cot_acc[sl], cot_vel[sl], hs,
                                         max_steps, disk_on, mass, inner, outer, opacity,
                                         disk_rgb, safe)
        v0bars.append(v0bar)
        statuses.append(st)
        partials = partials + part
    if not v0bars:
        v0bars = [torch.zeros((0, 3), dtype=dt, device=dev)]
        statuses = [torch.zeros((0,), dtype=torch.int32, device=dev)]
    return AdjointGrads(pos0=partials[7:10], vel0=torch.cat(v0bars), mass=partials[0],
                        inner=partials[1], outer=partials[2], opacity=partials[3],
                        disk_rgb=partials[4:7], status=torch.cat(statuses))


march_adjoint_reference.calls = 0  # plain-path call count: shows which adjoint a run took


def march_adjoint_from_checkpoints(pos0, vel0, checkpoints, ray_steps, *, h: float,
                                   max_steps: int, mass, inner, outer, opacity, disk_rgb,
                                   safe, disk_on: bool, cot_acc, cot_vel) -> AdjointGrads:
    """:func:`march_adjoint_reference` computed as kernel B2 computes it:
    from the checkpoints and advancing-step counts of the forward march
    (``geodesic.march_checkpointed``, or the march kernel's checkpointing
    variant), with B2's segment boundaries.

    Segments go newest first. Each is replayed from its checkpoint, at most
    ``SEG_LEN`` steps, and reversed over the steps that advanced its rays
    (step ``SEG_LEN·s + j`` of ray i advances iff it is below
    ``ray_steps[i]``); every other step is the identity for the adjoint, so
    the per-ray gradients equal :func:`march_adjoint_reference`'s bit for
    bit. ``status`` classifies each ray's replayed final state, as the
    forward march did: truncated (ACTIVE) at ``max_steps`` advancing steps,
    else HORIZON or ESCAPED. Arguments as :func:`march_adjoint_reference`,
    plus ``checkpoints`` (n_segments, 7, N) and ``ray_steps`` (N,).
    """
    march_adjoint_from_checkpoints.calls += 1
    dt = vel0.dtype
    n = vel0.shape[0]
    pos0, mass, inner, outer, opacity, disk_rgb, safe = _as_tensors(
        vel0, pos0, mass, inner, outer, opacity, disk_rgb, safe)
    p0b = pos0.expand(n, 3)
    c, cross = _consts(p0b, vel0, step_scalars(h, dt), mass, inner, outer, opacity,
                       disk_rgb, safe)
    carry = _initial_carry(cot_acc.to(dt), cot_vel.to(dt))
    nc = ray_steps.long()
    p0, v0 = Dot3(*p0b.unbind(-1)), Dot3(*vel0.unbind(-1))
    zero = torch.zeros_like(vel0[:, 0])
    final_p = p0  # the state after a ray's last advancing step
    n_max = int(nc.max()) if n else 0
    for seg in range((n_max - 1) // SEG_LEN, -1, -1):
        start = seg * SEG_LEN
        # Rays that never reach this segment replay from the camera: any
        # finite state will do, no cotangent flows through it.
        reached = nc > start
        ck = checkpoints[seg]
        p = Dot3(*(torch.where(reached, ck[k], p0[k]) for k in range(3)))
        v = Dot3(*(torch.where(reached, ck[3 + k], v0[k]) for k in range(3)))
        acc_a = torch.where(reached, ck[6], zero)
        pres = []
        for j in range(min(SEG_LEN, n_max - start)):
            st = torch.where(nc > start + j, ACTIVE, ESCAPED).to(torch.int32)
            pres.append((p, v, acc_a, st))
            p, v, acc_a, _ = step_primal(p, v, acc_a, st, c, disk_on=disk_on)
        newest = reached & (nc <= start + SEG_LEN)
        final_p = Dot3(*(torch.where(newest, a, b) for a, b in zip(p, final_p)))
        post_p = p
        for pp, pv, pa, st in reversed(pres):
            carry = step_vjp(pp, pv, pa, st, c, carry, disk_on=disk_on, post_p=post_p)
            post_p = pp

    r2 = final_p.dot(final_p)
    status = torch.where(r2 < c.rs2, HORIZON, torch.where(r2 > c.safe, ESCAPED, ACTIVE))
    status = torch.where(nc == max_steps, ACTIVE, status).to(torch.int32)
    v0bar, partials = _close(carry, p0b, vel0, mass, cross)
    return AdjointGrads(pos0=partials[7:10], vel0=v0bar, mass=partials[0], inner=partials[1],
                        outer=partials[2], opacity=partials[3], disk_rgb=partials[4:7],
                        status=status)


march_adjoint_from_checkpoints.calls = 0  # plain-path call count
