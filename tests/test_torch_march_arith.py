"""The march kernels' arithmetic and its float32 gate, on the CPU.

The march kernels B1 and B2 take their step from one header
(``ops/csrc/march_step.cuh``): r⁻⁵ by ``rsqrt`` powers in the TPU kernel's
order and explicit fused multiply-adds, where the plain march
(``geodesic.march``, held to the JAX package's march by
``test_torch_march.py``) divides and fuses nothing. So a float32 kernel is
held to the plain float64 march of the same rays no worse than the plain
float32 march is (``scripts/march_accuracy.py``). Here:

* the gate passes for the plain float32 march and fails for a march that is
  truly less accurate (its step size off by 1e-3);
* a float32 emulation of the header's step (each fused multiply-add taken
  in float64 and rounded once, rsqrt powers in the TPU kernel's order)
  passes it against the plain float64 march;
* the checkpoint and adjoint gates pass for the plain versions and fail
  for perturbed results, and the adjoint gate fails for local faults
  planted in the plain adjoint's step VJP (a stage term, the disk
  crossing's terms, the disk's outer-radius term);
* both kernel sources take their step from the header and define none of
  their own, which is what keeps B2's replay on B1's states (only the card
  can run them).
"""

import dataclasses
import math
import os
import re

import pytest
import torch

from blackstar_tpu_torch import geodesic
from blackstar_tpu_torch.color import hsi_to_rgb
from blackstar_tpu_torch.config import Config, load_config
from blackstar_tpu_torch.ops import march_adjoint_cuda, march_cuda, march_vjp
from blackstar_tpu_torch.render import safe_distance
from blackstar_tpu_torch.scripts import march_accuracy

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_CSRC = os.path.join(_ROOT, "blackstar_tpu_torch", "ops", "csrc")


def _frame(width, height, dtype, **overrides):
    """The default scene at ``width``×``height``: its parameters, static
    config, camera position and float32 ray directions."""
    from blackstar_tpu_torch.camera import generate_ray_components

    base = load_config(os.path.join(_ROOT, "scenes", "default.yaml"))
    scene = dataclasses.replace(base.scene, resolution=(width, height), dtype=dtype, **overrides)
    cfg = Config(scene=scene, camera=base.camera)
    params, static = cfg.params(torch.device("cpu")), cfg.static()
    pos0, planes = generate_ray_components(params.camera, width, height, dtype=torch.float32)
    return params, static, pos0, torch.stack(planes, dim=-1)


def _marches(width, height):
    """The plain float32 march of the default frame's rays and the plain
    float64 march of the same rays."""
    p32, s32, pos0, vel = _frame(width, height, "float32")
    p64, s64, _, _ = _frame(width, height, "float64")
    plain = geodesic.march(pos0, vel, p32, s32, safe_distance(p32, torch.float32))
    ref64 = geodesic.march(pos0.double(), vel.double(), p64, s64,
                           safe_distance(p64, torch.float64))
    return (p32, s32, pos0, vel), plain, ref64


@pytest.fixture(scope="module")
def small():
    return _marches(48, 27)


def test_gate_passes_the_plain_float32_march(small):
    _, plain, ref64 = small
    k, p, failed = march_accuracy.march_gate(plain, plain, ref64)
    assert failed == [] and k == p
    assert p.rgba_p999 > 0 and p.steps == int(ref64.steps)


def test_gate_fails_a_less_accurate_march(small):
    (params, static, pos0, vel), plain, ref64 = small
    off = dataclasses.replace(static, step_size=static.step_size * (1 + 1e-3))
    worse = geodesic.march(pos0, vel, params, off, safe_distance(params, torch.float32))
    _, _, failed = march_accuracy.march_gate(worse, plain, ref64)
    assert any(f.startswith("(c)") for f in failed), failed


def test_gate_step_count_is_anchored_on_float64(small):
    """(e): the kernel's executed step count may differ from the plain
    float32 march's by more than 2 only where it is no farther from the
    float64 march's than the plain's is (+2)."""
    _, plain, ref64 = small
    s = int(plain.steps)
    assert s == int(ref64.steps)
    off = plain._replace(steps=torch.tensor(s + 5, dtype=torch.int32))
    assert [f for f in march_accuracy.march_gate(off, plain, ref64)[2] if f.startswith("(e)")]
    # The plain float32 march 9 steps past float64 (one ray it classifies
    # otherwise), the kernel 5: closer to float64, so it passes.
    far = plain._replace(steps=torch.tensor(s + 9, dtype=torch.int32))
    assert not [f for f in march_accuracy.march_gate(off, far, ref64)[2] if f.startswith("(e)")]
    # The kernel 14 steps past float64 against the plain's 9: it fails.
    worse = plain._replace(steps=torch.tensor(s + 14, dtype=torch.int32))
    assert [f for f in march_accuracy.march_gate(worse, far, ref64)[2] if f.startswith("(e)")]


def test_quantile():
    x = torch.arange(1000, dtype=torch.float64)
    assert march_accuracy.quantile(x) == 998.0
    assert march_accuracy.quantile(x, 0.5) == 499.0
    assert march_accuracy.quantile(x[:0]) == 0.0


# ---- an emulation of march_step.cuh in float32 ---------------------------

def _fma(a, b, c):
    """A float32 fused multiply-add: the product and sum in float64, rounded
    once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _r2(x, y, z):
    return _fma(z, z, _fma(y, y, x * x))


def _accel(coef, q, r2):
    inv = torch.rsqrt(r2)
    inv2 = inv * inv
    s = coef * inv * inv2 * inv2
    return [s * c for c in q]


def _rk4_sum(h6, x, y1, y2, y3, y4):
    return _fma(h6, _fma(torch.tensor(2.0), y3, _fma(torch.tensor(2.0), y2, y1)) + y4, x)


def _emulated_march(params, static, safe, pos0, vel):
    """The float32 march as march_step.cuh takes it, all rays in lock step."""
    f32 = torch.float32
    n = vel.shape[0]
    h = torch.tensor(static.step_size, dtype=f32)
    hh, h6 = h / 2, h / 6
    mass = params.mass.to(f32)
    disk = params.disk
    inner, outer, opacity = disk.inner.to(f32), disk.outer.to(f32), disk.opacity.to(f32)
    rgb = hsi_to_rgb(disk.color_hsi.to(f32))
    p = [pos0[k].to(f32).expand(n).clone() for k in range(3)]
    v = [vel[:, k].to(f32) for k in range(3)]
    c = [p[1] * v[2] - p[2] * v[1], p[2] * v[0] - p[0] * v[2], p[0] * v[1] - p[1] * v[0]]
    coef = -1.5 * mass * (c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
    rs2, in2, out2 = mass * mass, inner * inner, outer * outer
    acc = [torch.zeros(n, dtype=f32) for _ in range(4)]
    status = torch.zeros(n, dtype=torch.int32)
    r2 = _r2(*p)
    steps = 0
    while steps < static.max_steps and bool((status == geodesic.ACTIVE).any()):
        active = status == geodesic.ACTIVE
        hit_h = active & (r2 < rs2)
        hit_e = active & ~(r2 < rs2) & (r2 > safe)
        cont = active & ~hit_h & ~hit_e
        a1 = _accel(coef, p, r2)
        q2 = [_fma(hh, v[k], p[k]) for k in range(3)]
        u2 = [_fma(hh, a1[k], v[k]) for k in range(3)]
        a2 = _accel(coef, q2, _r2(*q2))
        q3 = [_fma(hh, u2[k], p[k]) for k in range(3)]
        u3 = [_fma(hh, a2[k], v[k]) for k in range(3)]
        q4 = [_fma(h, u3[k], p[k]) for k in range(3)]
        a3 = _accel(coef, q3, _r2(*q3))
        u4 = [_fma(h, a3[k], v[k]) for k in range(3)]
        a4 = _accel(coef, q4, _r2(*q4))
        np_ = [_rk4_sum(h6, p[k], v[k], u2[k], u3[k], u4[k]) for k in range(3)]
        nv = [_rk4_sum(h6, v[k], a1[k], a2[k], a3[k], a4[k]) for k in range(3)]
        r2n = _r2(*np_)
        if static.disk_on:
            cand = (cont & (opacity != 0) & (torch.sign(p[1]) != torch.sign(np_[1]))
                    & ~(((r2 > out2) & (r2n > out2)) | ((r2 < in2) & (r2n < in2))))
            denom = torch.where(cand, np_[1] - p[1], torch.ones_like(r2))
            r2ave = (np_[1] * r2 - p[1] * r2n) / denom
            hit = cand & (r2ave > in2) & (r2ave < out2)
            r = torch.sqrt(torch.where(hit, r2ave, in2))
            frac = (outer - r) / (outer - inner)
            intensity = torch.sin(math.pi * (frac * frac).double()).float()  # sinpi, rounded once
            layer = [rgb[0] * intensity, rgb[1] * intensity, rgb[2] * intensity,
                     intensity * opacity]
            acc = [torch.where(hit, a + l * (1 - acc[3]), a) for a, l in zip(acc, layer)]
        status = torch.where(hit_h, geodesic.HORIZON,
                             torch.where(hit_e, geodesic.ESCAPED, status)).to(torch.int32)
        p = [torch.where(cont, a, b) for a, b in zip(np_, p)]
        v = [torch.where(cont, a, b) for a, b in zip(nv, v)]
        r2 = torch.where(cont, r2n, r2)
        steps += 1
    return geodesic.MarchResult(acc_rgba=torch.stack(acc, dim=-1), vel=torch.stack(v, dim=-1),
                                status=status, steps=torch.tensor(steps, dtype=torch.int32))


def test_emulated_kernel_arithmetic_passes_the_gate():
    (params, static, pos0, vel), plain, ref64 = _marches(96, 54)
    emu = _emulated_march(params, static, safe_distance(params, torch.float32), pos0, vel)
    assert not torch.equal(emu.acc_rgba, plain.acc_rgba)  # it does round otherwise
    k, p, failed = march_accuracy.march_gate(emu, plain, ref64)
    assert failed == [], (k, p, failed)
    assert k.status_mismatches == p.status_mismatches == 0


# ---- the checkpoint and adjoint gates -------------------------------------

def _checkpointed(dtype, width=24, height=14):
    params, static, pos0, vel = _frame(width, height, dtype)
    dt = static.tdtype
    return (params, static, pos0.to(dt), vel.to(dt),
            geodesic.march_checkpointed(pos0.to(dt), vel.to(dt), params, static,
                                        safe_distance(params, dt)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_checkpoint_gate(dtype):
    *_, plain = _checkpointed(dtype)
    ckpt, rsteps = plain.checkpoints.clone(), plain.ray_steps.clone()
    _, failed = march_accuracy.checkpoint_gate(ckpt, rsteps, plain)
    assert failed == []
    if dtype == "float64":
        ckpt[1, 2, 3] += 1e-5  # a written position (|z| ~ 15) off by ~7e-7 relative
    else:
        rsteps[:20] += 2  # 20 rays' counts off by 2
    _, failed = march_accuracy.checkpoint_gate(ckpt, rsteps, plain)
    assert failed, failed


def _adjoint(width, height):
    """The plain float32 and float64 adjoints of the default frame's float32
    rays, as functions of the cotangents' seed and mask."""
    params, static, pos0, vel = _frame(width, height, "float32")
    p64, s64, _, _ = _frame(width, height, "float64")

    def adjoint(dtype, seed, keep=None):
        par, st = (params, static) if dtype == torch.float32 else (p64, s64)
        ca, cv = march_accuracy.cotangents(vel.shape[0], seed, torch.float64, "cpu")
        if keep is not None:
            ca, cv = march_accuracy.masked_cotangents(ca, cv, keep)
        return march_vjp.march_adjoint_reference(
            pos0.to(dtype), vel.to(dtype), h=st.step_size, max_steps=st.max_steps,
            disk_on=st.disk_on, cot_acc=ca.to(dtype), cot_vel=cv.to(dtype),
            **march_accuracy.adjoint_args(par, st))

    return adjoint


def test_adjoint_gate():
    adjoint = _adjoint(24, 14)
    seeds = (5, 6)
    g32 = [adjoint(torch.float32, seed) for seed in seeds]
    g64 = [adjoint(torch.float64, seed) for seed in seeds]

    def rerun(i, keep):
        g = adjoint(torch.float32, seeds[i], keep)
        return g, g, adjoint(torch.float64, seeds[i], keep)

    k, p, failed = march_accuracy.adjoint_gate(list(zip(g32, g32, g64)), rerun)
    assert failed == [] and k._replace(margin=None) == p
    assert sorted(k.margin) == sorted(march_accuracy.SCALARS) and len(k.rays_over) == 2
    worse = g32[1]._replace(vel0=g32[1].vel0 * 1.01)
    runs = [(g32[0], g32[0], g64[0]), (worse, g32[1], g64[1])]
    _, _, failed = march_accuracy.adjoint_gate(runs, rerun)
    assert any(f.startswith("(b) set 1") for f in failed), failed
    worse = g32[0]._replace(status=torch.where(g32[0].status == 1, 2, g32[0].status)
                            .to(torch.int32))
    _, _, failed = march_accuracy.adjoint_gate([(worse, g32[0], g64[0])], rerun)
    assert any(f.startswith("(a) set 0") for f in failed), failed


# Local faults planted in the plain adjoint's step VJP, each as B2 could
# carry one: the clause of adjoint_gate that each must trip.

def _stage_fault(rk4_vjp):
    """The fourth RK4 stage's term h·q̄₄ dropped from the velocity cotangent."""
    def faulty(p, v, hs, coef, pbar_out, vbar_out):
        pb, vb, cb = rk4_vjp(p, v, hs, coef, pbar_out, vbar_out)
        k2 = march_vjp._accel(p + v.scale(hs.hh), coef)
        q4 = p + (v + k2.scale(hs.hh)).scale(hs.h)
        q4bar, _ = march_vjp._jtp(q4, vbar_out.scale(hs.h6), coef)
        return pb, vb + q4bar.scale(-hs.h), cb
    return faulty


def _crossing_fault(step_vjp):
    """The disk-blend VJP's terms through the crossing's position (r²,
    r²', y, y') dropped: the disk's shading gradients stay."""
    def faulty(p, v, acc_a, status, c, carry, *, disk_on, post_p=None):
        out = step_vjp(p, v, acc_a, status, c, carry, disk_on=disk_on, post_p=post_p)
        bare = step_vjp(p, v, acc_a, status, c, carry, disk_on=False, post_p=post_p)
        return out._replace(pbar=bare.pbar, vbar=bare.vbar, coef_bar=bare.coef_bar)
    return faulty


def _outer_fault(step_vjp):
    """The disk-blend VJP's term of the disk's outer radius dropped."""
    def faulty(p, v, acc_a, status, c, carry, *, disk_on, post_p=None):
        out = step_vjp(p, v, acc_a, status, c, carry, disk_on=disk_on, post_p=post_p)
        return out._replace(outer_bar=carry.outer_bar)
    return faulty


@pytest.fixture(scope="module")
def adjoint_96():
    adjoint = _adjoint(96, 54)
    return adjoint, adjoint(torch.float32, 10), adjoint(torch.float64, 10)


@pytest.mark.parametrize("target, fault, clause", [
    (None, None, None), ("rk4_vjp", _stage_fault, "(b)"),
    ("step_vjp", _crossing_fault, "(b)"), ("step_vjp", _outer_fault, "(c) outer")])
def test_adjoint_gate_catches_a_local_fault(adjoint_96, monkeypatch, target, fault, clause):
    adjoint, g32, g64 = adjoint_96

    def faulty(seed, keep=None):
        with monkeypatch.context() as m:
            if fault is not None:
                m.setattr(march_vjp, target, fault(getattr(march_vjp, target)))
            return adjoint(torch.float32, seed, keep)

    def rerun(i, keep):  # one set of cotangents: test_adjoint_gate reads two
        return (faulty(10, keep), adjoint(torch.float32, 10, keep),
                adjoint(torch.float64, 10, keep))

    k, p, failed = march_accuracy.adjoint_gate([(faulty(10), g32, g64)], rerun)
    if fault is None:
        assert failed == [], (k, p, failed)
        assert p.rays_over[0] > 0 and max(k.margin.values()) < 1
    else:
        assert any(f.startswith(clause) for f in failed), (k.line(), failed)


# ---- one step, one source --------------------------------------------------

_OWN_STEP = re.compile(r"__device__[^;{]*\b(accel|rk4_step|rk4_stages|r2_of|fma3|ray_coef)\s*\(")


@pytest.mark.parametrize("source", ["march.cu", "march_adjoint.cu"])
def test_kernels_take_their_step_from_the_header(source):
    text = open(os.path.join(_CSRC, source)).read()
    assert '#include "march_step.cuh"' in text
    assert _OWN_STEP.search(text) is None
    assert "sqrt(r2" not in text  # no r^-5 by a divide of its own
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert re.search(r"\brk4_step\s*\(", code) is not None  # the replay and B1's loop
    mod = march_cuda if source == "march.cu" else march_adjoint_cuda
    assert "-fmad=false" in mod.FLAGS


def test_header_takes_the_tpu_kernels_arithmetic():
    text = open(os.path.join(_CSRC, "march_step.cuh")).read()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "const T inv = rsqrt_of(r2);" in code
    assert "const T s = coef * inv * inv2 * inv2;" in code
    assert "__fmaf_rn" in code and "__fma_rn" in code
    assert "sinpi_of(c.frac * c.frac)" in code
