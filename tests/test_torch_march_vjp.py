"""Port parity: the hand-derived march adjoint (``ops/march_vjp.py``, the
plain version of kernel B2) against the JAX package's ``march_vjp`` in
float64 on the CPU, at 48 rays × 50 steps with the disk on and off as
``tests/test_march_adjoint.py`` sets them up; and the march autograd
Function (``ops/march_diff.py``) on the CPU against ``torch.autograd``
through the port's plain ``geodesic.march``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackstar_tpu.color import hsi_to_rgb as j_hsi_to_rgb
from blackstar_tpu.ops import march_vjp as jv
from blackstar_tpu_torch import config as tconfig
from blackstar_tpu_torch import geodesic as tgeodesic
from blackstar_tpu_torch.ops import march_vjp as tv
from blackstar_tpu_torch.ops.march_adjoint_cuda import march_adjoint_cuda
from blackstar_tpu_torch.ops.march_diff import march_diff

H, MAX_STEPS, SAFE = 0.3, 50, 2500.0
RTOL = 1e-9  # the gate of tests/test_march_adjoint.py
F64 = torch.float64
DISK = dict(mass=1.0, inner=1.8, outer=13.0, color_hsi=(0.5, 0.1, 1.05))


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _rays(n=48, seed=0):
    """Directions biased toward the hole so that rays cross the disk, with
    the cotangents, from a numpy seed (``tests/test_march_adjoint.py``)."""
    rng = np.random.default_rng(seed)
    dirs = np.array([0.0, -0.05, 1.0]) + 0.25 * rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs, rng.normal(size=(n, 4)), rng.normal(size=(n, 3))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=1e-12,
                               err_msg=what)


def test_rk4_and_accel_vjp_match_jax():
    rng = np.random.default_rng(1)
    n = 64
    pos = rng.uniform(-10, 10, (n, 3))
    vel = rng.normal(size=(n, 3))
    coef = -1.5 * 1.1 * np.einsum("ij,ij->i", np.cross(pos, vel), np.cross(pos, vel))
    pbo, vbo = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    jd = lambda a: jv.Dot3(*(jnp.asarray(a[:, k]) for k in range(3)))
    td = lambda a: tv.Dot3(*(_t(a[:, k]) for k in range(3)))
    hs = tv.step_scalars(H, F64)

    want_p, want_v = jv.rk4_fwd(jd(pos), jd(vel), H, jnp.asarray(coef))
    got_p, got_v = tv.rk4_fwd(td(pos), td(vel), hs, _t(coef))
    for g, w in zip(got_p + got_v, want_p + want_v):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13)

    want = jv.rk4_vjp(jd(pos), jd(vel), H, jnp.asarray(coef), jd(pbo), jd(vbo))
    got = tv.rk4_vjp(td(pos), td(vel), hs, _t(coef), td(pbo), td(vbo))
    for g, w, what in zip((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]),
                          ("p.x", "p.y", "p.z", "v.x", "v.y", "v.z", "coef")):
        _close(g.numpy(), w, what)

    want = jv._accel_vjp(jd(pos), jnp.asarray(coef), jd(pbo))
    got = tv._accel_vjp(td(pos), _t(coef), td(pbo))
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        _close(g.numpy(), w, "accel vjp")


def _consts(pos0, vel0, disk_opacity):
    """The same per-march constants for both packages."""
    cr = np.cross(np.broadcast_to(pos0, vel0.shape), vel0)
    h2 = np.einsum("ij,ij->i", cr, cr)
    d = DISK
    rgb = np.asarray(j_hsi_to_rgb(jnp.asarray(d["color_hsi"])))
    vals = dict(coef=-1.5 * d["mass"] * h2, rs2=d["mass"] ** 2, safe=SAFE,
                in2=d["inner"] ** 2, out2=d["outer"] ** 2,
                mid=0.5 * (d["inner"] ** 2 + d["outer"] ** 2), inner=d["inner"],
                outer=d["outer"], opacity=disk_opacity, rgb0=rgb[0], rgb1=rgb[1], rgb2=rgb[2])
    jc = jv.StepConsts(h=jnp.asarray(H), **{k: jnp.asarray(v) for k, v in vals.items()})
    tc = tv.StepConsts(hs=tv.step_scalars(H, F64), **{k: _t(v) for k, v in vals.items()})
    return jc, tc


@pytest.mark.parametrize("disk_opacity", [0.95, 0.0], ids=["disk", "no-disk"])
def test_step_vjp_matches_jax(disk_opacity):
    """``step_vjp`` on every pre-step state of a 50-step replay, with random
    carries, against the JAX function; the replay crosses the disk."""
    dirs, _, _ = _rays()
    pos0 = np.array([0.0, 1.0, -20.0])
    jc, tc = _consts(pos0, dirs, disk_opacity)
    disk_on = disk_opacity != 0.0
    n = dirs.shape[0]
    rng = np.random.default_rng(5)
    p = tv.Dot3(*(_t(np.full(n, c)) for c in pos0))
    v = tv.Dot3(*(_t(dirs[:, k]) for k in range(3)))
    aa, st = _t(np.zeros(n)), torch.zeros(n, dtype=torch.int32)
    hits = 0
    for _ in range(MAX_STEPS):
        carry = [rng.normal(size=n) for _ in range(17)]
        jcarry = jv.AdjointCarry(jv.Dot3(*map(jnp.asarray, carry[:3])),
                                 jv.Dot3(*map(jnp.asarray, carry[3:6])),
                                 *map(jnp.asarray, carry[6:]))
        tcarry = tv.AdjointCarry(tv.Dot3(*map(_t, carry[:3])), tv.Dot3(*map(_t, carry[3:6])),
                                 *map(_t, carry[6:]))
        want = jv.step_vjp(jv.Dot3(*(jnp.asarray(c.numpy()) for c in p)),
                           jv.Dot3(*(jnp.asarray(c.numpy()) for c in v)),
                           jnp.asarray(aa.numpy()), jnp.asarray(st.numpy()), jc,
                           jnp.asarray(True), jcarry, disk_on=disk_on)
        got = tv.step_vjp(p, v, aa, st, tc, tcarry, disk_on=disk_on)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            _close(g.numpy(), w, "step_vjp")
        hits += int((np.asarray(want.rgb0_bar) != carry[14]).sum())
        p, v, aa_new, st = tv.step_primal(p, v, aa, st, tc, disk_on=disk_on)
        aa = aa_new
    assert (hits > 0) == disk_on


@pytest.fixture(scope="module", params=[0.95, 0.0], ids=["disk", "no-disk"])
def adjoint(request):
    disk_opacity = request.param
    dirs, cot_acc, cot_vel = _rays()
    pos0 = np.array([0.0, 1.0, -20.0])
    d = DISK
    rgb = j_hsi_to_rgb(jnp.asarray(d["color_hsi"]))
    kw = dict(h=H, max_steps=MAX_STEPS, safe=SAFE, disk_on=disk_opacity != 0.0)
    want = jv.march_adjoint_reference(
        jnp.asarray(pos0), jnp.asarray(dirs), mass=jnp.float64(d["mass"]),
        inner=jnp.float64(d["inner"]), outer=jnp.float64(d["outer"]),
        opacity=jnp.float64(disk_opacity), disk_rgb=rgb, cot_acc=jnp.asarray(cot_acc),
        cot_vel=jnp.asarray(cot_vel), **kw)
    targs = dict(mass=_t(d["mass"]), inner=_t(d["inner"]), outer=_t(d["outer"]),
                 opacity=_t(disk_opacity), disk_rgb=_t(rgb), cot_acc=_t(cot_acc),
                 cot_vel=_t(cot_vel))
    got = tv.march_adjoint_reference(_t(pos0), _t(dirs), **targs, **kw)
    return want, got, (pos0, dirs, targs, kw)


def test_march_adjoint_reference_matches_jax(adjoint):
    want, got, _ = adjoint
    names = ("pos0", "vel0", "mass", "inner", "outer", "opacity", "disk_rgb")
    for name, w in zip(names, want):
        _close(getattr(got, name).numpy(), w, name)
    if float(want[5]) != 0.0:  # disk on: the disk gradients are live
        assert all(abs(float(getattr(got, k))) > 0 for k in ("inner", "outer", "opacity"))


def test_adjoint_chunks_agree(adjoint):
    """Chunking bounds memory only: any chunk size gives the same gradients."""
    _, got, (pos0, dirs, targs, kw) = adjoint
    chunked = tv.march_adjoint_reference(_t(pos0), _t(dirs), **targs, **kw, chunk=7)
    for a, b in zip(chunked, got):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-13)


def test_adjoint_wrapper_takes_plain_path_on_cpu(adjoint):
    _, got, (pos0, dirs, targs, kw) = adjoint
    cfg = tconfig.Config.from_dict({
        "camera": {"position": pos0.tolist(), "lookAt": [0, 0, 0], "upVec": [0, 1, 0],
                   "fov": 1.5},
        "scene": {"stepSize": H, "maxSteps": MAX_STEPS, "dtype": "float64",
                  "diskOpacity": float(targs["opacity"])}})
    calls = tv.march_adjoint_reference.calls
    res = march_adjoint_cuda(_t(pos0), tuple(_t(dirs).unbind(-1)), targs["cot_acc"],
                             targs["cot_vel"], mass=targs["mass"], inner=targs["inner"],
                             outer=targs["outer"], opacity=targs["opacity"],
                             disk_rgb=targs["disk_rgb"], safe=_t(SAFE), static=cfg.static())
    assert march_adjoint_cuda.launches == 0
    assert tv.march_adjoint_reference.calls == calls + 1
    for a, b in zip(res, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        march_adjoint_cuda(_t(pos0), _t(dirs).to("meta"), targs["cot_acc"], targs["cot_vel"],
                           mass=targs["mass"], inner=targs["inner"], outer=targs["outer"],
                           opacity=targs["opacity"], disk_rgb=targs["disk_rgb"],
                           safe=_t(SAFE), static=cfg.static())


@pytest.mark.parametrize("max_steps", [50, 250], ids=["truncated", "terminating"])
def test_march_diff_matches_autograd_of_plain_march(max_steps):
    """The Function's gradients w.r.t. every input leaf equal autograd's
    through the plain march; 250 steps lets rays escape and fall in."""
    cfg = tconfig.Config.from_dict({
        "camera": {"position": [0, 1, -20], "lookAt": [0, 0, 0], "upVec": [0, 1, 0],
                   "fov": 1.5},
        "scene": {"stepSize": H, "maxSteps": max_steps, "dtype": "float64",
                  "diskOpacity": 0.95, "diskInner": 1.8, "diskOuter": 13.0,
                  "diskColor": [180.0, 0.1, 1.05]}})
    static = cfg.static()
    dirs, cot_acc, cot_vel = _rays()

    def grads(march):
        p = cfg.params("cpu")
        leaves = [p.camera.position, p.mass, p.disk.inner, p.disk.outer, p.disk.opacity,
                  p.disk.color_hsi]
        for leaf in leaves:
            leaf.requires_grad_(True)
        vel = _t(dirs).requires_grad_(True)
        safe = _t(SAFE)
        res = march(p.camera.position, vel, p, static, safe)
        loss = (res.acc_rgba * _t(cot_acc)).sum() + (res.vel * _t(cot_vel)).sum()
        return res, torch.autograd.grad(loss, [vel] + leaves)

    want_res, want = grads(tgeodesic.march)
    got_res, got = grads(march_diff)
    assert not got_res.status.requires_grad and not got_res.steps.requires_grad
    assert got_res.acc_rgba.requires_grad and got_res.vel.requires_grad
    assert torch.equal(got_res.status, want_res.status)
    statuses = set(want_res.status.tolist())
    assert statuses == ({0} if max_steps == 50 else {1, 2})
    for g, w, what in zip(got, want, ("vel0", "pos0", "mass", "inner", "outer", "opacity",
                                      "color_hsi")):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= RTOL * scale, what
