"""Port parity for the march adjoint's checkpoints, in float64 on the CPU.

The plain checkpointing march (``geodesic.march_checkpointed``, the
yardstick of the march kernel's checkpointing variant) against the pre-step
states of the JAX package's ``march_vjp.step_primal``; the plain adjoint
from checkpoints (``march_vjp.march_adjoint_from_checkpoints``, the plain
version of the adjoint kernel B2) against the port's and the JAX package's
``march_adjoint_reference``. 48 seeded rays, an 80-step cap: rays fall in,
escape, cross the disk and are truncated (at 80 advancing steps, a multiple
of the 16-step segment); a radial ray escapes at step 32, another multiple
of 16; and a case whose escape radius lies inside the camera ends every ray
at step 0."""

import functools

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
from blackstar_tpu_torch.ops.march_cuda import march_cuda

H, MAX_STEPS = 0.4, 80
POS0 = np.array([0.0, 1.0, -15.0])
R0 = float(np.linalg.norm(POS0))
RTOL = 1e-9  # the gate of tests/test_march_adjoint.py
F64 = torch.float64
# (disk opacity, squared escape radius). The radial ray moves in a straight
# line, 0.4 a step: between steps 31 and 32 it crosses r = R0 + 0.4·31.5.
CASES = {
    "disk": (0.95, (R0 + H * 31.5) ** 2),
    "no-disk": (0.0, (R0 + H * 31.5) ** 2),
    "step-0": (0.95, R0 ** 2 - 1.0),
}


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _inputs(seed=0, n=48):
    """Numpy-seeded directions around the hole, the radial outward ray last,
    and cotangents."""
    rng = np.random.default_rng(seed)
    dirs = np.array([0.0, -0.05, 1.0]) + 0.8 * rng.normal(size=(n - 1, 3))
    dirs = np.concatenate([dirs, POS0[None]])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs, rng.normal(size=(n, 4)), rng.normal(size=(n, 3))


def _jax_states(dirs, opacity, safe, rgb):
    """Pre-step (p, v, alpha) of every step of the JAX package's
    ``step_primal`` iterated from the camera, and each ray's advancing
    steps."""
    cr = np.cross(np.broadcast_to(POS0, dirs.shape), dirs)
    h2 = np.einsum("ij,ij->i", cr, cr)
    c = jv.StepConsts(h=jnp.asarray(H), coef=jnp.asarray(-1.5 * h2), rs2=jnp.asarray(1.0),
                      safe=jnp.asarray(safe), in2=jnp.asarray(1.8 ** 2),
                      out2=jnp.asarray(13.0 ** 2), mid=jnp.asarray(0.5 * (1.8 ** 2 + 13.0 ** 2)),
                      inner=jnp.asarray(1.8), outer=jnp.asarray(13.0),
                      opacity=jnp.asarray(opacity), rgb0=rgb[0], rgb1=rgb[1], rgb2=rgb[2])
    step = jax.jit(functools.partial(jv.step_primal, disk_on=opacity != 0.0))
    n = dirs.shape[0]
    p = jv.Dot3(*(jnp.full((n,), x) for x in POS0))
    v = jv.Dot3(*(jnp.asarray(dirs[:, k]) for k in range(3)))
    aa, st = jnp.zeros((n,)), jnp.zeros((n,), jnp.int32)
    states, nc = [], np.zeros(n, np.int64)
    for _ in range(MAX_STEPS):
        states.append(np.stack([*map(np.asarray, p), *map(np.asarray, v), np.asarray(aa)]))
        before = np.asarray(st) == 0
        p, v, aa, st = step(p, v, aa, st, c, jnp.asarray(True))
        nc += before & (np.asarray(st) == 0)
    return np.stack(states), nc


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    opacity, safe = CASES[request.param]
    dirs, cot_acc, cot_vel = _inputs()
    cfg = tconfig.Config.from_dict({
        "camera": {"position": POS0.tolist(), "lookAt": [0, 0, 0], "upVec": [0, 1, 0],
                   "fov": 1.5},
        "scene": {"stepSize": H, "maxSteps": MAX_STEPS, "dtype": "float64",
                  "diskOpacity": opacity, "diskInner": 1.8, "diskOuter": 13.0,
                  "diskColor": [180.0, 0.1, 1.05]}})
    params, static = cfg.params("cpu"), cfg.static()
    rgb = np.asarray(j_hsi_to_rgb(jnp.asarray(params.disk.color_hsi.numpy())))
    marched = tgeodesic.march_checkpointed(_t(POS0), _t(dirs), params, static, _t(safe))
    adj_kw = dict(h=H, max_steps=MAX_STEPS, mass=_t(1.0), inner=_t(1.8), outer=_t(13.0),
                  opacity=_t(opacity), disk_rgb=_t(rgb), safe=_t(safe),
                  disk_on=static.disk_on, cot_acc=_t(cot_acc), cot_vel=_t(cot_vel))
    return dict(name=request.param, dirs=dirs, rgb=rgb, opacity=opacity, safe=safe,
                params=params, static=static, marched=marched, adj_kw=adj_kw,
                cot=(cot_acc, cot_vel))


def test_checkpoints_match_jax_step_primal(case):
    marched, dirs = case["marched"], case["dirs"]
    nc = marched.ray_steps.numpy()
    states, want_nc = _jax_states(dirs, case["opacity"], case["safe"], case["rgb"])
    np.testing.assert_array_equal(nc, want_nc)
    ckpt = marched.checkpoints.numpy()
    assert ckpt.shape == (tgeodesic.n_segments(MAX_STEPS), 7, dirs.shape[0])
    for s in range(ckpt.shape[0]):
        reached = nc > s * tgeodesic.SEG_LEN
        np.testing.assert_allclose(ckpt[s][:, reached], states[s * tgeodesic.SEG_LEN][:, reached],
                                   rtol=RTOL, atol=1e-12, err_msg=f"segment {s}")
        assert not ckpt[s][:, ~reached].any()
    # The same steps as the plain march.
    plain = tgeodesic.march(_t(POS0), _t(dirs), case["params"], case["static"],
                            _t(case["safe"]))
    for a, b in zip(marched.result, plain):
        assert torch.equal(a, b)
    status = marched.result.status.numpy()
    if case["name"] == "step-0":
        assert not nc.any() and (status == tgeodesic.ESCAPED).all()
    else:
        assert nc[-1] == 32 and status[-1] == tgeodesic.ESCAPED
        assert {tgeodesic.ACTIVE, tgeodesic.ESCAPED, tgeodesic.HORIZON} <= set(status.tolist())
        assert (nc[status == tgeodesic.ACTIVE] == MAX_STEPS).all()
        assert (marched.result.acc_rgba[:, 3] > 0).any() == (case["opacity"] != 0.0)


def test_adjoint_from_checkpoints_matches_references(case):
    marched, kw, dirs = case["marched"], case["adj_kw"], case["dirs"]
    got = tv.march_adjoint_from_checkpoints(_t(POS0), _t(dirs), marched.checkpoints,
                                            marched.ray_steps, **kw)
    ref = tv.march_adjoint_reference(_t(POS0), _t(dirs), **kw)
    assert torch.equal(got.vel0, ref.vel0)
    assert torch.equal(got.status, ref.status)
    assert torch.equal(got.status, marched.result.status)
    for name in ("pos0", "mass", "inner", "outer", "opacity", "disk_rgb"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=1e-12,
                                   atol=1e-12 * float(getattr(ref, name).abs().max()),
                                   msg=name)

    if case["name"] != "disk":  # the JAX package's adjoint: once, on the richest case
        return
    cot_acc, cot_vel = case["cot"]
    want = jv.march_adjoint_reference(
        jnp.asarray(POS0), jnp.asarray(dirs), h=H, max_steps=MAX_STEPS,
        mass=jnp.float64(1.0), inner=jnp.float64(1.8), outer=jnp.float64(13.0),
        opacity=jnp.float64(case["opacity"]), disk_rgb=jnp.asarray(case["rgb"]),
        safe=case["safe"], disk_on=kw["disk_on"], cot_acc=jnp.asarray(cot_acc),
        cot_vel=jnp.asarray(cot_vel))
    for name, w in zip(("pos0", "vel0", "mass", "inner", "outer", "opacity", "disk_rgb"), want):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-12, err_msg=name)
    assert all(abs(float(getattr(got, k))) > 0 for k in ("inner", "outer", "opacity"))


def test_wrappers_take_checkpoints_on_cpu(case):
    """On the CPU the adjoint wrapper takes the plain adjoint from
    checkpoints when given them; the march wrapper leaves checkpoints to
    the kernel."""
    marched, kw, dirs = case["marched"], dict(case["adj_kw"]), case["dirs"]
    for k in ("h", "max_steps", "disk_on"):
        del kw[k]
    planes = tuple(_t(dirs).unbind(-1))
    calls = tv.march_adjoint_from_checkpoints.calls
    got = march_adjoint_cuda(_t(POS0), planes, static=case["static"],
                             checkpoints=marched.checkpoints, ray_steps=marched.ray_steps, **kw)
    assert tv.march_adjoint_from_checkpoints.calls == calls + 1
    assert march_adjoint_cuda.launches == 0
    want = tv.march_adjoint_from_checkpoints(_t(POS0), _t(dirs), marched.checkpoints,
                                             marched.ray_steps, **case["adj_kw"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="written by the kernel"):
        march_cuda(_t(POS0), planes, case["params"], case["static"], _t(case["safe"]),
                   checkpoints=torch.empty_like(marched.checkpoints))
