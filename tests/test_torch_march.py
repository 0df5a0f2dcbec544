"""Port parity: the plain PyTorch march against the JAX package's
``geodesic.march`` (XLA while_loop path) in float64 on the CPU, and the
march-kernel wrapper's CPU dispatch."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from blackstar_tpu import camera as jcamera
from blackstar_tpu import config as jconfig
from blackstar_tpu import geodesic as jgeodesic
from blackstar_tpu.render import safe_distance as j_safe_distance
from blackstar_tpu_torch import config as tconfig
from blackstar_tpu_torch import geodesic as tgeodesic
from blackstar_tpu_torch.ops.march_cuda import march_cuda
from blackstar_tpu_torch.render import safe_distance as t_safe_distance

_DEFAULT = os.path.join(os.path.dirname(__file__), "..", "scenes", "default.yaml")

# (scene overrides, expect truncation): disk on and off, a heavier hole, and
# a cap that cuts rays off mid-flight.
CASES = {
    "disk": (dict(), False),
    "no-disk": (dict(disk_opacity=0.0), False),
    "mass-1.7": (dict(mass=1.7), False),
    "capped": (dict(max_steps=40), True),
}


def _inputs(overrides, seed=0):
    """A ragged 15×7 frame of camera rays plus numpy-seeded random unit
    directions, for both packages; parameters made by the JAX package and
    carried across as numpy leaves."""
    base = jconfig.load_config(_DEFAULT)
    scene = dataclasses.replace(base.scene, resolution=(15, 7), dtype="float64",
                                **overrides)
    cfg = jconfig.Config(scene=scene, camera=base.camera)
    jp = cfg.params()
    _, vel = jcamera.generate_rays(jp.camera, 15, 7, dtype=np.float64)
    rng = np.random.default_rng(seed)
    extra = rng.normal(size=(40, 3))
    extra /= np.linalg.norm(extra, axis=-1, keepdims=True)
    vel = np.concatenate([np.asarray(vel), extra])
    tp = tconfig.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp, vel


@pytest.fixture(scope="module", params=sorted(CASES))
def marched(request):
    overrides, truncates = CASES[request.param]
    cfg, jp, tp, vel = _inputs(overrides)
    js = cfg.static()
    ts = tconfig.static_config(tconfig.Config.from_dict(cfg.to_dict()))
    pos0 = np.asarray(cfg.camera.position, np.float64)
    want = jgeodesic.march(pos0, vel, jp, js, j_safe_distance(jp, np.float64))
    got = tgeodesic.march(torch.from_numpy(pos0), torch.from_numpy(vel), tp, ts,
                          t_safe_distance(tp, torch.float64))
    return want, got, truncates, (pos0, vel, tp, ts)


def test_plain_march_matches_jax(marched):
    want, got, truncates, _ = marched
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    assert int(got.steps) == int(want.steps)
    assert got.steps.dtype == torch.int32
    np.testing.assert_allclose(got.acc_rgba.numpy(), np.asarray(want.acc_rgba), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), rtol=0, atol=1e-8)
    statuses = set(np.asarray(want.status).tolist())
    assert (tgeodesic.ACTIVE in statuses) == truncates
    assert {tgeodesic.ESCAPED, tgeodesic.HORIZON} <= statuses or truncates


def test_march_wrapper_takes_plain_path_on_cpu(marched):
    _, got, _, (pos0, vel, tp, ts) = marched
    launches = march_cuda.launches
    calls = tgeodesic.march.calls
    v = torch.from_numpy(vel)
    res = march_cuda(torch.from_numpy(pos0), tuple(v.unbind(-1)), tp, ts,
                     t_safe_distance(tp, torch.float64))
    assert march_cuda.launches == launches
    assert tgeodesic.march.calls == calls + 1
    for a, b in zip(res, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_march_wrapper_rejects_other_devices():
    cfg, _, tp, vel = _inputs({})
    ts = tconfig.static_config(tconfig.Config.from_dict(cfg.to_dict()))
    v = torch.from_numpy(vel).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        march_cuda(torch.zeros(3), v, tp, ts, torch.tensor(2500.0))
