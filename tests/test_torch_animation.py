"""Port parity for the animation layer (``blackstar_tpu_torch/animation.py``):
validation, interpolation, frame expansion and file names against the JAX
package on the same keyframes, and ``camera_at`` against the JAX
``camera_at`` and against a finite difference of itself."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackstar_tpu import animation as janim
from blackstar_tpu import config as jconfig
from blackstar_tpu_torch import animation as tanim
from blackstar_tpu_torch import config as tconfig

_ANIM = os.path.join(os.path.dirname(__file__), "..", "animations", "default-ani.yaml")


def _keyframes(mod, cfgmod, spec):
    """Keyframes of either package from ``(time, position, look_at, up, fov)``."""
    return [mod.Keyframe(camera=cfgmod.Camera(position=p, look_at=la, up=u, fov=f), time=t)
            for t, p, la, u, f in spec]


_SPEC = [
    (0.0, (0.0, 1.0, -20.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 1.0),
    (0.4, (10.0, 2.0, -18.0), (1.0, -1.0, 0.5), (-0.2, 1.0, 0.0), 2.0),
    (1.0, (-5.0, 0.5, -25.0), (2.0, 0.0, 0.0), (0.1, 1.0, 0.2), 1.2),
]


def _both(spec=_SPEC):
    return _keyframes(janim, jconfig, spec), _keyframes(tanim, tconfig, spec)


@pytest.mark.parametrize("times", [[0.0], [], [0.1, 1.0], [0.0, 0.9], [0.0, 0.5, 1.0]],
                         ids=["one", "none", "late-start", "early-end", "ok"])
def test_validate_keyframes_matches_jax(times):
    spec = [(t, (float(i), 0.0, -20.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 1.5)
            for i, t in enumerate(times)]
    jk, tk = _both(spec)
    try:
        janim.validate_keyframes(jk)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        tanim.validate_keyframes(tk)
    else:
        with pytest.raises(ValueError) as err:
            tanim.validate_keyframes(tk)
        assert str(err.value) == want


def test_interpolate_matches_jax_exactly():
    jk, tk = _both()
    for t in np.linspace(-0.1, 1.1, 25).tolist() + [0.4, 1.0]:
        want, got = janim.interpolate(jk, t), tanim.interpolate(tk, t)
        assert got.to_dict() == want.to_dict(), t


def test_generate_frames_matches_jax():
    spec = list(reversed(_SPEC))  # unsorted: both sort by time
    jk, tk = _both(spec)
    scene = dict(resolution=(32, 18), disk_opacity=0.9)
    ja = janim.Animation(scene=jconfig.Scene(**scene), n_frames=7, interpolation="linear",
                         keyframes=jk)
    ta = tanim.Animation(scene=tconfig.Scene(**scene), n_frames=7, interpolation="linear",
                         keyframes=tk)
    want, got = janim.generate_frames(ja), tanim.generate_frames(ta)
    assert len(got) == 7
    assert [g.to_dict() for g in got] == [w.to_dict() for w in want]
    assert got[0].camera.position == _SPEC[0][1] and got[-1].camera.position == _SPEC[-1][1]
    assert all(f.scene is ta.scene for f in got)
    ta.keyframes[0].time = 0.2
    with pytest.raises(ValueError, match="time == 0"):
        tanim.generate_frames(ta)


@pytest.mark.parametrize("n,i", [(374, 0), (374, 42), (374, 374), (9, 3), (1000, 7), (0, 0)])
def test_pad_zero_and_frame_filename_match_jax(n, i):
    assert tanim.pad_zero(n, i) == janim.pad_zero(n, i)
    assert tanim.frame_filename("orbit", n + 1, i) == janim.frame_filename("orbit", n + 1, i)


def test_load_default_animation_matches_jax():
    ja, ta = janim.load_animation(_ANIM), tanim.load_animation(_ANIM)
    assert ta.n_frames == ja.n_frames == 375 and ta.interpolation == "linear"
    assert ta.scene.to_dict() == ja.scene.to_dict()
    assert ta.scene.disk_color == (0.16, 0.1, 0.95)  # diskHSV is an unknown key
    assert [k.to_dict() for k in ta.keyframes] == [k.to_dict() for k in ja.keyframes]
    with pytest.raises(ValueError, match="nFrames"):
        tanim.Animation.from_dict({"keyframes": []})


def test_camera_at_matches_jax():
    jk, tk = _both()
    ts = np.random.default_rng(7).uniform(-0.1, 1.1, 64)
    ts[:4] = [0.0, 0.4, 1.0, 1.1]
    want = janim.camera_at(jk, jnp.asarray(ts))
    got = tanim.camera_at(tk, torch.from_numpy(ts))
    for name in ("position", "look_at", "up", "fov"):
        g = getattr(got, name)
        assert g.dtype == torch.float64 and g.shape[0] == 64
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-12, err_msg=name)
    # Clamped before the first keyframe and past the last.
    np.testing.assert_array_equal(got.position[ts < 0].numpy(),
                                  np.broadcast_to(_SPEC[0][1], ((ts < 0).sum(), 3)))
    np.testing.assert_array_equal(got.fov[ts > 1].numpy(), np.full((ts > 1).sum(), _SPEC[-1][4]))


def test_camera_at_gradient_in_t_matches_finite_difference():
    _, tk = _both()
    ts = torch.tensor([0.1, 0.3, 0.55, 0.9], dtype=torch.float64, requires_grad=True)
    cam = tanim.camera_at(tk, ts)
    out = (cam.position ** 2).sum(dim=-1) + cam.fov * cam.look_at[:, 0] + cam.up[:, 2]
    (grad,) = torch.autograd.grad(out.sum(), ts)

    def f(t):
        c = tanim.camera_at(tk, t)
        return (c.position ** 2).sum(dim=-1) + c.fov * c.look_at[:, 0] + c.up[:, 2]

    eps = 1e-6
    t0 = ts.detach()
    fd = (f(t0 + eps) - f(t0 - eps)) / (2 * eps)
    np.testing.assert_allclose(grad.numpy(), fd.numpy(), rtol=1e-7, atol=1e-7)
    assert (grad.abs() > 1e-3).all()
