"""Port parity for whole-animation rendering (``blackstar_tpu_torch/video.py``)
on the CPU: the frames against the JAX package's ``render_animation`` in
float64 and against the port's own direct renders in float32, the end
frames against renders at the keyframe cameras, the step cap, and the
errors."""

import dataclasses

import numpy as np
import pytest
import torch

from blackstar_tpu import animation as janim
from blackstar_tpu import config as jconfig
from blackstar_tpu import video as jvideo
from blackstar_tpu_torch import animation as tanim
from blackstar_tpu_torch import config as tconfig
from blackstar_tpu_torch import video
from blackstar_tpu_torch.imageio import encode_rgb8, read_png
from blackstar_tpu_torch.ops.filters import bloom
from blackstar_tpu_torch.render import render

_CAMS = [((0, 1, -20), (0, 0, 0), (0, 1, 0), 1.5), ((4, 1, -20), (0, 0, 0), (0, 1, 0), 2.0)]


def _anim(mod, cfgmod, n_frames=3, cams=_CAMS, **scene):
    scene = {"resolution": (10, 6), "disk_opacity": 0.9, "bloom_strength": 0.0,
             "max_steps": 80, "dtype": "float32", **scene}
    keys = [mod.Keyframe(camera=cfgmod.Camera(*c), time=t)
            for c, t in zip(cams, np.linspace(0.0, 1.0, len(cams)).tolist())]
    return mod.Animation(scene=cfgmod.Scene(**scene), n_frames=n_frames,
                         interpolation="linear", keyframes=keys)


def _direct(anim, camera, static=None):
    """``encode_rgb8`` of a direct render of the animation's scene at
    ``camera`` (with the animation's shared step cap unless ``static``)."""
    cfg = tconfig.Config(scene=anim.scene, camera=camera)
    params = cfg.params("cpu")
    static = static or video.animation_config(anim).static()
    img = render(params, static)
    if anim.scene.bloom_strength != 0.0:
        img = bloom(img, params.bloom_strength, static.bloom_divider)
    return encode_rgb8(img).numpy()


def _assert_pixels_close(got, want):
    """Equal, or within 1 on the uint8 scale on at most 0.1% of the values
    (float32 against float64 ``pow`` rounding in the sRGB encode)."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_float64_frames_match_jax(tmp_path):
    ja = _anim(janim, jconfig, dtype="float64")
    ta = _anim(tanim, tconfig, dtype="float64")
    want = jvideo.render_animation(ja, str(tmp_path / "jax"), basename="o", batch_frames=3)
    seen = []
    got = video.render_animation(ta, str(tmp_path / "port"), basename="o", device="cpu",
                                 progress=lambda i, n: seen.append((i, n)))
    assert [p.split("/")[-1] for p in got] == ["o_0.png", "o_1.png", "o_2.png"]
    assert seen == [(1, 3), (2, 3), (3, 3)]
    for g, w in zip(got, want):
        _assert_pixels_close(read_png(g), read_png(w))


def test_float32_frames_equal_direct_renders(tmp_path):
    """Every frame is its own camera's render: a buffer handed on before its
    frame was copied, or overwritten before it was written, would show here
    as a frame equal to its neighbour."""
    anim = _anim(tanim, tconfig, n_frames=4, bloom_strength=0.3)
    paths = video.render_animation(anim, str(tmp_path), basename="f", device="cpu")
    imgs = [read_png(p) for p in paths]
    assert all(im.shape == (6, 10, 3) for im in imgs)
    for i, cam in enumerate(tanim.generate_frames(anim)):
        np.testing.assert_array_equal(imgs[i], _direct(anim, cam.camera), err_msg=f"frame {i}")
    assert all(not np.array_equal(a, b) for a, b in zip(imgs, imgs[1:]))
    # frames() yields the same pixels, through its two host buffers in turn.
    seen = [(i, rgb8.copy()) for i, rgb8 in video.frames(anim, device="cpu")]
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    for (_, a), b in zip(seen, imgs):
        np.testing.assert_array_equal(a, b)


def test_end_frames_equal_keyframe_renders(tmp_path):
    anim = _anim(tanim, tconfig, n_frames=5,
                 cams=_CAMS + [((-3, 2, -22), (1, 0, 0), (0, 1, 0), 1.8)])
    paths = video.render_animation(anim, str(tmp_path), basename="e", device="cpu")
    for idx, key in ((0, anim.keyframes[0]), (4, anim.keyframes[-1])):
        np.testing.assert_array_equal(read_png(paths[idx]), _direct(anim, key.camera))


def test_invalid_keyframes_raise(tmp_path):
    anim = _anim(tanim, tconfig)
    anim.keyframes[1].time = 0.5
    with pytest.raises(ValueError, match="time == 1"):
        video.render_animation(anim, str(tmp_path), device="cpu")
    anim.keyframes = anim.keyframes[:1]
    with pytest.raises(ValueError, match="at least two"):
        video.render_animation(anim, str(tmp_path), device="cpu")


def test_step_cap_covers_farthest_keyframe(tmp_path):
    """The shared step cap is the farthest keyframe's, or the far frames
    would truncate rays and render black."""
    cams = [((0, 1, -20), (0, 0, 0), (0, 1, 0), 1.5), ((0, 1, -90), (0, 0, 0), (0, 1, 0), 1.5)]
    anim = _anim(tanim, tconfig, n_frames=2, cams=cams, resolution=(8, 5), max_steps=None,
                 step_size=1.0)
    far = tconfig.Config(scene=anim.scene, camera=anim.keyframes[1].camera)
    near = tconfig.Config(scene=anim.scene, camera=anim.keyframes[0].camera)
    cap = video.animation_config(anim).static().max_steps
    assert cap == tconfig.default_max_steps(far) > tconfig.default_max_steps(near)
    ja = _anim(janim, jconfig, n_frames=2, cams=cams, resolution=(8, 5), max_steps=None,
               step_size=1.0)
    assert cap == jconfig.default_max_steps(
        jconfig.Config(scene=ja.scene, camera=ja.keyframes[1].camera))
    paths = video.render_animation(anim, str(tmp_path), basename="zoom", device="cpu")
    np.testing.assert_array_equal(read_png(paths[1]), _direct(anim, far.camera, far.static()))
    _, stats = render(far.params("cpu"), dataclasses.replace(far.static(), max_steps=cap),
                      with_stats=True)
    assert float(stats.truncated_frac) == 0.0


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        video.render_animation(_anim(tanim, tconfig), str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(video.frames(_anim(tanim, tconfig)))
