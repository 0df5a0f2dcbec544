"""Port parity: config parsing, camera rays and colour against the JAX
package, on the CPU."""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from blackstar_tpu import camera as jcamera
from blackstar_tpu import color as jcolor
from blackstar_tpu import config as jconfig
from blackstar_tpu_torch import camera as tcamera
from blackstar_tpu_torch import color as tcolor
from blackstar_tpu_torch import config as tconfig

SCENES = sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "..", "scenes", "*.yaml"))
)
assert len(SCENES) == 9, SCENES
_LEAVES = ("camera.position", "camera.look_at", "camera.up", "camera.fov",
           "disk.inner", "disk.outer", "disk.opacity", "disk.color_hsi",
           "stars.intensity", "stars.saturation", "bloom_strength", "mass")


def _leaf(tree, path):
    for name in path.split("."):
        tree = getattr(tree, name)
    return np.asarray(tree)


def _jax_params_np(cfg, dtype):
    return jax.tree.map(np.asarray, jconfig.scene_params(cfg, dtype=dtype))


@pytest.mark.parametrize("path", SCENES, ids=[os.path.basename(p) for p in SCENES])
def test_scene_parses_like_jax(path):
    jcfg = jconfig.load_config(path)
    tcfg = tconfig.load_config(path)
    assert tcfg.to_dict() == jcfg.to_dict()
    for preview in (False, True):
        js = jconfig.static_config(jcfg, preview=preview)
        ts = tconfig.static_config(tcfg, preview=preview)
        for f in dataclasses.fields(ts):
            assert getattr(ts, f.name) == getattr(js, f.name), f.name
    for np_dt, t_dt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        jp = _jax_params_np(jcfg, np_dt)
        tp = tcfg.params("cpu", t_dt)
        for leaf in _LEAVES:
            got = _leaf(tp, leaf)
            assert got.dtype == np_dt, leaf
            np.testing.assert_array_equal(got, _leaf(jp, leaf), err_msg=leaf)
    assert tconfig.apply_preview(tcfg).to_dict() == jconfig.apply_preview(jcfg).to_dict()


def test_params_from_numpy_carries_jax_leaves():
    jcfg = jconfig.load_config(SCENES[0])
    jp = _jax_params_np(jcfg, np.float64)
    tp = tconfig.params_from_numpy(jp, "cpu")
    for leaf in _LEAVES:
        got = _leaf(tp, leaf)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, _leaf(jp, leaf), err_msg=leaf)


def _random_cameras(seed, n):
    """Camera parameter sets made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    base = jconfig.load_config(os.path.join(os.path.dirname(SCENES[0]), "default.yaml"))
    for _ in range(n):
        cam = jconfig.Camera(
            position=tuple(rng.normal(size=3) * 15.0),
            look_at=tuple(rng.normal(size=3)),
            up=tuple(rng.normal(size=3)),
            fov=float(rng.uniform(0.5, 2.5)),
        )
        yield jconfig.Config(scene=base.scene, camera=cam)


@pytest.mark.parametrize("width,height", [(15, 7), (32, 18)])
def test_generate_rays_match_jax(width, height):
    for cfg in _random_cameras(width * height, 3):
        jp = _jax_params_np(cfg, np.float64)
        tp = tconfig.params_from_numpy(jp, "cpu")
        jcam = jconfig.scene_params(cfg, dtype=np.float64).camera
        jpos, jvel = jcamera.generate_rays(jcam, width, height, dtype=np.float64)
        tpos, tvel = tcamera.generate_rays(tp.camera, width, height, dtype=torch.float64)
        np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), rtol=0, atol=1e-12)
        _, jcomp = jcamera.generate_ray_components(jcam, width, height, dtype=np.float64)
        _, tcomp = tcamera.generate_ray_components(tp.camera, width, height, dtype=torch.float64)
        for j, t in zip(jcomp, tcomp):
            assert t.shape == (width * height,) and t.is_contiguous()
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-12)
        rot_j = jcamera.look_at_rotation(jcam.position, jcam.look_at, jcam.up)
        rot_t = tcamera.look_at_rotation(tp.camera.position, tp.camera.look_at, tp.camera.up)
        np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), rtol=0, atol=1e-12)


def test_hsi_to_rgb_matches_jax():
    rng = np.random.default_rng(7)
    hsi = np.stack([rng.uniform(0, 1, 500), rng.uniform(0, 1.5, 500),
                    rng.uniform(0, 1.2, 500)], axis=-1)
    hsi[:6, 0] = [0.0, 1 / 3, 2 / 3, 0.999999, 0.5, 0.16]  # sector edges
    want = np.asarray(jcolor.hsi_to_rgb(hsi))
    got = tcolor.hsi_to_rgb(torch.from_numpy(hsi)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    top = rng.uniform(0, 1, (50, 4))
    bottom = rng.uniform(0, 1, (50, 4))
    np.testing.assert_allclose(
        tcolor.blend_over(torch.from_numpy(top), torch.from_numpy(bottom)).numpy(),
        np.asarray(jcolor.blend_over(top, bottom)), rtol=0, atol=1e-12)
