"""Port parity for the whole frame on the CPU: ``render_image`` against the
JAX package, the float64 oracle goldens, the filters and encoders, and the
render CLI writing a PNG."""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from blackstar_tpu import config as jconfig
from blackstar_tpu import imageio as jimageio
from blackstar_tpu.ops import filters as jfilters
from blackstar_tpu.render import render_image as j_render_image
from blackstar_tpu.stars import grid as jgrid
from blackstar_tpu.stars.catalog import Catalog, spectral_color
from blackstar_tpu_torch import config as tconfig
from blackstar_tpu_torch import imageio as timageio
from blackstar_tpu_torch.cli import render as tcli
from blackstar_tpu_torch.ops import filters as tfilters
from blackstar_tpu_torch.render import render, render_image
from blackstar_tpu_torch.stars import grid as tgrid

_SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
_GOLDEN = os.path.join(os.path.dirname(__file__), "golden_cache")


def _scene(name, width, height, **overrides):
    cfg = jconfig.load_config(os.path.join(_SCENES, name))
    scene = dataclasses.replace(cfg.scene, resolution=(width, height),
                                dtype="float64", **overrides)
    return jconfig.Config(scene=scene, camera=cfg.camera)


def _port(cfg):
    return tconfig.Config.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def sky_catalog():
    """Stars placed (numpy seed) near the escape directions of the 48×27
    default frame, so the frame's sky actually shows them."""
    cfg = _port(_scene("default.yaml", 48, 27))
    from blackstar_tpu_torch.camera import generate_rays
    from blackstar_tpu_torch.geodesic import ESCAPED, march
    from blackstar_tpu_torch.render import safe_distance

    params, static = cfg.params("cpu"), cfg.static()
    pos, vel = generate_rays(params.camera, 48, 27, dtype=torch.float64)
    res = march(pos, vel, params, static, safe_distance(params, torch.float64))
    esc = res.vel[res.status == ESCAPED].numpy()
    esc /= np.linalg.norm(esc, axis=-1, keepdims=True)
    rng = np.random.default_rng(31)
    pick = esc[rng.choice(len(esc), 120, replace=False)]
    pos = pick + 3e-4 * rng.normal(size=pick.shape)
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    chars = rng.choice(list("OBAFGKM?"), len(pos))
    return Catalog(
        pos=pos,
        mag=rng.integers(400, 1400, len(pos)).astype(np.int32),
        hue=np.array([spectral_color(c)[0] for c in chars]),
        sat=np.array([spectral_color(c)[1] for c in chars]),
    )


@pytest.fixture(scope="module")
def compact_grids(sky_catalog):
    kw = dict(cell_size=0.006, radius=0.0075, k0=4)
    return (jgrid.build_star_grid_compact(sky_catalog, **kw),
            tgrid.build_star_grid_compact(sky_catalog, **kw))


def test_render_image_matches_jax_with_stars_and_bloom(compact_grids):
    jc, tc = compact_grids
    cfg = _scene("default.yaml", 48, 27)
    assert cfg.scene.bloom_strength != 0.0
    want = j_render_image(cfg, jc.to_grid(dtype=jnp.float64), jit=True)
    got = render_image(_port(cfg), tc.to_grid("cpu", dtype=torch.float64), device="cpu")
    assert got.shape == (27, 48, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    # The stars do show: the frame differs from a starless one.
    bare = render_image(_port(cfg), None, device="cpu")
    assert np.abs(got - bare).max() > 1e-3


def test_supersampled_render_matches_jax():
    cfg = _scene("default-aa.yaml", 24, 14)
    assert cfg.scene.supersampling
    want = j_render_image(cfg, None, jit=True)
    got = render_image(_port(cfg), None, device="cpu")
    assert got.shape == (14, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_default_render_matches_golden():
    """The committed float64-oracle golden (tests/test_scenes_golden.py)."""
    cfg = _port(_scene("default.yaml", 64, 36, bloom_strength=0.0))
    (golden,) = glob.glob(os.path.join(_GOLDEN, "default_64_*.npy"))
    img, stats = render(cfg.params("cpu"), cfg.static(), None, with_stats=True)
    assert float(stats.truncated_frac) == 0.0
    np.testing.assert_allclose(img.numpy(), np.load(golden), rtol=0, atol=1e-7)


def test_filters_match_jax():
    rng = np.random.default_rng(41)
    img = rng.uniform(0, 2, (27, 48, 3))
    t = torch.from_numpy(img)
    for r in (0, 1, 3, 30):
        np.testing.assert_allclose(tfilters.box_blur(t, r).numpy(),
                                   np.asarray(jfilters.box_blur(img, r)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tfilters.bloom(t, torch.tensor(0.15, dtype=torch.float64), 25).numpy(),
        np.asarray(jfilters.bloom(img, 0.15, 25)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tfilters.supersample(t[:26]).numpy(),
                               np.asarray(jfilters.supersample(img[:26])), rtol=0, atol=1e-12)


def test_encoders_match_jax():
    rng = np.random.default_rng(42)
    img = rng.uniform(-0.2, 1.3, (9, 11, 3))
    img[0, :4, 0] = [0.0031308, 0.5 / 255, 1.0, 0.0]  # branch and rounding edges
    t = torch.from_numpy(img)
    np.testing.assert_allclose(timageio.srgb_encode(t).numpy(),
                               np.asarray(jimageio.srgb_encode(img)), rtol=0, atol=1e-12)
    rgb8 = timageio.encode_rgb8(t)
    assert rgb8.dtype == torch.uint8
    np.testing.assert_array_equal(rgb8.numpy(), np.asarray(jimageio.encode_rgb8(img)))
    np.testing.assert_array_equal(timageio.to_uint8(img), jimageio.to_uint8(img))
    assert timageio._png_bytes(rgb8.numpy()) == jimageio._png_bytes(rgb8.numpy())


def test_write_png_round_trips(tmp_path):
    """A float image is written sRGB-encoded as the JAX package encodes it;
    a uint8 one as it is."""
    rng = np.random.default_rng(43)
    img = rng.uniform(-0.2, 1.3, (5, 7, 3))
    timageio.write_png(img, str(tmp_path / "f.png"))
    np.testing.assert_array_equal(timageio.read_png(str(tmp_path / "f.png")),
                                  np.asarray(jimageio.encode_rgb8(img)))
    rgb8 = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    timageio.write_png(torch.from_numpy(rgb8), str(tmp_path / "u.png"))
    np.testing.assert_array_equal(timageio.read_png(str(tmp_path / "u.png")), rgb8)


def test_cli_render_writes_the_rendered_png(tmp_path, compact_grids, capsys):
    _, tc = compact_grids
    npz = tgrid.save_star_grid(tc, str(tmp_path / "sky.grid"))
    cfg = _port(_scene("default.yaml", 32, 18))
    scene_path = tmp_path / "small.yaml"
    scene_path.write_text(yaml.safe_dump(cfg.to_dict(), sort_keys=False))
    out = tmp_path / "out"

    rc = tcli.main([str(scene_path), "-o", str(out), "--starmap", npz,
                    "--force", "--stats", "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "truncated=0\n" in printed

    got = timageio.read_png(str(out / "small.png"))
    grid = tgrid.load_star_grid(npz, "cpu", dtype=torch.float64)
    want = timageio.encode_rgb8(torch.from_numpy(render_image(cfg, grid, device="cpu")))
    np.testing.assert_array_equal(got, want.numpy())
    assert got.max() > 0


def test_cli_batch_resume_and_bad_scene(tmp_path, capsys):
    cfg = _port(_scene("default.yaml", 16, 9, bloom_strength=0.0))
    scenes = tmp_path / "scenes"
    scenes.mkdir()
    (scenes / "a.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    (scenes / "b.yaml").write_text("scene: {}\n")  # no camera: skipped
    out = tmp_path / "out"
    args = [str(scenes), "-o", str(out), "--starmap", str(tmp_path / "none.npz"),
            "--force", "--device", "cpu"]
    assert tcli.main(args) == 0
    assert (out / "a.png").exists() and not (out / "b.png").exists()
    before = (out / "a.png").stat().st_mtime_ns
    assert tcli.main(args + ["--resume"]) == 0
    assert (out / "a.png").stat().st_mtime_ns == before
    printed = capsys.readouterr().out
    assert "rendering without stars" in printed and "Skipping" in printed
    (scenes / "a.yaml").unlink()
    assert tcli.main(args) == 1  # nothing rendered
