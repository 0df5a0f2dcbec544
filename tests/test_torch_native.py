"""Port parity for the native IO runtime (``blackstar_tpu_torch/native.py``).

The port builds its own copy of the source,
``blackstar_tpu_torch/csrc/blackstar_native.cpp``, forked from the JAX
package's ``native/blackstar_native.cpp``. Its synchronous writers write the
same PNG bytes as the JAX package's build, and the same pixels as the
pure-Python writer. Its writer pool, one thread for each usable host CPU,
copies frames at submit, deflates a frame of one band into exactly those
bytes and a larger frame in primed bands into the same pixels at about the
same size, counts a failed frame once, and reports its counters. The
library is built at first use, never at import."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from blackstar_tpu import native as jnative
from blackstar_tpu_torch import imageio as timageio
from blackstar_tpu_torch import native, video
from blackstar_tpu_torch.animation import Animation, Keyframe
from blackstar_tpu_torch.config import Camera, Scene

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    if native.load() is None:
        pytest.fail(f"the native library did not build: {native.load_error}")
    return native


@pytest.fixture
def images():
    rng = np.random.default_rng(7)
    rgb8 = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    linear = rng.random((37, 53, 3), dtype=np.float32)
    linear[:5] *= 0.002  # the linear branch of the sRGB curve
    linear[5:8] += 0.5  # above 1: clamped
    return rgb8, linear


def test_library_is_built_into_build_dir_under_a_hashed_name(lib):
    path = lib.library_path()
    assert os.path.dirname(path) == os.path.join(_ROOT, "build")
    assert os.path.basename(path).startswith("libblackstar_native-") and os.path.exists(path)
    assert os.path.abspath(path) != os.path.abspath(os.path.join(_ROOT, "native",
                                                                 "libblackstar_native.so"))


@pytest.mark.parametrize("kind", ["rgb8", "linear"])
def test_png_bytes_equal_the_jax_packages(lib, images, tmp_path, kind):
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    img = images[0] if kind == "rgb8" else images[1]
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    if kind == "rgb8":
        assert lib.write_png_rgb8(img, str(ours)) and jnative.write_png_rgb8(img, str(theirs))
    else:
        assert lib.write_png_linear(img, str(ours)) and jnative.write_png_linear(img, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()


def test_native_pixels_equal_the_pure_python_writer(lib, images, tmp_path):
    rgb8, linear = images
    path = tmp_path / "native.png"
    assert lib.write_png_rgb8(rgb8, str(path))
    np.testing.assert_array_equal(timageio.read_png(str(path)), rgb8)
    assert path.read_bytes() == timageio._png_bytes(rgb8)
    # write_png takes the native route and encodes floats in float64 first,
    # so both routes give the pixels of encode_rgb8.
    timageio.write_png(linear, str(path))
    want = timageio.encode_rgb8(torch.from_numpy(linear.astype(np.float64))).numpy()
    np.testing.assert_array_equal(timageio.read_png(str(path)), want)
    assert path.read_bytes() == timageio._png_bytes(want)


def test_async_writer_round_trip_and_buffer_reuse(lib, images, tmp_path):
    rgb8, linear = images
    buf = rgb8.copy()
    paths = [str(tmp_path / f"f{i}.png") for i in range(6)]
    with lib.AsyncFrameWriter() as w:
        for i, p in enumerate(paths):
            buf[:] = (rgb8.astype(np.int64) + i) % 256
            w.submit(p, buf)  # copied at submit: the next frame overwrites buf at once
        buf[:] = 0
        w.submit(str(tmp_path / "lin.png"), linear)
        assert w.wait() == 0
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(timageio.read_png(p), (rgb8.astype(np.int64) + i) % 256)
    ref = tmp_path / "ref.png"
    assert lib.write_png_linear(linear, str(ref))
    assert (tmp_path / "lin.png").read_bytes() == ref.read_bytes()


def test_async_writer_counts_errors(lib, images, tmp_path):
    with lib.AsyncFrameWriter() as w:
        w.submit(str(tmp_path / "no_such_dir" / "x.png"), images[0])
        w.submit(str(tmp_path / "ok.png"), images[0])
        assert w.wait() == 1
    assert (tmp_path / "ok.png").exists()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(str(tmp_path / "late.png"), images[0])
    with pytest.raises(IOError):
        lib.write_png_rgb8(images[0], str(tmp_path / "no_such_dir" / "y.png"))
    with pytest.raises(ValueError):
        lib.write_png_rgb8(images[0][..., 0], str(tmp_path / "flat.png"))


def _smooth_frame(h, w):
    """A frame as a render has them: gradients, a band of noise, black areas."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * x / w, 255 * y / h, 127.5 * (1 + np.sin((x + 2 * y) / 40))], -1)
    img = img.astype(np.uint8)
    img[h // 3:h // 3 + h // 10] = np.random.default_rng(3).integers(
        0, 256, (h // 10, w, 3), dtype=np.uint8)
    img[h // 2:h // 2 + h // 5, w // 20:w // 2] = 0
    img[:, -w // 8:] = 0
    return img


# (size, kind, bands): a frame under one band (~512 KiB of rows) and larger ones.
POOL_FRAMES = [((37, 53), "rgb8", 1), ((1080, 1920), "rgb8", 12), ((1080, 1920), "linear", 12),
               ((317, 1001), "rgb8", 2)]


@pytest.mark.parametrize("size,kind,bands", POOL_FRAMES,
                         ids=[f"{h}x{w}-{k}" for (h, w), k, _ in POOL_FRAMES])
def test_pool_frames_against_the_jax_build(lib, tmp_path, size, kind, bands):
    """One band: the JAX build's bytes, and the pure-Python writer's. More
    bands: the JAX build's pixels, its file size within +0.5%."""
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    img = _smooth_frame(*size)
    if kind == "linear":
        img = timageio.srgb_decode(torch.from_numpy(img / 255.0)).numpy().astype(np.float32)
    ours, theirs = tmp_path / "pool.png", tmp_path / "jax.png"
    with lib.AsyncFrameWriter() as w:
        w.submit(str(ours), img)
        assert w.wait() == 0
        stats = w.stats()
    if kind == "linear":
        assert jnative.write_png_linear(img, str(theirs))
    else:
        assert jnative.write_png_rgb8(img, str(theirs))
    got, want = timageio.read_png(str(ours)), timageio.read_png(str(theirs))
    np.testing.assert_array_equal(got, want)
    if kind == "rgb8":
        np.testing.assert_array_equal(got, img)
    data = ours.read_bytes()
    assert {k: stats[k] for k in ("frames", "bands", "bytes")} == {
        "frames": 1, "bands": bands, "bytes": len(data)}
    assert stats["deflate_s"] > 0 and stats["write_s"] > 0
    if bands == 1:
        assert data == theirs.read_bytes() == timageio._png_bytes(img)
    else:
        assert len(data) <= 1.005 * len(theirs.read_bytes())


def test_a_failed_write_fails_its_frame_once(lib, tmp_path):
    """Every band of the frame is deflated; its one write fails, and counts once."""
    img = _smooth_frame(1080, 1920)
    with lib.AsyncFrameWriter() as w:
        w.submit(str(tmp_path / "no_such_dir" / "x.png"), img)
        w.submit(str(tmp_path / "ok.png"), img)
        assert w.wait() == 1
        stats = w.stats()
    assert stats["frames"] == 1 and stats["bands"] == 24
    assert stats["bytes"] == (tmp_path / "ok.png").stat().st_size
    np.testing.assert_array_equal(timageio.read_png(str(tmp_path / "ok.png")), img)


def test_many_banded_frames_each_written_whole(lib, tmp_path):
    """More frames than threads, each of several bands, from one reused
    buffer: every file holds its own frame's bands, in order."""
    base = _smooth_frame(317, 1001)
    buf = base.copy()
    paths = [str(tmp_path / f"b{i}.png") for i in range(3 * native.pool_threads())]
    with lib.AsyncFrameWriter() as w:
        for i, p in enumerate(paths):
            buf[:] = np.roll(base, 7 * i, axis=0)
            w.submit(p, buf)
        assert w.wait() == 0
        assert w.stats()["bands"] == 2 * len(paths)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(timageio.read_png(p), np.roll(base, 7 * i, axis=0))


@pytest.mark.parametrize("cpus,cpu_max,want", [
    (8, None, 8), (8, "max 100000\n", 8), (8, "250000 100000\n", 3), (1, None, 1)])
def test_pool_threads_are_the_usable_cpus(monkeypatch, tmp_path, cpus, cpu_max, want):
    monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: set(range(cpus)))
    path = tmp_path / "cpu.max"
    if cpu_max is not None:
        path.write_text(cpu_max)
    monkeypatch.setattr(native, "CPU_MAX", str(path))
    assert native.pool_threads() == want


def test_render_animation_adds_the_pools_counters(lib, tmp_path):
    scene = Scene(resolution=(10, 6), bloom_strength=0.0, max_steps=40, dtype="float32")
    keys = [Keyframe(camera=Camera((x, 1, -20), (0, 0, 0), (0, 1, 0), 1.5), time=t)
            for x, t in ((0, 0.0), (4, 1.0))]
    anim = Animation(scene=scene, n_frames=3, interpolation="linear", keyframes=keys)
    before = dict(video.render_animation.pool)
    paths = video.render_animation(anim, str(tmp_path), device="cpu")
    pool = {k: v - before[k] for k, v in video.render_animation.pool.items()}
    assert pool["frames"] == pool["bands"] == 3
    assert pool["bytes"] == sum(os.path.getsize(p) for p in paths)
    assert video.render_animation.threads == native.pool_threads()


def test_nothing_is_built_or_loaded_at_import():
    code = ("import blackstar_tpu_torch, blackstar_tpu_torch.native as n, "
            "blackstar_tpu_torch.imageio, blackstar_tpu_torch.video\n"
            "assert n._lib is None and not n._tried\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=_ROOT))
    assert out.returncode == 0, out.stderr
