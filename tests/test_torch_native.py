"""Port parity for the native IO runtime (``blackstar_tpu_torch/native.py``):
the port's build of ``native/blackstar_native.cpp`` writes the same PNG
bytes as the JAX package's build of it, the same pixels as the pure-Python
writer, and its writer pool copies frames at submit and counts failed
writes. The library is built at first use, never at import."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from blackstar_tpu import native as jnative
from blackstar_tpu_torch import imageio as timageio
from blackstar_tpu_torch import native

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
    with lib.AsyncFrameWriter(3) as w:
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
    with lib.AsyncFrameWriter(1) as w:
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


def test_nothing_is_built_or_loaded_at_import():
    code = ("import blackstar_tpu_torch, blackstar_tpu_torch.native as n, "
            "blackstar_tpu_torch.imageio, blackstar_tpu_torch.video\n"
            "assert n._lib is None and not n._tried\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=_ROOT))
    assert out.returncode == 0, out.stderr
