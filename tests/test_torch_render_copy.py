"""The still's copy to the host (``render._to_host``, ``render_image``).

On the CPU: the helper hands back a CPU tensor's own memory as ``.numpy()``
does and counts no pinned copy, refuses other devices than the CPU and
CUDA, and ``render_image`` still returns the float image of ``render`` (or
``render_rgb`` when the scene blooms).

Marked ``card``, and skipped without one: on a CUDA card, a small frame and
the 1080p frame come back bit-equal to ``.cpu().numpy()``, in page-locked
memory, one counted copy a call, each call in memory of its own, and warm
calls take no new block from the caching host allocator. A machine with the
card need not have JAX, which the repository's test ``conftest.py``
imports, so run them there without it::

    python -m pytest --noconftest tests/test_torch_render_copy.py -q -m card
"""

import os

import numpy as np
import pytest
import torch

from blackstar_tpu_torch.config import Config, load_config
from blackstar_tpu_torch.render import _to_host, render, render_image, render_rgb

_DEFAULT = os.path.join(os.path.dirname(__file__), "..", "scenes", "default.yaml")


def _cfg(width, height, dtype="float32", bloom=0.15, position=None):
    d = load_config(_DEFAULT).to_dict()
    d["scene"].update(resolution=[width, height], dtype=dtype, bloomStrength=bloom)
    if position is not None:
        d["camera"]["position"] = position
    return Config.from_dict(d)


# ---- CPU --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensor_is_returned_as_its_numpy_view(dtype):
    t = torch.linspace(0, 1, 5 * 7 * 3, dtype=dtype).reshape(5, 7, 3)
    before = render_image.pinned_copies
    got = _to_host(t)
    want = t.numpy()
    assert got.dtype == want.dtype and got.shape == (5, 7, 3)
    assert np.shares_memory(got, want)
    np.testing.assert_array_equal(got, want)
    assert render_image.pinned_copies == before


def test_rejects_a_device_other_than_cpu_or_cuda():
    with pytest.raises(ValueError, match="unsupported device meta"):
        _to_host(torch.empty((4, 6, 3), device="meta"))


@pytest.mark.parametrize("bloom", [0.0, 0.15])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_render_image_equals_the_render(dtype, bloom):
    cfg = _cfg(16, 9, dtype, bloom)
    before = render_image.pinned_copies
    got = render_image(cfg, None, device="cpu")
    fn = render_rgb if bloom else render
    want = fn(cfg.params("cpu"), cfg.static(), None).numpy()
    assert isinstance(got, np.ndarray) and got.dtype == np.dtype(dtype) and got.shape == (9, 16, 3)
    np.testing.assert_array_equal(got, want)
    assert render_image.pinned_copies == before


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


SIZES = [(64, 36), (1920, 1080)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("w,h", SIZES)
def test_card_copy_is_bit_equal_and_pinned(card, w, h, dtype):
    cfg = _cfg(w, h, dtype)
    img = render_rgb(cfg.params(card), cfg.static(), None)
    want = img.cpu().numpy()
    got = _to_host(img)
    assert got.dtype == want.dtype and got.shape == (h, w, 3)
    assert torch.from_numpy(got).is_pinned()
    np.testing.assert_array_equal(got, want)
    whole = render_image(cfg, None, device=card)
    assert torch.from_numpy(whole).is_pinned()
    np.testing.assert_array_equal(whole, want)


@pytest.mark.card
@pytest.mark.parametrize("w,h", SIZES)
def test_card_each_call_returns_its_own_memory_and_counts_one_copy(card, w, h):
    first, second = _cfg(w, h), _cfg(w, h, position=[0, 3, -25])
    before = render_image.pinned_copies
    a = render_image(first, None, device=card)
    kept = a.copy()
    b = render_image(second, None, device=card)
    assert render_image.pinned_copies == before + 2
    assert not np.shares_memory(a, b)
    assert not np.array_equal(a, b)  # else an overwrite of ``a`` would not show
    np.testing.assert_array_equal(a, kept)


@pytest.mark.card
@pytest.mark.parametrize("w,h", SIZES)
def test_card_warm_calls_take_no_new_pinned_block(card, w, h):
    cfg = _cfg(w, h)
    for _ in range(2):
        render_image(cfg, None, device=card)
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    for _ in range(20):
        render_image(cfg, None, device=card)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
