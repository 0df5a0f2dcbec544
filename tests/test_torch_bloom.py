"""Bloom's kernel B5 (``ops/bloom_cuda.py``, ``ops/csrc/bloom.cu``).

On the CPU: ``filters.bloom`` and the wrapper take the plain path there and
refuse other devices; B5's order of the passes (three horizontal, then three
vertical) equals the reference's (horizontal, vertical) three times in
float64; a float64 mirror of B5's segmented sliding window equals the plain
pass; and the launch plan covers every shape it is given.

Marked ``card``, and skipped without one: B5 against the plain version on a
CUDA card. A machine with the card need not have JAX, which the
repository's test ``conftest.py`` imports, so run them there without it::

    python -m pytest --noconftest tests/test_torch_bloom.py -q -m card
"""

import numpy as np
import pytest
import torch

from blackstar_tpu_torch.ops import bloom_cuda as b5
from blackstar_tpu_torch.ops import filters
from blackstar_tpu_torch.ops.filters import _box_blur_axis, box_blur

# tests/test_filters.py::test_box_blur_f32_precision_at_production_scale:
# the plain float32 blur's budget against float64 at these shapes.
F32_BUDGET = 1.5e-5
PRODUCTION = [(1080, 1920, 76), (32, 7680, 307), (4320, 64, 307)]
# Small odd shapes: windows wider than the image on either axis, r = 0, one pixel.
ODD = [(1, 1, 0), (1, 1, 3), (3, 5, 1), (7, 2, 4), (5, 33, 2), (17, 9, 40), (33, 300, 12),
       (301, 3, 7)]
H100_SMEM = 232448  # bytes of shared memory a block may take on an H100


def _img(h, w, seed, dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 1.3, (h, w, 3))).to(device=device, dtype=dtype)


# ---- CPU --------------------------------------------------------------------


@pytest.mark.parametrize("tensor_strength", [False, True])
@pytest.mark.parametrize("entry", ["filters.bloom", "bloom_cuda"])
def test_cpu_bloom_takes_the_plain_path(entry, tensor_strength):
    img = _img(12, 50, seed=1)
    strength = torch.tensor(0.7, dtype=torch.float64) if tensor_strength else 0.7
    fn = filters.bloom if entry == "filters.bloom" else b5.bloom_cuda
    before = b5.bloom_cuda.launches
    got = fn(img, strength, 25)
    assert torch.equal(got, img + strength * box_blur(img, 50 // 25, passes=3))
    assert b5.bloom_cuda.launches == before


@pytest.mark.parametrize("call", [
    lambda img: filters.bloom(img, 0.7, 25),
    lambda img: b5.bloom_cuda(img, 0.7, 25),
    lambda img: b5.bloom_radius_cuda(img, 0.7, 2),
], ids=["filters.bloom", "bloom_cuda", "bloom_radius_cuda"])
def test_rejects_a_device_other_than_cpu_or_cuda(call):
    img = torch.empty((4, 50, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        call(img)


@pytest.mark.parametrize("h,w,r", [(9, 14, 3), (5, 40, 4), (30, 4, 3), (6, 6, 0), (3, 2, 5),
                                   (1, 1, 2), (21, 17, 8)])
def test_three_horizontal_then_three_vertical_passes_equal_the_reference_order(h, w, r):
    """B5 runs H³V³; the reference runs (HV)³. The zero-padded filters act on
    different axes and commute, so the two agree up to rounding, also where
    the window is wider than the image (2r+1 > H or > W) and at r = 0."""
    img = _img(h, w, seed=h * 100 + w)
    reordered = img
    for axis in (1, 1, 1, 0, 0, 0):
        reordered = _box_blur_axis(reordered, r, axis) if r > 0 else reordered
    torch.testing.assert_close(reordered, box_blur(img, r, passes=3), rtol=0, atol=1e-12)


def _sliding_pass(x, r, seg):
    """A float64 mirror of ``box_pass`` in the source: each segment of
    ``seg`` positions sums its first window outright, then slides it."""
    n = x.shape[0]
    out = np.empty_like(x)
    for a0 in range(0, n, seg):
        s = x[max(a0 - r, 0):min(a0 + r, n - 1) + 1].sum(axis=0)
        for a in range(a0, min(a0 + seg, n)):
            out[a] = s / (2 * r + 1)
            if a + r + 1 < n:
                s = s + x[a + r + 1]
            if a - r >= 0:
                s = s - x[a - r]
    return out


@pytest.mark.parametrize("n,r,seg", [(1, 0, 1), (7, 3, 1), (7, 3, 3), (10, 20, 3), (31, 4, 5),
                                     (64, 10, 7), (5, 0, 3), (40, 2, 41)])
def test_segmented_sliding_window_equals_the_plain_pass(n, r, seg):
    x = np.random.default_rng(n + 7 * r + seg).uniform(0, 1.3, (n, 8))
    want = _box_blur_axis(torch.from_numpy(x), r, 0).numpy()
    np.testing.assert_allclose(_sliding_pass(x, r, seg), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("h,w,itemsize", [(1080, 1920, 4), (1080, 1920, 8), (32, 7680, 4),
                                          (4320, 64, 4), (4320, 64, 8), (1, 1, 4), (3, 5, 8),
                                          (40000, 2, 4), (2, 40000, 8), (301, 3, 4)])
def test_plan_covers_every_position(h, w, itemsize):
    for p, inner, outer in zip(b5.plan(h, w, itemsize, H100_SMEM), (3, 3 * w), (h, 1)):
        assert p.seg >= 1 and p.seg % 2 == 1
        assert -(-p.n // p.seg) <= b5.THREADS // p.wc  # every position has a thread
        assert p.blocks == -(-inner // p.wc) * outer  # every strip has a block
        buffers = 2 * p.n * p.wc * itemsize
        if p.smem:
            assert p.scratch == 0 and p.smem == buffers <= H100_SMEM
        else:
            assert buffers > H100_SMEM and p.scratch == 2 * p.n * p.wc * p.blocks


def test_plan_at_the_production_shapes():
    rows, cols = b5.plan(1080, 1920, 4, H100_SMEM)
    assert (rows.n, rows.wc, rows.smem, rows.blocks) == (1920, 3, 46080, 1080)
    assert (cols.n, cols.wc, cols.smem, cols.blocks) == (1080, 8, 69120, 720)
    assert b5.plan(4320, 64, 4, H100_SMEM)[1].wc == 4  # 8 columns of 4320 rows do not fit
    assert b5.plan(40000, 2, 4, H100_SMEM)[1].scratch  # nor does 1 column of 40000


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _plain(img, strength, r):
    return img + strength * box_blur(img, r, passes=3)


@pytest.mark.card
@pytest.mark.parametrize("h,w,r", PRODUCTION)
def test_b5_f32_within_the_plain_blurs_budget_at_production_scale(card, h, w, r):
    img = _img(h, w, seed=0, device=card)
    got = b5.bloom_radius_cuda(img.float(), 1.0, r)
    err = (got.double() - _plain(img, 1.0, r)).abs().max().item()
    assert err <= F32_BUDGET, (h, w, r, err)


@pytest.mark.card
@pytest.mark.parametrize("dtype,atol", [(torch.float32, F32_BUDGET), (torch.float64, 1e-12)])
@pytest.mark.parametrize("h,w,r", [(1080, 1920, 76)] + ODD)
def test_b5_against_the_float64_plain_bloom(card, h, w, r, dtype, atol):
    img = _img(h, w, seed=h + w + r, device=card)
    strength = torch.tensor(0.7, dtype=torch.float64, device=card)
    got = b5.bloom_radius_cuda(img.to(dtype), strength.to(dtype), r)
    assert got.dtype == dtype and got.shape == img.shape
    err = (got.double() - _plain(img, strength, r)).abs().max().item()
    assert err <= atol, (h, w, r, dtype, err)


@pytest.mark.card
@pytest.mark.parametrize("limit", [20000, 9000, 5000, 2500, 1000])
def test_b5_narrow_strips_and_scratch_memory(card, monkeypatch, limit):
    """Less shared memory a block forces narrower strips, then the scratch
    path in device memory; every plan gives the same bloom. At 257x383 the
    five limits take, in float32 and float64, every strip width of the rows
    (3, 1) and the columns (8, 4, 2, 1) and the scratch path of each."""
    monkeypatch.setattr(b5, "smem_limit", lambda index: limit)
    img = _img(257, 383, seed=5, device=card)
    for dtype, atol in ((torch.float32, F32_BUDGET), (torch.float64, 1e-12)):
        got = b5.bloom_radius_cuda(img.to(dtype), 0.4, 9)
        err = (got.double() - _plain(img, 0.4, 9)).abs().max().item()
        assert err <= atol, (limit, dtype, err)


@pytest.mark.card
def test_b5_one_launch_a_bloom_and_no_host_sync(card):
    img = _img(1080, 1920, seed=3, dtype=torch.float32, device=card)
    strength = torch.tensor(0.7, dtype=torch.float32, device=card)
    filters.bloom(img, strength, 25)  # builds and loads the library
    before = b5.bloom_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = filters.bloom(img, strength, 25)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert b5.bloom_cuda.launches == before + 1
    err = (got.double() - _plain(img.double(), 0.7, 76)).abs().max().item()
    assert err <= F32_BUDGET


@pytest.mark.card
def test_b5_refuses_an_input_that_requires_grad(card):
    img = _img(8, 50, seed=4, dtype=torch.float32, device=card).requires_grad_()
    with pytest.raises(ValueError, match="forward only"):
        filters.bloom(img, 0.7, 25)
    strength = torch.tensor(0.7, device=card, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        filters.bloom(img.detach(), strength, 25)
    with torch.no_grad():
        filters.bloom(img, strength, 25)
