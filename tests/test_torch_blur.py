"""The fit pyramid's blur through B5 (``ops/bloom_cuda.box_blur_cuda``,
``ops/filters.pyramid_blur``).

On the CPU: the plain one-pass blur is self-adjoint, which B5's backward
(the same blur of the gradient) relies on; ``pyramid_blur`` takes the plain
path there, values and gradients; the autograd Function's backward, with
the kernel's launch replaced by the plain blur, passes ``gradcheck``; and
the wrapper refuses devices other than the CPU and CUDA.

Marked ``card``, and skipped without one: B5's one-pass blur and its
gradient against the float64 plain blur on a CUDA card. Run them there
without the repository's test ``conftest.py`` (it imports JAX)::

    python -m pytest --noconftest tests/test_torch_blur.py -q -m card
"""

import numpy as np
import pytest
import torch
from torch.autograd import gradcheck

from blackstar_tpu_torch.ops import bloom_cuda as b5
from blackstar_tpu_torch.ops import filters
from blackstar_tpu_torch.ops.filters import box_blur

# tests/test_filters.py::test_box_blur_f32_precision_at_production_scale:
# the plain float32 blur's budget against float64.
F32_BUDGET = 1.5e-5
PYRAMID_RADII = (4, 8, 16)  # fit --pyramid 3
# (h, w, r): the pyramid's radii, and windows as wide as or wider than the
# image on one axis or on both.
SMALL = [(37, 53, 4), (37, 53, 8), (37, 53, 16), (37, 53, 37), (37, 53, 45), (37, 53, 60),
         (9, 4, 3), (5, 7, 9), (1, 1, 2)]


def _img(h, w, seed, dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 1.3, (h, w, 3))).to(device=device, dtype=dtype)


# ---- CPU --------------------------------------------------------------------


@pytest.mark.parametrize("h,w,r", SMALL)
def test_plain_one_pass_blur_is_self_adjoint(h, w, r):
    """<B x, y> = <x, B y> in float64: the zero-padded box filter is
    symmetric along each axis and the two axes' filters commute, so the
    blur's transpose is the blur, also where the window is wider than the
    image."""
    x, y = _img(h, w, seed=h + w + r), _img(h, w, seed=h * w + r)
    lhs = torch.sum(box_blur(x, r, passes=1) * y)
    rhs = torch.sum(x * box_blur(y, r, passes=1))
    assert abs(float(lhs - rhs)) <= 1e-12 * float(abs(lhs))


def test_pyramid_blur_takes_the_plain_path_on_the_cpu():
    """On the CPU ``pyramid_blur`` launches no B5 blur, forward or
    backward: it is ``box_blur(·, r, passes=1)``."""
    before = b5.box_blur_cuda.launches, b5.box_blur_cuda.backward_launches
    img, cot = _img(21, 34, seed=8), _img(21, 34, seed=9)
    got_in, want_in = img.clone().requires_grad_(), img.clone().requires_grad_()
    got, want = filters.pyramid_blur(got_in, 8), box_blur(want_in, 8, passes=1)
    got.backward(cot)
    want.backward(cot)
    assert torch.equal(got, want) and torch.equal(got_in.grad, want_in.grad)
    assert (b5.box_blur_cuda.launches, b5.box_blur_cuda.backward_launches) == before


@pytest.fixture
def plain_launch(monkeypatch):
    """B5's wrapper with its launch replaced by the plain one-pass blur and
    its device check by a contiguous copy: its autograd Function on the CPU."""
    monkeypatch.setattr(b5, "_launch", lambda name, img, r: box_blur(img, r, passes=1))
    monkeypatch.setattr(b5, "_checked", lambda img, what: img.contiguous())


@pytest.mark.parametrize("h,w,r", [(6, 9, 2), (6, 9, 6), (6, 9, 12), (4, 3, 1)])
def test_function_backward_is_the_blur_of_the_gradient(plain_launch, h, w, r):
    """``gradcheck`` of the Function in float64 (its backward against finite
    differences), and its counters: one blur forward, one backward."""
    x = _img(h, w, seed=h + r).requires_grad_()
    assert gradcheck(lambda t: b5.box_blur_cuda(t, r), (x,), eps=1e-6, atol=1e-9)
    before = b5.box_blur_cuda.launches, b5.box_blur_cuda.backward_launches
    b5.box_blur_cuda(x, r).backward(_img(h, w, seed=1))
    assert (b5.box_blur_cuda.launches - before[0],
            b5.box_blur_cuda.backward_launches - before[1]) == (2, 1)


def test_function_radius_zero_returns_the_input(plain_launch):
    x = _img(3, 4, seed=0).requires_grad_()
    before = b5.box_blur_cuda.launches
    assert b5.box_blur_cuda(x, 0) is x and b5.box_blur_cuda(x, -2) is x
    assert b5.box_blur_cuda.launches == before


@pytest.mark.parametrize("call", [
    lambda img: filters.pyramid_blur(img, 4),
    lambda img: b5.box_blur_cuda(img, 4),
], ids=["filters.pyramid_blur", "box_blur_cuda"])
def test_blur_rejects_a_device_other_than_cpu_or_cuda(call):
    img = torch.empty((4, 50, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        call(img)


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _plain_grad(img, r, cot):
    """The float64 plain blur's autograd gradient of <blur(img), cot>."""
    x = img.double().detach().requires_grad_()
    box_blur(x, r, passes=1).backward(cot.double())
    return x.grad


@pytest.mark.card
@pytest.mark.parametrize("dtype,atol", [(torch.float32, F32_BUDGET), (torch.float64, 1e-12)])
@pytest.mark.parametrize("h,w,r", [(1080, 1920, r) for r in PYRAMID_RADII] + SMALL)
def test_b5_blur_and_gradient_against_the_float64_plain_blur(card, h, w, r, dtype, atol):
    img = _img(h, w, seed=h + w + r, device=card)
    cot = _img(h, w, seed=h + w + r + 1, device=card)
    x = img.to(dtype).requires_grad_()
    got = b5.box_blur_cuda(x, r)
    assert got.dtype == dtype and got.shape == img.shape
    err = (got.double() - box_blur(img, r, passes=1)).abs().max().item()
    assert err <= atol, (h, w, r, dtype, err)
    got.backward(cot.to(dtype))
    err = (x.grad.double() - _plain_grad(img, r, cot)).abs().max().item()
    assert err <= atol, ("gradient", h, w, r, dtype, err)


@pytest.mark.card
@pytest.mark.parametrize("h,w,r", [(6, 9, 2), (6, 9, 6), (6, 9, 12), (5, 40, 4), (33, 3, 40)])
def test_b5_blur_gradcheck(card, h, w, r):
    x = _img(h, w, seed=h + r, device=card).requires_grad_()
    assert gradcheck(lambda t: b5.box_blur_cuda(t, r), (x,), eps=1e-6, atol=1e-9)


@pytest.mark.card
@pytest.mark.parametrize("limit", [20000, 9000, 5000, 2500, 1000])
def test_b5_blur_narrow_strips_and_scratch_memory(card, monkeypatch, limit):
    """Less shared memory a block forces narrower strips, then the scratch
    path in device memory (the limits of
    ``test_torch_bloom.py::test_b5_narrow_strips_and_scratch_memory``);
    every plan gives the same blur and gradient."""
    monkeypatch.setattr(b5, "smem_limit", lambda index: limit)
    img, cot = _img(257, 383, seed=5, device=card), _img(257, 383, seed=6, device=card)
    for dtype, atol in ((torch.float32, F32_BUDGET), (torch.float64, 1e-12)):
        x = img.to(dtype).requires_grad_()
        got = b5.box_blur_cuda(x, 9)
        got.backward(cot.to(dtype))
        err = (got.double() - box_blur(img, 9, passes=1)).abs().max().item()
        gerr = (x.grad.double() - _plain_grad(img, 9, cot)).abs().max().item()
        assert err <= atol and gerr <= atol, (limit, dtype, err, gerr)


@pytest.mark.card
def test_b5_two_launches_a_blur_and_no_host_sync(card):
    """A blur and its gradient through ``pyramid_blur``: two blurs counted
    (one backward), four ``bloom_kernel`` launches by the profiler and no
    other blur kernel, and no wait for the card."""
    img = _img(1080, 1920, seed=3, dtype=torch.float32, device=card)
    cot = _img(1080, 1920, seed=4, dtype=torch.float32, device=card)
    filters.pyramid_blur(img, 8)  # builds and loads the library
    before = b5.box_blur_cuda.launches, b5.box_blur_cuda.backward_launches
    x = img.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        filters.pyramid_blur(x, 8).backward(cot)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (b5.box_blur_cuda.launches - before[0],
            b5.box_blur_cuda.backward_launches - before[1]) == (2, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        filters.pyramid_blur(img.clone().requires_grad_(), 8).backward(cot)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("bloom_kernel" in k for k in kernels) == 4, kernels
    assert not [k for k in kernels if "scan" in k or "index" in k or "flip" in k], kernels
    assert (x.grad.double() - _plain_grad(img, 8, cot)).abs().max().item() <= F32_BUDGET

