"""Wrapper of the bloom kernel B5 (``csrc/bloom.cu``).

B5 computes ``img + strength · boxBlur(width // divider, 3 passes)(img)``
for an (H, W, 3) image, what :func:`blackstar_tpu_torch.ops.filters.bloom`
computes; its plain PyTorch twin is that function's body on the CPU
(``filters.box_blur``). It replaces no TPU kernel; see the source's header
for why it was added, its design and what bounds it.

:func:`bloom_cuda` takes the plain path for an image on the CPU, launches
the kernel for an image on a CUDA device, and raises for anything else. It
never falls back from the kernel to the plain version, and on the card it
reads nothing back from the device: the kernel reads a tensor ``strength``
there. It is forward only: no caller differentiates through bloom (the fit
compares renders before bloom).

:func:`box_blur_cuda` is the same kernel at one pass and without the
bloom's epilogue: ``filters.box_blur(img, r, passes=1)`` on the card, for
the fit's loss pyramid (``filters.pyramid_blur``). It is differentiable.
The zero-padded box filter is symmetric along each axis and the two axes'
filters commute, so the blur is its own transpose: its backward is the same
blur of the incoming gradient, and it saves nothing for it.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from blackstar_tpu_torch.ops import _build, filters
from blackstar_tpu_torch.ops._build import D, I, L, P

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "bloom.cu")
FLAGS = ()
THREADS = 256  # kThreads in the source
# Strip widths a block may take, widest first: the rows launch holds a
# pixel's three channels (or one channel, for rows too long for that), the
# columns launch a strip of adjacent floats of every row.
ROW_WIDTHS = (3, 1)
COL_WIDTHS = (8, 4, 2, 1)

LIBRARY = _build.Library(SOURCE, FLAGS, {
    "bs_bloom": _build.Entry((P, P, P, L, L, L, P, D, I, I, P, I, I, P, P), dtyped=True),
    "bs_box_blur": _build.Entry((P, P, P, L, L, L, I, I, P, I, I, P, P), dtyped=True),
    "bs_bloom_smem_limit": _build.Entry((I,), stream=False),
})


class Pass(NamedTuple):
    """One launch of the kernel: ``n`` positions along the blurred axis, in
    strips of ``wc`` elements across it, ``seg`` positions a thread;
    ``blocks`` blocks, each holding its strip's two buffers in ``smem``
    bytes of shared memory, or in a ``scratch``-element slice of device
    memory (then ``smem`` is 0)."""

    n: int
    wc: int
    seg: int
    blocks: int
    smem: int
    scratch: int


@functools.lru_cache(maxsize=None)
def smem_limit(device_index: int) -> int:
    """The most dynamic shared memory a block may take on the device."""
    v = LIBRARY.entry("bs_bloom_smem_limit")(device_index)
    if v <= 0:
        raise RuntimeError(f"bloom kernel: cannot read the shared memory limit of cuda:{device_index}")
    return v


def _pass(n: int, inner: int, outer: int, widths, itemsize: int, limit: int) -> Pass:
    """The launch that blurs ``n`` positions, ``inner`` elements across,
    ``outer`` times: the widest strip whose two buffers fit in ``limit``
    bytes of shared memory, else the widest in device memory."""
    fits = [wc for wc in widths if 2 * n * wc * itemsize <= limit]
    wc = fits[0] if fits else widths[0]
    seg = -(-n // (THREADS // wc))
    seg += 1 - seg % 2  # odd: a warp's segments fall in distinct banks
    blocks = -(-inner // wc) * outer
    if fits:
        return Pass(n, wc, seg, blocks, 2 * n * wc * itemsize, 0)
    return Pass(n, wc, seg, blocks, 0, 2 * n * wc * blocks)


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, itemsize: int, limit: int):
    """The rows launch and the columns launch for an (h, w, 3) image of
    ``itemsize``-byte elements, with ``limit`` bytes of shared memory a
    block (the source's header says what each launch does)."""
    return (_pass(w, 3, h, ROW_WIDTHS, itemsize, limit),
            _pass(h, 3 * w, 1, COL_WIDTHS, itemsize, limit))


def _strength(strength, dt, dev):
    """``(pointer, value, tensor kept alive)``: a tensor on the card is read
    by the kernel (pointer); a number or a CPU tensor is passed by value."""
    if not isinstance(strength, torch.Tensor):
        return 0, float(strength), None
    if strength.numel() != 1:
        raise ValueError(f"bloom_cuda: strength must have one element, got {tuple(strength.shape)}")
    if strength.device.type == "cpu":
        return 0, float(strength), None
    if strength.device != dev:
        raise ValueError(f"bloom_cuda: strength is on {strength.device}, the image on {dev}")
    s = strength.reshape(()).to(dt).contiguous()
    return s.data_ptr(), 0.0, s


def bloom_cuda(img: torch.Tensor, strength, divider: int) -> torch.Tensor:
    """``img + strength · boxBlur(W // divider, 3 passes)`` of an (H, W, 3)
    image: kernel B5 on a CUDA device, :func:`filters.bloom`'s plain
    version on the CPU. ``strength`` is a number or a one-element tensor
    (on the card, the kernel reads it there)."""
    if img.device.type == "cpu":
        return filters.bloom(img, strength, divider)
    if img.dim() != 3:
        raise ValueError(f"bloom_cuda: expected an (H, W, 3) image, got {tuple(img.shape)}")
    return bloom_radius_cuda(img, strength, img.shape[1] // divider)


def bloom_radius_cuda(img: torch.Tensor, strength, r: int) -> torch.Tensor:
    """``img + strength · boxBlur(r, 3 passes)`` by kernel B5, for an image
    on a CUDA device: :func:`bloom_cuda` at a radius given outright (a
    radius of 0 or less leaves the image to be blurred unchanged, as in
    ``box_blur``)."""
    img = _checked(img, "bloom_cuda")
    if torch.is_grad_enabled() and (img.requires_grad or getattr(strength, "requires_grad", False)):
        raise ValueError("bloom_cuda: the bloom kernel is forward only; the input requires grad")
    s_ptr, s_val, _keep = _strength(strength, img.dtype, img.device)
    out = _launch("bs_bloom", img, r, s_ptr, s_val)
    bloom_cuda.launches += 1
    return out


bloom_cuda.launches = 0  # blooms launched (each the kernel's two launches): shows B5 ran


def box_blur_cuda(img: torch.Tensor, r: int) -> torch.Tensor:
    """One pass of the zero-padded box blur of radius ``r`` of an (H, W, 3)
    image on a CUDA device, ``filters.box_blur(img, r, passes=1)``, by
    kernel B5; differentiable, its backward the same blur of the gradient.
    A radius of 0 or less returns ``img``, as ``box_blur`` does."""
    img = _checked(img, "box_blur_cuda")
    if r <= 0:
        return img
    return _BoxBlur.apply(img, int(r))


box_blur_cuda.launches = 0  # blurs launched, forward and backward (each two kernel launches)
box_blur_cuda.backward_launches = 0  # of those, the blurs of a gradient


def _blur(img: torch.Tensor, r: int) -> torch.Tensor:
    out = _launch("bs_box_blur", img, r)
    box_blur_cuda.launches += 1
    return out


class _BoxBlur(torch.autograd.Function):
    """B5's one-pass blur; the map is linear and its own transpose."""

    @staticmethod
    def forward(ctx, img, r):
        ctx.r = r
        return _blur(img, r)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        box_blur_cuda.backward_launches += 1
        return _blur(grad.contiguous(), ctx.r), None


def _checked(img: torch.Tensor, what: str) -> torch.Tensor:
    """``img`` made contiguous, once it passes the checks of what B5 takes:
    an (H, W, 3) image of a dtype of ``_build.DTYPES`` on a CUDA device,
    with fewer than 2**31 elements."""
    if img.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {img.device}")
    if img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"{what}: expected an (H, W, 3) image, got {tuple(img.shape)}")
    if img.dtype not in _build.DTYPES:
        raise ValueError(f"{what}: unsupported dtype {img.dtype}")
    if img.numel() >= 2**31:
        raise ValueError(f"{what}: image of {img.numel()} elements is too large")
    return img.contiguous()


def _launch(name: str, img: torch.Tensor, r: int, *args) -> torch.Tensor:
    """B5's two launches of the entry ``name`` on a checked, contiguous
    image, ``args`` between the radius and the plan; returns the output."""
    dev = img.device
    h, w, _ = img.shape
    out = torch.empty_like(img)
    if not img.numel():
        return out
    rows, cols = plan(h, w, img.element_size(), smem_limit(dev.index))
    tmp = torch.empty_like(img)
    scratch = [torch.empty((p.scratch,), dtype=img.dtype, device=dev) if p.scratch else None
               for p in (rows, cols)]
    LIBRARY.call(name, img.data_ptr(), tmp.data_ptr(), out.data_ptr(), h, w, max(int(r), 0),
                 *args,
                 rows.wc, rows.seg, 0 if scratch[0] is None else scratch[0].data_ptr(),
                 cols.wc, cols.seg, 0 if scratch[1] is None else scratch[1].data_ptr(),
                 dtype=img.dtype, device=dev)
    return out
