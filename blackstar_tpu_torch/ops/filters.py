"""Image post-processing: separable box blur, bloom, supersampling.

Reference semantics (``src/ImageFilters.hs``):

* ``boxBlur r passes``: per pass, a horizontal then a vertical sliding-window
  box filter of width ``2r+1`` normalised by ``1/(2r+1)``, with out-of-bounds
  pixels reading as black (zero padding) — ImageFilters.hs:28-78.
* ``bloom strength divider``: 3-pass box blur with ``r = width // divider``,
  then ``out = img + strength·blurred`` — ImageFilters.hs:80-86.
* ``supersample``: 2×2 box average from a double-resolution render —
  ImageFilters.hs:88-97.

The running window sum is an exclusive prefix sum and the difference of two
of its entries per pixel, as in the JAX package. These are plain tensor ops:
the JAX package has no hand-written kernel for this stage either. On a CUDA
device ``bloom`` launches the hand-written kernel B5 (``ops/bloom_cuda.py``)
instead, and ``pyramid_blur``, the fit's blurred loss levels, launches B5 at
one pass (forward and backward). ``box_blur`` stays plain on every device:
it is the twin that B5 is held to on the card.
"""

from __future__ import annotations

import torch


def _box_blur_axis(img: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """Zero-padded 1-D box filter of width ``2r+1`` along ``axis``."""
    n = img.shape[axis]
    # Exclusive cumsum: c[k] = sum(img[:k]); the windowed sum over
    # [x-r, x+r] ∩ [0,n) is c[clip(x+r+1, 0, n)] - c[clip(x-r, 0, n)].
    c = torch.cumsum(img, dim=axis)
    c = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
    x = torch.arange(n, device=img.device)
    hi = torch.clamp(x + r + 1, 0, n)
    lo = torch.clamp(x - r, 0, n)
    win = c.index_select(axis, hi) - c.index_select(axis, lo)
    return win * (1.0 / (2 * r + 1))


def box_blur(img: torch.Tensor, r: int, passes: int = 3) -> torch.Tensor:
    """Separable multi-pass box blur of an (H, W, C) image.

    Each pass blurs horizontally then vertically (ImageFilters.hs:70-75).
    """
    if r <= 0:
        return img
    for _ in range(passes):
        img = _box_blur_axis(img, r, axis=1)  # horizontal
        img = _box_blur_axis(img, r, axis=0)  # vertical
    return img


def bloom(img: torch.Tensor, strength, divider: int) -> torch.Tensor:
    """``img + strength · boxBlur(width//divider, 3 passes)`` (ImageFilters.hs:80-86).

    The plain version below on the CPU; on any other device the bloom
    kernel's wrapper, which launches B5 on a CUDA device and raises for
    anything else."""
    if img.device.type != "cpu":
        from blackstar_tpu_torch.ops.bloom_cuda import bloom_cuda

        return bloom_cuda(img, strength, divider)
    w = img.shape[1]
    blurred = box_blur(img, w // divider, passes=3)
    return img + strength * blurred


def pyramid_blur(img: torch.Tensor, r: int) -> torch.Tensor:
    """One pass of the box blur of radius ``r``, a level of the fit's loss
    pyramid: ``box_blur(img, r, passes=1)`` on the CPU; on any other device
    the blur kernel's wrapper, which launches B5 on a CUDA device (its
    backward too) and raises for anything else."""
    if img.device.type != "cpu":
        from blackstar_tpu_torch.ops.bloom_cuda import box_blur_cuda

        return box_blur_cuda(img, r)
    return box_blur(img, r, passes=1)


def supersample(img: torch.Tensor) -> torch.Tensor:
    """2×2 box-average downsample of an (2H, 2W, C) image (ImageFilters.hs:88-97)."""
    h, w, c = img.shape
    return 0.25 * img.reshape(h // 2, 2, w // 2, 2, c).sum(dim=(1, 3))
