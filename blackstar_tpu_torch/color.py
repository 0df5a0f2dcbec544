"""Colour-space conversion and compositing primitives.

Matches the reference's ``Graphics.ColorSpace`` HSI model (``toPixelRGB`` in
StarMap.hs:114 and Raytracer.hs:64) and the front-to-back "over" blend of
Raytracer.hs:34-37, on tensors with a trailing channel axis.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi


def hsi_to_rgb(hsi: torch.Tensor) -> torch.Tensor:
    """HSI -> RGB, hue in [0,1) mapping to [0, 2π).

    Sector formula (hue thirds), with per-sector components::

        is_   = i*s
        second = i - is_
        first(a) = i + is_ * cos(a) / cos(π/3 - a)   for a = hue angle within sector
        third  = 2i + is_ - first

    which preserves r+g+b = 3i. Saturation/intensity outside [0,1] pass
    through un-clamped, like the reference.
    """
    h = hsi[..., 0]
    s = hsi[..., 1]
    i = hsi[..., 2]

    hp = h * _TWO_PI
    sector = torch.clamp(torch.floor(hp / (_TWO_PI / 3.0)), 0, 2).to(torch.int32)
    a = hp - sector.to(hp.dtype) * (_TWO_PI / 3.0)

    is_ = i * s
    second = i - is_
    # cos(π/3 - a) is bounded away from 0 for a in [0, 2π/3): min cos(π/3)=0.5
    first = i + is_ * torch.cos(a) / torch.cos(math.pi / 3.0 - a)
    third = 2.0 * i + is_ - first

    r = torch.where(sector == 0, first, torch.where(sector == 1, second, third))
    g = torch.where(sector == 0, third, torch.where(sector == 1, first, second))
    b = torch.where(sector == 0, second, torch.where(sector == 1, third, first))
    return torch.stack([r, g, b], dim=-1)


def blend_over(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Front-to-back "over" compositing of RGBA pixels.

    ``out = top + bottom * (1 - top.alpha)`` per channel *including alpha*
    (Raytracer.hs:34-37, where the accumulated colour is the top layer).
    """
    return top + bottom * (1.0 - top[..., 3:4])
