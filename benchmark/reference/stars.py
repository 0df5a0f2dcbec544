"""The sky of the plain reference: the star catalogue and ``starLookup``.

The catalogue is the upstream's PPM file: a 28-byte header, then 28-byte
records of big-endian right ascension and declination (f64, radians), the
spectral class (one ASCII byte), a skipped byte, the magnitude (i16, used
raw) and 8 skipped bytes. A star sits at ``(cos δ cos α, cos δ sin α, sin δ)``
and takes its hue and saturation from its spectral class
(``src/StarMap.hs:44-75``).

``starLookup`` (``src/StarMap.hs:93-115``): every star within chordal
distance ``3w`` (``w = 0.0005``) of the ray's unit direction ``n`` adds
``HSI(hue, starSaturation·sat, starIntensity·min(1, exp(ln2/50·(950 − mag)
− |p − n|²/(2w²))))``, and each channel of the sum is clamped at 1.

The stars are found through a hash of cubes of side ``2·3w`` over the unit
sphere's box: the stars within ``3w`` of ``n`` lie in the 2×2×2 cubes
starting at ``floor((n − 3w + 1)/side)``. Each star is in one cube, so each
counts once. This is the reference's own search; the program's star table
plays no part in it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.render import hsi_to_rgb

W = 0.0005
RADIUS = 3.0 * W
SIDE = 2.0 * RADIUS
_RECORD = np.dtype([("ra", ">f8"), ("dec", ">f8"), ("spectral", "u1"), ("_pad1", "u1"),
                    ("mag", ">i2"), ("_pad2", "V8")])
SPECTRAL = {"O": (0.631, 0.39), "B": (0.628, 0.33), "A": (0.622, 0.21), "F": (0.650, 0.03),
            "G": (0.089, 0.09), "K": (0.094, 0.29), "M": (0.094, 0.56)}
_CELLS = int(math.ceil(2.0 / SIDE)) + 3  # cubes along an axis, with a guard on each side


def read_ppm(path: str):
    """(positions (S, 3), magnitudes, hues, saturations) as float64 numpy arrays."""
    with open(path, "rb") as f:
        body = f.read()[28:]
    rec = np.frombuffer(body, dtype=_RECORD, count=len(body) // _RECORD.itemsize)
    ra, dec = rec["ra"].astype(np.float64), rec["dec"].astype(np.float64)
    pos = np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)], axis=-1)
    hue, sat = np.zeros(256), np.zeros(256)
    for ch, (h, s) in SPECTRAL.items():
        hue[ord(ch)], sat[ord(ch)] = h, s
    return pos, rec["mag"].astype(np.float64), hue[rec["spectral"]], sat[rec["spectral"]]


def _cube(x: torch.Tensor) -> torch.Tensor:
    return torch.floor((x.double() + 1.0) / SIDE).to(torch.int64) + 1


def _key(ix, iy, iz):
    return (ix * _CELLS + iy) * _CELLS + iz


class Sky:
    """The catalogue on ``device`` at ``dtype``, sorted by cube."""

    def __init__(self, catalogue, device, dtype):
        pos, mag, hue, sat = (torch.as_tensor(a, device=device) for a in catalogue)
        c = _cube(pos)
        key = _key(c[:, 0], c[:, 1], c[:, 2])
        self.keys, order = torch.sort(key)
        self.pos = pos[order].to(dtype)
        # ln2/50·(950 − mag): the log brightness before the distance term.
        self.loglum = (math.log(2.0) / 50.0 * (950.0 - mag[order])).to(dtype)
        self.hue, self.sat = hue[order].to(dtype), sat[order].to(dtype)
        self.dtype = dtype

    @classmethod
    def from_ppm(cls, path: str, device, dtype):
        return cls(read_ppm(path), device, dtype)

    def candidates(self, n: torch.Tensor):
        """(ray, star) index pairs of every star in the 8 cubes around each
        of the unit directions ``n`` (N, 3)."""
        lo = _cube(n - RADIUS)
        keys = []
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    keys.append(_key(lo[:, 0] + dx, lo[:, 1] + dy, lo[:, 2] + dz))
        keys = torch.stack(keys, dim=1).reshape(-1)  # (N·8,)
        start = torch.searchsorted(self.keys, keys)
        count = torch.searchsorted(self.keys, keys, right=True) - start
        total = int(count.sum())
        slot = torch.repeat_interleave(torch.arange(keys.numel(), device=n.device), count,
                                       output_size=total)
        first = torch.cumsum(count, 0) - count
        star = start[slot] + torch.arange(total, device=n.device) - first[slot]
        return slot // 8, star

    def lookup(self, vel: torch.Tensor, intensity, saturation, chunk: int = 1 << 20,
               clamp: bool = True) -> torch.Tensor:
        """Star colour (N, 3) in the directions ``vel`` (N, 3)."""
        parts = [self._lookup(vel[s:s + chunk], intensity, saturation, clamp)
                 for s in range(0, vel.shape[0], chunk)]
        if not parts:
            return vel.new_zeros((0, 3))
        return torch.cat(parts)

    def _lookup(self, vel, intensity, saturation, clamp):
        n = vel / torch.sqrt((vel * vel).sum(-1, keepdim=True))
        ray, star = self.candidates(n.detach())
        d = self.pos[star] - n[ray]
        d2 = (d * d).sum(-1)
        near = torch.nonzero(d2 <= RADIUS * RADIUS).squeeze(1)
        ray, star, d2 = ray[near], star[near], d2[near]
        val = intensity * torch.clamp(torch.exp(self.loglum[star] - d2 / (2.0 * W * W)), max=1.0)
        rgb = hsi_to_rgb(self.hue[star], saturation * self.sat[star], val)
        out = torch.zeros((vel.shape[0], 3), dtype=vel.dtype, device=vel.device)
        out = out.index_add(0, ray, rgb.to(vel.dtype))
        if clamp:
            out = torch.minimum(out, torch.ones((), dtype=out.dtype, device=out.device))
        return out
