"""PPM star-catalogue parsing.

Binary format per http://tdc-www.harvard.edu/software/catalogs/ppm.entry.html
as consumed by the reference (StarMap.hs:44-58): a 28-byte header followed by
28-byte records::

    f64be  right ascension (rad)
    f64be  declination (rad)
    u8     spectral type (ASCII char)
    u8     (skip)
    i16be  magnitude (milli-magnitudes, used raw)
    8 B    (skip)

RA/Dec map to unit-sphere Cartesian ``(cos dec·cos ra, cos dec·sin ra,
sin dec)`` (StarMap.hs:74-75). The Morgan–Keenan spectral class maps to
(hue, saturation) pairs (StarMap.hs:64-72).

TPU-first: the record stream is parsed in one vectorised numpy pass over a
structured dtype instead of a sequential byte reader.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_HEADER_BYTES = 28
_RECORD = np.dtype(
    [
        ("ra", ">f8"),
        ("dec", ">f8"),
        ("spectral", "u1"),
        ("_pad1", "u1"),
        ("mag", ">i2"),
        ("_pad2", "V8"),
    ]
)
assert _RECORD.itemsize == 28

# Morgan–Keenan class -> (hue, saturation) (StarMap.hs:64-72).
SPECTRAL_COLORS = {
    "O": (0.631, 0.39),
    "B": (0.628, 0.33),
    "A": (0.622, 0.21),
    "F": (0.650, 0.03),
    "G": (0.089, 0.09),
    "K": (0.094, 0.29),
    "M": (0.094, 0.56),
}


def spectral_color(ch: str):
    return SPECTRAL_COLORS.get(ch, (0.0, 0.0))


class Catalog(NamedTuple):
    pos: np.ndarray  # (S, 3) float64 unit vectors
    mag: np.ndarray  # (S,) int32 raw magnitude field
    hue: np.ndarray  # (S,) float64
    sat: np.ndarray  # (S,) float64

    @property
    def n_stars(self) -> int:
        return self.pos.shape[0]


def ra_dec_to_cartesian(ra: np.ndarray, dec: np.ndarray) -> np.ndarray:
    cd = np.cos(dec)
    return np.stack([cd * np.cos(ra), cd * np.sin(ra), np.sin(dec)], axis=-1)


def parse_ppm(data: bytes) -> Catalog:
    """Parse raw PPM catalogue bytes into star arrays."""
    body = data[_HEADER_BYTES:]
    n = len(body) // _RECORD.itemsize
    rec = np.frombuffer(body, dtype=_RECORD, count=n)
    pos = ra_dec_to_cartesian(rec["ra"].astype(np.float64), rec["dec"].astype(np.float64))
    mag = rec["mag"].astype(np.int32)

    # Vectorised spectral-class -> (hue, sat) lookup over the 256 byte values.
    hue_table = np.zeros(256, np.float64)
    sat_table = np.zeros(256, np.float64)
    for ch, (h, s) in SPECTRAL_COLORS.items():
        hue_table[ord(ch)] = h
        sat_table[ord(ch)] = s
    sp = rec["spectral"]
    return Catalog(pos=pos, mag=mag, hue=hue_table[sp], sat=sat_table[sp])


def read_catalog(path: str) -> Catalog:
    with open(path, "rb") as f:
        return parse_ppm(f.read())


def encode_ppm(ra, dec, spectral, mag) -> bytes:
    """Inverse of ``parse_ppm`` — used to synthesise catalogues in tests."""
    n = len(ra)
    rec = np.zeros(n, dtype=_RECORD)
    rec["ra"] = ra
    rec["dec"] = dec
    rec["spectral"] = [ord(c) for c in spectral]
    rec["mag"] = mag
    return b"\x00" * _HEADER_BYTES + rec.tobytes()
