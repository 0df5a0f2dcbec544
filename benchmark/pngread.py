"""Read back an 8-bit RGB PNG, whatever row filters its writer chose.

The benchmark's own decoder, so that what the program wrote is judged by
what any reader of the file would see: the zlib stream inflated, each row
unfiltered by its filter type (None, Sub, Up, Average, Paeth; PNG
specification, section 9). Interlaced files and other colour types are
refused.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of an 8-bit RGB, non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, size = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError(f"{path}: not an 8-bit RGB non-interlaced PNG")
            size = (h, w)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if size is None:
        raise ValueError(f"{path}: no IHDR chunk")
    h, w = size
    stride = 3 * w
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = row
        elif kind == 1:  # Sub: add the byte 3 to the left, a running sum per channel
            cur = np.cumsum(row.reshape(w, 3), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (row + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = int(cur[x - 3]) if x >= 3 else 0
                b = int(prev[x])
                c = int(prev[x - 3]) if x >= 3 else 0
                pred = (a + b) // 2 if kind == 3 else _paeth(a, b, c)
                cur[x] = (int(row[x]) + pred) & 0xFF
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3)
