"""Reader/writer for the reference's serialized star tree (``stars.kdt``).

The port of ``blackstar_tpu/stars/kdt.py`` (which imports no JAX); the port
keeps its own copy, on its own ``stars/catalog.py``.

The reference persists its k-d tree with Haskell's ``cereal`` generic
encoding of ``KdMap Double (V3 Double) (Int, Char)`` (StarMap.hs:25-41,
treeToByteString/readTreeFromFile at :82-88). That format is defined by the
GHC ``Generic`` representation of two libraries' internal types, so this
module is a *best-effort* structural parser:

  * cereal primitives are fixed: Int → Int64 big-endian, Double → IEEE-754
    float64 big-endian (cereal >= 0.5, 2015), tuples/records → fields in
    declaration order, sum types → a leading Word8 constructor tag,
    ASCII Char → one UTF-8 byte.
  * StarMap.hs serializes the KdMap's two function fields as one 0x00 byte
    each (the "hack around it" instances at :34-41).
  * the ``kdt`` package's exact field/constructor declaration order is not
    pinned anywhere in the reference, so the parser *detects* it: it tries
    the plausible layouts (empty/node tag assignment × node field order)
    and accepts the unique one that consumes the whole file with the
    trailing/leading size field matching the star count and every star
    position unit-norm. A mis-guessed layout cannot silently parse: the
    subtree tags, 28-byte payloads, and the norm check are mutually
    incompatible across layouts.

Trees produced by :func:`write_kdt` (median-split, axes cycled x→y→z like
``Data.KdMap.Static.build`` with ``toList``) round-trip through
:func:`read_kdt` under every candidate layout; a genuine GHC-written file
additionally needs cereal >= 0.5 (older cereal encoded Double as a
decodeFloat pair — unsupported, rebuild from the .ppm instead:
``python -m blackstar_tpu_torch generate-grid``).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from blackstar_tpu_torch.stars.catalog import Catalog, spectral_color

_TAG_EMPTY_FIRST = 0  # TreeEmpty declared before TreeNode
_TAG_NODE_FIRST = 1  # TreeNode declared before TreeEmpty

# Node field orders to try: (subtree, point, axis, subtree) is the kdt
# package's shape; which side of the payload each subtree sits on is the
# detected part.
_FIELD_ORDERS = (
    "LPAR",  # left, (point, value), axisValue, right
    "PALR",  # (point, value), axisValue, left, right
    "LRPA",  # left, right, (point, value), axisValue
)


class KdtFormatError(ValueError):
    """The bytes do not match any supported stars.kdt layout."""


class _Reader:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise KdtFormatError("unexpected end of file")
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self.take(8))[0]

    def char(self) -> str:
        # cereal's Char is UTF-8-style; spectral types are ASCII (1 byte).
        b0 = self.u8()
        if b0 < 0x80:
            return chr(b0)
        n = 1 + (b0 >= 0xC0) + (b0 >= 0xE0) + (b0 >= 0xF0)
        try:
            return (bytes([b0]) + self.take(n - 1)).decode("utf-8")
        except UnicodeDecodeError as e:
            # A wrong layout guess lands here mid-probe: reject, don't crash.
            raise KdtFormatError(f"invalid Char encoding: {e}") from e


def _parse_point(r: _Reader) -> Tuple[Tuple[float, float, float], int, str]:
    pos = (r.f64(), r.f64(), r.f64())
    mag = r.i64()
    ch = r.char()
    return pos, mag, ch


def _parse_node_palr(r: _Reader, empty_tag: int, out: list) -> None:
    """point, axis, left, right — payload leads, subtrees trail."""
    pending = 1  # subtrees still to parse (pure pre-order: no frames needed)
    while pending:
        pending -= 1
        tag = r.u8()
        if tag == empty_tag:
            continue
        if tag != 1 - empty_tag:
            raise KdtFormatError(f"bad constructor tag {tag}")
        out.append(_parse_point(r))
        r.f64()  # axisValue
        pending += 2


def _parse_node_lpar(r: _Reader, empty_tag: int, out: list) -> None:
    """left, point, axis, right — payload interleaved between subtrees."""
    # Frame: 0 = expect tree, 1 = payload-then-right marker.
    stack: List[int] = [0]
    while stack:
        action = stack.pop()
        if action == 1:
            out.append(_parse_point(r))
            r.f64()  # axisValue
            stack.append(0)  # right subtree
            continue
        tag = r.u8()
        if tag == empty_tag:
            continue
        if tag != 1 - empty_tag:
            raise KdtFormatError(f"bad constructor tag {tag}")
        stack.append(1)  # after the left subtree: payload + right
        stack.append(0)  # left subtree
    return


def _parse_node_lrpa(r: _Reader, empty_tag: int, out: list) -> None:
    """left, right, point, axis — payload after both subtrees."""
    stack: List[int] = [0]
    while stack:
        action = stack.pop()
        if action == 1:
            out.append(_parse_point(r))
            r.f64()
            continue
        tag = r.u8()
        if tag == empty_tag:
            continue
        if tag != 1 - empty_tag:
            raise KdtFormatError(f"bad constructor tag {tag}")
        stack.append(1)
        stack.append(0)  # right
        stack.append(0)  # left
    return


def _try_layout(buf: bytes, empty_tag: int, order: str,
                size_first: bool) -> Optional[list]:
    r = _Reader(buf)
    if r.u8() != 0 or r.u8() != 0:
        # The two serialized-function placeholder bytes (StarMap.hs:34-41).
        return None
    out: list = []
    try:
        size = r.i64() if size_first else None
        if order == "LPAR":
            _parse_node_lpar(r, empty_tag, out)
        elif order == "LRPA":
            _parse_node_lrpa(r, empty_tag, out)
        else:
            _parse_node_palr(r, empty_tag, out)
        if size is None:
            size = r.i64()
    except KdtFormatError:
        return None
    if r.off != len(buf) or size != len(out) or not out:
        return None
    pos = np.array([p for p, _, _ in out])
    if not np.allclose(np.linalg.norm(pos, axis=-1), 1.0, atol=1e-6):
        return None  # star positions are unit directions by construction
    return out


def read_kdt(path: str) -> Catalog:
    """Parse a reference ``stars.kdt`` into a :class:`Catalog`.

    Raises :class:`KdtFormatError` with a rebuild hint when no supported
    layout matches (e.g. a pre-0.5 cereal encoding).
    """
    with open(path, "rb") as f:
        buf = f.read()
    hits = []
    for empty_tag in (_TAG_EMPTY_FIRST, _TAG_NODE_FIRST):
        for order in _FIELD_ORDERS:
            for size_first in (False, True):
                out = _try_layout(buf, empty_tag, order, size_first)
                if out is not None:
                    hits.append((empty_tag, order, out))
    if not hits:
        raise KdtFormatError(
            f"{path}: no supported stars.kdt layout matches (is it a "
            "pre-2015 cereal encoding?). Rebuild the grid from the PPM "
            "catalogue instead: python -m blackstar_tpu_torch generate-grid"
        )
    # Distinct layouts that both fully parse must contain the same stars
    # (tag/field permutations of identical payloads); keep the first.
    out = hits[0][2]
    pos = np.array([p for p, _, _ in out], np.float64)
    mag = np.array([m for _, m, _ in out], np.int32)
    chars = [c for _, _, c in out]
    hue = np.array([spectral_color(c)[0] for c in chars])
    sat = np.array([spectral_color(c)[1] for c in chars])
    return Catalog(pos=pos, mag=mag, hue=hue, sat=sat)


# ---------------------------------------------------------------------------
# Writer — a balanced median-split tree in the canonical layout, so existing
# reference installs can consume grids we ship (and the reader round-trips).
# ---------------------------------------------------------------------------


def _spectral_char(hue: float, sat: float) -> str:
    """Inverse of spectral_color: recover the MK class char (exact table)."""
    for c in "OBAFGKM":
        if spectral_color(c) == (hue, sat):
            return c
    return "?"


def write_kdt(catalog: Catalog, path: str, *, empty_tag: int = _TAG_EMPTY_FIRST,
              order: str = "LPAR") -> str:
    """Serialize a catalogue as a ``stars.kdt`` (median-split k-d tree,
    axes cycled x→y→z like ``Data.KdMap.Static.build`` over ``toList``)."""
    chunks: List[bytes] = [b"\x00\x00"]
    node_tag = 1 - empty_tag
    pos = np.asarray(catalog.pos, np.float64)
    mag = np.asarray(catalog.mag)
    chars = [_spectral_char(h, s) for h, s in zip(catalog.hue, catalog.sat)]

    def payload(i: int) -> bytes:
        return (
            struct.pack(">ddd", *pos[i])
            + struct.pack(">q", int(mag[i]))
            + chars[i].encode("utf-8")
        )

    def emit(idx: np.ndarray, depth: int) -> None:
        if idx.size == 0:
            chunks.append(bytes([empty_tag]))
            return
        axis = depth % 3
        o = idx[np.argsort(pos[idx, axis], kind="stable")]
        m = o.size // 2
        chunks.append(bytes([node_tag]))
        axv = struct.pack(">d", pos[o[m], axis])
        if order == "LPAR":
            emit(o[:m], depth + 1)
            chunks.append(payload(o[m]) + axv)
            emit(o[m + 1:], depth + 1)
        elif order == "PALR":
            chunks.append(payload(o[m]) + axv)
            emit(o[:m], depth + 1)
            emit(o[m + 1:], depth + 1)
        else:  # LRPA
            emit(o[:m], depth + 1)
            emit(o[m + 1:], depth + 1)
            chunks.append(payload(o[m]) + axv)

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * int(np.ceil(np.log2(max(2, pos.shape[0])))) + 100))
    try:
        emit(np.arange(pos.shape[0], dtype=np.int64), 0)
    finally:
        sys.setrecursionlimit(old)
    chunks.append(struct.pack(">q", pos.shape[0]))
    data = b"".join(chunks)
    with open(path, "wb") as f:
        f.write(data)
    return path
