"""sRGB encoding and decoding, PNG output and input.

Reference semantics: per-channel sRGB gamma
``x < 0.0031308 ? 12.92·x : 1.055·x^(1/2.4) − 0.055`` followed by a clamp to
[0,1] and round-half-even quantisation to uint8 (Raytracer.hs:23-32 and the
colour library's ``toWord8``). PNGs are written by the native library
(``native.py``) when it can be built, else by a small pure-Python encoder;
both write the same pixels, so no imaging library is needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def srgb_encode(linear: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB gamma (Raytracer.hs:23-27). Input may exceed [0,1]."""
    lo = 12.92 * linear
    # Guard pow against negatives (only the low branch is selected there).
    hi = 1.055 * torch.pow(torch.clamp(linear, min=0.0031308), 1.0 / 2.4) - 0.055
    return torch.where(linear < 0.0031308, lo, hi)


def srgb_decode(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB gamma -> linear; the exact inverse of :func:`srgb_encode` (the
    encode switch at linear 0.0031308 maps to sRGB 0.04045)."""
    return torch.where(srgb <= 0.04045, srgb / 12.92,
                       torch.pow((srgb + 0.055) / 1.055, 2.4))


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp to [0,1] and quantise with round-half-even (`toWord8`)."""
    arr = np.asarray(img, dtype=np.float64)
    return np.rint(np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def encode_rgb8(linear: torch.Tensor) -> torch.Tensor:
    """Linear RGB -> sRGB uint8 on the tensor's device (``torch.round``
    rounds half to even, like ``toWord8``)."""
    srgb = srgb_encode(linear)
    return torch.round(torch.clamp(srgb, 0.0, 1.0) * 255.0).to(torch.uint8)


def _png_bytes(rgb8: np.ndarray) -> bytes:
    """Minimal dependency-free PNG encoder (8-bit RGB, filter 0)."""
    h, w, _ = rgb8.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1
    ).tobytes()
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB PNG whose rows all use filter 0 — what
    :func:`write_png` writes — into a uint8 (H, W, 3) array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError(f"{path}: not a plain 8-bit RGB PNG")
            size = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    if size is None:
        raise ValueError(f"{path}: no IHDR chunk")
    h, w = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows use PNG filters other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def write_png(img, path: str) -> None:
    """Write an (H, W, 3) image (array or tensor) as an 8-bit RGB PNG. A
    uint8 image is taken as already sRGB-encoded; a float one as linear RGB,
    encoded here in float64 (Raytracer.hs:29-32). The encoded pixels go to
    the native writer when the library is available, else to the pure-Python
    encoder: the pixels are the same on both routes."""
    t = torch.as_tensor(img).cpu()
    if t.dtype != torch.uint8:
        t = encode_rgb8(t.to(torch.float64))
    rgb8 = np.ascontiguousarray(t.numpy())
    from blackstar_tpu_torch import native

    if native.write_png_rgb8(rgb8, path):
        return
    with open(path, "wb") as f:
        f.write(_png_bytes(rgb8))
