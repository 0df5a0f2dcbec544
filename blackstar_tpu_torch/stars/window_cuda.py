"""Wrappers of the windowed star stage's kernels K1 and K2 (both in
``csrc/star_window.cu``).

K1 and K2 replace the TPU prototype's Pallas kernels ``_k1_kernel`` and
``_k2_kernel`` (``scripts/proto_window_kernel.py:102`` and ``:136``). They
take the arguments of their plain versions, :func:`window.k1_reference` and
:func:`window.k2_reference`, and return the same; see the source's header
for what bounds them.

Each wrapper takes the plain path for rays on the CPU, launches its kernel
for rays on a CUDA device, and raises for anything else. It never falls
back from the kernel to the plain version.
"""

from __future__ import annotations

import os

import torch

from blackstar_tpu_torch.ops import _build
from blackstar_tpu_torch.ops._build import D, I, L, P
from blackstar_tpu_torch.stars import window

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "star_window.cu")
# No multiply-add contraction: each f32 operation rounds as the plain
# version's does (the PSF is sensitive to it; see the source's header).
FLAGS = ("-fmad=false",)

LIBRARY = _build.Library(SOURCE, FLAGS, {
    "bs_window_k1": _build.Entry((P,) * 6 + (L, I, I, P, I, I) + (D,) * 5 + (P, P, P),
                                 dtyped=True),
    "bs_window_k2": _build.Entry((P,) * 6 + (L, I, I, P, L, P) + (D,) * 5 + (P, P),
                                 dtyped=True),
})


def _device(what: str, rx: torch.Tensor) -> str:
    dev = rx.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {rx.device}")
    return dev


def _check_rays(what, n_tiles, covered, rx, ry, rz, ints):
    """Validate the per-ray and per-tile arguments of a launch."""
    n = rx.shape[0]
    dev, dt = rx.device, rx.dtype
    if dt not in _build.DTYPES:
        raise ValueError(f"{what}: unsupported dtype {dt}")
    if n != n_tiles * window.T:
        raise ValueError(f"{what}: {n} rays for {n_tiles} tiles of {window.T}")
    for name, t, want in (("ry", ry, dt), ("rz", rz, dt), ("covered", covered, torch.bool),
                          *((k, v, torch.int32) for k, v in ints.items())):
        if t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {want} tensor on {dev}")
    for name, t in (("ry", ry), ("rz", rz), ("covered", covered)):
        if t.shape != (n,):
            raise ValueError(f"{what}: {name} must be ({n},), got {tuple(t.shape)}")
    if not rx.is_contiguous() or rx.shape != (n,):
        raise ValueError(f"{what}: rx must be a contiguous ({n},) tensor")


def _table(what, t, dt, dev):
    if t.dtype != dt or t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: tables must be contiguous, 16-byte aligned {dt} on {dev}")


def k1_cuda(starts, widx, covered, rx, ry, rz, tbl3, consts, intensity, saturation):
    """K1, the base pass: :func:`window.k1_reference`'s arguments and
    results. On a CUDA device a ray that is not covered gets 0 colour and
    pointer 0."""
    if _device("k1_cuda", rx) == "cpu":
        return window.k1_reference(starts, widx, covered, rx, ry, rz, tbl3, consts,
                                   intensity, saturation)
    n, dt, dev = rx.shape[0], rx.dtype, rx.device
    n_tiles = starts.shape[0]
    _check_rays("k1_cuda", n_tiles, covered, rx, ry, rz, {"starts": starts, "widx": widx})
    if starts.shape != (n_tiles, 2) or widx.shape != (n,):
        raise ValueError("k1_cuda: starts must be (n_tiles, 2) and widx (N,)")
    _table("k1_cuda", tbl3, dt, dev)
    nr, nc, width = tbl3.shape
    if width % window.ROW or nr < window.DR or nc < window.DC:
        raise ValueError(f"k1_cuda: base table {tuple(tbl3.shape)} does not hold a window")
    out = torch.empty((3, n), dtype=dt, device=dev)  # the kernel writes every element
    optr = torch.empty((n,), dtype=torch.int32, device=dev)
    LIBRARY.call(
        "bs_window_k1", starts.data_ptr(), widx.data_ptr(), covered.data_ptr(), rx.data_ptr(),
        ry.data_ptr(), rz.data_ptr(), n, window.T, window.DC, tbl3.data_ptr(), nc,
        width // window.ROW, intensity, saturation, *consts, out.data_ptr(), optr.data_ptr(),
        dtype=dt, device=dev)
    k1_cuda.launches += 1
    return out[0], out[1], out[2], optr


k1_cuda.launches = 0  # kernel launches: shows the stage went through K1


def k2_cuda(s2, optr, covered, rx, ry, rz, ovf_tbl, octets, consts, intensity, saturation):
    """K2, the overflow pass: :func:`window.k2_reference`'s arguments and
    results. Each taking part ray scans only its own row's used octets."""
    if _device("k2_cuda", rx) == "cpu":
        return window.k2_reference(s2, optr, covered, rx, ry, rz, ovf_tbl, octets, consts,
                                   intensity, saturation)
    n, dt, dev = rx.shape[0], rx.dtype, rx.device
    n_tiles = s2.shape[0]
    _check_rays("k2_cuda", n_tiles, covered, rx, ry, rz,
                {"s2": s2, "optr": optr, "octets": octets})
    if s2.shape != (n_tiles,) or optr.shape != (n,):
        raise ValueError("k2_cuda: s2 must be (n_tiles,) and optr (N,)")
    _table("k2_cuda", ovf_tbl, dt, dev)
    if ovf_tbl.dim() != 2 or octets.shape != (ovf_tbl.shape[0],):
        raise ValueError("k2_cuda: the overflow table must be (rows, width) with (rows,) octets")
    out = torch.empty((3, n), dtype=dt, device=dev)
    LIBRARY.call(
        "bs_window_k2", s2.data_ptr(), optr.data_ptr(), covered.data_ptr(), rx.data_ptr(),
        ry.data_ptr(), rz.data_ptr(), n, window.T, window.OVW, ovf_tbl.data_ptr(),
        ovf_tbl.shape[1], octets.data_ptr(), intensity, saturation, *consts, out.data_ptr(),
        dtype=dt, device=dev)
    k2_cuda.launches += 1
    return out[0], out[1], out[2]


k2_cuda.launches = 0  # kernel launches: shows the stage went through K2
