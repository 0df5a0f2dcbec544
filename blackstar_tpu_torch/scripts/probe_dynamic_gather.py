"""Dynamic-gather probe on the card: the port of
``scripts/probe_dynamic_gather.py``, which priced the gather and copy
primitives a windowed star kernel is built from on a TPU.

Three kernels (``csrc/probe_dynamic_gather.cu``), each with its plain
PyTorch version beside its wrapper:

* row gather, ``out[i, :] = tbl[idx[i], :]`` (plain: ``tbl[idx[:, 0]]``);
* lane gather, ``out[i, j] = tbl[i, idx[i, j]]`` (plain:
  ``torch.take_along_dim``);
* range copy, ``out = tbl[start:start+rows, :128]`` with ``start`` read on
  the device (plain: a slice copy).

Run::

    python -m blackstar_tpu_torch.scripts.probe_dynamic_gather               # the card
    python -m blackstar_tpu_torch.scripts.probe_dynamic_gather --device cpu  # plain versions

At each of the TPU probe's sizes it runs the kernel, requires its output to
equal the plain version's bit for bit (anything else raises: unlike the TPU
probe, nothing is caught), and on the card prints ns per row or element and
GB/s from CUDA events over 300 launches, beside the time of one
PyTorch call for the same work (``torch.index_select``, ``torch.gather``,
``Tensor.copy_`` of the slice). That call is the yardstick; the port never
calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os

import numpy as np
import torch

from blackstar_tpu_torch.ops import _build
from blackstar_tpu_torch.scripts import cuda_ms

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "probe_dynamic_gather.cu")
FLAGS = ("-fmad=false",)
THREADS = 256  # kThreads in the source
COPY_MAX_COLS = 256  # kCopyMaxCols in the source: the widest row the range copy stages

ROW_GATHER_ROWS = (8, 64, 256, 512, 1024, 2048)
ROW_GATHER_COLS = 256
LANE_GATHER_SHAPES = ((8, 128), (256, 128), (512, 256))
RANGE_TABLE = (1 << 16, 256)  # 64 MB of float32
RANGE_ROWS = (64, 256, 1024)
RANGE_START = 128
RANGE_OUT_COLS = 128
REPS = 300  # launches per timing on the card

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load(SOURCE, FLAGS)
    for name, argtypes in (("bs_row_gather_f32", [_P, _P, _I, _I, _P, _P]),
                           ("bs_lane_gather_f32", [_P, _P, _I, _I, _P, _P]),
                           ("bs_range_copy_f32", [_P, _P, _I, _I, _I, _P, _P])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _on_card(what: str, tensors) -> bool:
    """False for CPU tensors, True for CUDA float32/int32 tensors that the
    kernels take; raises for anything else."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cpu":
        return False
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"{what}: tensors must be contiguous float32 / int32 on {dev}")
    return True


def row_gather_reference(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = tbl[idx[i, 0], :]`` in plain PyTorch."""
    row_gather_reference.calls += 1
    return tbl[idx[:, 0].long()]


row_gather_reference.calls = 0


def row_gather_cuda(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The row gather for ``tbl`` (M, L) float32 and ``idx`` (R, 1) int32
    with entries in ``[0, M)``: the kernel on a CUDA device, the plain
    version on the CPU."""
    if not _on_card("row_gather_cuda", (tbl, idx)):
        return row_gather_reference(tbl, idx)
    rows, cols = idx.shape[0], tbl.shape[1]
    if idx.shape != (rows, 1) or cols % 4 or tbl.data_ptr() % 16:
        raise ValueError("row_gather_cuda: idx must be (R, 1) and tbl rows whole float4s")
    out = torch.empty((rows, cols), dtype=tbl.dtype, device=tbl.device)
    _build.check(build().bs_row_gather_f32(tbl.data_ptr(), idx.data_ptr(), rows, cols,
                                           out.data_ptr(), _build.stream_handle(tbl.device)),
                 "row gather kernel")
    row_gather_cuda.launches += 1
    return out


row_gather_cuda.launches = 0


def lane_gather_reference(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = tbl[i, idx[i, j]]`` in plain PyTorch."""
    lane_gather_reference.calls += 1
    return torch.take_along_dim(tbl, idx.long(), dim=1)


lane_gather_reference.calls = 0


def lane_gather_cuda(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The lane gather for ``tbl`` and ``idx`` (R, L), entries of ``idx`` in
    ``[0, L)``: the kernel on a CUDA device, the plain version on the CPU."""
    if not _on_card("lane_gather_cuda", (tbl, idx)):
        return lane_gather_reference(tbl, idx)
    if idx.shape != tbl.shape:
        raise ValueError("lane_gather_cuda: idx and tbl must have one shape")
    rows, cols = tbl.shape
    out = torch.empty_like(tbl)
    _build.check(build().bs_lane_gather_f32(tbl.data_ptr(), idx.data_ptr(), rows, cols,
                                            out.data_ptr(), _build.stream_handle(tbl.device)),
                 "lane gather kernel")
    lane_gather_cuda.launches += 1
    return out


lane_gather_cuda.launches = 0


def range_copy_reference(tbl: torch.Tensor, start: torch.Tensor, rows: int,
                         out_cols: int = RANGE_OUT_COLS) -> torch.Tensor:
    """``tbl[start:start+rows, :out_cols]`` as a new tensor, in plain
    PyTorch (``start`` (1,) int32 is read on the host)."""
    range_copy_reference.calls += 1
    s = int(start[0])
    return tbl[s:s + rows, :out_cols].clone()


range_copy_reference.calls = 0


def range_copy_cuda(tbl: torch.Tensor, start: torch.Tensor, rows: int,
                    out_cols: int = RANGE_OUT_COLS) -> torch.Tensor:
    """The range copy for ``tbl`` (M, L) float32 and ``start`` (1,) int32,
    read on the device, with ``start + rows <= M``: the kernel on a CUDA
    device, the plain version on the CPU."""
    if not _on_card("range_copy_cuda", (tbl, start)):
        return range_copy_reference(tbl, start, rows, out_cols)
    cols = tbl.shape[1]
    if (start.shape != (1,) or rows > tbl.shape[0] or not 0 < out_cols <= cols
            or cols > COPY_MAX_COLS or cols % 4 or tbl.data_ptr() % 16):
        raise ValueError("range_copy_cuda: start must be (1,) and the rows whole float4s "
                         f"of at most {COPY_MAX_COLS} floats")
    out = torch.empty((rows, out_cols), dtype=tbl.dtype, device=tbl.device)
    _build.check(build().bs_range_copy_f32(tbl.data_ptr(), start.data_ptr(), rows, cols,
                                           out_cols, out.data_ptr(),
                                           _build.stream_handle(tbl.device)),
                 "range copy kernel")
    range_copy_cuda.launches += 1
    return out


range_copy_cuda.launches = 0

WRAPPERS = {"row gather": (row_gather_cuda, row_gather_reference),
            "lane gather": (lane_gather_cuda, lane_gather_reference),
            "range copy": (range_copy_cuda, range_copy_reference)}


def counts() -> dict:
    """Every kernel launch and plain call count of the probe."""
    out = {}
    for name, (wrapper, plain) in WRAPPERS.items():
        out[f"{name} launches"] = wrapper.launches
        out[f"{name} plain calls"] = plain.calls
    return out


def _probe(name, size, kernel_call, plain_call, library_call, want, units, nbytes, moved,
           reps, path):
    """Run one size: the kernel (counted into ``path``), its check against the
    plain version and, on the card, its time and the library call's."""
    before = counts()
    got = kernel_call()
    on_card = got.device.type == "cuda"
    ms = cuda_ms(kernel_call, reps) if on_card else None
    for k, v in counts().items():
        path[k] = path.get(k, 0) + v - before[k]
    plain = plain_call() if on_card else got
    ok = torch.equal(got, plain) and np.array_equal(plain.cpu().numpy(), want)
    if not ok:
        raise AssertionError(f"{name} {size}: the kernel and its plain version differ")
    res = {"kernel": name, "size": size, "ok": ok, "bytes": nbytes, "call": kernel_call,
           "ms": ms,
           "plain_ms": cuda_ms(plain_call, reps) if on_card else None,
           "library_ms": cuda_ms(library_call, reps) if on_card else None}
    msg = f"{size}: ok={ok}"
    if on_card:
        count, unit = units
        msg += (f"  {ms * 1e6 / count:8.3f} ns/{unit} ({moved / ms / 1e6:7.1f} GB/s effective)"
                f"; plain {res['plain_ms'] * 1e6 / count:8.3f}, library "
                f"{res['library_ms'] * 1e6 / count:8.3f} ns/{unit}")
    print(msg, flush=True)
    return res


def run(device: torch.device, reps: int = REPS):
    """Every probe at the TPU probe's sizes on ``device``; returns
    ``(results, path)``: one dict per size (its kernel's call, the least
    bytes its function moves, and on the card the kernel's, the plain
    version's and the library call's milliseconds), and the launch and
    plain call counts of the kernel runs alone (the checks against the plain
    versions are not in them)."""
    results, path = [], {}
    print("--- row gather out[i, :] = tbl[idx[i], :] ---")
    for rows in ROW_GATHER_ROWS:
        cols = ROW_GATHER_COLS
        rng = np.random.default_rng(0)
        tbl_np = rng.standard_normal((rows, cols)).astype(np.float32)
        idx_np = rng.integers(0, rows, (rows, 1)).astype(np.int32)
        tbl, idx = torch.from_numpy(tbl_np).to(device), torch.from_numpy(idx_np).to(device)
        flat = idx[:, 0].long()
        dst = torch.empty((rows, cols), dtype=tbl.dtype, device=device)
        nbytes = idx_np.nbytes + (len(np.unique(idx_np)) + rows) * cols * 4
        results.append(_probe(
            "row gather", f"R={rows:5d} L={cols}", functools.partial(row_gather_cuda, tbl, idx),
            functools.partial(row_gather_reference, tbl, idx),
            functools.partial(torch.index_select, tbl, 0, flat, out=dst), tbl_np[idx_np[:, 0]],
            (rows, "row"), nbytes, rows * cols * 4, reps, path))
    print("--- lane gather out[i, j] = tbl[i, idx[i, j]] ---")
    for rows, cols in LANE_GATHER_SHAPES:
        rng = np.random.default_rng(0)
        tbl_np = rng.standard_normal((rows, cols)).astype(np.float32)
        idx_np = rng.integers(0, cols, (rows, cols)).astype(np.int32)
        tbl, idx = torch.from_numpy(tbl_np).to(device), torch.from_numpy(idx_np).to(device)
        idx64 = idx.long()
        dst = torch.empty_like(tbl)
        distinct = sum(len(np.unique(r)) for r in idx_np)
        nbytes = idx_np.nbytes + (distinct + rows * cols) * 4
        results.append(_probe(
            "lane gather", f"R={rows:5d} L={cols}", functools.partial(lane_gather_cuda, tbl, idx),
            functools.partial(lane_gather_reference, tbl, idx),
            functools.partial(torch.gather, tbl, 1, idx64, out=dst),
            np.take_along_axis(tbl_np, idx_np, axis=1), (rows * cols, "elem"), nbytes,
            rows * cols * 4, reps, path))
    print("--- dynamic-start range copy out = tbl[start:start+rows, :128] ---")
    rng = np.random.default_rng(0)
    tbl_np = rng.standard_normal(RANGE_TABLE).astype(np.float32)
    tbl = torch.from_numpy(tbl_np).to(device)
    start = torch.tensor([RANGE_START], dtype=torch.int32, device=device)
    for rows in RANGE_ROWS:
        src = tbl[RANGE_START:RANGE_START + rows, :RANGE_OUT_COLS]
        dst = torch.empty((rows, RANGE_OUT_COLS), dtype=tbl.dtype, device=device)
        moved = rows * RANGE_TABLE[1] * 4
        results.append(_probe(
            "range copy", f"rows={rows:5d} ({moved // 1024:5d} KB)",
            functools.partial(range_copy_cuda, tbl, start, rows),
            functools.partial(range_copy_reference, tbl, start, rows),
            functools.partial(dst.copy_, src), tbl_np[RANGE_START:RANGE_START + rows, :RANGE_OUT_COLS],
            (rows, "row"), 4 + 2 * rows * RANGE_OUT_COLS * 4, moved, reps, path))
    return results, path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_dynamic_gather: no CUDA device (use --device cpu)")
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    results, path = run(device)
    print(f"kernel runs: {path}")
    return results, path


if __name__ == "__main__":
    main()
