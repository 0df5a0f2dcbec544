"""Dynamic-gather probe on the card: the port of
``scripts/probe_dynamic_gather.py``, which priced the gather and copy
primitives a windowed star kernel is built from on a TPU.

Three kernels (``csrc/probe_dynamic_gather.cu``), each with its plain
PyTorch version beside its wrapper:

* row gather, ``out[i, :] = tbl[idx[i], :]`` (plain: ``tbl[idx[:, 0]]``);
* lane gather, ``out[i, j] = tbl[i, idx[i, j]]`` (plain:
  ``torch.take_along_dim``);
* range copy, ``out = tbl[start:start+rows, :128]`` with ``start`` read on
  the device (plain: ``index_select`` of the rows from ``start`` on).

Run::

    python -m blackstar_tpu_torch.scripts.probe_dynamic_gather               # the card
    python -m blackstar_tpu_torch.scripts.probe_dynamic_gather --device cpu  # plain versions
    python -m blackstar_tpu_torch.scripts.probe_dynamic_gather --source A.cu --source B.cu

At each of the TPU probe's sizes it runs the kernel and requires its output
to equal the plain version's bit for bit (anything else raises: unlike the
TPU probe, nothing is caught), and the row gather also, untimed, at
:data:`ROW_GATHER_CHECKS`. On the card it then times, as the TPU probe
times its primitives at the device's steady state (300 calls in one jitted
loop), the kernel's wrapper, the plain version, one PyTorch call for the
same work (``torch.index_select``, ``torch.gather``, ``Tensor.copy_`` of the
slice: the yardstick, which the port never calls) and an empty kernel
launched with the kernel's grid and block (the floor no kernel of that
shape goes below), each as one CUDA graph of 300 calls replayed warm
(:func:`~blackstar_tpu_torch.scripts.graph_ms`; the wrappers are captured as
a caller calls them, their outputs allocated from the graph's pool, and the
tables stay in L2 as they do in the TPU loop). Beside those it gives the
wrapper's time per call launched from the host (CUDA events): what a Python
caller pays. ``--source`` (repeatable) times the kernels of other builds of
the source with the same C interface in turns (A, B, B, A), e.g. an earlier
commit's; a build without the empty kernel gets no floor.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os

import numpy as np
import torch

from blackstar_tpu_torch.ops import _build
from blackstar_tpu_torch.ops._build import I, P
from blackstar_tpu_torch.scripts import cuda_ms, graph_ms

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "probe_dynamic_gather.cu")
FLAGS = ("-fmad=false",)
LANE_MAX_COLS = 1024  # kLaneMaxCols in the source: the widest row the lane gather stages
COPY_MAX_COLS = 256  # kCopyMaxCols in the source: the widest output row the range copy stages
ROW_GATHER, LANE_GATHER, RANGE_COPY = 0, 1, 2  # the source's Kernel enum

ROW_GATHER_ROWS = (8, 64, 256, 512, 1024, 2048)
ROW_GATHER_COLS = 256
# (R, M, L) the row gather is also held to its plain version at, untimed: R
# that fill no whole number of blocks, tables of M != R rows (the TPU
# probe's table has R) with indices 0, M - 1 and a repeat among them, and a
# row wider than one pass of the kernel's loads (L 1028: 257 float4s).
ROW_GATHER_CHECKS = ((1, 1, 256), (7, 7, 256), (2047, 2047, 256), (64, 1 << 16, 256),
                     (2048, 3, 256), (33, 40, 1028))
LANE_GATHER_SHAPES = ((8, 128), (256, 128), (512, 256))
RANGE_TABLE = (1 << 16, 256)  # 64 MB of float32
RANGE_ROWS = (64, 256, 1024)
RANGE_START = 128
RANGE_OUT_COLS = 128
REPS = 300  # calls per timing on the card
# The H100 SXM's published HBM rate (NVIDIA data sheet, 700 W), for the
# bound printed beside each size.
PEAK_BYTES_S = 3.35e12

_PI = ctypes.POINTER(ctypes.c_int)
# A build of the first design lacks the last two entries.
LIBRARY = _build.Library(SOURCE, FLAGS, {
    "bs_row_gather_f32": _build.Entry((P, P, I, I, P, P)),
    "bs_lane_gather_f32": _build.Entry((P, P, I, I, P, P)),
    "bs_range_copy_f32": _build.Entry((P, P, I, I, I, P, P)),
    "bs_probe_dims": _build.Entry((I, I, _PI, _PI), stream=False, optional=True),
    "bs_empty": _build.Entry((I, I, P), optional=True),
})


def launch_dims(which: int, rows: int):
    """``(grid, block)`` the kernel ``which`` (:data:`ROW_GATHER`,
    :data:`LANE_GATHER`, :data:`RANGE_COPY`) is launched with for ``rows``
    rows, or None for a build without the query."""
    fn = LIBRARY.entry("bs_probe_dims")
    if fn is None:
        return None
    grid, block = ctypes.c_int(), ctypes.c_int()
    fn(which, rows, ctypes.byref(grid), ctypes.byref(block))
    return grid.value, block.value


def empty_cuda(grid: int, block: int, device) -> None:
    """Launch the empty kernel with ``grid`` blocks of ``block`` threads on
    ``device``'s current stream: a launch and nothing else."""
    LIBRARY.call("bs_empty", grid, block, device=device)


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
    with entries in ``[0, M)``, L a multiple of 4 (the kernel moves whole
    16-byte float4s): the kernel on a CUDA device, the plain version on the
    CPU. Raises on any other shape, on every device, and on the card unless
    ``tbl`` starts on 16 bytes."""
    if tbl.dim() != 2 or idx.dim() != 2 or idx.shape[1] != 1:
        raise ValueError("row_gather_cuda: tbl must be (M, L) and idx (R, 1)")
    rows, cols = idx.shape[0], tbl.shape[1]
    if cols % 4:
        raise ValueError(f"row_gather_cuda: L must be a multiple of 4, got {cols}")
    if not _on_card("row_gather_cuda", (tbl, idx)):
        return row_gather_reference(tbl, idx)
    if tbl.data_ptr() % 16:
        raise ValueError("row_gather_cuda: tbl must start on 16 bytes")
    out = torch.empty((rows, cols), dtype=tbl.dtype, device=tbl.device)
    LIBRARY.call("bs_row_gather_f32", tbl.data_ptr(), idx.data_ptr(), rows, cols,
                 out.data_ptr(), device=tbl.device)
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
    ``[0, L)``, L a multiple of 4 of at most :data:`LANE_MAX_COLS` (the
    kernel stages a row in shared memory and reads its indices as int4s;
    the TPU probe's widths are 128 and 256): the kernel on a CUDA device,
    the plain version on the CPU. Raises on any other shape, on every
    device."""
    if idx.shape != tbl.shape or tbl.dim() != 2:
        raise ValueError("lane_gather_cuda: idx and tbl must have one (R, L) shape")
    rows, cols = tbl.shape
    if cols % 4 or cols > LANE_MAX_COLS:
        raise ValueError(f"lane_gather_cuda: L must be a multiple of 4 of at most "
                         f"{LANE_MAX_COLS}, got {cols}")
    if not _on_card("lane_gather_cuda", (tbl, idx)):
        return lane_gather_reference(tbl, idx)
    if tbl.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError("lane_gather_cuda: tbl and idx must start on 16 bytes")
    out = torch.empty_like(tbl)
    LIBRARY.call("bs_lane_gather_f32", tbl.data_ptr(), idx.data_ptr(), rows, cols,
                 out.data_ptr(), device=tbl.device)
    lane_gather_cuda.launches += 1
    return out


lane_gather_cuda.launches = 0


def range_copy_reference(tbl: torch.Tensor, start: torch.Tensor, rows: int,
                         out_cols: int = RANGE_OUT_COLS) -> torch.Tensor:
    """``tbl[start:start+rows, :out_cols]`` as a new tensor, in plain
    PyTorch, with ``start`` (1,) int32 read on the tensors' device (an
    ``index_select`` of the rows, which raises, or asserts on the card, for
    a row past the table)."""
    range_copy_reference.calls += 1
    r = start.long() + torch.arange(rows, device=tbl.device)
    return torch.index_select(tbl[:, :out_cols], 0, r)


range_copy_reference.calls = 0


def range_copy_cuda(tbl: torch.Tensor, start: torch.Tensor, rows: int,
                    out_cols: int = RANGE_OUT_COLS) -> torch.Tensor:
    """The range copy for ``tbl`` (M, L) float32 and ``start`` (1,) int32,
    read on the device: the kernel on a CUDA device, the plain version on
    the CPU.

    Raises, on every device, unless ``0 < rows <= M`` and ``0 < out_cols <=
    min(L, COPY_MAX_COLS)`` with L and ``out_cols`` multiples of 4 (the
    kernel's bulk copies move whole 16-byte runs from 16-byte addresses),
    and on the card unless ``tbl`` starts on 16 bytes. ``start + rows <=
    M`` is the caller's to keep: the wrapper cannot read ``start`` without
    waiting for the card, so it is not checked there (the plain version
    checks it)."""
    m, cols = tbl.shape
    if start.shape != (1,):
        raise ValueError("range_copy_cuda: start must be (1,)")
    if not 0 < rows <= m:
        raise ValueError(f"range_copy_cuda: rows must be in [1, {m}] (the table's), got {rows}")
    if not 0 < out_cols <= min(cols, COPY_MAX_COLS) or out_cols % 4 or cols % 4:
        raise ValueError(f"range_copy_cuda: out_cols must be a multiple of 4 of at most "
                         f"min(L, {COPY_MAX_COLS}), and L a multiple of 4; got out_cols "
                         f"{out_cols}, L {cols}")
    if not _on_card("range_copy_cuda", (tbl, start)):
        return range_copy_reference(tbl, start, rows, out_cols)
    if tbl.data_ptr() % 16:
        raise ValueError("range_copy_cuda: tbl must start on 16 bytes")
    out = torch.empty((rows, out_cols), dtype=tbl.dtype, device=tbl.device)
    LIBRARY.call("bs_range_copy_f32", tbl.data_ptr(), start.data_ptr(), rows, cols, out_cols,
                 out.data_ptr(), device=tbl.device)
    range_copy_cuda.launches += 1
    return out


range_copy_cuda.launches = 0

WRAPPERS = {"row gather": (row_gather_cuda, row_gather_reference),
            "lane gather": (lane_gather_cuda, lane_gather_reference),
            "range copy": (range_copy_cuda, range_copy_reference)}


def counts() -> dict:
    """Every kernel launch and plain call count of the probe. A call
    captured into a CUDA graph counts once; the graph's replays launch its
    kernels without the wrapper and are not counted."""
    out = {}
    for name, (wrapper, plain) in WRAPPERS.items():
        out[f"{name} launches"] = wrapper.launches
        out[f"{name} plain calls"] = plain.calls
    return out


def _probe(name, size, kernel_call, plain_call, library_call, want, units, nbytes, moved,
           dims, reps, path):
    """Run one size: the kernel (counted into ``path``), its check against the
    plain version and, on the card, the graph-clocked times of the kernel,
    the plain version, the library call and the empty kernel at the
    kernel's grid (``dims``: its :func:`launch_dims` arguments), and the
    wrapper's time per host call."""
    before = counts()
    got = kernel_call()
    on_card = got.device.type == "cuda"
    res = {"kernel": name, "size": size, "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_S * 1e3}
    if on_card:
        res["kernel_ms"] = graph_ms(kernel_call, reps)
        res["ms"] = cuda_ms(kernel_call, reps)
    for k, v in counts().items():
        path[k] = path.get(k, 0) + v - before[k]
    plain = plain_call() if on_card else got
    ok = torch.equal(got, plain) and np.array_equal(plain.cpu().numpy(), want)
    if not ok:
        raise AssertionError(f"{name} {size}: the kernel and its plain version differ")
    res["ok"] = ok
    msg = f"{size}: ok={ok}"
    if on_card:
        res["plain_ms"] = graph_ms(plain_call, reps)
        res["library_ms"] = graph_ms(library_call, reps)
        grid = launch_dims(*dims)
        res["floor_ms"] = None if grid is None else graph_ms(
            functools.partial(empty_cuda, *grid, got.device), reps)
        count, unit = units
        kms, floor = res["kernel_ms"], res["floor_ms"]
        floor_txt = "not measured" if floor is None else f"{floor:.5f}"
        msg += (f"  kernel {kms:.5f} ms ({kms * 1e6 / count:8.3f} ns/{unit}, "
                f"{moved / kms / 1e6:7.1f} GB/s effective), floor {floor_txt}, bound "
                f"{res['bound_ms']:.5f} ms (bytes), bound/kernel {res['bound_ms'] / kms:.3f}")
        if floor is not None:
            msg += f", max(bound, floor)/kernel {max(res['bound_ms'], floor) / kms:.3f}"
        library = getattr(library_call, "func", library_call).__name__
        msg += (f"; plain {res['plain_ms']:.5f}, {library} {res['library_ms']:.5f} ms (graph "
                f"clock, grid {grid}); wrapper {res['ms']:.5f} ms a host call")
    print(msg, flush=True)
    return res


def row_gather_inputs(rows: int, m: int, cols: int = ROW_GATHER_COLS):
    """A seeded (M, L) float32 table and (R, 1) int32 indices into it. For
    M == R they are the TPU probe's; otherwise the indices hold 0, M - 1
    and a repeat of the first."""
    rng = np.random.default_rng(0)
    tbl = rng.standard_normal((m, cols)).astype(np.float32)
    idx = rng.integers(0, m, (rows, 1)).astype(np.int32)
    if m != rows:
        idx[0, 0], idx[-1, 0] = 0, m - 1
        idx[rows // 2, 0] = idx[0, 0]
    return tbl, idx


def check_row_gather(device: torch.device, path: dict) -> None:
    """Hold the row gather to its plain version and to numpy, bit for bit,
    at each (R, M, L) of :data:`ROW_GATHER_CHECKS`; the kernel's runs are
    counted into ``path``, the plain version's are not. Raises on a
    difference."""
    for rows, m, cols in ROW_GATHER_CHECKS:
        tbl_np, idx_np = row_gather_inputs(rows, m, cols)
        tbl, idx = torch.from_numpy(tbl_np).to(device), torch.from_numpy(idx_np).to(device)
        before = counts()
        got = row_gather_cuda(tbl, idx)
        for k, v in counts().items():
            path[k] = path.get(k, 0) + v - before[k]
        plain = row_gather_reference(tbl, idx) if got.device.type == "cuda" else got
        if not (torch.equal(got, plain) and np.array_equal(plain.cpu().numpy(),
                                                           tbl_np[idx_np[:, 0]])):
            raise AssertionError(f"row gather R={rows} M={m} L={cols}: the kernel and its "
                                 f"plain version differ")
        print(f"R={rows:5d} M={m:5d} L={cols}: equal to the plain version and numpy")


def run(device: torch.device, reps: int = REPS):
    """Every probe at the TPU probe's sizes on ``device``; returns
    ``(results, path)``: one dict per size (the least bytes its function
    moves and their time at :data:`PEAK_BYTES_S`, and on the card the times
    :func:`_probe` takes), and the launch and plain call counts of the
    kernel's runs and timings, the row gather's :func:`check_row_gather`
    included (the plain versions' checks and timings are not in them)."""
    results, path = [], {}
    print("--- row gather out[i, :] = tbl[idx[i], :] ---")
    for rows in ROW_GATHER_ROWS:
        cols = ROW_GATHER_COLS
        tbl_np, idx_np = row_gather_inputs(rows, rows)
        tbl, idx = torch.from_numpy(tbl_np).to(device), torch.from_numpy(idx_np).to(device)
        flat = idx[:, 0].long()
        dst = torch.empty((rows, cols), dtype=tbl.dtype, device=device)
        nbytes = idx_np.nbytes + (len(np.unique(idx_np)) + rows) * cols * 4
        results.append(_probe(
            "row gather", f"R={rows:5d} L={cols}", functools.partial(row_gather_cuda, tbl, idx),
            functools.partial(row_gather_reference, tbl, idx),
            functools.partial(torch.index_select, tbl, 0, flat, out=dst), tbl_np[idx_np[:, 0]],
            (rows, "row"), nbytes, rows * cols * 4, (ROW_GATHER, rows), reps, path))
    check_row_gather(device, path)
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
            rows * cols * 4, (LANE_GATHER, rows), reps, path))
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
            (rows, "row"), 4 + 2 * rows * RANGE_OUT_COLS * 4, moved,
            (RANGE_COPY, rows), reps, path))
    return results, path


def main(argv=None):
    global LIBRARY
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    ap.add_argument("--source", action="append", default=[],
                    help="a build of csrc/probe_dynamic_gather.cu to time in turns with the "
                    "others (repeatable; default the package's)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_dynamic_gather: no CUDA device (use --device cpu)")
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    sources = [os.path.abspath(s) for s in args.source] or [SOURCE]
    package, totals = LIBRARY, {}
    # What is returned: the package's build's last run and its launch counts
    # where it is among the sources, else the last run and every count.
    keep = SOURCE if SOURCE in sources else None
    try:
        for src in sources + sources[::-1] if len(sources) > 1 else sources:
            # The wrappers launch from a build of src through the same table.
            LIBRARY = package if src == SOURCE else _build.Library(src, FLAGS, package.entries)
            if len(sources) > 1:
                print(f"=== {os.path.relpath(src)} ===")
            results, path = run(device)
            if keep in (None, src):
                kept = results
                for k, v in path.items():
                    totals[k] = totals.get(k, 0) + v
    finally:
        LIBRARY = package
    print(f"kernel runs: {totals}")
    return kept, totals


if __name__ == "__main__":
    main()
