"""Port parity: the dynamic-gather probe's plain versions
(``blackstar_tpu_torch/scripts/probe_dynamic_gather.py``) against the TPU
probe's Pallas kernels ``scripts/probe_dynamic_gather.py`` in interpret mode,
on the probe's own seeded inputs, on the CPU. The TPU probe is loaded by file
path and not changed."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackstar_tpu_torch.scripts import probe_dynamic_gather as tprobe

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "_jax_probe_dynamic_gather", os.path.join(_ROOT, "scripts", "probe_dynamic_gather.py"))
jprobe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jprobe)


def _inputs(rows, cols, hi):
    """The TPU probe's table and indices for one size (float32, int32)."""
    rng = np.random.default_rng(0)
    tbl = rng.standard_normal((rows, cols)).astype(np.float32)
    idx_shape = (rows, 1) if hi == rows else (rows, cols)
    return tbl, rng.integers(0, hi, idx_shape).astype(np.int32)


@pytest.mark.parametrize("rows", tprobe.ROW_GATHER_ROWS)
def test_row_gather_matches_pallas(rows):
    cols = tprobe.ROW_GATHER_COLS
    tbl, idx = _inputs(rows, cols, rows)
    want = np.asarray(jprobe._pallas_row_gather(rows, cols, True)(idx, tbl))
    got = tprobe.row_gather_cuda(torch.from_numpy(tbl), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,m,cols", tprobe.ROW_GATHER_CHECKS)
def test_row_gather_checks_match_jax(rows, m, cols):
    """The entry point's untimed checks: R that fill no whole block, tables
    of M != R rows with indices 0, M - 1 and a repeat, which the TPU probe's
    kernel (a table of R rows) never takes, and a row wider than one pass of
    the kernel's loads; held to the Pallas kernel where M == R and to
    ``jnp.take`` otherwise."""
    tbl, idx = tprobe.row_gather_inputs(rows, m, cols)
    assert tbl.shape == (m, cols) and idx.shape == (rows, 1)
    if m == rows:
        np.testing.assert_array_equal(tbl, _inputs(rows, cols, rows)[0])
        want = np.asarray(jprobe._pallas_row_gather(rows, tbl.shape[1], True)(idx, tbl))
    else:
        assert idx.min() == 0 and idx.max() == m - 1 and len(np.unique(idx)) < rows
        want = np.asarray(jnp.take(jnp.asarray(tbl), jnp.asarray(idx[:, 0]), axis=0))
    got = tprobe.row_gather_cuda(torch.from_numpy(tbl), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", ["L unaligned", "idx not (R, 1)", "tbl not 2-D"])
def test_row_gather_rejects_what_the_kernel_cannot_take(device, case):
    """The wrapper's checks run before it picks the kernel or the plain
    version, so the CPU and a meta tensor (no data) raise as the card would."""
    tbl_shape, idx_shape = (16, 256), (8, 1)
    if case == "L unaligned":
        tbl_shape = (16, 126)
    elif case == "idx not (R, 1)":
        idx_shape = (8, 2)
    else:
        tbl_shape = (256,)
    tbl = torch.zeros(tbl_shape, device=device)
    idx = torch.zeros(idx_shape, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="row_gather_cuda: (L must be|tbl must be)"):
        tprobe.row_gather_cuda(tbl, idx)


@pytest.mark.parametrize("rows,cols", [(8, 128), (256, 128)])
def test_lane_gather_matches_pallas(rows, cols):
    tbl, idx = _inputs(rows, cols, cols)
    want = np.asarray(jprobe._pallas_lane_gather(rows, cols, True)(idx, tbl))
    got = tprobe.lane_gather_cuda(torch.from_numpy(tbl), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def _range_copies():
    """The port's range copy of the TPU probe's seeded table at each of its
    sizes, beside the slice the TPU probe holds its range DMA to:
    tbl[128:128+rows, :128]."""
    rng = np.random.default_rng(0)
    tbl = rng.standard_normal(tprobe.RANGE_TABLE).astype(np.float32)
    start = torch.tensor([tprobe.RANGE_START], dtype=torch.int32)
    for rows in tprobe.RANGE_ROWS:
        got = tprobe.range_copy_cuda(torch.from_numpy(tbl), start, rows)
        yield got.numpy(), tbl[128:128 + rows, :128]


def test_range_copy_matches_probe_slice():
    for got, want in _range_copies():
        np.testing.assert_array_equal(got, want)


def test_range_copy_matches_probe_dma_interpret(capsys):
    """The TPU probe's own range DMA, run in interpret mode, holds its copy
    to that slice at every size; the port's copy equals the same slice of
    the same seeded table."""
    jprobe.probe_range_dma(True)
    out = capsys.readouterr().out
    assert out.count("ok=True") == len(tprobe.RANGE_ROWS), out
    for got, want in _range_copies():
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", ["out_cols unaligned", "out_cols too wide", "rows past table",
                                  "no rows", "table width unaligned"])
def test_range_copy_rejects_what_the_kernel_cannot_take(device, case):
    """The wrapper's checks run before it picks the kernel or the plain
    version, so the CPU and a meta tensor (no data) raise as the card would."""
    m, cols, rows, out_cols = 64, 256, 8, 128
    if case == "out_cols unaligned":
        out_cols = 126
    elif case == "out_cols too wide":
        out_cols = tprobe.COPY_MAX_COLS + 4
        cols = 2 * tprobe.COPY_MAX_COLS
    elif case == "rows past table":
        rows = m + 1
    elif case == "no rows":
        rows = 0
    else:
        cols, out_cols = 130, 8
    tbl = torch.zeros((m, cols), device=device)
    start = torch.zeros((1,), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="range_copy_cuda: (out_cols|rows)"):
        tprobe.range_copy_cuda(tbl, start, rows, out_cols)


def test_range_copy_plain_rejects_a_start_past_the_table():
    """``start + rows <= M``, which the wrapper cannot check on the card
    without waiting for it, is checked by the plain version."""
    tbl = torch.zeros((64, 256))
    start = torch.tensor([60], dtype=torch.int32)
    np.testing.assert_array_equal(tprobe.range_copy_cuda(tbl, start, 4).numpy(), np.zeros((4, 128)))
    with pytest.raises(IndexError):
        tprobe.range_copy_cuda(tbl, start, 5)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("cols", [126, tprobe.LANE_MAX_COLS + 4])
def test_lane_gather_rejects_widths_the_kernel_cannot_take(device, cols):
    tbl = torch.zeros((8, cols), device=device)
    idx = torch.zeros((8, cols), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="lane_gather_cuda: L must be"):
        tprobe.lane_gather_cuda(tbl, idx)


def test_entry_point_cpu(capsys):
    results, path = tprobe.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(results) == 12 and all(r["ok"] for r in results)
    assert out.count("ok=True") == 12
    checks = len(tprobe.ROW_GATHER_CHECKS)
    assert out.count("equal to the plain version and numpy") == checks
    assert path["row gather launches"] == 0 and path["row gather plain calls"] == 6 + checks


@pytest.mark.parametrize("which", ["row", "lane", "range"])
def test_wrappers_reject_other_devices(which):
    tbl = torch.empty((8, 256), device="meta")
    idx = torch.empty((8, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if which == "row":
            tprobe.row_gather_cuda(tbl, idx)
        elif which == "lane":
            tprobe.lane_gather_cuda(tbl, idx.expand(8, 256))
        else:
            tprobe.range_copy_cuda(tbl, idx[:, 0][:1], 4)
