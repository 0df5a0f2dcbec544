"""Port parity: the windowed star stage (``blackstar_tpu_torch/stars/window.py``
and its entry point) against the TPU prototype ``scripts/proto_window_kernel.py``
run in interpret mode, on the prototype's own catalogue and ray recipe, in
float64 on the CPU. The prototype is loaded by file path and not changed."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackstar_tpu.stars import grid as jgrid
from blackstar_tpu.stars.catalog import Catalog as JCatalog
from blackstar_tpu_torch.scripts import proto_window_kernel as tproto
from blackstar_tpu_torch.stars import window, window_cuda

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "_jax_proto_window_kernel", os.path.join(_ROOT, "scripts", "proto_window_kernel.py"))
jproto = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jproto)

I = S = 0.7


def _grids(cat):
    """The prototype's grid from both packages (float64)."""
    jg = jgrid.build_star_grid(JCatalog(*cat), cell_size=0.02, radius=0.0075, k0=8,
                               dtype=jnp.float64)
    tg = tproto.synthetic_grid(cat, torch.float64, "cpu")
    return jg, tg


def _both_stages(jg, tg, v_np):
    """Run both stages on the same rays; returns the JAX pre-pass outputs,
    the JAX stage's outputs, the port's stage inputs and outputs."""
    n = v_np.shape[0]
    v = jnp.asarray(v_np)
    esc = jnp.ones((n,), bool)
    rgb, cov, missed = jax.jit(jproto.run_stage(v, esc, jg, I, S, True))(v, esc)
    vn = v * jax.lax.rsqrt((v * v).sum(axis=1))[:, None]
    starts, widx, jcov = jproto.prepass(vn, esc, jg.n_rings, jg.n_cols)
    jax_out = {k: np.asarray(x) for k, x in dict(
        starts=starts, widx=widx.reshape(n), covered=cov, prepass_covered=jcov.reshape(n),
        ovf_missed=missed, rgb=rgb).items()}
    vt = torch.from_numpy(v_np)
    esct = torch.ones((n,), dtype=torch.bool)
    inp = window.stage_inputs(vt, esct, tg)
    t_rgb, t_cov, t_missed = window.window_stage(vt, esct, tg, I, S)
    return jax_out, inp, dict(rgb=t_rgb, covered=t_cov, ovf_missed=t_missed)


def _assert_stage_equal(jax_out, inp, port):
    np.testing.assert_array_equal(inp.starts.numpy(), jax_out["starts"])
    np.testing.assert_array_equal(inp.widx.numpy(), jax_out["widx"])
    np.testing.assert_array_equal(inp.covered.numpy(), jax_out["prepass_covered"])
    np.testing.assert_array_equal(port["covered"].numpy(), jax_out["covered"])
    np.testing.assert_array_equal(port["ovf_missed"].numpy(), jax_out["ovf_missed"])
    np.testing.assert_allclose(port["rgb"].numpy(), jax_out["rgb"], rtol=0, atol=1e-12)


def _assert_matches_lookup(tg, vt, port):
    """The stage equals the per-ray lookup on covered, not-missed rays."""
    ref = tg.lookup(vt, torch.tensor(I, dtype=vt.dtype), torch.tensor(S, dtype=vt.dtype))
    m = port["covered"] & ~port["ovf_missed"]
    torch.testing.assert_close(port["rgb"][m], ref[m], rtol=0, atol=1e-9)
    assert (ref[m].amax(dim=-1) > 0).sum() > 10  # stars were hit


def _cluster_tile(cdec, cra):
    """One tile aimed half at cluster 19 and half at cluster 3, with seeded
    jitter: both clusters' cells have overflow rows, their pointers 167 rows
    apart, and the tile's base window covers both."""
    jit = np.random.default_rng(19).normal(0, 0.003, (2, window.T))
    half = window.T // 2
    d = np.concatenate([np.full(half, cdec[19]), np.full(half, cdec[3])]) + jit[0]
    r = np.concatenate([np.full(half, cra[19]), np.full(half, cra[3])]) + jit[1]
    return np.stack([np.cos(d) * np.cos(r), np.cos(d) * np.sin(r), np.sin(d)], axis=-1)


@pytest.fixture(scope="module")
def catalog():
    """The prototype's catalogue and cluster centres, its grid from both
    packages, and two tiles of its rays."""
    rng = np.random.default_rng(7)
    cat, centres = tproto.synthetic_catalog(rng)
    return cat, centres, _grids(cat), tproto.synthetic_rays(rng, 2)


@pytest.fixture(scope="module")
def case(catalog):
    """Two tiles of the prototype's rays through both stages."""
    _, _, (jg, tg), v_np = catalog
    return (jg, tg, v_np, *_both_stages(jg, tg, v_np))


def test_grid_matches_jax_grid(case):
    jg, tg = case[:2]
    for name in ("cell_data", "ovf_data", "ovf_octets"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)


def test_stage_matches_jax(case):
    _, _, _, jax_out, inp, port = case
    assert jax_out["ovf_missed"].sum() == 0 and jax_out["covered"].mean() > 0.9
    _assert_stage_equal(jax_out, inp, port)


def test_stage_matches_lookup(case):
    _, tg, v_np, _, _, port = case
    _assert_matches_lookup(tg, torch.from_numpy(v_np), port)


def test_passes_match_jax_kernels(catalog):
    """k1_reference and k2_reference against the prototype's Pallas K1 and K2
    in interpret mode, on the same inputs (the port's pre-pass and glue for
    the cluster tile, whose overflow rows hold stars the rays hit)."""
    _, centres, (jg, tg), _ = catalog
    v_np = _cluster_tile(*centres)
    inp = window.stage_inputs(torch.from_numpy(v_np), torch.ones((window.T,), dtype=torch.bool),
                              tg)
    n_tiles = inp.starts.shape[0]
    consts = tg.psf_constants(torch.float64)
    tbl3 = tg.cell_data.reshape(tg.n_rings, tg.n_cols, -1)
    k1 = window.k1_reference(inp.starts, inp.widx, inp.covered, inp.rx, inp.ry, inp.rz, tbl3,
                             consts, I, S)
    planes = [jnp.asarray(p.numpy().reshape(n_tiles, 32, 128)) for p in (inp.rx, inp.ry, inp.rz)]
    jk1 = jproto.build_k1(n_tiles, tg.pad_k, tg.psf_width, I, S, True, dtype=jnp.float64)(
        jnp.asarray(inp.starts.numpy()), jnp.asarray(inp.widx.numpy()[:, None]), *planes,
        jnp.asarray(tbl3.numpy()))
    for got, want in zip(k1, jk1):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(k1[3].numpy(), np.asarray(jk1[3]).reshape(-1))

    out = window.run_passes(inp, tg, I, S, window.k1_reference, window.k2_reference)
    ovf_tbl, octets, _ = window.overflow_tables(tg)
    k2 = window.k2_reference(out.s2, out.optr, inp.covered, inp.rx, inp.ry, inp.rz, ovf_tbl,
                             octets, consts, I, S)
    assert (k2[0] > 0).sum() > 10 and not out.ovf_missed.any()  # overflow stars were hit
    n_oct = ovf_tbl.shape[1] // 64
    jk2 = jproto.build_k2(n_tiles, n_oct, tg.psf_width, I, S, True, dtype=jnp.float64)(
        jnp.asarray(out.s2.numpy()[:, None]),
        jnp.asarray(out.optr.numpy().reshape(n_tiles, 32, 128)),
        jnp.asarray(inp.covered.numpy().reshape(n_tiles, 32, 128).astype(np.int32)), *planes,
        jnp.asarray(ovf_tbl.numpy()), jnp.asarray(octets.numpy()[:, None]))
    for got, want in zip(k2, jk2):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1), rtol=0, atol=1e-12)


def test_missed_overflow_matches_jax(catalog, monkeypatch):
    """The ovf_missed branch: the cluster tile with a 128-row overflow
    window, the smallest the prototype's K2 takes (T // OVW ≤ 32), so the
    pointers of one cluster miss the window."""
    monkeypatch.setattr(jproto, "OVW", 128)
    monkeypatch.setattr(window, "OVW", 128)
    _, centres, (jg, tg), _ = catalog
    v_np = _cluster_tile(*centres)
    jax_out, inp, port = _both_stages(jg, tg, v_np)
    assert port["covered"].all()
    assert 0 < port["ovf_missed"].sum() < window.T
    _assert_stage_equal(jax_out, inp, port)
    _assert_matches_lookup(tg, torch.from_numpy(v_np), port)


def test_entry_point_cpu(capsys):
    res = tproto.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "grid 158x315 pad_k=8 stars=8400 ovf_rows=290 ovf_octets_max=12" in out
    assert "covered 0.9610  ovf_missed 0.0000  max|err|" in out
    assert out.rstrip().endswith("SEMANTICS OK")
    assert res["lookup_err"] < 1e-9


def test_stage_rejects_partial_tiles(catalog):
    grid = catalog[2][1]
    v = torch.ones((window.T + 1, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="whole number"):
        window.window_stage(v, torch.ones((window.T + 1,), dtype=torch.bool), grid, I, S)


@pytest.mark.parametrize("which", ["k1", "k2"])
def test_wrappers_reject_other_devices(which):
    m = torch.empty((window.T,), device="meta")
    i32 = torch.empty((window.T,), dtype=torch.int32, device="meta")
    cov = torch.empty((window.T,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if which == "k1":
            window_cuda.k1_cuda(i32[:2].reshape(1, 2), i32, cov, m, m, m, m, (1.0, 1.0, 1.0),
                                I, S)
        else:
            window_cuda.k2_cuda(i32[:1], i32, cov, m, m, m, m, i32, (1.0, 1.0, 1.0), I, S)
