"""Port parity for the star build side: ``stars/kdt.py`` against the JAX
package's reader and writer, the ``generate-grid`` CLI against the JAX
CLI's ``.npz`` (from a PPM and from a ``stars.kdt``), and a dense grid
saved and reloaded against its compact source. Catalogues are seeded
synthetic ones or a cut of the committed ``stars.ppm``."""

import os

import numpy as np
import pytest
import torch

from blackstar_tpu.cli.generate_grid import main as jgrid_main
from blackstar_tpu.stars import kdt as jkdt
from blackstar_tpu.stars.catalog import Catalog as JCatalog
from blackstar_tpu_torch.cli.generate_grid import main as grid_main
from blackstar_tpu_torch.stars import artifact
from blackstar_tpu_torch.stars import kdt as tkdt
from blackstar_tpu_torch.stars.catalog import Catalog, read_catalog, spectral_color
from blackstar_tpu_torch.stars.grid import (build_star_grid, build_star_grid_compact,
                                            load_star_grid_compact, save_star_grid)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURES = os.path.join(_ROOT, "tests", "fixtures")
_PPM_HEADER, _PPM_RECORD = 28, 28


def _catalog(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    chars = rng.choice(list("OBAFGKM?"), n)
    return Catalog(pos=pos, mag=rng.integers(-100, 1500, n).astype(np.int32),
                   hue=np.array([spectral_color(c)[0] for c in chars]),
                   sat=np.array([spectral_color(c)[1] for c in chars]))


def _jax(cat):
    return JCatalog(pos=cat.pos, mag=cat.mag, hue=cat.hue, sat=cat.sat)


@pytest.fixture(scope="module")
def ppm_cut(tmp_path_factory):
    """The first 4,000 stars of the committed catalogue, as a PPM file."""
    path = tmp_path_factory.mktemp("ppm") / "cut.ppm"
    with open(os.path.join(_ROOT, "stars.ppm"), "rb") as f:
        path.write_bytes(f.read(_PPM_HEADER + 4000 * _PPM_RECORD))
    return path


@pytest.mark.parametrize("order", tkdt._FIELD_ORDERS)
@pytest.mark.parametrize("empty_tag", [0, 1], ids=["empty0", "empty1"])
def test_write_kdt_bytes_equal_jax(tmp_path, order, empty_tag):
    cat = _catalog(257, seed=5)
    ours, theirs = tmp_path / "port.kdt", tmp_path / "jax.kdt"
    tkdt.write_kdt(cat, str(ours), empty_tag=empty_tag, order=order)
    jkdt.write_kdt(_jax(cat), str(theirs), empty_tag=empty_tag, order=order)
    assert ours.read_bytes() == theirs.read_bytes()
    got, want = tkdt.read_kdt(str(ours)), jkdt.read_kdt(str(theirs))
    for field in ("pos", "mag", "hue", "sat"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("name", ["foreign_stars_emptyfirst.kdt", "foreign_stars_nodefirst.kdt"])
def test_read_kdt_fixtures_equal_jax(name):
    got = tkdt.read_kdt(os.path.join(_FIXTURES, name))
    want = jkdt.read_kdt(os.path.join(_FIXTURES, name))
    assert got.n_stars == want.n_stars == 7
    for field in ("pos", "mag", "hue", "sat"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype


def test_read_kdt_rejects_garbage_and_non_unit_positions(tmp_path):
    bad = tmp_path / "bad.kdt"
    bad.write_bytes(b"\x00\x00" + b"\x07" * 64)
    with pytest.raises(tkdt.KdtFormatError, match="generate-grid"):
        tkdt.read_kdt(str(bad))
    cat = _catalog(32, seed=4)
    scaled = tmp_path / "scaled.kdt"
    tkdt.write_kdt(cat._replace(pos=cat.pos * 3.0), str(scaled))
    with pytest.raises(tkdt.KdtFormatError):
        tkdt.read_kdt(str(scaled))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_npz_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _canonical(z):
    """A grid's candidate sets independent of the star table's order: each
    cell's slot rows, sorted within the cell."""
    counts = z["counts"].astype(np.int64)
    rows = z["star_rows"][z["star_ids"]]
    cells = np.repeat(np.arange(counts.size), counts)
    order = np.lexsort(tuple(rows.T[::-1]) + (cells,))
    return counts, rows[order]


def test_generate_grid_matches_jax_cli(tmp_path, ppm_cut):
    kw = ["--cell-size", "0.02", "--radius", "0.025", "--k0", "8", "-f"]
    kdt = str(tmp_path / "cut.kdt")
    tkdt.write_kdt(read_catalog(str(ppm_cut)), kdt)
    outs = {}
    for src, extra in ((str(ppm_cut), []), (kdt, ["--kdt"])):
        tag = "kdt" if extra else "ppm"
        ours, theirs = str(tmp_path / f"port-{tag}.npz"), str(tmp_path / f"jax-{tag}.npz")
        assert grid_main([src, ours, *extra, *kw]) == 0
        assert jgrid_main([src, theirs, *extra, *kw]) == 0
        outs[tag] = _npz(ours)
        _assert_npz_equal(outs[tag], _npz(theirs))
    assert int(outs["ppm"]["n_stars"]) == 4000
    # From the .kdt the stars come in tree order, so the tables hold the
    # same candidates in another order.
    for a, b in zip(_canonical(outs["ppm"]), _canonical(outs["kdt"])):
        np.testing.assert_array_equal(a, b)


def test_generate_grid_defaults_are_the_production_build(tmp_path, ppm_cut):
    out = str(tmp_path / "g")
    assert grid_main([str(ppm_cut), out]) == 0
    got = load_star_grid_compact(out + ".npz")
    assert (got.radius, got.k0) == (artifact.RADIUS, artifact.K0)
    want = build_star_grid_compact(read_catalog(str(ppm_cut)), cell_size=artifact.CELL_SIZE,
                                   radius=artifact.RADIUS, k0=artifact.K0)
    assert (got.n_rings, got.n_cols) == (want.n_rings, want.n_cols)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.slots, want.slots)
    assert grid_main([str(tmp_path / "absent.ppm"), out]) == 1


@pytest.mark.parametrize("k0", [2, 64], ids=["overflow", "no-overflow"])
def test_dense_grid_saved_and_reloaded_equals_its_compact_source(tmp_path, k0):
    cat = _catalog(3000, seed=11)
    kw = dict(cell_size=0.02, radius=0.025, k0=k0)
    compact = build_star_grid_compact(cat, **kw)
    dense = build_star_grid(cat, device="cpu", dtype=torch.float64, **kw)
    for a, b in zip((dense.cell_data, dense.ovf_data, dense.ovf_octets), compact.tables()):
        np.testing.assert_array_equal(a.numpy(), b)
    back = load_star_grid_compact(save_star_grid(dense, str(tmp_path / "dense")))
    np.testing.assert_array_equal(back.counts, compact.counts)
    np.testing.assert_array_equal(back.slots, compact.slots)
    assert (back.n_rings, back.n_cols, back.n_stars, back.psf_width, back.radius) == (
        compact.n_rings, compact.n_cols, compact.n_stars, compact.psf_width, compact.radius)
    for a, b in zip(back.tables(), compact.tables()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        save_star_grid(object(), str(tmp_path / "x"))
