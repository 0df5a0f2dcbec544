"""Port parity: the star grid build, its ``.npz`` format and the plain
per-ray lookup against the JAX package (float64, CPU), and against the
brute-force oracle, on a 500-star clustered synthetic catalogue with small
base rows, so dense cells spill into overflow rows."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackstar_tpu.stars import grid as jgrid
from blackstar_tpu.stars.catalog import Catalog, ra_dec_to_cartesian
from blackstar_tpu_torch.stars import grid as tgrid
from blackstar_tpu_torch.stars.lookup_cuda import star_lookup_cuda
from tests import oracle
from tests.test_stars import _random_catalog

INTENSITY, SATURATION = 0.4, 1.5
K0 = 2
# "exact": margin 0, exact asin/atan2 cell ids; "fast": the production
# 6 mrad margin, bounded-error fast cell ids.
BUILDS = {
    "exact": dict(cell_size=0.008, k0=K0),
    "fast": dict(cell_size=0.006, radius=0.0075, k0=K0),
}


def _catalog():
    """496 clustered stars plus stars at both poles and straddling RA 0/2π."""
    cat = _random_catalog(496, seed=21, clusters=True)
    special = np.array([
        [0.0, 0.0, 1.0],
        [0.0, 0.0, -1.0],
        ra_dec_to_cartesian(np.float64(2 * math.pi - 1e-5), np.float64(0.1)),
        ra_dec_to_cartesian(np.float64(1e-5), np.float64(-0.2)),
    ])
    return Catalog(
        pos=np.concatenate([cat.pos, special]),
        mag=np.concatenate([cat.mag, np.full(4, 900, np.int32)]),
        hue=np.concatenate([cat.hue, [0.631, 0.628, 0.094, 0.0]]),
        sat=np.concatenate([cat.sat, [0.39, 0.33, 0.56, 0.0]]),
    )


def _probes(cat):
    """Directions near stars (incl. poles and the RA wrap), random
    directions, and an inactive mask, all from a numpy seed."""
    rng = np.random.default_rng(22)
    near = cat.pos[rng.integers(0, cat.n_stars, 160)] + 4e-4 * rng.normal(size=(160, 3))
    special = np.repeat(cat.pos[-4:], 8, axis=0) + 3e-4 * rng.normal(size=(32, 3))
    far = rng.normal(size=(64, 3))
    dirs = np.concatenate([near, special, far])
    active = np.ones(len(dirs), bool)
    active[::5] = False
    return dirs, active


@pytest.fixture(scope="module")
def catalog():
    return _catalog()


@pytest.fixture(scope="module", params=sorted(BUILDS))
def grids(request, catalog):
    kw = BUILDS[request.param]
    jc = jgrid.build_star_grid_compact(catalog, **kw)
    tc = tgrid.build_star_grid_compact(catalog, **kw)
    return jc, tc


_META = ("n_rings", "n_cols", "n_stars", "psf_width", "radius", "k0")


def _assert_compact_equal(a, b):
    for f in ("counts", "star_ids", "star_rows"):
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in _META:
        assert getattr(a, f) == getattr(b, f), f


def test_compact_build_bit_equal(grids):
    jc, tc = grids
    _assert_compact_equal(tc, jc)
    assert tc.counts.max() > K0  # the catalogue does exercise overflow rows


@pytest.mark.parametrize("t_dt,np_dt", [(torch.float64, np.float64),
                                        (torch.float32, np.float32)])
def test_to_grid_tables_equal_jax(grids, t_dt, np_dt):
    jc, tc = grids
    want = jc.to_grid(dtype=np_dt, device=False)
    got = tc.to_grid("cpu", dtype=t_dt)
    assert got.ovf_data.shape[0] > 1
    for f in ("cell_data", "ovf_data", "ovf_octets"):
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in ("n_rings", "n_cols", "n_stars", "psf_width", "radius"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.margin == want.margin
    assert got.fast_cells_ok(t_dt) == want._fast_cells_ok(jnp.dtype(np_dt))


def test_npz_cross_load(grids, tmp_path):
    jc, tc = grids
    from_jax = tgrid.load_star_grid_compact(jgrid.save_star_grid(jc, str(tmp_path / "j")))
    _assert_compact_equal(from_jax, jc)
    from_port = jgrid.load_star_grid_compact(tgrid.save_star_grid(tc, str(tmp_path / "t")))
    _assert_compact_equal(from_port, tc)


@pytest.fixture(scope="module")
def looked_up(grids, catalog):
    jc, tc = grids
    dirs, active = _probes(catalog)
    want = np.asarray(jc.to_grid(dtype=jnp.float64).lookup(
        jnp.asarray(dirs), jnp.float64(INTENSITY), jnp.float64(SATURATION),
        active=jnp.asarray(active)))
    tg = tc.to_grid("cpu", dtype=torch.float64)
    got = tg.lookup(torch.from_numpy(dirs), torch.tensor(INTENSITY, dtype=torch.float64),
                    torch.tensor(SATURATION, dtype=torch.float64),
                    active=torch.from_numpy(active))
    return tg, dirs, active, want, got


def test_lookup_matches_jax(looked_up):
    _, _, active, want, got = looked_up
    assert got.shape == (len(active), 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert (got.numpy()[~active] == 0).all()
    assert (got.numpy()[active] > 0).any()


def test_lookup_matches_oracle(looked_up, catalog):
    _, dirs, active, _, got = looked_up
    want = np.stack([oracle.star_lookup(catalog, INTENSITY, SATURATION, d)
                     for d in dirs[active]])
    np.testing.assert_allclose(got.numpy()[active], want, rtol=0, atol=1e-12)


def test_lookup_wrapper_takes_plain_path_on_cpu(looked_up):
    tg, dirs, active, _, got = looked_up
    calls = tgrid.StarGrid.lookup.calls
    res = star_lookup_cuda(tg, torch.from_numpy(dirs),
                           torch.tensor(INTENSITY, dtype=torch.float64),
                           torch.tensor(SATURATION, dtype=torch.float64),
                           torch.from_numpy(active))
    assert star_lookup_cuda.launches == 0
    assert tgrid.StarGrid.lookup.calls == calls + 1
    torch.testing.assert_close(res, got, rtol=0, atol=0)


def test_lookup_chunks_agree(looked_up):
    """Chunking bounds memory only: any chunk size gives the same colours."""
    tg, dirs, active, _, got = looked_up
    res = tg.lookup(torch.from_numpy(dirs), torch.tensor(INTENSITY, dtype=torch.float64),
                    torch.tensor(SATURATION, dtype=torch.float64),
                    active=torch.from_numpy(active), chunk=7)
    torch.testing.assert_close(res, got, rtol=0, atol=1e-15)
