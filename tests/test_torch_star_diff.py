"""Port parity: the differentiable star stage (the plain hand-derived star
VJP ``StarGrid.lookup_vjp`` under the autograd Function of
``blackstar_tpu_torch/stars/diff.py``) against ``jax.grad`` through the JAX
package's ``StarGrid.lookup(differentiable=True)``, in float64 on the CPU,
on a clustered synthetic catalogue with overflow rows, inactive rays,
non-unit velocities and clamped pixels; the 0.5 splits of both ties; and
the refusal of grid-table gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackstar_tpu.stars import grid as jgrid
from blackstar_tpu.stars.catalog import Catalog
from blackstar_tpu_torch.stars import grid as tgrid
from blackstar_tpu_torch.stars.diff import lookup_diff
from blackstar_tpu_torch.stars.lookup_cuda import star_lookup_vjp_cuda
from tests.test_stars import _random_catalog

F64 = torch.float64
BUILD = dict(cell_size=0.006, radius=0.0075, k0=2)
RTOL = 1e-11  # the gate of tests/test_star_diff.py: max |Δ| / max |g|


@pytest.fixture(scope="module")
def case():
    """600 clustered stars in a K0 = 2 grid (dense cells spill into overflow
    rows), and rays near stars, random rays, an inactive mask and non-unit
    velocities, all from numpy seeds."""
    cat = _random_catalog(600, seed=21, clusters=True)
    jc = jgrid.build_star_grid_compact(cat, **BUILD)
    tc = tgrid.build_star_grid_compact(cat, **BUILD)
    rng = np.random.default_rng(22)
    n = 512
    near = cat.pos[rng.integers(0, cat.n_stars, n - 64)] + 4e-4 * rng.normal(size=(n - 64, 3))
    dirs = np.concatenate([near, rng.normal(size=(64, 3))])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    vel = dirs * rng.uniform(0.5, 2.0, size=(n, 1))
    active = rng.uniform(size=n) < 0.9
    cot = rng.normal(size=(n, 3))
    return jc.to_grid(dtype=jnp.float64), tc.to_grid("cpu", dtype=F64), vel, active, cot


def _jax_grads(jg, vel, active, cot, i0, s0):
    def loss(v, i, s):
        out = jg.lookup(v, i, s, jnp.asarray(active), differentiable=True)
        return jnp.sum(out * jnp.asarray(cot))

    val = loss(jnp.asarray(vel), jnp.float64(i0), jnp.float64(s0))
    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(vel), jnp.float64(i0), jnp.float64(s0))
    return float(val), [np.asarray(g) for g in grads]


def _port_grads(tg, vel, active, cot, i0, s0):
    v = torch.tensor(vel, dtype=F64, requires_grad=True)
    i = torch.tensor(i0, dtype=F64, requires_grad=True)
    s = torch.tensor(s0, dtype=F64, requires_grad=True)
    out = lookup_diff(tg, v, i, s, torch.from_numpy(active))
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    return out.detach(), float(loss.detach()), [v.grad.numpy(), i.grad.numpy(), s.grad.numpy()]


def _assert_grads_close(got, want):
    for g, w, name in zip(got, want, ("vel", "intensity", "saturation")):
        scale = max(1e-30, float(np.max(np.abs(w))))
        err = float(np.max(np.abs(g - w))) / scale
        assert err < RTOL, (name, err)


def test_star_vjp_matches_jax_grad(case):
    jg, tg, vel, active, cot = case
    i0, s0 = 0.7, 0.9
    j_val, j_grads = _jax_grads(jg, vel, active, cot, i0, s0)
    out, t_val, t_grads = _port_grads(tg, vel, active, cot, i0, s0)
    assert abs(t_val - j_val) <= 1e-11 * max(1.0, abs(j_val))
    _assert_grads_close(t_grads, j_grads)
    # The case exercises what it claims: overflow rows, clamped pixels,
    # inactive rays with zero gradient, and live star gradients.
    unclamped = tg.lookup(torch.from_numpy(vel), torch.tensor(i0, dtype=F64),
                          torch.tensor(s0, dtype=F64), torch.from_numpy(active), clamp=False)
    assert (unclamped > 1.0).any() and ((unclamped > 0) & (unclamped < 1.0)).any()
    torch.testing.assert_close(out, torch.clamp(unclamped, max=1.0), rtol=0, atol=0)
    assert tg.ovf_data.shape[0] > 1
    assert np.all(t_grads[0][~active] == 0.0) and np.max(np.abs(t_grads[0])) > 0
    assert abs(float(t_grads[1])) > 0 and abs(float(t_grads[2])) > 0


def test_star_vjp_wrapper_takes_plain_path_and_chunks_agree(case):
    _, tg, vel, active, cot = case
    args = (torch.from_numpy(vel), torch.tensor(0.7, dtype=F64), torch.tensor(0.9, dtype=F64),
            torch.from_numpy(active), torch.from_numpy(cot))
    calls = tgrid.StarGrid.lookup_vjp.calls
    whole = star_lookup_vjp_cuda(tg, *args)
    assert star_lookup_vjp_cuda.launches == 0
    assert tgrid.StarGrid.lookup_vjp.calls == calls + 1
    chunked = tg.lookup_vjp(*args, chunk=37)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


def _one_star_grid(pos, mag, sat=0.0):
    cat = Catalog(pos=np.asarray(pos, np.float64)[None], mag=np.asarray([mag], np.float64),
                  hue=np.asarray([0.3]), sat=np.asarray([sat]))
    return tgrid.build_star_grid_compact(cat).to_grid("cpu", dtype=F64), cat


def test_psf_cap_tie_splits_half():
    """A slot whose PSF brightness e equals the cap 1 exactly takes du/de =
    0.5, as ``lax.min``'s derivative gives it: the ray (0, 1, 0) and a star
    whose squared distance is tuned until exp(...) == 1 in float64."""
    pos = [4e-4, 1.0, 2e-4]
    a, _, inv2w2 = _one_star_grid(pos, 900.0)[0].psf_constants(F64)
    mag = 950.0 - (pos[0] ** 2 + pos[2] ** 2) * inv2w2 / a  # e ≈ 1
    tg, _ = _one_star_grid(pos, mag, sat=0.6)
    _, r2lim, _ = tg.psf_constants(F64)
    slots = tg.cell_data.view(-1, 8)
    s = slots[slots[:, 3] == mag][0]
    logb0 = a * (950.0 - s[3])
    # d² = sx² + (sy − 1)² + sz² with sx tuned in ulps until e == 1.
    found = None
    sx = s[0].clone()
    for _ in range(20000):
        d2 = sx * sx + (s[1] - 1.0) * (s[1] - 1.0) + s[2] * s[2]
        e = torch.exp(logb0 - d2 * inv2w2)
        if e == 1.0:
            found = sx
            break
        sx = torch.nextafter(sx, torch.tensor(0.0 if logb0 < d2 * inv2w2 else 1.0, dtype=F64))
    assert found is not None and d2 <= r2lim
    slots[slots[:, 3] == mag, 0] = found
    vel = torch.tensor([[0.0, 1.0, 0.0]], dtype=F64)
    w = torch.tensor([[0.3, -1.1, 0.8]], dtype=F64)
    gvel, g_i, g_s = tg.lookup_vjp(vel, torch.tensor(0.2, dtype=F64),
                                   torch.tensor(0.5, dtype=F64), torch.tensor([True]), w)
    # By hand: gd2 = I·cw·(du/de)·e·(−1/(2w²)), g_n = −2·gd2·(s − n),
    # then the projection off n = (0, 1, 0).
    cw = float((w[0] * (1.0 + 0.5 * s[4:7])).sum())
    d = np.array([float(found), float(s[1]) - 1.0, float(s[2])])
    for due, match in ((0.5, True), (1.0, False)):
        g_n = -2.0 * (0.2 * cw * due * 1.0 * -inv2w2) * d
        want = np.array([g_n[0], 0.0, g_n[2]])
        assert np.allclose(gvel[0].numpy(), want, rtol=1e-12, atol=0) == match, due


def test_clamp_tie_splits_half_as_jax():
    """An unclamped sum of exactly 1 (one star on the ray, brightness capped,
    no colour, intensity 1) passes half its cotangent, in both packages."""
    pos = np.array([0.3, -0.4, 0.5])
    pos /= np.linalg.norm(pos)
    tg, cat = _one_star_grid(pos, 900.0)
    jg = jgrid.build_star_grid(cat, dtype=jnp.float64)
    vel = pos[None]
    active = np.array([True])
    cot = np.array([[0.7, -0.2, 1.3]])
    out, _, t_grads = _port_grads(tg, vel, active, cot, 1.0, 0.4)
    assert (out == 1.0).all()
    _, j_grads = _jax_grads(jg, vel, active, cot, 1.0, 0.4)
    assert float(t_grads[1]) == pytest.approx(0.5 * cot.sum(), rel=1e-12)
    _assert_grads_close(t_grads, j_grads)


def test_grid_tables_refuse_gradients(case):
    _, tg, vel, active, _ = case
    table = tg.cell_data.clone().requires_grad_(True)
    grid = tgrid.StarGrid(cell_data=table, ovf_data=tg.ovf_data, ovf_octets=tg.ovf_octets,
                          n_rings=tg.n_rings, n_cols=tg.n_cols, n_stars=tg.n_stars,
                          psf_width=tg.psf_width, radius=tg.radius)
    with pytest.raises(ValueError, match="take no gradient"):
        lookup_diff(grid, torch.from_numpy(vel), torch.tensor(0.7, dtype=F64),
                    torch.tensor(0.9, dtype=F64), torch.from_numpy(active))
    with pytest.raises(ValueError, match="active mask"):
        lookup_diff(tg, torch.from_numpy(vel), torch.tensor(0.7, dtype=F64),
                    torch.tensor(0.9, dtype=F64), None)
