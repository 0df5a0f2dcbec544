"""The star kernels' row walk (``stars/csrc/star_walk.cuh``), on the CPU.

B3 and B4 run only on the card. Here:

* the Python mirror of the kernels' thread→ray map (``lookup_cuda.thread_rays``)
  takes every ray exactly once, with the width hint (8×4 pixel tiles, the
  ragged edge included) and without it;
* a float64 emulation of the walk's order (each 4-lane group walks one ray's
  base row and used overflow octets, lane j on slots j, j + 4, ..., then a
  butterfly over lanes 2 and 1 apart) gives the plain lookup's colours and
  gradients, so the walk covers every slot once and sums nothing twice;
* both kernels take their walk and slot math from the header and define
  none of their own, and the wrappers read nothing back from the device
  (source checks, as ``test_torch_march_arith.py`` makes for
  ``march_step.cuh``);
* the width hint changes no result of the wrappers' CPU path.

The plain versions are held to the JAX package by ``test_torch_stars.py``
and ``test_torch_star_diff.py``.
"""

import os
import re

import numpy as np
import pytest
import torch

from blackstar_tpu_torch.stars import grid as tgrid
from blackstar_tpu_torch.stars import lookup_cuda
from blackstar_tpu_torch.stars.diff import lookup_diff
from tests.test_stars import _random_catalog

_CSRC = os.path.join(os.path.dirname(lookup_cuda.__file__), "csrc")
F64 = torch.float64
LANES = 4  # kLanes in star_walk.cuh


# ---- the thread→ray map ----------------------------------------------------

@pytest.mark.parametrize("n, width", [(1920 * 1080, 1920), (481 * 271, 481), (7 * 3, 7),
                                      (1000, None), (1000, 7), (31, None)])
def test_thread_rays_take_every_ray_once(n, width):
    rays = lookup_cuda.thread_rays(n, width)
    w, blocks = lookup_cuda.launch_shape(n, width)
    assert rays.shape == (blocks * lookup_cuda.THREADS // 32, 32)
    taken = rays[rays >= 0]
    assert torch.equal(taken.sort().values, torch.arange(n))
    assert w == (width if width and n % width == 0 else 0)


def test_thread_rays_tile_the_frame():
    """With the hint a warp takes an 8×4 pixel tile, tiles in row-major
    order; without it, 32 consecutive rays."""
    tw, th = lookup_cuda.WARP_TILE
    rays = lookup_cuda.thread_rays(24 * 8, 24)
    assert (tw, th) == (8, 4)
    first = rays[0].view(th, tw)
    assert torch.equal(first, torch.arange(th)[:, None] * 24 + torch.arange(tw))
    assert rays[1, 0] == 8 and rays[3, 0] == 4 * 24  # three tiles a tile-row
    assert torch.equal(lookup_cuda.thread_rays(64)[1], torch.arange(32, 64))


# ---- the walk's order against the plain versions ---------------------------

@pytest.fixture(scope="module")
def case():
    """600 clustered stars, base rows of 8 slots (dense cells spill into
    overflow rows of several octets), rays near stars and random rays, an
    inactive mask, non-unit velocities and cotangents, from numpy seeds."""
    cat = _random_catalog(600, seed=21, clusters=True)
    grid = tgrid.build_star_grid_compact(cat, cell_size=0.006, radius=0.0075,
                                         k0=8).to_grid("cpu", dtype=F64)
    rng = np.random.default_rng(23)
    n = 768
    near = cat.pos[rng.integers(0, cat.n_stars, n - 64)] + 4e-4 * rng.normal(size=(n - 64, 3))
    dirs = np.concatenate([near, rng.normal(size=(64, 3))])
    vel = torch.from_numpy(dirs * rng.uniform(0.5, 2.0, size=(n, 1)))
    active = torch.from_numpy(rng.uniform(size=n) < 0.9)
    w = torch.from_numpy(rng.normal(size=(n, 3)))
    return grid, vel, active, w


def _group_walk(grid, vel, active, per_slot, channels):
    """The kernels' order of summation, emulated: per ray, lane j of its
    group of ``LANES`` sums ``per_slot`` over its slots j, j + LANES, ... of
    the base row, then of the used overflow octets; the butterfly over
    lanes LANES/2, ..., 2, 1 apart adds the lanes. ``per_slot(slots (m, 8),
    n (m, 3), rays (m,))`` gives each slot's terms (m, channels). Returns the
    per-ray sums, the normalised directions and 1/|v|."""
    inv = torch.rsqrt((vel * vel).sum(dim=1))
    n = vel * inv[:, None]
    cells = grid.cell_ids(n[:, 0], n[:, 1], n[:, 2])
    base = grid.cell_data[cells].view(len(vel), -1, 8)
    ptr = base[:, 0, 7].long()
    used = grid.ovf_octets.long()[ptr] * 8  # slots in the used octets
    ovf = grid.ovf_data[ptr].view(len(vel), -1, 8).clone()
    ovf[torch.arange(ovf.shape[1]) >= used[:, None]] = 0.0  # beyond the used octets
    slots = torch.cat([base, ovf], dim=1)
    m = slots.shape[1]
    rays = torch.arange(len(vel)).repeat_interleave(m)
    terms = per_slot(slots.reshape(-1, 8), n[rays], rays).view(len(vel), m // LANES, LANES, -1)
    terms = terms * (active[:, None, None, None] & (torch.arange(m).view(-1, LANES) < (
        grid.pad_k + used[:, None, None]))[..., None])
    lanes = terms.sum(dim=1)  # (rays, lane, channels): lane j's slots j, j + LANES, ...
    off = LANES // 2
    while off:
        lanes = lanes + lanes[:, torch.arange(LANES) ^ off]
        off //= 2
    return lanes[:, 0], n, inv


def _slot_terms(grid, intensity, saturation, w=None):
    """Each slot's colour (or, with cotangents ``w``, its five gradient
    channels) by the plain version's own slot math, one slot a row."""
    consts = grid.psf_constants(F64)

    def colour(slots, n, rays):
        return grid._slot_sum(slots, n[:, 0], n[:, 1], n[:, 2], intensity, saturation, consts)

    def grad(slots, n, rays):
        return grid._slot_vjp(slots, n[:, 0], n[:, 1], n[:, 2], w[rays], intensity,
                              saturation, consts)

    return colour if w is None else grad


def test_group_walk_gives_the_plain_lookup(case):
    grid, vel, active, _ = case
    i, s = torch.tensor(0.4, dtype=F64), torch.tensor(1.5, dtype=F64)
    assert (grid.ovf_octets > 1).any()  # overflow rows of several octets
    sums, _, _ = _group_walk(grid, vel, active, _slot_terms(grid, i, s), 3)
    want = grid.lookup(vel, i, s, active, clamp=False)
    assert (want.amax(dim=1) > 0).sum() > 100
    torch.testing.assert_close(sums, want, rtol=0, atol=1e-12)


def test_group_walk_gives_the_plain_vjp(case):
    grid, vel, active, w = case
    i, s = torch.tensor(0.4, dtype=F64), torch.tensor(1.5, dtype=F64)
    g, n, inv = _group_walk(grid, vel, active, _slot_terms(grid, i, s, w), 5)
    gdotn = (g[:, :3] * n).sum(dim=1, keepdim=True)
    gvel = (g[:, :3] - n * gdotn) * inv[:, None]
    want = grid.lookup_vjp(vel, i, s, active, w)
    scale = want[0].abs().max()
    assert scale > 0
    torch.testing.assert_close(gvel, want[0], rtol=0, atol=1e-12 * scale.item())
    torch.testing.assert_close(g[:, 3].sum(), want[1], rtol=1e-12, atol=0)
    torch.testing.assert_close(g[:, 4].sum(), want[2], rtol=1e-12, atol=0)


# ---- one walk, one source; no read-back -------------------------------------

def _code(name):
    text = open(os.path.join(_CSRC, name)).read()
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def test_kernels_take_their_walk_from_the_header():
    code = _code("star_lookup.cu")
    assert '#include "star_walk.cuh"' in code
    for own in (r"\bexp\s*\(", r"\bd2\b", r"<=\s*[\w.]*r2lim", r"__device__[^;{]*\b(cell_id|fast_asin|"
                r"fast_ra|slot_colour|slot_grad|walk_rows|load_quad)\s*\("):
        assert re.search(own, code) is None, own
    for call in ("walk_rows(", "slot_colour(", "slot_grad(", "round_ray(", "lane_ray("):
        assert call in code, call
    assert "-fmad=false" in lookup_cuda.FLAGS


def test_header_holds_the_slot_math():
    code = _code("star_walk.cuh")
    assert code.count("const T e = exp(logb0 - d2 * S.inv2w2);") == 2
    assert "const T d2 = dx * dx + dy * dy + dz * dz;" in code
    assert "e == T(1) ? T(0.5) : T(0)" in code
    assert "__shfl_xor_sync" in code and "atomicAdd" not in code


def test_short_names_of_the_star_kernels():
    from blackstar_tpu_torch.scripts import kernel_sass

    for kernel, arg, want in (("18star_lookup_kernel", "f", "star_lookup_kernel<float>"),
                              ("15star_vjp_kernel", "d", "star_vjp_kernel<double>")):
        mangled = (f"_ZN45_GLOBAL__N__0a1b2c3d_14_star_lookup_cu_4e5f6a7b{kernel}I{arg}EEvPKT_"
                   "S3_S3_PKbN4star4RaysENS4_4GridIS1_EEiPS1_")
        assert kernel_sass.short_name(mangled) == want


def test_wrappers_read_nothing_back():
    src = open(lookup_cuda.__file__).read()
    code = "\n".join(line.split("#")[0] for line in src.splitlines())
    for sync in (".tolist(", ".item(", ".cpu(", "synchronize", ".numpy("):
        assert sync not in code, sync
    assert re.search(r"\bfloat\(", code) is None


# ---- the width hint changes no result ---------------------------------------

def test_width_hint_changes_no_result(case):
    grid, vel, active, w = case
    i, s = torch.tensor(0.4, dtype=F64), torch.tensor(1.5, dtype=F64)
    plain = lookup_cuda.star_lookup_cuda(grid, vel, i, s, active)
    hinted = lookup_cuda.star_lookup_cuda(grid, vel, i, s, active, width=32)
    assert torch.equal(plain, hinted)
    g0 = lookup_cuda.star_lookup_vjp_cuda(grid, vel, i, s, active, w)
    g1 = lookup_cuda.star_lookup_vjp_cuda(grid, vel, i, s, active, w, width=32)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    grads = []
    for hint in (None, 32):
        v = vel.clone().requires_grad_(True)
        (lookup_diff(grid, v, i, s, active, width=hint) * w).sum().backward()
        grads.append(v.grad)
    assert torch.equal(*grads)
