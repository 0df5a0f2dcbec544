"""Bucketed spherical star grid and the per-ray star lookup — the port of
``blackstar_tpu/stars/grid.py`` (the replacement for the reference's k-d
tree, StarMap.hs:90-104).

The unit sphere is cut into ``n_rings`` declination rings of ``n_cols``
azimuth columns each. At build time every star is inserted into each cell
whose region, expanded by the query radius, contains it, so a lookup reads
exactly one cell. Storage is two-level:

* ``cell_data`` (C, K0·8): the first K0 candidate slots of every cell;
* ``ovf_data`` (R, K1·8): the excess slots of the dense cells, row 0 an
  all-sentinel dummy. A cell's overflow row index is packed into slot 0's
  aux field (column 7) of its base row; 0 means none. ``ovf_octets`` (R,)
  counts each overflow row's used 8-slot octets.

Each slot is 8 floats ``[x, y, z, mag, H_r, H_g, H_b, aux]`` with ``H`` the
star's HSI colour basis (``rgb = val·(1 + starSaturation·H)``). Sentinel
slots have ``pos = 9.0`` and ``mag = 1e9``, so the radius test excludes them.

Shading matches ``starLookup`` (StarMap.hs:93-115): candidates within
squared chordal distance (3w)² contribute
``min(1, exp(ln2/50·(950 − mag) − d²/(2w²))) · starIntensity · (1 + sat·H)``,
summed over base and overflow slots and clamped to ≤ 1 per channel at the
end. :meth:`StarGrid.lookup` is the plain PyTorch version; the kernel B3
(``stars/csrc/star_lookup.cu``, wrapper ``stars/lookup_cuda.py``) computes
the same per ray on the card. :meth:`StarGrid.lookup_vjp` is the
hand-derived reverse of the unclamped sums (the JAX package's
``_slot_math`` gradient mode), the plain version of the kernel B4 beside B3.

The on-disk form is the JAX package's v6 compact ``.npz`` (per-cell counts,
CSR star ids, a deduplicated star-row table), so either package reads the
other's file.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from blackstar_tpu_torch.stars.catalog import Catalog

# Constants from StarMap.hs:97-100.
MAX_BRIGHTNESS = 950.0  # magnitude of "maximum brightness"
DYNAMIC = 50.0  # magnitude change that doubles intensity
PSF_WIDTH = 0.0005  # Gaussian width parameter w
QUERY_RADIUS = 3.0 * PSF_WIDTH  # inRadius search radius (StarMap.hs:104)

_FORMAT_VERSION = 6
_ROW = 8  # floats per candidate slot: x y z mag H_r H_g H_b aux
_SENTINEL_POS = 9.0
_SENTINEL_MAG = 1e9
DEFAULT_K0 = 8
DEFAULT_CELL_SIZE = 0.008
_MANTISSA_BITS = {torch.float32: 24, torch.float64: 53}

# ---- fast cell ids ---------------------------------------------------------
#
# Exactness does not require exact cell assignment: the build halo puts every
# star within `radius` (chordal) of a cell's box into its candidate list, so
# a lookup through any cell whose box is within `margin = radius − 3w` of the
# ray is exact. The approximations below have a proven error bound (the JAX
# package gates it in tests/test_stars.py::test_fast_cell_id_bound):
#
#   * asin: Abramowitz–Stegun 4.4.45 sqrt-weighted cubic, |err| ≤ 6.8e-5
#   * atan2: octant-folded odd minimax polynomial, |err| ≤ 5e-7 + rounding
#
# The fast ids are used only when margin ≥ _FAST_CELL_MIN_MARGIN and the
# dtype carries at least f32 precision; other grids take the exact
# transcendentals.
_FAST_CELL_ERR = 2.0e-4
_FAST_CELL_MIN_MARGIN = 15.0 * _FAST_CELL_ERR
_ASIN_C = (1.5707288, -0.2121144, 0.0742610, -0.0187293)
_ATAN_C = (0.99999933, -0.33326375, 0.19879872, -0.13480406,
           0.08374156, -0.03689863, 0.00782548)


def _fast_asin(z: torch.Tensor) -> torch.Tensor:
    """asin with |error| ≤ 6.8e-5 rad (A&S 4.4.45):
    asin(x) = π/2 − √(1−x)·(a₀+a₁x+a₂x²+a₃x³) on [0,1], odd-extended."""
    az = torch.abs(z)
    a0, a1, a2, a3 = _ASIN_C
    p = a0 + az * (a1 + az * (a2 + az * a3))
    r = math.pi / 2 - torch.sqrt(torch.clamp(1.0 - az, min=0.0)) * p
    return torch.where(z < 0, -r, r)


def _fast_ra(ny: torch.Tensor, nx: torch.Tensor) -> torch.Tensor:
    """atan2(ny, nx) folded into [0, 2π), |error| ≤ ~1e-6 rad: octant
    reduction (one divide) + odd minimax polynomial on [0, 1]."""
    ax = torch.abs(nx)
    ay = torch.abs(ny)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.clamp(hi, min=1e-30)
    u = t * t
    c = _ATAN_C
    p = c[6]
    for k in (5, 4, 3, 2, 1, 0):
        p = c[k] + u * p
    a = t * p  # atan in [0, π/4]
    a = torch.where(ay > ax, math.pi / 2 - a, a)
    a = torch.where(nx < 0, math.pi - a, a)
    return torch.where(ny < 0, 2.0 * math.pi - a, a)


def rgb_basis(hue: np.ndarray, sat: np.ndarray) -> np.ndarray:
    """Per-star colour basis H = s·G(h): HSI→RGB is rgb = i·(1 + H).

    Mirrors :func:`blackstar_tpu_torch.color.hsi_to_rgb` algebraically
    (float64, build-time): sector cr = cos(a)/cos(π/3−a); G permutes
    (cr, 1−cr, −1).
    """
    hue = np.asarray(hue, np.float64)
    sat = np.asarray(sat, np.float64)
    hp = hue * 2.0 * np.pi
    sector = np.clip(np.floor(hp / (2.0 * np.pi / 3.0)), 0, 2).astype(np.int64)
    a = hp - sector * (2.0 * np.pi / 3.0)
    cr = np.cos(a) / np.cos(np.pi / 3.0 - a)
    first, third, second = cr, 1.0 - cr, np.full_like(cr, -1.0)
    g = np.empty(hue.shape + (3,), np.float64)
    for s_idx, perm in enumerate(((first, third, second),
                                  (second, first, third),
                                  (third, second, first))):
        m = sector == s_idx
        for c in range(3):
            g[m, c] = perm[c][m]
    return sat[..., None] * g


@dataclass
class StarGrid:
    """The two-level bucketed star tables, as tensors on one device.

    The grid is equirectangular — every declination ring has the same
    ``n_cols`` columns — so a ray's cell id is pure arithmetic.
    """

    cell_data: torch.Tensor  # (C, K0·8) base candidate slots, sentinel-padded
    ovf_data: torch.Tensor  # (R, K1·8) overflow slots; row 0 = dummy
    ovf_octets: torch.Tensor  # (R,) int32 used octets per overflow row
    n_rings: int
    n_cols: int
    n_stars: int
    psf_width: float
    radius: float

    @property
    def pad_k(self) -> int:
        return self.cell_data.shape[1] // _ROW

    @property
    def margin(self) -> float:
        """Build halo beyond the query radius: how far a ray direction may
        sit from its cell while its whole query disk is still covered."""
        return max(0.0, self.radius - 3.0 * self.psf_width)

    @property
    def dtype(self) -> torch.dtype:
        return self.cell_data.dtype

    @property
    def device(self) -> torch.device:
        return self.cell_data.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.cell_data, self.ovf_data, self.ovf_octets))

    def fast_cells_ok(self, dt: torch.dtype) -> bool:
        """Whether the bounded-error fast cell ids keep lookups exact: the
        build margin must absorb the assignment error and the dtype must
        carry f32 precision."""
        return (self.margin >= _FAST_CELL_MIN_MARGIN
                and torch.finfo(dt).eps <= 2.0 ** -23)

    def psf_constants(self, dt: torch.dtype):
        """``(a, r2lim, inv2w2)`` = (ln2/50, (3w)², 1/(2w²)) rounded to
        ``dt`` exactly as the JAX package evaluates them, as Python floats
        (each exactly representable in ``dt``). The plain lookup and the
        kernel both take them from here."""
        w = torch.tensor(self.psf_width, dtype=dt)
        a = torch.log(torch.tensor(2.0, dtype=dt)) / DYNAMIC
        r2lim = (3.0 * w) ** 2
        inv2w2 = 1.0 / (2.0 * w * w)
        return float(a), float(r2lim), float(inv2w2)

    def cell_ids(self, nx: torch.Tensor, ny: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
        """Bucket id (int64) from unit-direction component planes:
        declination ring, then azimuthal column."""
        dt = nx.dtype
        two_pi = 2.0 * math.pi
        delta = torch.tensor(math.pi / self.n_rings, dtype=dt, device=nx.device)
        if self.fast_cells_ok(dt):
            dec = _fast_asin(torch.clamp(nz, -1.0, 1.0))
            ra = _fast_ra(ny, nx)
        else:
            dec = torch.asin(torch.clamp(nz, -1.0, 1.0))
            ra = torch.remainder(torch.atan2(ny, nx), two_pi)
        ring = torch.clamp(torch.floor((dec + math.pi / 2) / delta).to(torch.int64),
                           0, self.n_rings - 1)
        col = torch.clamp(torch.floor(ra / two_pi * self.n_cols).to(torch.int64),
                          0, self.n_cols - 1)
        return ring * self.n_cols + col

    def _slot_sum(self, rows, nx, ny, nz, intensity, saturation, consts):
        """Summed candidate RGB (m, 3) over all slots of gathered rows
        (m, K·8): the per-star ``starLookup`` math (StarMap.hs:93-114).
        The difference-first d² keeps full precision at d ~ w in float32."""
        a, r2lim, inv2w2 = consts
        s = rows.reshape(rows.shape[0], -1, _ROW)
        dx = s[..., 0] - nx[:, None]
        dy = s[..., 1] - ny[:, None]
        dz = s[..., 2] - nz[:, None]
        d2 = dx * dx + dy * dy + dz * dz
        logb0 = a * (MAX_BRIGHTNESS - s[..., 3])
        # Outside the 3w cutoff the contribution is exactly 0 (the
        # reference's inRadius pre-filter); sentinels die here too.
        e = torch.exp(torch.where(d2 <= r2lim, logb0 - d2 * inv2w2,
                                  torch.full_like(d2, -math.inf)))
        val = torch.clamp(e, max=1.0) * intensity
        color = 1.0 + saturation * s[..., 4:7]
        return (val[..., None] * color).sum(dim=1)

    def _slot_vjp(self, rows, nx, ny, nz, w, intensity, saturation, consts):
        """Gradient mode of :meth:`_slot_sum` (the JAX package's
        ``_slot_math`` with cotangent planes): per ray, the five channels
        ``(gx, gy, gz, gI, gS)`` (m, 5) of ∂L/∂(normalised direction),
        ∂L/∂intensity and ∂L/∂saturation, summed over the slots of gathered
        rows (m, K·8), for the cotangents ``w`` (m, 3) of the unclamped
        sums. ``du/de`` of ``u = min(1, e)`` is 1 below the cap, 0 above it
        and 0.5 at an exact tie, as ``jax.grad`` through ``lax.min`` takes
        it."""
        a, r2lim, inv2w2 = consts
        s = rows.reshape(rows.shape[0], -1, _ROW)
        dx = s[..., 0] - nx[:, None]
        dy = s[..., 1] - ny[:, None]
        dz = s[..., 2] - nz[:, None]
        d2 = dx * dx + dy * dy + dz * dz
        logb0 = a * (MAX_BRIGHTNESS - s[..., 3])
        e = torch.exp(torch.where(d2 <= r2lim, logb0 - d2 * inv2w2,
                                  torch.full_like(d2, -math.inf)))
        u = torch.clamp(e, max=1.0)
        hr, hg, hb = s[..., 4], s[..., 5], s[..., 6]
        wr, wg, wb = (w[:, c:c + 1] for c in range(3))
        # Σ_c w̄_c·(1 + sat·H_c) = ∂L/∂(I·u), and Σ_c w̄_c·H_c.
        cw = wr * (1.0 + saturation * hr) + wg * (1.0 + saturation * hg) + wb * (1.0 + saturation * hb)
        hw = wr * hr + wg * hg + wb * hb
        due = torch.where(e < 1.0, 1.0, torch.where(e == 1.0, 0.5, 0.0)).to(e.dtype)
        # ∂L/∂d² = I·cw·(du/de)·e·(−1/(2w²)); ∂d²/∂n_i = −2·d_i.
        gd2 = (intensity * cw) * (due * e) * (-inv2w2)
        return torch.stack([-(2.0 * gd2 * dx).sum(dim=1), -(2.0 * gd2 * dy).sum(dim=1),
                            -(2.0 * gd2 * dz).sum(dim=1), (u * cw).sum(dim=1),
                            ((u * intensity) * hw).sum(dim=1)], dim=-1)

    def _rays(self, vel, active):
        """Normalised directions (nx, ny, nz), ``1/|v|`` and the rows of a
        batch: dead rays get a harmless probe direction (results zeroed by
        the callers)."""
        dt = vel.dtype
        if active is not None:
            vel = torch.where(active[:, None], vel, torch.ones((), dtype=dt, device=vel.device))
        vx, vy, vz = vel.unbind(-1)
        inv = torch.rsqrt(vx * vx + vy * vy + vz * vz)
        nx, ny, nz = vx * inv, vy * inv, vz * inv
        raw = self.cell_data[self.cell_ids(nx, ny, nz)]  # grid dtype: the pointer column stays exact
        ptr = raw[:, 7].to(torch.int64)
        has = ptr > 0
        if active is not None:
            has = has & active
        return (nx, ny, nz), inv, raw.to(dt), ptr, torch.nonzero(has).squeeze(1)

    def _lookup_block(self, vel, intensity, saturation, active, consts, clamp):
        dt = vel.dtype
        (nx, ny, nz), _, rows, ptr, idx = self._rays(vel, active)
        acc = self._slot_sum(rows, nx, ny, nz, intensity, saturation, consts)
        if idx.numel():
            orow = self.ovf_data[ptr[idx]].to(dt)
            acc = acc.index_add(0, idx, self._slot_sum(
                orow, nx[idx], ny[idx], nz[idx], intensity, saturation, consts))
        out = torch.clamp(acc, max=1.0) if clamp else acc
        if active is not None:
            out = torch.where(active[:, None], out, torch.zeros((), dtype=dt, device=out.device))
        return out

    def lookup(self, vel: torch.Tensor, intensity: torch.Tensor,
               saturation: torch.Tensor, active: Optional[torch.Tensor] = None,
               chunk: int = 1 << 17, clamp: bool = True) -> torch.Tensor:
        """Star colour (N, 3) for ray directions ``vel`` (N, 3): the plain
        PyTorch ``starLookup`` (StarMap.hs:93-115), semantics of the JAX
        package's ``StarGrid._lookup_block``.

        Per ray: normalise by rsqrt, take the cell id, sum the base row's
        slots, then the overflow row's (through the pointer in base slot
        0's aux column), clamp at 1 (unless ``clamp`` is False), and zero
        where ``active`` is False. Rays go in ``chunk``-sized batches so the
        gathered rows (K0·32 bytes per ray in f32) stay bounded.
        """
        StarGrid.lookup.calls += 1
        dt = vel.dtype
        n = vel.shape[0]
        if self.n_stars == 0:
            return torch.zeros((n, 3), dtype=dt, device=vel.device)
        consts = self.psf_constants(dt)
        intensity = intensity.to(dt)
        saturation = saturation.to(dt)
        parts = []
        for s in range(0, n, chunk):
            act = None if active is None else active[s:s + chunk]
            parts.append(self._lookup_block(vel[s:s + chunk], intensity,
                                            saturation, act, consts, clamp))
        return torch.cat(parts) if parts else torch.zeros((0, 3), dtype=dt, device=vel.device)

    lookup.calls = 0  # plain-path call count: shows which lookup a run took

    def lookup_vjp(self, vel: torch.Tensor, intensity: torch.Tensor,
                   saturation: torch.Tensor, active: torch.Tensor, w: torch.Tensor,
                   chunk: int = 1 << 16):
        """Reverse of the unclamped ``lookup(..., clamp=False)`` for the
        cotangents ``w`` (N, 3): ``(∂L/∂vel (N, 3), ∂L/∂intensity,
        ∂L/∂saturation)``. Written out by hand (the JAX package's
        ``stars/diff.py`` backward): the five gradient channels of each slot
        over the same base-row plus overflow-row walk as :meth:`lookup`,
        then the chain through the normalisation ``n = v/|v|``,
        ``∂n_i/∂v_j = (δ_ij − n_i n_j)/|v|``. Rays where ``active`` is False
        have a constant zero output and get zero gradient. No gradient
        reaches the grid's tables."""
        StarGrid.lookup_vjp.calls += 1
        dt = vel.dtype
        n = vel.shape[0]
        zero = torch.zeros((), dtype=dt, device=vel.device)
        if self.n_stars == 0:
            return torch.zeros((n, 3), dtype=dt, device=vel.device), zero, zero
        consts = self.psf_constants(dt)
        intensity = intensity.to(dt)
        saturation = saturation.to(dt)
        w = torch.where(active[:, None], w.to(dt), zero)
        gvels = []
        g_i = g_s = zero
        for s in range(0, n, chunk):
            act, ws = active[s:s + chunk], w[s:s + chunk]
            (nx, ny, nz), inv, rows, ptr, idx = self._rays(vel[s:s + chunk], act)
            g = self._slot_vjp(rows, nx, ny, nz, ws, intensity, saturation, consts)
            if idx.numel():
                orow = self.ovf_data[ptr[idx]].to(dt)
                g = g.index_add(0, idx, self._slot_vjp(
                    orow, nx[idx], ny[idx], nz[idx], ws[idx], intensity, saturation, consts))
            gx, gy, gz, gi, gsat = g.unbind(-1)
            gdotn = gx * nx + gy * ny + gz * nz
            gvels.append(torch.stack([(gx - nx * gdotn) * inv, (gy - ny * gdotn) * inv,
                                      (gz - nz * gdotn) * inv], dim=-1))
            g_i = g_i + gi.sum()
            g_s = g_s + gsat.sum()
        gvel = torch.cat(gvels) if gvels else torch.zeros((0, 3), dtype=dt, device=vel.device)
        return gvel, g_i, g_s

    lookup_vjp.calls = 0  # plain-path call count


@dataclass
class CompactStarGrid:
    """Host-side CSR form of the grid: per-cell candidate counts plus
    star ids into a deduplicated (S, 8) slot-row table. This is what is
    serialised and what :meth:`to_grid` densifies into a :class:`StarGrid`."""

    counts: np.ndarray  # (C,) int32 candidates per cell
    star_ids: np.ndarray  # (P,) int32/int64 into star_rows, CSR order
    star_rows: np.ndarray  # (S, 8) float64 per-star slot rows
    n_rings: int
    n_cols: int
    n_stars: int
    psf_width: float
    radius: float
    k0: int = DEFAULT_K0

    @property
    def n_cells(self) -> int:
        return self.counts.shape[0]

    @property
    def slots(self) -> np.ndarray:
        """(P, 8) candidate slots in CSR order (materialised)."""
        return self.star_rows[self.star_ids]

    def tables(self):
        """The dense float64 tables ``(cell_data, ovf_data, ovf_octets)``:
        (C, K0·8), (R, K1·8) and (R,) int32, single overflow tier."""
        k0 = int(self.k0)
        counts = self.counts.astype(np.int64)
        c = self.n_cells
        k_max = int(counts.max()) if c and counts.size else 0
        k0e = max(1, min(k0, max(k_max, 1)))

        base = np.zeros((c, k0e, _ROW), np.float64)
        base[..., 0:3] = _SENTINEL_POS
        base[..., 3] = _SENTINEL_MAG

        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        p = int(counts.sum())
        cells = np.repeat(np.arange(c, dtype=np.int64), counts)
        slot = np.arange(p, dtype=np.int64) - starts[cells]
        slots = self.slots

        bm = slot < k0e
        base[cells[bm], slot[bm], :] = slots[bm]
        base[cells[bm], slot[bm], 7] = 0.0  # aux field is not star data

        # Overflow rows are padded to whole octets (8 slots).
        k1 = max(0, k_max - k0e)
        k1 = -(-k1 // 8) * 8 if k1 else 0
        if k1 == 0:
            ovf = np.zeros((1, 1, _ROW), np.float64)
            ovf[..., 0:3] = _SENTINEL_POS
            ovf[..., 3] = _SENTINEL_MAG
            ovf_octets = np.zeros(1, np.int32)
        else:
            ovf_cells = np.flatnonzero(counts > k0e)
            n_ovf = len(ovf_cells)
            ovf = np.zeros((n_ovf + 1, k1, _ROW), np.float64)
            ovf[..., 0:3] = _SENTINEL_POS
            ovf[..., 3] = _SENTINEL_MAG
            row_of_cell = np.zeros(c, np.int64)
            row_of_cell[ovf_cells] = 1 + np.arange(n_ovf)
            om = ~bm
            ovf[row_of_cell[cells[om]], slot[om] - k0e, :] = slots[om]
            # The overflow pointer lives in the base row's aux field: row 0
            # is the dummy, so 0 means "none".
            base[:, 0, 7] = row_of_cell
            ovf_octets = np.zeros(n_ovf + 1, np.int32)
            ovf_octets[1:] = -(-(counts[ovf_cells] - k0e) // 8)
        return (base.reshape(base.shape[0], -1), ovf.reshape(ovf.shape[0], -1),
                ovf_octets)

    def to_grid(self, device, dtype: torch.dtype = torch.float32) -> StarGrid:
        """Materialise the dense two-level tables as tensors of ``dtype``
        on ``device``."""
        base, ovf, ovf_octets = self.tables()
        # The float-encoded overflow pointers must survive the cast.
        mant = _MANTISSA_BITS.get(dtype)
        if mant is None:
            raise ValueError(f"unsupported star-grid dtype {dtype}")
        if ovf.shape[0] > (1 << mant):
            raise ValueError(
                f"cannot build StarGrid at {dtype}: overflow-row pointers up "
                f"to {ovf.shape[0]} need more than {mant} mantissa bits"
            )
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        return StarGrid(
            cell_data=torch.from_numpy(base.astype(np_dt, copy=False)).to(device),
            ovf_data=torch.from_numpy(ovf.astype(np_dt, copy=False)).to(device),
            ovf_octets=torch.from_numpy(ovf_octets).to(device),
            n_rings=int(self.n_rings),
            n_cols=int(self.n_cols),
            n_stars=int(self.n_stars),
            psf_width=float(self.psf_width),
            radius=float(self.radius),
        )


def _insertion_pairs(catalog: Catalog, cell_size: float, r: float):
    """(cells, stars) insertion pairs: each star enters every cell whose
    radius-expanded region contains it, so queries touch exactly one cell.
    Fully vectorised (the variable azimuthal halo is expanded with a
    repeat/offset trick rather than a loop over offsets)."""
    n_rings = max(1, int(np.ceil(np.pi / cell_size)))
    ncol = max(1, int(np.ceil(2 * np.pi / cell_size)))  # fixed per ring
    delta = np.pi / n_rings

    pos = np.asarray(catalog.pos, np.float64)
    s = pos.shape[0]
    if s == 0:
        z = np.zeros(0, np.int64)
        return z, z, n_rings, ncol

    z = np.clip(pos[:, 2], -1.0, 1.0)
    dec = np.arcsin(z)
    ra = np.mod(np.arctan2(pos[:, 1], pos[:, 0]), 2 * np.pi)

    # Insertion halo: the query radius is *chordal*; converting to angular
    # distance and cell overlap needs a small safety margin.
    rh = 1.01 * r

    # Rings whose dec-range expanded by rh contains the star.
    ring_lo = np.clip(
        np.floor((dec - rh + np.pi / 2) / delta).astype(np.int64), 0, n_rings - 1
    )
    ring_hi = np.clip(
        np.floor((dec + rh + np.pi / 2) / delta).astype(np.int64), 0, n_rings - 1
    )

    # Expand (star, ring) pairs.
    n_ring = ring_hi - ring_lo + 1
    sr_star = np.repeat(np.arange(s, dtype=np.int64), n_ring)
    sr_first = np.repeat(np.cumsum(n_ring) - n_ring, n_ring)
    sr_ring = ring_lo[sr_star] + (np.arange(len(sr_star)) - sr_first)

    # Azimuthal halo: chordal radius r subtends RA width r / cos(dec). The
    # star can sit up to rh outside the ring in declination, where cos(dec)
    # is smaller than at the ring's own edge — take the worst cos over the
    # rh-extended band.
    edge_lo = -np.pi / 2 + delta * sr_ring
    edge_hi = edge_lo + delta
    ext_lo = np.maximum(edge_lo - rh, -np.pi / 2)
    ext_hi = np.minimum(edge_hi + rh, np.pi / 2)
    min_cos = np.minimum(np.cos(ext_lo), np.cos(ext_hi))
    safe_cos = np.maximum(min_cos, 1e-12)
    # Rings touching the poles: halo covers the full circle.
    dra = np.where(min_cos < rh, np.pi, 1.05 * rh / safe_cos)
    col_halo = np.ceil(dra / (2 * np.pi) * ncol).astype(np.int64)
    col_halo = np.minimum(col_halo, ncol // 2)  # full circle at most
    col0 = np.floor(ra[sr_star] / (2 * np.pi) * ncol).astype(np.int64)

    # Expand (star, ring, col) triples: offsets -halo..+halo per pair.
    n_col = 2 * col_halo + 1
    p_star = np.repeat(sr_star, n_col)
    p_ring = np.repeat(sr_ring, n_col)
    p_first = np.repeat(np.cumsum(n_col) - n_col, n_col)
    offs = (np.arange(len(p_star)) - p_first) - np.repeat(col_halo, n_col)
    p_col = np.mod(np.repeat(col0, n_col) + offs, ncol)

    cells = p_ring * ncol + p_col
    stars = p_star
    # Deduplicate (a star can enter the same wrapped column twice).
    uniq = np.unique(cells * np.int64(s) + stars)
    cells, stars = uniq // s, uniq % s
    order = np.argsort(cells, kind="stable")
    return cells[order], stars[order], n_rings, ncol


def build_star_grid_compact(
    catalog: Catalog,
    *,
    cell_size: float = DEFAULT_CELL_SIZE,
    k0: int = DEFAULT_K0,
    psf_width: float = PSF_WIDTH,
    radius: Optional[float] = None,
) -> CompactStarGrid:
    """Offline bucket build (the ``generate-tree`` analogue, StarMap.hs:90-91).

    ``cell_size`` is the ring height in radians; ``radius`` (default 3w)
    may exceed it. A radius beyond 3·psf_width is the build margin that the
    fast cell ids need. ``k0`` picks the base-table slot count — excess
    candidates of dense cells go to the overflow table.
    """
    r = QUERY_RADIUS if radius is None else float(radius)
    r = float(max(r, 3.0 * psf_width))
    if cell_size <= 0:
        raise ValueError(f"cell_size must be positive, got {cell_size}")

    cells, stars, n_rings, ncol = _insertion_pairs(catalog, cell_size, r)
    n_cells = n_rings * ncol
    counts = np.bincount(cells, minlength=n_cells).astype(np.int32)

    s = int(catalog.pos.shape[0])
    star_rows = np.zeros((s, _ROW), np.float64)
    if s:
        star_rows[:, 0:3] = np.asarray(catalog.pos, np.float64)
        star_rows[:, 3] = np.asarray(catalog.mag, np.float64)
        star_rows[:, 4:7] = rgb_basis(catalog.hue, catalog.sat)

    return CompactStarGrid(
        counts=counts,
        star_ids=stars.astype(np.int32 if s < (1 << 31) else np.int64),
        star_rows=star_rows,
        n_rings=n_rings,
        n_cols=ncol,
        n_stars=s,
        psf_width=float(psf_width),
        radius=r,
        k0=int(k0),
    )


def build_star_grid(
    catalog: Catalog,
    *,
    device,
    dtype: torch.dtype = torch.float32,
    cell_size: float = DEFAULT_CELL_SIZE,
    k0: int = DEFAULT_K0,
    psf_width: float = PSF_WIDTH,
    radius: Optional[float] = None,
) -> StarGrid:
    """Build (:func:`build_star_grid_compact`) and densify
    (:meth:`CompactStarGrid.to_grid`) in one step."""
    compact = build_star_grid_compact(
        catalog, cell_size=cell_size, k0=k0, psf_width=psf_width, radius=radius
    )
    return compact.to_grid(device, dtype=dtype)


def save_star_grid(grid, path: str) -> str:
    """Serialise a grid to the v6 ``.npz``; returns the path written (the
    ``.npz`` suffix is appended when missing). Takes a
    :class:`CompactStarGrid` (the offline build's product) or a dense
    :class:`StarGrid` (turned back into the compact form first). Slot values
    are stored as float64 but keep the precision of the grid saved: a dense
    grid at float32 round-trips with float32 values."""
    if isinstance(grid, StarGrid):
        grid = _dense_to_compact(grid)
    if not isinstance(grid, CompactStarGrid):
        raise TypeError(f"save_star_grid takes a CompactStarGrid or a StarGrid, "
                        f"got {type(grid).__name__}")
    if not path.endswith(".npz"):
        path = path + ".npz"
    # Atomic write: an interrupted build never leaves a truncated file at
    # the final path.
    tmp = path[:-4] + ".tmp.npz"  # keep the suffix: np.savez appends it
    np.savez_compressed(
        tmp,
        version=_FORMAT_VERSION,
        counts=grid.counts.astype(np.int32),
        star_ids=grid.star_ids,
        star_rows=np.asarray(grid.star_rows, np.float64),
        n_rings=grid.n_rings,
        n_cols=grid.n_cols,
        n_stars=grid.n_stars,
        psf_width=grid.psf_width,
        radius=grid.radius,
        k0=grid.k0,
    )
    os.replace(tmp, path)
    return path


def _dense_to_compact(grid: StarGrid) -> CompactStarGrid:
    """Recover the CSR form from the dense tables (the layout
    :meth:`CompactStarGrid.tables` writes: K0 base slots a cell, one
    overflow row per dense cell through the pointer in base slot 0's aux
    column). Sentinels are unambiguous: a real candidate has mag ≪ 1e9.
    The star table is rebuilt by deduplicating identical slot rows (halo
    copies of a star are exact duplicates), so its order is not
    that of :func:`build_star_grid_compact`."""
    base = grid.cell_data.detach().cpu().double().numpy()
    base = base.reshape(base.shape[0], -1, _ROW).copy()
    ovf = grid.ovf_data.detach().cpu().double().numpy()
    ovf = ovf.reshape(ovf.shape[0], -1, _ROW)
    c, k0 = base.shape[0], base.shape[1]
    ptr = base[:, 0, 7].astype(np.int64)
    base[:, 0, 7] = 0.0

    bvalid = base[..., 3] < _SENTINEL_MAG / 2  # (C, K0)
    bcounts = bvalid.sum(axis=1).astype(np.int64)
    ocounts_row = (ovf[..., 3] < _SENTINEL_MAG / 2).sum(axis=1).astype(np.int64)
    ocells = np.flatnonzero(ptr > 0)
    ocounts = np.zeros(c, np.int64)
    ocounts[ocells] = ocounts_row[ptr[ocells]]
    # Valid slots are a prefix of every row, so CSR order is the cells in
    # order, each its base slots, then its overflow slots.
    orows = ovf[ptr[ocells]]
    rows = np.concatenate([base[bvalid],
                           orows[orows[..., 3] < _SENTINEL_MAG / 2]])
    cell_of = np.concatenate([np.repeat(np.arange(c), bcounts), np.repeat(ocells, ocounts[ocells])])
    slot_of = np.concatenate([
        np.concatenate([np.arange(k) for k in bcounts]) if c else np.zeros(0, np.int64),
        k0 + (np.concatenate([np.arange(k) for k in ocounts[ocells]]) if len(ocells)
              else np.zeros(0, np.int64)),
    ])
    rows = rows[np.lexsort((slot_of, cell_of))]
    view = np.ascontiguousarray(rows).view(
        np.dtype((np.void, rows.dtype.itemsize * rows.shape[1]))
    ).reshape(-1)
    uniq, ids = np.unique(view, return_inverse=True)
    star_rows = uniq.view(rows.dtype).reshape(-1, rows.shape[1])
    return CompactStarGrid(
        counts=(bcounts + ocounts).astype(np.int32),
        star_ids=ids.reshape(-1).astype(np.int32),
        star_rows=star_rows,
        n_rings=grid.n_rings,
        n_cols=grid.n_cols,
        n_stars=grid.n_stars,
        psf_width=grid.psf_width,
        radius=grid.radius,
        k0=k0,
    )


def load_star_grid_compact(path: str) -> CompactStarGrid:
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported star-grid format version {int(z['version'])} "
                f"(expected {_FORMAT_VERSION}; rebuild the grid)"
            )
        return CompactStarGrid(
            counts=z["counts"],
            star_ids=z["star_ids"],
            star_rows=z["star_rows"],
            n_rings=int(z["n_rings"]),
            n_cols=int(z["n_cols"]),
            n_stars=int(z["n_stars"]),
            psf_width=float(z["psf_width"]),
            radius=float(z["radius"]),
            k0=int(z["k0"]),
        )


def load_star_grid(path: str, device, dtype: torch.dtype = torch.float32) -> StarGrid:
    """Load the compact artifact and materialise the dense tables on
    ``device``."""
    return load_star_grid_compact(path).to_grid(device, dtype=dtype)
