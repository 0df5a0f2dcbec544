"""The windowed star stage: the port of ``scripts/proto_window_kernel.py``
(a TPU prototype of the star lookup in two passes over 4096-ray tiles).

It computes, for the rays it covers, what :meth:`StarGrid.lookup` computes
per ray (the exact ``starLookup`` of StarMap.hs:93-115), but reads the
tables through per-tile windows:

* a pre-pass (:func:`prepass`) gives each tile a DR×DC-cell window of the
  base table centred on the tile's mean direction, and each ray its index in
  that window; a ray whose cell lies outside the window (or that did not
  escape) is not covered;
* K1 sums the slot math over each covered ray's base row and emits the
  packed overflow-row pointer (base slot 0's aux column);
* K2 gives each tile an OVW-row window of the overflow table, starting at
  the tile's least positive pointer (clipped), and sums the used octets of
  the overflow row of every covered ray whose pointer lies in it. A pointer
  outside the window is an ``ovf_missed`` ray: its overflow stars are left
  out.

The passes' sum is clamped at 1 per channel and zeroed where not covered.
The prototype's approximations are kept as they are: the exact
``asin``/``atan2`` cell ids, ``c0`` clamped to ``[0, nc − DC]`` and no
wrap at the RA seam.

:func:`k1_reference` and :func:`k2_reference` are the plain PyTorch versions
of K1 and K2, in the prototype's ``_star_math`` order of operations; the
kernels (``stars/csrc/star_window.cu``, wrappers ``stars/window_cuda.py``)
compute the same on the card. :func:`window_stage` runs the stage: CUDA
tensors go through the kernels, CPU tensors through the plain versions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from blackstar_tpu_torch.stars.grid import MAX_BRIGHTNESS, StarGrid

T = 4096  # rays per tile
DR, DC = 32, 128  # base window: DR rings × DC columns (DR·DC == T)
OVW = 2048  # overflow window rows
ROW = 8  # floats per slot

_CHUNK = 1 << 18  # rays per batch of the plain passes (1 KB of rows per ray at K0 32, f32)


class StageInputs(NamedTuple):
    """The pre-pass's outputs, flat over rays (N = n_tiles·T)."""

    rx: torch.Tensor  # (N,) normalised direction planes
    ry: torch.Tensor
    rz: torch.Tensor
    starts: torch.Tensor  # (n_tiles, 2) int32 base-window origin (r0, c0)
    widx: torch.Tensor  # (N,) int32 index in the window, rrel·DC + crel (0 if not covered)
    covered: torch.Tensor  # (N,) bool


class StageOutputs(NamedTuple):
    rgb: torch.Tensor  # (N, 3) clamped, 0 where not covered
    covered: torch.Tensor  # (N,) bool
    ovf_missed: torch.Tensor  # (N,) bool: the overflow pointer missed its tile's window
    optr: torch.Tensor  # (N,) int32 overflow pointer of covered rays (0: none)
    s2: torch.Tensor  # (n_tiles,) int32 overflow-window starts


def _ring_col(v: torch.Tensor, nr: int, nc: int):
    """Exact declination ring and RA column (int32) of unit directions."""
    dec = torch.asin(torch.clamp(v[:, 2], -1, 1))
    ra = torch.remainder(torch.atan2(v[:, 1], v[:, 0]), 2 * math.pi)
    delta = math.pi / nr
    ring = torch.clamp(torch.floor((dec + math.pi / 2) / delta).to(torch.int32), 0, nr - 1)
    col = torch.clamp(torch.floor(ra / (2 * math.pi) * nc).to(torch.int32), 0, nc - 1)
    return ring, col


def prepass(v: torch.Tensor, esc: torch.Tensor, nr: int, nc: int):
    """Per-tile window starts ``(n_tiles, 2)``, per-ray window index and
    cover ``(n_tiles, T)`` for unit directions ``v`` (N, 3) and the escape
    mask ``esc`` (N,): the prototype's XLA pre-pass."""
    n = v.shape[0]
    n_tiles = n // T
    ring, col = _ring_col(v, nr, nc)
    mean = v.reshape(n_tiles, T, 3).mean(dim=1)
    mean = mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
    mring, mcol = _ring_col(mean, nr, nc)
    r0 = torch.clamp(mring - DR // 2, 0, nr - DR)
    c0 = torch.clamp(mcol - DC // 2, 0, nc - DC)  # no seam wrap, as in the prototype
    starts = torch.stack([r0, c0], dim=-1)
    rrel = ring.reshape(n_tiles, T) - r0[:, None]
    crel = col.reshape(n_tiles, T) - c0[:, None]
    covered = ((rrel >= 0) & (rrel < DR) & (crel >= 0) & (crel < DC)
               & esc.reshape(n_tiles, T))
    widx = torch.where(covered, rrel * DC + crel, 0).to(torch.int32)
    return starts, widx, covered


def _slot_accumulate(rows, slots, rx, ry, rz, consts, intensity, saturation, acc):
    """Add the slot math of ``rows``' first ``slots`` slots to ``acc``, slot by
    slot in the prototype's ``_star_math`` order: difference-first d², the
    (3w)² cutoff inside the exp, ``min(1, e)·intensity``, then
    ``val·(1 + sat·H)`` per channel."""
    a, r2lim, inv2w2 = consts
    ar, ag, ab = acc
    for k in range(slots):
        s = rows[:, k * ROW:(k + 1) * ROW]
        logb0 = a * (MAX_BRIGHTNESS - s[:, 3])
        cr = 1.0 + saturation * s[:, 4]
        cg = 1.0 + saturation * s[:, 5]
        cb = 1.0 + saturation * s[:, 6]
        dx = s[:, 0] - rx
        dy = s[:, 1] - ry
        dz = s[:, 2] - rz
        d2 = dx * dx + dy * dy + dz * dz
        e = torch.exp(torch.where(d2 <= r2lim, logb0 - d2 * inv2w2,
                                  torch.full_like(d2, -math.inf)))
        val = torch.clamp(e, max=1.0) * intensity
        ar = ar + val * cr
        ag = ag + val * cg
        ab = ab + val * cb
    return ar, ag, ab


def k1_reference(starts, widx, covered, rx, ry, rz, tbl3, consts, intensity, saturation):
    """K1, the base pass, in plain PyTorch: per ray, the slot sums of its
    window row ``tbl3[r0 + widx // DC, c0 + widx % DC]`` and that row's
    overflow pointer. Every ray is computed, as on the TPU (an uncovered ray
    reads its window's first row); ``covered`` is the kernel's and unused
    here. ``tbl3`` is the base table as (n_rings, n_cols, K0·8); ``consts``
    is :meth:`StarGrid.psf_constants`. Returns ``(ar, ag, ab, optr)``, (N,)
    each, ``optr`` int32."""
    k1_reference.calls += 1
    nc, width = tbl3.shape[1], tbl3.shape[2]
    flat = tbl3.reshape(-1, width)
    tile = torch.arange(widx.shape[0], device=widx.device) // T
    w = widx.long()
    cell = ((starts[tile, 0].long() + w // DC) * nc + starts[tile, 1].long() + w % DC)
    outs = [torch.empty_like(rx), torch.empty_like(rx), torch.empty_like(rx)]
    optr = torch.empty(widx.shape, dtype=torch.int32, device=widx.device)
    for s in range(0, rx.shape[0], _CHUNK):
        sl = slice(s, s + _CHUNK)
        rows = flat[cell[sl]]
        zero = torch.zeros_like(rx[sl])
        acc = _slot_accumulate(rows, width // ROW, rx[sl], ry[sl], rz[sl], consts,
                               intensity, saturation, (zero, zero, zero))
        for out, a in zip(outs, acc):
            out[sl] = a
        optr[sl] = rows[:, 7].to(torch.int32)
    return (*outs, optr)


k1_reference.calls = 0  # plain-path call count


def k2_reference(s2, optr, covered, rx, ry, rz, ovf_tbl, octets, consts, intensity, saturation):
    """K2, the overflow pass, in plain PyTorch: per covered ray whose
    pointer ``p`` lies in ``[s, s + OVW)`` of its tile's window start
    ``s = s2[tile]`` (and ``p > 0``), the slot sums of overflow row ``p``;
    0 for every other ray. The slots are scanned up to the largest used
    octet count of the batch's participating rows: the slots past a row's
    own octets are sentinels whose terms are exact +0, so the sums equal
    the TPU kernel's scan to the window's largest count. Returns
    ``(ar, ag, ab)``, (N,) each."""
    k2_reference.calls += 1
    tile = torch.arange(optr.shape[0], device=optr.device) // T
    s = s2[tile]
    within = (optr >= s) & (optr < s + OVW) & (optr > 0) & covered
    outs = [torch.zeros_like(rx), torch.zeros_like(rx), torch.zeros_like(rx)]
    idx_all = torch.nonzero(within).squeeze(1)
    for b in range(0, idx_all.shape[0], _CHUNK):
        idx = idx_all[b:b + _CHUNK]
        p = optr[idx].long()
        slots = int(octets[p].max()) * 8
        rows = ovf_tbl[:, :slots * ROW][p]
        zero = torch.zeros_like(rx[idx])
        acc = _slot_accumulate(rows, slots, rx[idx], ry[idx], rz[idx], consts,
                               intensity, saturation, (zero, zero, zero))
        for out, a in zip(outs, acc):
            out[idx] = a
    return tuple(outs)


k2_reference.calls = 0  # plain-path call count


def overflow_tables(grid: StarGrid):
    """The overflow table and octet counts as K2 takes them, padded as the
    prototype pads them: at least OVW + 1 rows, so that any clipped window
    start stays in range, and an even octet count per row (its kernel
    scanned octet pairs). Zero padding dies at the cutoff (d² = |r|² = 1).
    Returns ``(ovf_tbl, octets, pad_to)``; the grid's own tensors when no
    padding is needed."""
    ovf, octs = grid.ovf_data, grid.ovf_octets
    rows, width = ovf.shape
    n_oct = width // (8 * ROW)
    n_oct = n_oct + (n_oct & 1)
    pad_to = max(OVW + 1, rows)
    if pad_to == rows and n_oct * 8 * ROW == width:
        return ovf, octs, pad_to
    tbl = torch.zeros((pad_to, n_oct * 8 * ROW), dtype=ovf.dtype, device=ovf.device)
    tbl[:rows, :width] = ovf
    octs2 = torch.zeros((pad_to,), dtype=octs.dtype, device=octs.device)
    octs2[:rows] = octs
    return tbl, octs2, pad_to


def stage_inputs(v: torch.Tensor, esc: torch.Tensor, grid: StarGrid) -> StageInputs:
    """Normalise ``v`` (N, 3) by rsqrt, as the per-ray lookup does, and run
    the pre-pass. Raises unless N is a whole number of tiles."""
    n = v.shape[0]
    if v.shape != (n, 3) or esc.shape != (n,):
        raise ValueError(f"window stage: v must be (N, 3) and esc (N,), got "
                         f"{tuple(v.shape)} and {tuple(esc.shape)}")
    if n % T:
        raise ValueError(f"window stage: {n} rays is not a whole number of {T}-ray tiles")
    vx, vy, vz = v.unbind(-1)
    v = v * torch.rsqrt(vx * vx + vy * vy + vz * vz)[:, None]
    starts, widx, covered = prepass(v, esc, grid.n_rings, grid.n_cols)
    return StageInputs(v[:, 0].contiguous(), v[:, 1].contiguous(), v[:, 2].contiguous(),
                       starts, widx.reshape(n), covered.reshape(n))


def run_passes(inp: StageInputs, grid: StarGrid, intensity, saturation, k1, k2) -> StageOutputs:
    """K1, the window starts of K2, K2 and the clamp, with the passes ``k1``
    and ``k2`` given (the kernels' wrappers or the plain versions, which
    take the same arguments)."""
    dt = inp.rx.dtype
    n = inp.rx.shape[0]
    n_tiles = n // T
    consts = grid.psf_constants(dt)
    # The shading scalars rounded to the working type, as host numbers.
    intensity, saturation = torch.tensor([float(intensity), float(saturation)], dtype=dt).tolist()
    tbl3 = grid.cell_data.reshape(grid.n_rings, grid.n_cols, grid.pad_k * ROW)
    ar, ag, ab, optr = k1(inp.starts, inp.widx, inp.covered, inp.rx, inp.ry, inp.rz, tbl3,
                          consts, intensity, saturation)
    optr = torch.where(inp.covered, optr, 0)
    ovf_tbl, octets, pad_to = overflow_tables(grid)
    # Per-tile least positive pointer -> K2 window start.
    big = 1 << 30
    pmin = torch.where(optr > 0, optr, big).reshape(n_tiles, T).amin(dim=1)
    s2 = torch.clamp(torch.where(pmin == big, 1, pmin), 1, max(1, pad_to - OVW)).to(torch.int32)
    if grid.ovf_data.shape[0] > 1:
        br, bg, bb = k2(s2, optr, inp.covered, inp.rx, inp.ry, inp.rz, ovf_tbl, octets,
                        consts, intensity, saturation)
        ar, ag, ab = ar + br, ag + bg, ab + bb
        s = s2.repeat_interleave(T)
        ovf_missed = (optr > 0) & ((optr < s) | (optr >= s + OVW))
    else:
        ovf_missed = torch.zeros_like(inp.covered)
    rgb = torch.clamp(torch.stack([ar, ag, ab], dim=-1), max=1.0)
    rgb = torch.where(inp.covered[:, None], rgb, 0.0)
    return StageOutputs(rgb, inp.covered, ovf_missed, optr, s2)


def window_stage(v: torch.Tensor, esc: torch.Tensor, grid: StarGrid, intensity, saturation):
    """The windowed star stage for ray directions ``v`` (N, 3), N a multiple
    of T, and the escape mask ``esc`` (N,): ``(rgb (N, 3), covered (N,),
    ovf_missed (N,))``. K1 and K2 run as kernels for CUDA tensors and as
    their plain versions for CPU tensors."""
    from blackstar_tpu_torch.stars import window_cuda

    out = run_passes(stage_inputs(v, esc, grid), grid, intensity, saturation,
                     window_cuda.k1_cuda, window_cuda.k2_cuda)
    return out.rgb, out.covered, out.ovf_missed
