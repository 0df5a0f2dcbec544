"""The windowed star stage (K1 + K2) on a synthetic grid with overflow
cells: the port of ``scripts/proto_window_kernel.py``'s ``main``.

Run::

    python -m blackstar_tpu_torch.scripts.proto_window_kernel               # the card, f32
    python -m blackstar_tpu_torch.scripts.proto_window_kernel --device cpu  # semantics, f64

It builds the prototype's catalogue from ``numpy.random.default_rng(7)``
(6000 background stars plus 40 clusters of 60, so some cells overflow
K0 = 8) and its rays (per tile a seeded centre with jitter, 5% strays), and
runs :func:`window_stage` on them. It prints the grid, the covered and
``ovf_missed`` shares and the stage's largest difference from the per-ray
lookup on the covered rays whose overflow row was not missed.

* ``--device cpu``: float64, 4 tiles, the plain K1 and K2; the difference
  from :meth:`StarGrid.lookup` must stay under 1e-9 (``SEMANTICS OK``).
* on the card (the default): float32, ``--tiles`` tiles (507 = 1080p),
  kernels K1 and K2. The stage must launch both kernels and call no plain
  pass; then the kernels are held against the plain passes on the same
  pre-pass outputs (masks and pointers equal, colours within the f32 gates
  of the star kernel B3: mean 1e-6, max 3e-2), the stage against B3 under
  the same gates, and the stage, K1, K2 and B3 are timed with CUDA events
  over 20 calls.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from blackstar_tpu_torch.scripts import cuda_ms
from blackstar_tpu_torch.stars import window, window_cuda
from blackstar_tpu_torch.stars.catalog import Catalog
from blackstar_tpu_torch.stars.grid import build_star_grid_compact
from blackstar_tpu_torch.stars.lookup_cuda import star_lookup_cuda

INTENSITY = SATURATION = 0.7
REPS = 20  # calls per timing on the card


def synthetic_catalog(rng: np.random.Generator):
    """The prototype's catalogue, drawn from ``rng``: ``(catalog,
    (cluster_dec, cluster_ra))``, the cluster centres in the order drawn."""
    n_bg = 6000
    sdec = rng.uniform(-0.8, 0.8, n_bg)
    sra = rng.uniform(0.5, 5.5, n_bg)
    n_cl, cl_sz = 40, 60  # clusters: 40 spots × 60 stars inside ~1 cell each
    cdec = rng.uniform(-0.5, 0.5, n_cl)
    cra = rng.uniform(1.0, 5.0, n_cl)
    sdec = np.concatenate([sdec, np.repeat(cdec, cl_sz) + rng.normal(0, 0.004, n_cl * cl_sz)])
    sra = np.concatenate([sra, np.repeat(cra, cl_sz) + rng.normal(0, 0.004, n_cl * cl_sz)])
    n_stars = len(sdec)
    pos = np.stack([np.cos(sdec) * np.cos(sra), np.cos(sdec) * np.sin(sra), np.sin(sdec)],
                   axis=-1)
    cat = Catalog(pos=pos, mag=rng.integers(300, 900, n_stars).astype(np.int32),
                  hue=rng.uniform(0, 1, n_stars), sat=rng.uniform(0, 1, n_stars))
    return cat, (cdec, cra)


def synthetic_grid(cat: Catalog, dtype: torch.dtype, device):
    """The prototype's grid of ``cat``: cells of 0.02 rad, build radius
    7.5 mrad, K0 = 8."""
    return build_star_grid_compact(cat, cell_size=0.02, radius=0.0075, k0=8).to_grid(
        device, dtype=dtype)


def synthetic_rays(rng: np.random.Generator, n_tiles: int) -> np.ndarray:
    """The prototype's ray directions (n_tiles·T, 3) float64: per tile a
    centre with jitter, 5% strays anywhere in the field."""
    t = window.T
    n = n_tiles * t
    centers_dec = rng.uniform(-0.45, 0.45, n_tiles)
    centers_ra = rng.uniform(1.0, 5.0, n_tiles)
    d = np.repeat(centers_dec, t) + rng.normal(0, 0.02, n)
    r = np.repeat(centers_ra, t) + rng.normal(0, 0.04, n)
    out = rng.uniform(size=n) < 0.05
    d = np.where(out, rng.uniform(-0.7, 0.7, n), d)
    r = np.where(out, rng.uniform(0.6, 5.4, n), r)
    return np.stack([np.cos(d) * np.cos(r), np.cos(d) * np.sin(r), np.sin(d)], axis=-1)


def synthetic_case(n_tiles: int, dtype: torch.dtype, device):
    """The prototype's grid and rays: ``(grid, v (N, 3), esc (N,))`` with
    N = n_tiles·T, every ray escaped. One generator draws the catalogue,
    then the rays, in the prototype's order."""
    rng = np.random.default_rng(7)
    cat, _ = synthetic_catalog(rng)
    grid = synthetic_grid(cat, dtype, device)
    v = torch.from_numpy(synthetic_rays(rng, n_tiles)).to(device, dtype)
    return grid, v, torch.ones((v.shape[0],), dtype=torch.bool, device=device)


def counts() -> dict:
    """The launch counts of K1 and K2 and the call counts of their plain
    versions."""
    return {"k1 launches": window_cuda.k1_cuda.launches,
            "k2 launches": window_cuda.k2_cuda.launches,
            "k1 plain calls": window.k1_reference.calls,
            "k2 plain calls": window.k2_reference.calls}


def f32_gate(what: str, got: torch.Tensor, want: torch.Tensor):
    """B3's float32 gate: mean |d| ≤ 1e-6 and max |d| ≤ 3e-2. Returns
    ``(max, mean)``."""
    d = (got - want).abs()
    mx, mean = (d.max().item(), d.mean().item()) if d.numel() else (0.0, 0.0)
    print(f"  {what}: max |d| {mx:.3e}, mean |d| {mean:.3e}")
    if mean > 1e-6 or mx > 3e-2:
        raise AssertionError(f"{what}: colours differ (mean {mean:.3g} > 1e-6 or "
                             f"max {mx:.3g} > 3e-2)")
    return mx, mean


def compare_passes(ker: window.StageOutputs, ref: window.StageOutputs, dtype: torch.dtype):
    """Hold the kernels' stage outputs to the plain passes' (one pre-pass):
    pointers, window starts and masks equal, colours within 1e-9 (float64)
    or B3's float32 gate. Returns ``(max, mean)`` of the colour error."""
    for name in ("optr", "s2", "covered", "ovf_missed"):
        if not torch.equal(getattr(ker, name), getattr(ref, name)):
            raise AssertionError(f"K1 + K2 vs the plain passes: {name} differs")
    if dtype == torch.float64:
        d = (ker.rgb - ref.rgb).abs()
        print(f"  K1 + K2 vs plain passes: max |d| {d.max().item():.3e}")
        torch.testing.assert_close(ker.rgb, ref.rgb, rtol=0, atol=1e-9)
        return d.max().item(), d.mean().item()
    return f32_gate("K1 + K2 vs plain passes", ker.rgb, ref.rgb)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (kernels, f32) or cpu (plain, f64)")
    ap.add_argument("--tiles", type=int, default=507,
                    help="tiles of 4096 rays on the card (507 = 1080p)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("proto_window_kernel: no CUDA device (use --device cpu)")
    dtype = torch.float32 if on_card else torch.float64
    n_tiles = args.tiles if on_card else 4

    grid, v, esc = synthetic_case(n_tiles, dtype, device)
    print(f"grid {grid.n_rings}x{grid.n_cols} pad_k={grid.pad_k} stars={grid.n_stars} "
          f"ovf_rows={grid.ovf_data.shape[0]} "
          f"ovf_octets_max={int(grid.ovf_octets.max())}")

    before = counts()
    rgb, covered, missed = window.window_stage(v, esc, grid, INTENSITY, SATURATION)
    path = {k: n - before[k] for k, n in counts().items()}
    print(f"stage run: {path}")
    if on_card and (min(path["k1 launches"], path["k2 launches"]) < 1
                    or max(path["k1 plain calls"], path["k2 plain calls"]) != 0):
        raise AssertionError("the stage did not go through K1 and K2 alone")

    shading = (torch.tensor(INTENSITY, dtype=dtype, device=device),
               torch.tensor(SATURATION, dtype=dtype, device=device))
    ref = star_lookup_cuda(grid, v, *shading, esc)
    m = covered & ~missed
    err = (rgb[m] - ref[m]).abs().max().item() if bool(m.any()) else 0.0
    print(f"covered {covered.double().mean().item():.4f}  "
          f"ovf_missed {missed.double().mean().item():.4f}  "
          f"max|err| (covered & not missed): {err:.3e}")
    result = {"path": path, "covered": covered.double().mean().item(),
              "ovf_missed": missed.double().mean().item(), "lookup_err": err}
    if not on_card:
        if not err < 1e-9:
            raise AssertionError("windowed K1 + K2 does not match the per-ray lookup")
        print("SEMANTICS OK")
        return result

    f32_gate("stage vs B3 (covered, not missed)", rgb[m], ref[m])
    inp = window.stage_inputs(v, esc, grid)
    ker = window.run_passes(inp, grid, INTENSITY, SATURATION, window_cuda.k1_cuda,
                            window_cuda.k2_cuda)
    plain = window.run_passes(inp, grid, INTENSITY, SATURATION, window.k1_reference,
                              window.k2_reference)
    result["max_abs_err"], _ = compare_passes(ker, plain, dtype)

    consts = grid.psf_constants(dtype)
    tbl3 = grid.cell_data.reshape(grid.n_rings, grid.n_cols, -1)
    ovf_tbl, octets, _ = window.overflow_tables(grid)
    shade = ker.rgb.new_tensor([INTENSITY, SATURATION]).tolist()
    k1_args = (inp.starts, inp.widx, inp.covered, inp.rx, inp.ry, inp.rz, tbl3, consts, *shade)
    k2_args = (ker.s2, ker.optr, inp.covered, inp.rx, inp.ry, inp.rz, ovf_tbl, octets, consts,
               *shade)
    times = {
        "stage_ms": cuda_ms(lambda: window.window_stage(v, esc, grid, INTENSITY, SATURATION), REPS),
        "k1_ms": cuda_ms(lambda: window_cuda.k1_cuda(*k1_args), REPS),
        "k2_ms": cuda_ms(lambda: window_cuda.k2_cuda(*k2_args), REPS),
        "b3_ms": cuda_ms(lambda: star_lookup_cuda(grid, v, *shading, esc), REPS),
    }
    result.update(times)
    n = v.shape[0]
    dt = times["stage_ms"] * 1e-3
    print(f"K1+K2 windowed stage: {times['stage_ms']:.3f} ms / {n_tiles} tiles "
          f"({n / dt / 1e6:.1f} Mrays/s; {dt * 1e9 / n:.2f} ns/ray); K1 {times['k1_ms']:.3f} ms, "
          f"K2 {times['k2_ms']:.3f} ms; B3 on the same rays {times['b3_ms']:.3f} ms  "
          f"[{torch.cuda.get_device_name(device)}]")
    return result


if __name__ == "__main__":
    main()
