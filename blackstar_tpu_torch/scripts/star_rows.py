"""Rows per warp load of the star kernels B3 and B4, and their times, on the
1920×1080 default frame's escaped rays against the 470k-star grid, in
float32.

Run on a CUDA card from the checkout's root::

    python -m blackstar_tpu_torch.scripts.star_rows [--source PATH ...]

It prints, for several ways of giving rays to a warp's 32 lanes (32
consecutive pixels of an image row, 8×4 and 16×2 pixel tiles) and to a
block's 128 threads, how many distinct base rows and distinct overflow rows
of the grid one load of all the lanes touches (``k``), from the cell ids of
``StarGrid.cell_ids`` on the card; then B3's and B4's registers (``ptxas
-v``), their kernel times (torch.profiler) and wrapper times (CUDA events)
as the main path calls them (all times in ms), and the frame's
``render_image``: its wall time (median and least of 60 calls), its device
busy time and its copies to the host (torch.profiler). With
``--source``, B3 and B4 are built from each given source in turn (A, B,
..., B, A), each of which must take the checkout's wrapper's arguments.

The script calls only the port's public API (``render_image``,
``star_lookup_cuda``, ``star_lookup_vjp_cuda``, the grid loader), so a copy
of it in another checkout of the port measures that checkout with the same
yardstick: run two commits in turns to compare them.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import os
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WIDTH, HEIGHT = 1920, 1080
# Groups of rays whose rows one load touches: warps of 32 lanes and blocks
# of 128 threads, as pixel tiles (width, height).
WARP_TILES = {"32 consecutive pixels": (32, 1), "8x4 tiles": (8, 4), "16x2 tiles": (16, 2)}
BLOCK_TILES = {"128 consecutive pixels": (128, 1), "32x4 tiles": (32, 4), "16x8 tiles": (16, 8)}


def tile_groups(width: int, height: int, tile) -> torch.Tensor:
    """(groups, tw·th) ray indices of the ``tile`` = (tw, th) pixel tiles of
    a row-major ``width``×``height`` image, tiles in row-major order, lanes
    row-major in their tile; -1 where a tile overhangs the image."""
    tw, th = tile
    tiles_x, tiles_y = -(-width // tw), -(-height // th)
    t = torch.arange(tiles_x * tiles_y)[:, None]
    lane = torch.arange(tw * th)
    x = (t % tiles_x) * tw + lane % tw
    y = (t // tiles_x) * th + lane // tw
    return torch.where((x < width) & (y < height), y * width + x, -1)


def rounds(groups: torch.Tensor, lanes_per_ray: int) -> torch.Tensor:
    """The rays a warp takes together when ``lanes_per_ray`` lanes walk one
    ray's row: lane group g takes the warp's rays g·G .. g·G + G − 1, one a
    round, so round t holds rays t, G + t, 2G + t, ..."""
    g = lanes_per_ray
    return groups.view(groups.shape[0], 32 // g, g).transpose(1, 2).reshape(-1, 32 // g)


def distinct_rows(rows: torch.Tensor, groups: torch.Tensor) -> dict:
    """Distinct non-negative entries of ``rows`` (one a ray, −1 for none)
    per group of ``groups``: their mean, 90th percentile and maximum over
    the groups that hold at least one, the share of groups that do, and the
    mean count of rays with a row per such group."""
    groups = groups.to(rows.device)
    ids = torch.where(groups >= 0, rows[groups.clamp_min(0)], -1)
    s = ids.sort(dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    k = ((s >= 0) & first).sum(dim=1)
    live = k > 0
    kd = k[live].double()
    if not kd.numel():
        return {"k_mean": 0.0, "k_p90": 0.0, "k_max": 0, "share": 0.0, "rays": 0.0}
    return {"k_mean": kd.mean().item(), "k_p90": torch.quantile(kd, 0.9).item(),
            "k_max": int(k.max()), "share": live.double().mean().item(),
            "rays": (s >= 0).sum(dim=1)[live].double().mean().item()}


def frame_rows(grid, vel: torch.Tensor, escaped: torch.Tensor):
    """Per ray: its cell's base row (−1 if not escaped), its overflow row
    (−1 if none), and its used overflow octets."""
    n = torch.nn.functional.normalize(vel, dim=-1)
    cells = grid.cell_ids(n[:, 0], n[:, 1], n[:, 2])
    ptr = grid.cell_data[cells, 7].long()
    base = torch.where(escaped, cells, -1)
    ovf = torch.where(escaped & (ptr > 0), ptr, -1)
    octets = torch.where(ovf > 0, grid.ovf_octets.long()[ptr], 0)
    return base, ovf, octets


def print_rows(grid, vel, escaped, width=WIDTH, height=HEIGHT) -> dict:
    """Print and return the distinct rows per load of each grouping."""
    base, ovf, octets = frame_rows(grid, vel, escaped)
    n_esc = int(escaped.sum())
    n_rows = torch.unique(base[base >= 0]).numel()
    print(f"  {n_esc} escaped rays over {n_rows} distinct base rows ({n_esc / n_rows:.2f} rays "
          f"a row); {int((ovf > 0).sum())} rays with an overflow row over "
          f"{torch.unique(ovf[ovf > 0]).numel()} distinct ones, mean used octets "
          f"{octets[ovf > 0].double().mean().item():.2f}")
    out = {}
    cases = [(f"warp, {name}", tile_groups(width, height, t)) for name, t in WARP_TILES.items()]
    for lanes in (8, 4):
        for name in ("32 consecutive pixels", "8x4 tiles"):
            warps = tile_groups(width, height, WARP_TILES[name])
            cases.append((f"round of {lanes}-lane groups, {name}", rounds(warps, lanes)))
    cases += [(f"block, {name}", tile_groups(width, height, t)) for name, t in BLOCK_TILES.items()]
    for name, groups in cases:
        b, o = distinct_rows(base, groups), distinct_rows(ovf, groups)
        print(f"  {name:44s} base rows k mean {b['k_mean']:.2f} (p90 {b['k_p90']:.0f}, max "
              f"{b['k_max']}, {b['rays']:.1f} rays); overflow rows k mean {o['k_mean']:.2f} "
              f"(p90 {o['k_p90']:.0f}, max {o['k_max']}, in {o['share']:.3f} of the groups)")
        out[name] = {"base": b, "overflow": o}
    return out


def frame(dev):
    """The 1080p f32 default scene, the 470k grid on ``dev``, and B1's
    escape directions and mask for the frame."""
    from blackstar_tpu_torch.camera import generate_ray_components
    from blackstar_tpu_torch.config import Config, load_config
    from blackstar_tpu_torch.geodesic import ESCAPED
    from blackstar_tpu_torch.ops.march_cuda import march_cuda
    from blackstar_tpu_torch.render import safe_distance
    from blackstar_tpu_torch.stars.artifact import ensure_star_grid
    from blackstar_tpu_torch.stars.grid import load_star_grid_compact

    base = load_config(os.path.join(ROOT, "scenes", "default.yaml"))
    cfg = Config(scene=dataclasses.replace(base.scene, resolution=(WIDTH, HEIGHT),
                                           dtype="float32"), camera=base.camera)
    params, static = cfg.params(dev), cfg.static()
    grid = load_star_grid_compact(ensure_star_grid()).to_grid(dev, dtype=torch.float32)
    pos0, planes = generate_ray_components(params.camera, WIDTH, HEIGHT, dtype=torch.float32)
    res = march_cuda(pos0, planes, params, static, safe_distance(params, torch.float32))
    return cfg, params, grid, res.vel, res.status == ESCAPED


def kernel_ms(fn, name: str, reps: int = 10) -> float:
    """Device ms per launch of the kernel whose name holds ``name``, from
    torch.profiler over ``reps`` calls of ``fn`` (taken again, up to three
    times, while the profiler drops launches; averaged over those kept)."""
    from blackstar_tpu_torch.scripts import step_profile

    for _ in range(3):
        prof = step_profile.profile_steps(fn, reps)
        hits = [v for k, v in prof["by_kernel"].items() if name in k]
        kept = sum(n for _, n in hits)
        if kept == reps:
            break
    if not kept:
        raise RuntimeError(f"the profiler saw no launch of {name}")
    return sum(ms for ms, _ in hits) * reps / kept


def frame_times(cfg, grid, dev, reps: int = 60) -> dict:
    """``render_image``'s wall ms (host clock, each call ending in its copy
    to the host): median and least over ``reps`` warm calls; and from
    torch.profiler over 5 calls, the device busy ms a frame and the copies
    to the host a frame (count and ms)."""
    from blackstar_tpu_torch.render import render_image
    from blackstar_tpu_torch.scripts import step_profile

    if not np.isfinite(render_image(cfg, grid, device=dev)).all():
        raise AssertionError("the 1080p frame is not finite")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        render_image(cfg, grid, device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = step_profile.profile_steps(lambda: render_image(cfg, grid, device=dev), 5)
    copies = [v for k, v in prof["by_kernel"].items() if "DtoH" in k]
    return {"render_image median": float(np.median(times)), "render_image least": min(times),
            "frame busy": prof["busy_ms"],
            "copies to host a frame": sum(n for _, n in copies) / 5,
            "their ms": sum(ms for ms, _ in copies)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="a B3/B4 source to time in turns with the others (repeatable)")
    ap.add_argument("--no-rows", action="store_true", help="skip the rows-per-load readings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("star_rows: needs a CUDA card")

    from blackstar_tpu_torch.scripts import cuda_ms, kernel_sass
    from blackstar_tpu_torch.stars import lookup_cuda as b3

    dev = torch.device("cuda:0")
    os.chdir(ROOT)
    cfg, params, grid, vel, escaped = frame(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if not args.no_rows:
        print("distinct rows per load, 1920x1080 default frame, 470k grid:")
        print_rows(grid, vel, escaped)

    inten, sat = params.stars.intensity, params.stars.saturation
    w = torch.from_numpy(np.random.default_rng(8).normal(size=(vel.shape[0], 3))).to(
        dev, torch.float32)
    # The width hint where the checkout's wrappers take it (an older
    # checkout's do not).
    hint = {"width": WIDTH} if "width" in inspect.signature(b3.star_lookup_cuda).parameters else {}

    def b3_call():
        return b3.star_lookup_cuda(grid, vel, inten, sat, escaped, **hint)

    def b4_call():
        return b3.star_lookup_vjp_cuda(grid, vel, inten, sat, escaped, w, **hint)

    sources = [os.path.abspath(s) for s in args.source] or [b3.SOURCE]
    for src in sources + sources[::-1]:
        b3.SOURCE = src
        b3.build.cache_clear()
        b3.build()
        res = {"b3_kernel": kernel_ms(b3_call, "star_lookup_kernel"),
               "b3_wrapper": cuda_ms(b3_call, 10),
               "b4_kernel": kernel_ms(b4_call, "star_vjp_kernel"),
               "b4_wrapper": cuda_ms(b4_call, 10)}
        if len(sources) == 1:
            res.update(frame_times(cfg, grid, dev))
        print(f"  {os.path.relpath(src, ROOT)}: " + ", ".join(f"{k} {v:.4f}"
                                                           for k, v in res.items()))
    for src in sources:
        report, _ = kernel_sass.compile_cubin(src, b3.FLAGS)
        for name, line in kernel_sass.resources(report).items():
            print(f"  ptxas -v {os.path.relpath(src, ROOT)}: {name}: {line}")


if __name__ == "__main__":
    main()
