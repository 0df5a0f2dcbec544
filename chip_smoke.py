#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``blackstar_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which passes or raises (nothing is caught, so a failing
phase exits non-zero):

1. the card: CUDA must be available; print versions and the card's name
   and power limit;
2. build both kernels from the sources in the checkout;
3. the march kernel B1 against the plain march on the card, default scene
   at 480×270, in float64 and float32;
4. the star kernel B3 against the plain lookup on the card, the full
   470k-star grid and the escaped rays of the 1920×1080 default frame, in
   float64 and float32;
5. the slice: the render CLI on ``scenes/default.yaml`` at 1920×1080 in
   float32 with stars and bloom; both kernels must carry it (launch counts
   > 0, plain call counts 0) with no truncated ray; then warm per-frame
   times of the render, each kernel and each plain version at the frame's
   shapes, with each kernel held to its plain version there too;
6. a float64 64×36 render through the kernels against the committed
   float64-oracle golden at 1e-7.

The last two lines of stdout are a JSON line of per-kernel results and
``{"ok": true, "device": {...}}``. Per kernel, ``ms`` is the wrapper's time
per call as the render calls it (CUDA events), ``kernel_ms`` the kernel's
own device time (torch.profiler), and ``plain_ms`` the plain version's wall
time per call, all at the 1080p frame's shapes.
"""

import contextlib
import dataclasses
import glob
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def _banner(text):
    print(f"\n== {text}", flush=True)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _scene(width, height, dtype, **overrides):
    from blackstar_tpu_torch.config import Config, load_config

    cfg = load_config(os.path.join(ROOT, "scenes", "default.yaml"))
    scene = dataclasses.replace(cfg.scene, resolution=(width, height), dtype=dtype,
                                **overrides)
    return Config(scene=scene, camera=cfg.camera)


def _cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` warm calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps):
    """Mean wall milliseconds of ``fn()`` (ending in a synchronise) over
    ``reps`` warm calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _kernel_ms(fn, kernel_name, reps):
    """Device milliseconds per call of the CUDA kernel whose name contains
    ``kernel_name``, from torch.profiler over ``reps`` warm calls of ``fn``
    (the kernel alone, without its wrapper's host work)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages() if kernel_name in e.key)
    if total <= 0:
        raise AssertionError(f"the profiler saw no device time for {kernel_name}")
    return total / reps / 1e3


def _check_march(ker, ref, dtype):
    """Hold B1's result to the plain march's; returns (max RGBA error,
    status mismatch fraction)."""
    from blackstar_tpu_torch.geodesic import ESCAPED

    mismatch = ker.status != ref.status
    frac = mismatch.float().mean().item()
    ok = ~mismatch
    rgba_err = (ker.acc_rgba[ok] - ref.acc_rgba[ok]).abs().max().item()
    vel_err = (ker.vel[ok] - ref.vel[ok]).abs().max().item()
    print(f"  {dtype}: {ref.status.numel()} rays, steps kernel {int(ker.steps)} / plain "
          f"{int(ref.steps)}, status mismatches {int(mismatch.sum())} ({frac:.3g}), "
          f"max |dRGBA| {rgba_err:.3g}, max |dvel| {vel_err:.3g}")
    if int(ker.steps) != int(ref.steps):
        raise AssertionError(f"step counts differ: {int(ker.steps)} vs {int(ref.steps)}")
    if dtype == "float64":
        if frac > 1e-4:
            raise AssertionError(f"float64 status mismatch {frac:.3g} > 1e-4")
        torch.testing.assert_close(ker.acc_rgba[ok], ref.acc_rgba[ok], rtol=0, atol=1e-7)
        torch.testing.assert_close(ker.vel[ok], ref.vel[ok], rtol=0, atol=1e-7)
    else:  # the JAX package's Pallas-vs-XLA gate (tests/test_march_pallas.py)
        if frac >= 0.02:
            raise AssertionError(f"float32 status mismatch {frac:.3g} >= 0.02")
        torch.testing.assert_close(ker.acc_rgba[ok], ref.acc_rgba[ok], rtol=2e-4, atol=2e-4)
        esc = ok & (ref.status == ESCAPED)
        kd = torch.nn.functional.normalize(ker.vel[esc].double(), dim=-1)
        rd = torch.nn.functional.normalize(ref.vel[esc].double(), dim=-1)
        dir_err = (kd - rd).norm(dim=-1).max().item() if esc.any() else 0.0
        print(f"  float32 max escape-direction error {dir_err:.3g}")
        if dir_err >= 2e-4:
            raise AssertionError(f"escape directions differ by {dir_err:.3g} >= 2e-4")
    return rgba_err, frac


def _check_stars(ker, ref, dtype):
    """Hold B3's colours to the plain lookup's; returns the max error."""
    diff = (ker - ref).abs()
    max_err, mean_err = diff.max().item(), diff.mean().item()
    lit = (ref.amax(dim=-1) > 0).sum().item()
    print(f"  {dtype}: {ref.shape[0]} rays ({lit} lit by stars), max |d| {max_err:.3g}, "
          f"mean |d| {mean_err:.3g}")
    if lit == 0:
        raise AssertionError("no ray picked up a star")
    if dtype == "float64":
        torch.testing.assert_close(ker, ref, rtol=0, atol=1e-9)
    elif mean_err > 1e-6 or max_err > 3e-2:
        raise AssertionError(f"float32 star colours differ: mean {mean_err:.3g} (limit 1e-6), "
                             f"max {max_err:.3g} (limit 3e-2)")
    return max_err


def main():
    # ---- 1. the card --------------------------------------------------
    _banner("1. card")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; "
                           "this script runs only on a CUDA card")
    os.chdir(ROOT)
    from blackstar_tpu_torch import geodesic
    from blackstar_tpu_torch.camera import generate_ray_components
    from blackstar_tpu_torch.cli import render as cli_render
    from blackstar_tpu_torch.geodesic import ESCAPED
    from blackstar_tpu_torch.imageio import read_png
    from blackstar_tpu_torch.ops import march_cuda as b1
    from blackstar_tpu_torch.ops.filters import bloom
    from blackstar_tpu_torch.render import render, render_image, safe_distance
    from blackstar_tpu_torch.stars import lookup_cuda as b3
    from blackstar_tpu_torch.stars.artifact import ensure_star_grid
    from blackstar_tpu_torch.stars.grid import StarGrid, load_star_grid_compact

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = _card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(card)

    # ---- 2. build ------------------------------------------------------
    _banner("2. build")
    for name, mod in (("B1 march", b1), ("B3 star lookup", b3)):
        t0 = time.perf_counter()
        mod.build()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s")

    # ---- 3. B1 against the plain march, 480×270 ------------------------
    _banner("3. B1 march kernel vs plain march, default scene 480x270")
    for dtype in ("float64", "float32"):
        cfg = _scene(480, 270, dtype)
        params, static = cfg.params(dev), cfg.static()
        dt = static.tdtype
        pos0, planes = generate_ray_components(params.camera, 480, 270, dtype=dt)
        safe = safe_distance(params, dt)
        ker = b1.march_cuda(pos0, planes, params, static, safe)
        ref = geodesic.march(pos0, torch.stack(planes, dim=-1), params, static, safe)
        torch.cuda.synchronize()
        _check_march(ker, ref, dtype)

    # ---- 4. B3 against the plain lookup, full grid, 1080p escapes ------
    _banner("4. B3 star kernel vs plain lookup, 470k-star grid, 1920x1080 escaped rays")
    t0 = time.perf_counter()
    grid_path = ensure_star_grid()
    if grid_path is None:
        raise RuntimeError("stars.ppm is missing: cannot build the star grid")
    compact = load_star_grid_compact(grid_path)
    print(f"  grid {grid_path}: {compact.n_stars} stars, {compact.n_cells} cells "
          f"(ready in {time.perf_counter() - t0:.1f} s)")
    if compact.n_stars != 470000:
        raise AssertionError(f"expected the 470k-star grid, got {compact.n_stars} stars")
    grid32 = None
    for dtype in ("float64", "float32"):
        cfg = _scene(1920, 1080, dtype)
        params, static = cfg.params(dev), cfg.static()
        dt = static.tdtype
        t0 = time.perf_counter()
        grid = compact.to_grid(dev, dtype=dt)
        print(f"  {dtype} tables: {grid.nbytes() / 2**20:.0f} MiB on the card "
              f"({time.perf_counter() - t0:.1f} s)")
        pos0, planes = generate_ray_components(params.camera, 1920, 1080, dtype=dt)
        res = b1.march_cuda(pos0, planes, params, static, safe_distance(params, dt))
        vel = res.vel[res.status == ESCAPED]
        inten, sat = params.stars.intensity, params.stars.saturation
        ker = b3.star_lookup_cuda(grid, vel, inten, sat)
        ref = grid.lookup(vel, inten, sat)
        torch.cuda.synchronize()
        _check_stars(ker, ref, dtype)
        if dtype == "float32":
            grid32 = grid
        del grid, res, vel, ker, ref
        torch.cuda.empty_cache()

    # ---- 5. the slice through the CLI ----------------------------------
    _banner("5. slice: render CLI, scenes/default.yaml 1920x1080 float32")
    b1.march_cuda.launches = 0
    b3.star_lookup_cuda.launches = 0
    geodesic.march.calls = 0
    StarGrid.lookup.calls = 0
    out_dir = os.path.join(ROOT, "build", "chip_smoke")  # gitignored
    os.makedirs(out_dir, exist_ok=True)
    try:
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli_render.main([os.path.join("scenes", "default.yaml"), "-o", out_dir,
                                  "--force", "--stats"])
        cli_s = time.perf_counter() - t0
        launches = {"b1": b1.march_cuda.launches, "b3": b3.star_lookup_cuda.launches}
        plain_calls = {"march": geodesic.march.calls, "lookup": StarGrid.lookup.calls}
        print("  | " + log.getvalue().strip().replace("\n", "\n  | "))
        print(f"  CLI run {cli_s:.1f} s (cold: includes loading the star tables), rc {rc}, "
              f"kernel launches {launches}, plain calls {plain_calls}")
        if rc != 0:
            raise AssertionError(f"render CLI returned {rc}")
        if min(launches.values()) < 1 or max(plain_calls.values()) != 0:
            raise AssertionError("the render did not go through both kernels alone")
        m = re.search(r"truncated=(\S+)", log.getvalue())
        if m is None or float(m.group(1)) != 0.0:
            raise AssertionError(f"truncated rays in the render: {m and m.group(1)}")
        png = os.path.join(out_dir, "default.png")
        if not os.path.exists(png) or os.path.getsize(png) == 0:
            raise AssertionError(f"{png} missing or empty")
        rgb8 = read_png(png)
        if rgb8.shape != (1080, 1920, 3) or rgb8.max() == 0:
            raise AssertionError(f"PNG is {rgb8.shape}, max {rgb8.max()}")
        print(f"  {png}: {os.path.getsize(png)} bytes, {rgb8.shape}, "
              f"mean {rgb8.mean():.2f}, non-black pixels {(rgb8.max(axis=-1) > 0).mean():.3f}")
    finally:
        shutil.rmtree(out_dir)

    cfg = _scene(1920, 1080, "float32")
    params, static = cfg.params(dev), cfg.static()
    dt = static.tdtype
    img = render_image(cfg, grid32, device=dev)
    if not np.isfinite(img).all() or img.max() <= 0:
        raise AssertionError("the rendered 1080p image is not finite or is all black")
    frame_ms = _host_ms(lambda: render_image(cfg, grid32, device=dev), 5)

    pos0, planes = generate_ray_components(params.camera, 1920, 1080, dtype=dt)
    stacked = torch.stack(planes, dim=-1)
    safe = safe_distance(params, dt)
    ker = b1.march_cuda(pos0, planes, params, static, safe)
    ref = geodesic.march(pos0, stacked, params, static, safe)
    torch.cuda.synchronize()
    print("  B1 at the frame's shape:")
    b1_err, _ = _check_march(ker, ref, "float32")
    b1_ms = _cuda_ms(lambda: b1.march_cuda(pos0, planes, params, static, safe), 10)
    b1_kernel_ms = _kernel_ms(lambda: b1.march_cuda(pos0, planes, params, static, safe),
                              "march_kernel", 10)
    march_ms = _host_ms(lambda: geodesic.march(pos0, stacked, params, static, safe), 2)

    escaped = ker.status == ESCAPED
    inten, sat = params.stars.intensity, params.stars.saturation
    s_ker = b3.star_lookup_cuda(grid32, ker.vel, inten, sat, escaped)
    s_ref = grid32.lookup(ker.vel, inten, sat, escaped)
    torch.cuda.synchronize()
    print("  B3 at the frame's shape (all rays, escaped mask):")
    b3_err = _check_stars(s_ker, s_ref, "float32")
    b3_ms = _cuda_ms(lambda: b3.star_lookup_cuda(grid32, ker.vel, inten, sat, escaped), 10)
    b3_kernel_ms = _kernel_ms(lambda: b3.star_lookup_cuda(grid32, ker.vel, inten, sat, escaped),
                              "star_lookup_kernel", 10)
    lookup_ms = _host_ms(lambda: grid32.lookup(ker.vel, inten, sat, escaped), 2)

    def plain_frame():
        """The same frame through the plain march and plain lookup."""
        p0, pl = generate_ray_components(params.camera, 1920, 1080, dtype=dt)
        res = geodesic.march(p0, torch.stack(pl, dim=-1), params, static,
                             safe_distance(params, dt))
        esc = res.status == ESCAPED
        star = grid32.lookup(res.vel, inten, sat, esc)
        rgb = res.acc_rgba[:, :3] + torch.where(esc[:, None], star, 0.0) * (1.0 - res.acc_rgba[:, 3:4])
        out = bloom(rgb.reshape(1080, 1920, 3), params.bloom_strength, static.bloom_divider)
        return out.cpu().numpy()

    plain_img = plain_frame()
    frame_err = float(np.abs(plain_img - img).max())
    plain_frame_ms = _host_ms(plain_frame, 2)
    print(f"  frame: kernel path vs plain path max |d| {frame_err:.3g}")
    for what, ms, plain in (("render_image 1920x1080 f32 (march+stars+bloom+copy)", frame_ms, plain_frame_ms),
                            ("B1 march wrapper", b1_ms, march_ms),
                            ("B3 star wrapper", b3_ms, lookup_ms)):
        print(f"  {what}: {ms:.3f} ms, plain {plain:.3f} ms  [{card}]")
    print(f"  device time of the kernels alone: B1 {b1_kernel_ms:.3f} ms, "
          f"B3 {b3_kernel_ms:.3f} ms  [{card}]")

    # ---- 6. float64 golden through the kernels -------------------------
    _banner("6. float64 64x36 render through the kernels vs the oracle golden")
    goldens = glob.glob(os.path.join(ROOT, "tests", "golden_cache", "default_64_*.npy"))
    if len(goldens) != 1:
        raise AssertionError(f"expected one default_64 golden, found {goldens}")
    cfg = _scene(64, 36, "float64", bloom_strength=0.0)
    before = b1.march_cuda.launches
    img, stats = render(cfg.params(dev), cfg.static(), None, with_stats=True)
    if b1.march_cuda.launches != before + 1:
        raise AssertionError("the golden render did not launch the march kernel")
    if float(stats.truncated_frac) != 0.0:
        raise AssertionError("the golden render truncated rays")
    want = torch.from_numpy(np.load(goldens[0])).to(dev)
    gold_err = (img - want).abs().max().item()
    print(f"  max |d| vs {os.path.relpath(goldens[0], ROOT)}: {gold_err:.3g} (limit 1e-7)")
    torch.testing.assert_close(img, want, rtol=0, atol=1e-7)

    # ---- results -------------------------------------------------------
    kernels = [
        {"name": "march (B1)", "route": "cuda",
         "source": "blackstar_tpu_torch/ops/csrc/march.cu",
         "replaces": "blackstar_tpu/ops/march_pallas.py:104",
         "launches": launches["b1"], "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": march_ms,
         "kernel_ms": b1_kernel_ms},
        {"name": "star lookup (B3)", "route": "cuda",
         "source": "blackstar_tpu_torch/stars/csrc/star_lookup.cu",
         "replaces": "blackstar_tpu/stars/grid.py:717",
         "launches": launches["b3"], "max_abs_err": b3_err, "ms": b3_ms, "plain_ms": lookup_ms,
         "kernel_ms": b3_kernel_ms},
    ]
    print()
    print(_card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
