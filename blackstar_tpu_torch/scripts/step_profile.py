"""Where a training step's device time goes: ``scenes/default.yaml`` at
1920×1080 in float32 with the 470k-star sky, every parameter leaf
trainable, fitted to a target rendered with ``diskOuter`` 12.5 (before
bloom), as ``chip_smoke.py`` phase 10 takes it.

Run on a CUDA card from the checkout's root::

    python -m blackstar_tpu_torch.scripts.step_profile [--steps N]

It prints the card, the warm step's wall time (host clock after a
synchronise, unprofiled), the peak allocated memory, and from
torch.profiler over N warm steps each kernel's device time per step and
its launches. Device busy counts kernels and copies, not the GPU ranges of
user annotations (``Optimizer.step``), which overlap them. The last line is
one JSON object of these numbers.

The script calls only the training API (``fit.init_train_state``,
``fit.make_train_step``, ``render.render``) and the star-grid loader, so a
copy of it in another checkout of the port measures that checkout with the
same yardstick: run two commits in turns to compare them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The port's kernels on the training path, by a part of their device name.
KERNELS = {"B1": "march_kernel", "B2": "march_adjoint_kernel", "B3": "star_lookup_kernel",
           "B4": "star_vjp_kernel"}


def profile_steps(step, steps: int) -> dict:
    """Device time of ``steps`` warm calls of ``step()`` under torch.profiler:
    per kernel name its milliseconds per step and its launches in all
    (``by_kernel``), device busy per step, and the wall milliseconds per
    step under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / steps, n + 1)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    return {"by_kernel": by_kernel, "busy_ms": busy_ms, "wall_ms": wall_ms}


def port_kernels(by_kernel: dict) -> dict:
    """B1-B4's milliseconds per step and launches, from ``by_kernel``."""
    out = {}
    for tag, part in KERNELS.items():
        hits = [v for k, v in by_kernel.items() if part in k]
        out[tag] = {"ms": sum(ms for ms, _ in hits), "launches": sum(n for _, n in hits)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="profiled steps (default 4)")
    ap.add_argument("--reps", type=int, default=5, help="unprofiled timed steps (default 5)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA card")

    from blackstar_tpu_torch.config import Config, load_config
    from blackstar_tpu_torch.fit import init_train_state, make_train_step
    from blackstar_tpu_torch.render import render
    from blackstar_tpu_torch.stars.artifact import ensure_star_grid
    from blackstar_tpu_torch.stars.grid import load_star_grid_compact

    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    base = load_config(os.path.join(ROOT, "scenes", "default.yaml"))

    def scene(**overrides):
        return Config(scene=dataclasses.replace(base.scene, resolution=(1920, 1080),
                                                dtype="float32", **overrides),
                      camera=base.camera)

    grid_path = ensure_star_grid()
    if grid_path is None:
        raise SystemExit("step_profile: stars.ppm is missing")
    grid = load_star_grid_compact(grid_path).to_grid(dev, dtype=torch.float32)
    cfg_t = scene(disk_outer=12.5)
    target = render(cfg_t.params(dev), cfg_t.static(), grid)
    cfg = scene()
    static = cfg.static()
    state = init_train_state(cfg.params(dev), 1e-3)  # every leaf trainable
    step_fn = make_train_step(static, grid)

    def step():
        step_fn(state, target)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        step()
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.reps
    torch.cuda.reset_peak_memory_stats(dev)
    step()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    prof = profile_steps(step, args.steps)
    ours = port_kernels(prof["by_kernel"])
    rest_ms = prof["busy_ms"] - sum(k["ms"] for k in ours.values())

    print(card)
    print(f"training step 1920x1080 f32, every leaf trainable: {step_ms:.3f} ms a step over "
          f"{args.reps} (unprofiled), peak allocated {peak_mib:.0f} MiB")
    print(f"profile over {args.steps} steps: device busy {prof['busy_ms']:.3f} ms a step, wall "
          f"{prof['wall_ms']:.3f} ms a step under the profiler; the port's kernels (ms a step, "
          "launches in all):")
    for tag, k in ours.items():
        print(f"  {tag} {KERNELS[tag]}: {k['ms']:.3f} ms, {k['launches']} launches")
    print(f"  the rest: {rest_ms:.3f} ms; the largest kernels:")
    for name, (ms, n) in sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    {ms:9.3f} ms  {n:4d}  {name[:100]}")
    result = {"card": card, "step_ms": step_ms, "peak_mib": peak_mib,
              "busy_ms": prof["busy_ms"], "prof_wall_ms": prof["wall_ms"],
              "steps": args.steps, "kernels": ours, "rest_ms": rest_ms}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
