"""Animation throughput on the card: ``animations/default-ani.yaml`` rendered
by ``video.render_animation`` (keyframe cameras interpolated on the card,
each frame through the march kernel B1 and the star kernel B3 with the
470k-star sky, bloom and the uint8 encode, then the native PNG pool), at
preview size and at full size (1920×1080 supersampled: 3840×2160 rays a
frame).

Run on a CUDA card from the checkout's root::

    python -m blackstar_tpu_torch.scripts.bench_animation [--frames N] [--sizes preview,full]

For each size it prints frames per second twice: with the PNG writes, and
with each frame dropped as soon as its copy to the host is complete
(``video.frames``). When the second is much higher, the run is bound by the
writes, else by the render. Then, from torch.profiler over a few frames of
the second kind: the card's busy time a frame (kernels and copies), the
frame's wall time under the profiler, the card's idle share, the host's
time a frame blocked in ``cudaStreamSynchronize`` (the march wrapper's
read of the scene scalars) and in ``cudaEventSynchronize`` (waiting for a
frame's copy), the largest device operations, and the peak allocated
memory (and what was allocated before the run). The last line is one
JSON object of these numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ANIMATION = os.path.join(ROOT, "animations", "default-ani.yaml")
_HOST_WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize")


def frames_per_second(anim, grid, device, *, preview: bool, out_dir=None) -> float:
    """Frames per second of the whole animation: written as PNGs into
    ``out_dir``, or dropped after their copy when ``out_dir`` is None."""
    from blackstar_tpu_torch.video import frames, render_animation

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if out_dir is None:
        for _ in frames(anim, star_grid=grid, preview=preview, device=device):
            pass
    else:
        render_animation(anim, out_dir, star_grid=grid, preview=preview, device=device)
    return anim.n_frames / (time.perf_counter() - t0)


def profile_frames(anim, grid, device, *, preview: bool, n: int = 5) -> dict:
    """torch.profiler over ``n`` warm frames of ``video.frames`` (dropped
    after their copy): device busy, wall, idle share and host waits, in ms
    a frame, and the device operations by name (ms a frame, launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from blackstar_tpu_torch.video import frames

    it = frames(dataclasses.replace(anim, n_frames=n + 3), star_grid=grid, preview=preview,
                device=device)
    next(it)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    it.close()
    by_op, waits = {}, dict.fromkeys(_HOST_WAITS, 0.0)
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3 / n
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            t, k = by_op.get(e.name, (0.0, 0))
            by_op[e.name] = (t + ms, k + 1)
        elif e.name in waits:
            waits[e.name] += ms
    busy_ms = sum(ms for ms, _ in by_op.values())
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "host_wait_ms": waits, "by_op": by_op}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=375,
                    help="frames of the animation to time (default: all 375)")
    ap.add_argument("--sizes", default="preview,full",
                    help="comma list of sizes to run: preview, full (default: both)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_animation: needs a CUDA card")

    from blackstar_tpu_torch import native
    from blackstar_tpu_torch.animation import load_animation
    from blackstar_tpu_torch.stars.artifact import default_star_grid

    device = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    if not native.available():
        raise SystemExit(f"bench_animation: the native PNG library is unavailable: "
                         f"{native.load_error}")
    anim = dataclasses.replace(load_animation(ANIMATION), n_frames=args.frames)
    grid = default_star_grid(device, torch.float32)
    if grid is None:
        raise SystemExit("bench_animation: stars.ppm is missing")
    out_dir = os.path.join(ROOT, "build", "bench_animation")  # gitignored
    print(card)
    result = {"card": card, "frames": args.frames, "sizes": {}}
    for size in args.sizes.split(","):
        preview = size == "preview"
        warm = dataclasses.replace(anim, n_frames=2)
        frames_per_second(warm, grid, device, preview=preview)
        base_mib = torch.cuda.memory_allocated(device) / 2**20
        torch.cuda.reset_peak_memory_stats(device)
        try:
            fps_write = frames_per_second(anim, grid, device, preview=preview, out_dir=out_dir)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        fps_drop = frames_per_second(anim, grid, device, preview=preview)
        peak_mib = torch.cuda.max_memory_allocated(device) / 2**20
        prof = profile_frames(anim, grid, device, preview=preview)
        bound = "the writes" if fps_drop > 1.2 * fps_write else "the render"
        waits = prof["host_wait_ms"]
        print(f"{size}: {args.frames} frames, {fps_write:.3f} frames/s with the PNG writes, "
              f"{fps_drop:.3f} frames/s with the frames dropped after their copy: bound by "
              f"{bound}; peak allocated {peak_mib:.0f} MiB ({base_mib:.0f} before the run)")
        print(f"  profile over 5 frames: device busy {prof['busy_ms']:.3f} ms a frame, wall "
              f"{prof['wall_ms']:.3f} ms a frame, device idle share {prof['idle_share']:.4f}; "
              f"host blocked in cudaStreamSynchronize {waits['cudaStreamSynchronize']:.3f} ms "
              f"and in cudaEventSynchronize {waits['cudaEventSynchronize']:.3f} ms a frame")
        for name, (ms, n) in sorted(prof["by_op"].items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"    {ms:9.3f} ms  {n:4d}  {name[:100]}")
        result["sizes"][size] = {
            "fps_write": fps_write, "fps_drop": fps_drop, "bound_by": bound,
            "peak_mib": peak_mib, "base_mib": base_mib, "busy_ms": prof["busy_ms"],
            "wall_ms": prof["wall_ms"], "idle_share": prof["idle_share"], "host_wait_ms": waits}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
