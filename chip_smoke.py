#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``blackstar_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py
    python3 chip_smoke.py --probe-parent build/parent/probe_dynamic_gather.cu

(the second also times another build of the gather probe's source, e.g. a
parent commit's, in turns with the package's in phase 13).

Phases, each of which passes or raises (nothing is caught, so a failing
phase exits non-zero):

1. the card: CUDA must be available; print versions and the card's name
   and power limit;
2. build the six kernel sources in the checkout in parallel, with B1's,
   B2's, B3's + B4's and B5's cubins under ``-Xptxas -v`` (registers,
   stack, spills) beside them;
3. the march kernel B1 against the plain march on the card, default scene
   at 480×270: in float64 within 1e-7; in float32 held to the plain float64
   march of the same rays no worse than the plain float32 march is
   (``blackstar_tpu_torch/scripts/march_accuracy.py``: B1 rounds otherwise,
   with ``rsqrt`` powers and fused multiply-adds, so near the photon ring
   its float32 orbits part from the plain float32 march's);
4. the star kernel B3 against the plain lookup on the card, the full
   470k-star grid: the escaped rays of the 1920×1080 default frame; all the
   rays of the 481×271 default frame (a size no 8×4 warp tile divides),
   passed with and without the width hint; and 2^16 seeded random
   directions, one cell a lane (the most distinct rows a warp load can
   touch); each in float64 and float32;
5. the slice: the render CLI on ``scenes/default.yaml`` at 1920×1080 in
   float32 with stars and bloom; B1 and B3 must carry it (launch counts
   > 0, plain call counts 0) and B5 its bloom (1 launch), with no truncated
   ray; then warm per-frame
   times of the render, each kernel and each plain version at the frame's
   shapes, with each kernel held to its plain version there too (B1 by
   phase 3's float32 gate), the
   share of useful lanes in B1's warps from its per-ray step counts, the
   distinct table rows a warp load of B3 touches under several layouts
   (``scripts/star_rows.py``), B3's kernel time on the frame and on the
   band shard phase 17's deal gives rank 0 of two (with and without the
   width hint), and B3's wrapper run under
   ``torch.cuda.set_sync_debug_mode("error")`` (it must not wait for the
   card);
6. a float64 64×36 render through the kernels against the committed
   float64-oracle golden at 1e-7;
7. default scene at 480×270 in float64 and float32: B1's checkpointing
   variant (its outputs equal the frame variant's bit for bit; its
   checkpoints and step counts against the plain checkpointing march's:
   float64 counts equal on all but 1e-4 of the rays and checkpoints within
   1e-7·max(1, |value|), float32 counts off on at most 1e-3 of the rays), and
   the march adjoint kernel B2, fed those checkpoints, with seeded random
   cotangents: its statuses equal B1's bit for bit; in float64 its
   gradients within rtol 1e-9 of the plain adjoint from nothing and from
   the same checkpoints; in float32 held to the plain float64 adjoint of
   the same rays no worse than the plain float32 adjoint is
   (``march_accuracy.adjoint_gate``: statuses, rays whose direction
   gradient misses, and each of the 10 scene partials summed over the rays
   on which both float32 adjoints agree with float64, read over 8 sets of
   cotangents here and 4 in phase 10);
8. the star VJP kernel B4 against the plain star VJP, the full 470k-star
   grid, with seeded random cotangents, on phase 4's three sets of rays,
   in float64 and float32;
9. the training slice: the fit CLI on ``scenes/default.yaml`` at 1920×1080
   in float32 with the 470k-star sky, fitting ``disk.outer`` for 5 Adam
   steps to a target rendered with ``diskOuter`` 12.5; all four kernels
   must carry it (launch counts > 0, plain call counts 0), every loss
   finite, the loss falling and ``disk.outer`` moving toward 12.5;
10. times at the 1080p training shapes: a warm training step with every
   leaf trainable (forward, forward + backward, the whole step), its
   device-time profile (``scripts/step_profile.py``) and peak memory; B1's
   checkpointing variant held to the plain checkpointing march (phase 7's
   float32 gate) and timed against the frame variant in turns, with B1's
   registers and stack; B2 (kernel, wrapper, plain version, with its
   registers, stack and shared memory; held in phase 18) and B4 (the same,
   held to its plain version there, its wrapper run under the sync-debug
   mode as B3's);
11. the windowed star stage's kernels K1 and K2 against their plain
   versions on the prototype's synthetic grid, fed the same pre-pass
   outputs: float64 at 4 tiles (pointers and masks equal, colours within
   1e-9, and the stage within 1e-9 of the plain per-ray lookup on covered,
   not-missed rays) and float32 at 507 tiles (B3's f32 gates); then the
   stage through its entry point ``python -m
   blackstar_tpu_torch.scripts.proto_window_kernel`` (K1 and K2 launched,
   no plain pass called, the stage within B3's gates of B3);
12. the windowed stage on the 1920×1080 default frame's rays (padded with
   non-escaped rays to 507 tiles) and the 470k-star grid in float32: its
   coverage and missed-overflow share, K1 + K2 against the plain passes and
   the stage against B3 on covered, not-missed rays (B3's f32 gates), and
   the times of K1, K2, the stage and B3 on the same rays (K1 and K2 also
   on phase 13's graph clock);
13. the dynamic-gather probe through its entry point ``python -m
   blackstar_tpu_torch.scripts.probe_dynamic_gather``: the row gather, lane
   gather and range copy kernels at every size of the TPU probe, each equal
   bit for bit to its plain version (the row gather also at R 1, 7 and
   2047, on tables of M != R rows and at L 1028), and at every size the
   kernel's, the plain version's, the library call's and an empty kernel's
   (launched with the kernel's grid: the floor) times on the graph clock
   (300 calls captured in one CUDA graph and replayed warm, as the TPU
   probe times 300 calls in one jitted loop), with the wrapper's time a
   host call, the bound and the kernel's share of it beside them; with
   ``--probe-parent`` the other build's kernels too, in turns (A, B, B, A);
14. the animation: ``python -m blackstar_tpu_torch animate
   animations/default-ani.yaml --render -f`` (375 frames at 1920×1080
   supersampled, float32, the 470k-star sky, bloom 0.7); B1, B3 and B5 must
   carry it, each launched once a frame (375 times) with no plain call, the
   native PNG writer pool must write it (the phase fails if the library
   does not build) in more than one band a frame, and frames 0 and 374
   must be within 1 on the uint8 scale of direct renders at the keyframe
   cameras;
15. all nine reference scenes: in float64 through B1 and B3, at 16 px
   with a small star catalogue lit in each scene against
   ``tests/oracle.py`` computed now (one process a scene), and the three
   disk scenes at 64 px against the committed oracle goldens, each within
   1e-7 and with no truncated ray; the render CLI in batch mode on
   ``scenes/`` at full size in float32 with stars, bloom and ``-f`` (the
   native writer pool): nine PNGs, B1 and B3 launched once a scene (9
   times) with no plain call, each scene's truncated share (``--stats``);
   then per scene its warm frame time and its full-size rays through B1's
   float32 gate (phase 3's) and B3's float32 gates;
16. the star build side: ``python -m blackstar_tpu_torch generate-grid
   stars.ppm`` at the production defaults, its ``.npz`` arrays equal to
   those of the grid phase 4 loaded;
17. the sharded slice (``blackstar_tpu_torch.parallel``): (a) ``torchrun
   --nproc-per-node 1 -m blackstar_tpu_torch render scenes/default.yaml
   --sharded`` on one NCCL rank, its PNG equal byte for byte to phase 5's,
   B1 and B3 launched with no plain call; (b) two ranks on the one card
   over gloo (NCCL refuses two ranks on one device), through
   ``scripts/multihost_check.py``: the sharded 1920×1080 and 481×271
   (ragged) float32 frames equal to the unsharded frames bit for bit, the
   sharded training step's gradient leaf by leaf within rtol 1e-9 of the
   unsharded one in float64 at 480×270 and, in float32 at 1920×1080, no
   farther from the unsharded float32 gradient than that is from the
   unsharded float64 one, its two losses within the float32 loss gap (the
   unsharded float32 step's first loss against float64's) of the unsharded
   ones, and the gather's backward; then ``fit --sharded`` on one NCCL rank
   as phase 9 runs it: on one rank every stage and the all-reduce are
   those of phase 9, so its printed losses must equal phase 9's and its
   fitted YAML phase 9's byte for byte; (c) warm frame times: sharded on
   one NCCL rank against unsharded, in turns (the cost of the deal, the
   gather and ``generate_rays_at``), and on the two gloo ranks (one card
   gives no scaling figure); B3's kernel time on a band shard is taken in
   phase 5, where torch.profiler still sees it;
18. B2 at the 1920×1080 training shape held as in phase 7, over 4 sets of
   cotangents: after every profile, because the plain adjoints' millions
   of launches before a profile left torch.profiler blind to B2;
19. B2's float32 gradient gate (``scripts/fit_partials.gradient_gate``):
   ``scenes/default.yaml`` at 1920×1080 with the 470k-star sky, every leaf
   trainable; at the scene's own parameters with three targets (``diskOuter``
   12.5; ``mass`` 1.02; ``diskInner`` 2.2 with ``diskOpacity`` 0.85) and at
   iterates 5 and 10 of the float64 Adam fit to the first (lr 1e-3), the
   float32 gradient through B2 and through the plain float32 adjoint from
   the same B1 checkpoints, each against B2's float64 gradient there: on
   every leaf at every point B2's relative error must be at most
   ``GATE_MARGIN`` (1.05) × the plain adjoint's + 1e-7;
20. the bloom kernel B5 against the plain bloom (``img + strength ·
   box_blur``) computed in float64 on the card: in float32 within the
   plain float32 blur's budget, 1.5e-5 (``tests/test_filters.py``), at the
   three shapes of that test and on the 1920×1080 default frame before
   bloom, and in float64 within 1e-12; one launch a bloom and no wait for
   the card (``torch.cuda.set_sync_debug_mode("error")``); then B5's and
   the plain bloom's times at the frame's shape on the graph clock, beside
   B5's bound (one read and one write of the image), and B5's wrapper's.
   Then B5 at one pass (``box_blur_cuda``, the fit pyramid's blur) on a
   random 1920×1080 image at r 4, 8 and 16, its values and its gradient of
   ``<blur(x), cot>`` against the plain float64 blur's, within 1.5e-5 in
   float32 and 1e-12 in float64; its time at each radius beside its bound
   (two reads and two writes of the image); and one ``fit_scene(pyramid=3)``
   step, which must blur through it 9 times, 3 of them backward.

The last two lines of stdout are a JSON line of per-kernel results and
``{"ok": true, "device": {...}}``. Per kernel, ``ms`` is the wrapper's time
per call as the main path calls it (CUDA events), ``kernel_ms`` the
kernel's own device time (torch.profiler), ``plain_ms`` the plain version's
time per call, all at the 1080p shapes (for the probe kernels: their
largest size, with ``kernel_ms``, ``plain_ms`` and ``library_ms``, the
PyTorch call that computes the same, on the graph clock, ``floor_ms`` the
empty kernel's time at the kernel's grid on that clock, and ``ms`` the
wrapper's per host call);
B1's ``ckpt_ms`` / ``ckpt_kernel_ms`` are its checkpointing variant's;
K1's and K2's ``graph_ms`` their kernel on the graph clock;
``max_abs_err`` the largest error against the plain version on the card
(B1: RGBA, and B2: the direction gradients, at 1080p in float32 against
the plain float64 march and adjoint, with ``plain_max_abs_err`` the plain
float32 version's beside it);
``launches`` the count in the fit CLI's run (``launches_render``: in the
render CLI's run of phase 5; B1's and B3's ``launches_animation`` and
``launches_scenes``: in the animate CLI's run of phase 14 and the batch
render of phase 15; K1, K2 and the probe kernels: in their entry points'
runs; B1-B4's ``launches_sharded``: in ``fit --sharded``'s run of phase 17,
and B1's and B3's ``launches_sharded_render`` in its render CLI's run);
B5's ``*_pyramid`` fields those of its one-pass blur (phase 20:
``kernel_ms_pyramid`` per radius, the launches in its pyramid fit step);
``bound_ms`` the least time the card could take for the same work on
this run's data (the larger of its bytes over 3.35 TB/s and its operations
over 67 TFLOP/s, float32 without tensor cores).
"""

import argparse
import concurrent.futures
import contextlib
import dataclasses
import glob
import io
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


_T0 = time.perf_counter()


def _banner(text):
    print(f"\n== {text} (at {time.perf_counter() - _T0:.0f} s)", flush=True)


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
    """Device milliseconds per launch of the CUDA kernel whose name contains
    ``kernel_name``, from torch.profiler over ``reps`` warm calls of ``fn``
    (the kernel alone, without its wrapper's host work; ``fn`` launches it
    once), read as the training step's profile is read. The profiler can
    drop a short kernel's events: the profile is taken again, up to three
    times, until it keeps every launch, and the time is averaged over the
    launches it kept."""
    from blackstar_tpu_torch.scripts import step_profile

    for _ in range(3):
        prof = step_profile.profile_steps(fn, reps)
        hits = [v for name, v in prof["by_kernel"].items() if kernel_name in name]
        kept = sum(n for _, n in hits)
        if kept == reps:
            break
    if kept == 0:
        raise AssertionError(f"the profiler saw no device time for {kernel_name}")
    if kept != reps:
        print(f"  (the profiler kept {kept} of {reps} launches of {kernel_name})")
    return sum(ms for ms, _ in hits) * reps / kept


def _kernel_ms_turns(fns, kernel_name, reps):
    """:func:`_kernel_ms` for several calls that each launch the same kernel
    once, in one torch.profiler session (each session taken makes later
    ones drop more events): the calls run in turns, ``reps`` rounds, and
    the kernel's launches, in the order the card ran them, are dealt back
    to the calls. Taken again, up to three times, until the profile keeps
    every launch; returns per call name its device milliseconds a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    want = reps * len(fns)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn in fns.values():
                    fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and kernel_name in e.name),
                    key=lambda e: e.time_range.start)
        if len(ev) == want:
            return {name: sum(e.time_range.elapsed_us() for e in ev[i::len(fns)]) / 1e3 / reps
                    for i, name in enumerate(fns)}
    raise AssertionError(f"the profiler kept {len(ev)} of {want} launches of {kernel_name}")


# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM bytes per
# second, and float32 operations per second outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# Operations per advancing RK4 step of the march, counted on the plain
# march's formulation (one per multiply, add, divide or square root): four
# accelerations (7 each, plus 5 for the stage r^2 of three of them), six
# stage vectors (36), the new position and velocity (42), the new r^2 (5)
# and the two classification compares: 128. The disk filter and the rare
# crossings are left out. Kept as the yardstick now that B1 takes rsqrt
# powers and fused multiply-adds (a fused multiply-add counts two).
MARCH_OPS_PER_STEP = 128
# The adjoint per advancing step: one forward step (128), the RK4 VJP
# proper (four symmetric-Jacobian applications of 28 and 66 to combine
# them: 178) and the carry update (4). The kernel's second replay and its
# stage recomputation are its own choices, not the function's work.
ADJOINT_OPS_PER_STEP = 310
# Operations per candidate slot scanned by the star kernels: the
# difference (3), d^2 (5) and the cutoff compare (1). The PSF of the few
# slots inside the cutoff is left out.
STAR_OPS_PER_SLOT = 9
ANIMATION = os.path.join("animations", "default-ani.yaml")
# The TPU probe kernels the gather probe's kernels replace.
PROBE_REPLACES = {"row gather": "scripts/probe_dynamic_gather.py:42",
                  "lane gather": "scripts/probe_dynamic_gather.py:54",
                  "range copy": "scripts/probe_dynamic_gather.py:157"}


def _bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _star_work(grid, vel, escaped):
    """What a star kernel must touch for these rays: the distinct base rows
    and the used octets of the distinct overflow rows of the escaped rays'
    cells (bytes), and the candidate slots the rays scan."""
    v = vel[escaped]
    n = torch.nn.functional.normalize(v, dim=-1)
    cells = grid.cell_ids(n[:, 0], n[:, 1], n[:, 2])
    ptr = grid.cell_data[cells, 7].long()
    octs = grid.ovf_octets.long()
    uniq_cells = torch.unique(cells)
    uniq_ptr = torch.unique(ptr[ptr > 0])
    esz = grid.cell_data.element_size()
    table_bytes = (uniq_cells.numel() * grid.cell_data.shape[1]
                   + int(octs[uniq_ptr].sum()) * 64) * esz
    slots = v.shape[0] * grid.pad_k + int((octs[ptr] * 8).sum())
    return table_bytes, slots


def _check_march(ker, ref, dtype, ref64=None):
    """Hold B1's result. In float64 to the plain march ``ref``: equal step
    counts, status mismatches ≤ 1e-4, RGBA and velocity within 1e-7. In
    float32 B1 rounds otherwise than the plain march (rsqrt powers, fused
    multiply-adds) and near the photon ring follows other orbits, so it is
    held to ``ref64``, the plain float64 march of the same rays, no worse
    than the plain float32 march ``ref`` is (``scripts/march_accuracy.py``).
    Returns the kernel's max RGBA error against the plain float64 march,
    and in float32 the plain float32 march's beside it (else None)."""
    from blackstar_tpu_torch.scripts import march_accuracy

    if dtype == "float64":
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
        if frac > 1e-4:
            raise AssertionError(f"float64 status mismatch {frac:.3g} > 1e-4")
        torch.testing.assert_close(ker.acc_rgba[ok], ref.acc_rgba[ok], rtol=0, atol=1e-7)
        torch.testing.assert_close(ker.vel[ok], ref.vel[ok], rtol=0, atol=1e-7)
        return rgba_err, None
    k, p, failed = march_accuracy.march_gate(ker, ref, ref64)
    print(f"  float32, {ref.status.numel()} rays, against the plain float64 march of the same "
          f"rays:\n    kernel {k.line()}\n    plain  {p.line()}")
    if failed:
        raise AssertionError("B1's float32 accuracy gate failed: " + "; ".join(failed))
    return k.rgba_max, p.rgba_max


def _march64(pos0, planes, width, height):
    """The plain float64 march of float32 rays (the default scene in float64
    at ``width``×``height``)."""
    from blackstar_tpu_torch import geodesic
    from blackstar_tpu_torch.render import safe_distance

    cfg = _scene(width, height, "float64")
    params, static = cfg.params(pos0.device), cfg.static()
    return geodesic.march(pos0.double(), torch.stack(planes, dim=-1).double(), params, static,
                          safe_distance(params, torch.float64))


def _ckpt_buffers(static, n, dev):
    """Empty checkpoints and advancing counts for B1's checkpointing variant."""
    from blackstar_tpu_torch.geodesic import CKPT_VALUES, n_segments

    return (torch.empty((n_segments(static.max_steps), CKPT_VALUES, n), dtype=static.tdtype,
                        device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev))


def _adjoint64(pos0, planes, cot_acc, cot_vel, width, height):
    """The plain float64 adjoint of float32 rays and cotangents (the default
    scene in float64 at ``width``×``height``), in batches of 2^20 rays."""
    from blackstar_tpu_torch.ops.march_vjp import march_adjoint_reference
    from blackstar_tpu_torch.scripts.march_accuracy import adjoint_args

    cfg = _scene(width, height, "float64")
    params, static = cfg.params(pos0.device), cfg.static()
    return march_adjoint_reference(
        pos0.double(), torch.stack(planes, dim=-1).double(), h=static.step_size,
        max_steps=static.max_steps, disk_on=static.disk_on, cot_acc=cot_acc.double(),
        cot_vel=cot_vel.double(), chunk=1 << 20, **adjoint_args(params, static))


def _check_checkpoints(ckpt, ray_steps, plain, dtype):
    """Hold B1's checkpoints (the entries it wrote) and advancing counts to
    the plain checkpointing march's (``march_accuracy.checkpoint_gate``)."""
    from blackstar_tpu_torch.scripts import march_accuracy

    line, failed = march_accuracy.checkpoint_gate(ckpt, ray_steps, plain)
    print(f"  {dtype}: B1's checkpoints and ray_steps against the plain checkpointing march: "
          f"{line}")
    if failed:
        raise AssertionError(f"{dtype}: " + "; ".join(failed))


def _check_stars(ker, ref, dtype, label=""):
    """Hold B3's colours to the plain lookup's; returns the max error."""
    diff = (ker - ref).abs()
    max_err, mean_err = diff.max().item(), diff.mean().item()
    lit = (ref.amax(dim=-1) > 0).sum().item()
    print(f"  {dtype}{label}: {ref.shape[0]} rays ({lit} lit by stars), max |d| {max_err:.3g}, "
          f"mean |d| {mean_err:.3g}")
    if lit == 0:
        raise AssertionError("no ray picked up a star")
    if dtype == "float64":
        torch.testing.assert_close(ker, ref, rtol=0, atol=1e-9)
    elif mean_err > 1e-6 or max_err > 3e-2:
        raise AssertionError(f"float32 star colours differ: mean {mean_err:.3g} (limit 1e-6), "
                             f"max {max_err:.3g} (limit 3e-2)")
    return max_err


def _rtol_excess(got, want, rtol, atol_rel):
    """Where |got − want| > atol_rel·max|want| + rtol·|want| elementwise:
    (elements over, the worst error over its limit, the max abs error)."""
    err = (got - want).abs()
    limit = atol_rel * want.abs().max() + rtol * want.abs()
    ratio = (err / limit.clamp_min(1e-300)).max().item() if err.numel() else 0.0
    return int((err > limit).sum()), ratio, (err.max().item() if err.numel() else 0.0)


def _check_adjoint(ker, ref, fwd_status, dtype, runs=None, rerun=None):
    """Hold B2's gradients. B2's replay must classify every ray as the
    forward kernel B1 did (statuses bit-equal). Against the plain adjoint
    ``ref``: status mismatches ≤ 1e-4 (f64) or < 2% (f32). In float64 the
    per-ray gradients and the 10 scalar partials within rtol 1e-9 (floor
    1e-12·max) of ``ref``. In float32 B2 follows B1's orbits, which part
    from the plain adjoint's near the photon ring, so it is held to the
    plain float64 adjoint of the same rays, no worse than ``ref`` is, over
    the sets of cotangents in ``runs`` (``march_accuracy.adjoint_gate``,
    which calls ``rerun``; ``ker`` and ``ref`` are the first set's).
    Returns the max error of the per-ray gradients against the plain
    float64 adjoint, and in float32 the plain float32 adjoint's beside it
    (else None)."""
    from blackstar_tpu_torch.scripts import march_accuracy

    if not torch.equal(ker.status, fwd_status):
        raise AssertionError("B2's replayed statuses differ from B1's forward statuses")
    mismatch = ker.status != ref.status
    frac = mismatch.float().mean().item()
    if dtype == "float32":  # B1's 2% status gate
        if frac >= 0.02:
            raise AssertionError(f"float32 status mismatch {frac:.3g} >= 0.02")
        k, p, failed = march_accuracy.adjoint_gate(runs, rerun)
        print(f"  float32, {ref.status.numel()} rays, status mismatches with the plain float32 "
              f"adjoint {int(mismatch.sum())}; against the plain float64 adjoint of the same "
              f"rays over {len(runs)} sets of cotangents:\n    kernel {k.line()}\n"
              f"    plain  {p.line()}")
        if failed:
            raise AssertionError("B2's float32 accuracy gate failed: " + "; ".join(failed))
        return k.grad_max, p.grad_max
    if frac > 1e-4:  # tests/test_march_adjoint.py's rtol, floor 1e-12·max|g|
        raise AssertionError(f"float64 status mismatch {frac:.3g} > 1e-4")
    ok = ~mismatch
    over, ratio, err = _rtol_excess(ker.vel0[ok], ref.vel0[ok], 1e-9, 1e-12)
    report = [f"vel0 {over} elements over (worst {ratio:.3g} x its limit)"]
    for name in march_accuracy.SCALARS:
        s_over, s_ratio, _ = _rtol_excess(getattr(ker, name), getattr(ref, name), 1e-9, 1e-12)
        over += s_over
        report.append(f"{name} {s_ratio:.3g} x")
    print(f"  {dtype}: {ref.status.numel()} rays, status mismatches {int(mismatch.sum())}, "
          f"max |vel0 grad| {ref.vel0[ok].abs().max().item():.3g}, max |d| {err:.3g}; rtol "
          "1e-9: " + ", ".join(report))
    if over:
        raise AssertionError("float64 B2 gradients outside rtol 1e-9: " + ", ".join(report))
    return err, None


def _check_star_vjp(ker, ref, dtype, n_escaped, label=""):
    """Hold B4's gradients to the plain star VJP's: per plane, B3's gates
    scaled by the output's largest magnitude; the two scalar sums (over
    ~2M rays, summed in other orders) at 1e-9 (f64) and 1e-4 (f32)
    relative. Returns the max error of the per-ray gradients."""
    gk, gr = ker[0], ref[0]
    scale = gr.abs().max().item()
    d = (gk - gr).abs()
    max_err, mean_err = d.max().item(), d.mean().item()
    rel = [abs((k - r).item()) / max(abs(r.item()), 1e-30) for k, r in zip(ker[1:], ref[1:])]
    print(f"  {dtype}{label}: {gr.shape[0]} rays ({n_escaped} escaped), max |g vel| {scale:.3g}, "
          f"max |d| {max_err:.3g}, mean |d| {mean_err:.3g}; dI rel {rel[0]:.3g}, "
          f"dS rel {rel[1]:.3g} (dI {ref[1].item():.6g}, dS {ref[2].item():.6g})")
    if scale == 0 or ref[1].item() == 0:
        raise AssertionError("no star gradient flowed")
    if dtype == "float64":
        if max_err > 1e-9 * scale or max(rel) > 1e-9:
            raise AssertionError("float64 star gradients differ")
    elif mean_err > 1e-6 * scale or max_err > 3e-2 * scale or max(rel) > 1e-4:
        raise AssertionError("float32 star gradients differ")
    return max_err


def _star_cases(dtype, dev):
    """Phase 4's and 8's further rays for the star kernels: every ray of the
    481×271 default frame, escaped or not (no 8×4 warp tile divides the
    frame), with and without the width hint; and 2^16 seeded random
    directions, 90% active, one cell a lane. Yields (label, directions,
    active mask, width hints, intensity, saturation)."""
    from blackstar_tpu_torch.camera import generate_ray_components
    from blackstar_tpu_torch.geodesic import ESCAPED
    from blackstar_tpu_torch.ops.march_cuda import march_cuda
    from blackstar_tpu_torch.render import safe_distance

    cfg = _scene(481, 271, dtype)
    params, static = cfg.params(dev), cfg.static()
    dt = static.tdtype
    shade = (params.stars.intensity, params.stars.saturation)
    pos0, planes = generate_ray_components(params.camera, 481, 271, dtype=dt)
    res = march_cuda(pos0, planes, params, static, safe_distance(params, dt))
    yield "481x271 frame", res.vel, res.status == ESCAPED, (481, None), *shade
    rng = np.random.default_rng(16)
    vel = torch.from_numpy(rng.normal(size=(1 << 16, 3))).to(dev, dt)
    active = torch.from_numpy(rng.uniform(size=1 << 16) < 0.9).to(dev)
    yield "2^16 random directions", vel, active, (None,), *shade


@contextlib.contextmanager
def _sync_error():
    """Run the body under ``torch.cuda.set_sync_debug_mode("error")``: any
    operation in it that waits for the card raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _escape_catalog(dev, per_scene=30, seed=14):
    """A small star catalogue lit in every reference scene at 16 px: stars
    (numpy seed) within 3e-4 rad of escape directions of each scene's
    16-px float64 frame, through B1."""
    from blackstar_tpu_torch.camera import generate_rays
    from blackstar_tpu_torch.geodesic import ESCAPED
    from blackstar_tpu_torch.ops.march_cuda import march_cuda
    from blackstar_tpu_torch.render import safe_distance
    from blackstar_tpu_torch.stars.catalog import Catalog, spectral_color
    from tests.test_torch_scenes_golden import SCENES, scene_at

    rng = np.random.default_rng(seed)
    picks = []
    for path in SCENES:
        cfg = scene_at(path, 16)
        params, static = cfg.params(dev), cfg.static()
        pos, vel = generate_rays(params.camera, static.render_width, static.render_height,
                                 dtype=torch.float64)
        res = march_cuda(pos, vel, params, static, safe_distance(params, torch.float64))
        esc = torch.nn.functional.normalize(res.vel[res.status == ESCAPED], dim=-1).cpu().numpy()
        picks.append(esc[rng.choice(len(esc), min(per_scene, len(esc)), replace=False)])
    pos = np.concatenate(picks)
    pos = pos + 3e-4 * rng.normal(size=pos.shape)
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    chars = rng.choice(list("OBAFGKM?"), len(pos))
    return Catalog(pos=pos, mag=rng.integers(300, 1300, len(pos)).astype(np.int32),
                   hue=np.array([spectral_color(c)[0] for c in chars]),
                   sat=np.array([spectral_color(c)[1] for c in chars]))


def _oracle_scenes(dev):
    """The all-scenes gate through the kernels in float64: the nine scenes at
    16 px with a star catalogue lit in each (B1 and B3) against
    ``tests/oracle.py`` computed now (one process a scene), and the three
    disk scenes at 64 px without stars (B1) against the committed goldens
    of the oracle; each at atol 1e-7, with no truncated ray. Returns
    [(scene, width, max |d|, pixels the stars change)]."""
    from blackstar_tpu_torch.render import render
    from blackstar_tpu_torch.stars.grid import build_star_grid_compact
    from tests import oracle
    from tests.test_torch_scenes_golden import DISK_SCENES, SCENES, golden_path, scene_at

    catalog = _escape_catalog(dev)
    grid = build_star_grid_compact(catalog, cell_size=0.006, radius=0.0075, k0=32).to_grid(
        dev, dtype=torch.float64)
    cases = [(p, 16, catalog, grid) for p in SCENES]
    cases += [(p, 64, None, None) for p in DISK_SCENES]
    ctx = multiprocessing.get_context("spawn")
    workers = min(len(SCENES), os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        wants = [pool.submit(oracle.render, scene_at(p, w), cat) if cat is not None else None
                 for p, w, cat, _ in cases]
        out = []
        for (path, width, cat, g), fut in zip(cases, wants):
            cfg = scene_at(path, width)
            img, stats = render(cfg.params(dev), cfg.static(), g, with_stats=True)
            if float(stats.truncated_frac) != 0.0:
                raise AssertionError(f"{path} at {width} px truncated rays")
            if fut is None:
                want = np.load(golden_path(cfg, path, width))
            else:
                want = fut.result()
            got = img.cpu().numpy()
            err = float(np.abs(got - want).max())
            lit = 0
            if g is not None:  # pixels the stars change
                bare = render(cfg.params(dev), cfg.static(), None).cpu().numpy()
                lit = int((np.abs(got - bare).max(axis=-1) > 1e-9).sum())
            out.append((os.path.basename(path), width, err, lit))
            if err > 1e-7:
                raise AssertionError(f"{path} at {width} px: max |d| {err:.3g} > 1e-7 from the "
                                     "oracle")
    return out


def _animation_phase(dev, grid32):
    """Phase 14 (module docstring); returns B1's, B3's and B5's launches in
    the animate CLI's run."""
    from blackstar_tpu_torch import geodesic, native
    from blackstar_tpu_torch.animation import load_animation
    from blackstar_tpu_torch.cli import animate as cli_animate
    from blackstar_tpu_torch.imageio import encode_rgb8, read_png
    from blackstar_tpu_torch.ops import bloom_cuda as b5
    from blackstar_tpu_torch.ops import march_cuda as b1
    from blackstar_tpu_torch.ops.filters import bloom
    from blackstar_tpu_torch.render import render
    from blackstar_tpu_torch.stars import lookup_cuda as b3
    from blackstar_tpu_torch.stars.grid import StarGrid
    from blackstar_tpu_torch.video import animation_config, render_animation

    _banner("14. animation: animate --render, animations/default-ani.yaml, 375 frames at "
            "1920x1080 supersampled, float32, 470k-star sky")

    print(f"  native PNG library: {native.library_path() if native.available() else 'unavailable'}"
          + ("" if native.available() else f" ({native.load_error})"))
    if not native.available():
        raise AssertionError("the native PNG library did not build: the animation would be "
                             "written by the pure-Python writer")
    anim = load_animation(os.path.join(ROOT, ANIMATION))
    ani_dir = os.path.join(ROOT, "build", "chip_smoke_ani")  # gitignored
    torch.cuda.empty_cache()
    try:
        b1.march_cuda.launches = b3.star_lookup_cuda.launches = b5.bloom_cuda.launches = 0
        geodesic.march.calls = StarGrid.lookup.calls = 0
        pool_before = dict(render_animation.pool)
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli_animate.main([ANIMATION, "--render", "-o", ani_dir, "-f"])
        ani_s = time.perf_counter() - t0
        ani_launches = {"b1": b1.march_cuda.launches, "b3": b3.star_lookup_cuda.launches,
                        "b5": b5.bloom_cuda.launches}
        ani_plain = {"march": geodesic.march.calls, "lookup": StarGrid.lookup.calls}
        text = log.getvalue().replace("\r", "\n")
        lines = [ln for ln in text.splitlines() if ln and not ln.startswith("Frame ")]
        print("  | " + "\n  | ".join(lines))
        print(f"  CLI run {ani_s:.1f} s (cold: includes loading the star tables), rc {rc}, "
              f"kernel launches {ani_launches}, plain calls {ani_plain}")
        if rc != 0:
            raise AssertionError(f"animate CLI returned {rc}")
        if "PNG writer: native pool" not in text:
            raise AssertionError("the animation was not written by the native writer pool")
        pool = {k: v - pool_before[k] for k, v in render_animation.pool.items()}
        print(f"  writer pool: {render_animation.threads} threads, {pool}")
        if pool["frames"] != 375 or pool["bands"] <= 375:
            raise AssertionError("the writer pool did not write 375 frames in more than one "
                                 "band each")
        if ani_launches != {"b1": 375, "b3": 375, "b5": 375} or max(ani_plain.values()) != 0:
            raise AssertionError("the animation did not go through B1, B3 and B5 alone, once a "
                                 "frame")
        pngs = sorted(glob.glob(os.path.join(ani_dir, "default-ani_*.png")))
        if len(pngs) != 375:
            raise AssertionError(f"expected 375 frames, found {len(pngs)}")
        cfg = animation_config(anim)
        static = cfg.static()
        print(f"  frame {static.width}x{static.height}, {static.n_rays} rays, step cap "
              f"{static.max_steps} (the farthest keyframe's)")
        for idx, key in ((0, anim.keyframes[0]), (374, anim.keyframes[-1])):
            params = dataclasses.replace(cfg, camera=key.camera).params(dev)
            img, stats = render(params, static, grid32, with_stats=True)
            img = bloom(img, params.bloom_strength, static.bloom_divider)
            want = encode_rgb8(img).cpu().numpy()
            got = read_png(pngs[idx])
            d = np.abs(got.astype(np.int16) - want.astype(np.int16))
            print(f"  frame {idx} vs a direct render at keyframe {idx and 1}'s camera: max |d| "
                  f"{int(d.max())} on the uint8 scale, {int((d > 0).sum())} values differ; "
                  f"truncated share {float(stats.truncated_frac):.6g}, escaped "
                  f"{float(stats.escaped_frac):.4f}")
            if d.max() > 1:
                raise AssertionError(f"frame {idx} differs from the direct render by {d.max()}")
        del img
    finally:
        shutil.rmtree(ani_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return ani_launches


def _scenes_phase(dev, grid32, card):
    """Phase 15 (module docstring); returns B1's and B3's launches in the
    batch render of ``scenes/``."""
    from blackstar_tpu_torch import geodesic
    from blackstar_tpu_torch.camera import generate_ray_components
    from blackstar_tpu_torch.cli import render as cli_render
    from blackstar_tpu_torch.config import load_config
    from blackstar_tpu_torch.geodesic import ESCAPED
    from blackstar_tpu_torch.imageio import encode_rgb8, read_png
    from blackstar_tpu_torch.ops import march_cuda as b1
    from blackstar_tpu_torch.render import render_rgb, safe_distance
    from blackstar_tpu_torch.stars import lookup_cuda as b3
    from blackstar_tpu_torch.stars.grid import StarGrid
    from tests.test_torch_scenes_golden import SCENES

    _banner("15. all nine scenes: float64 through B1 and B3 vs the oracle; the render CLI "
            "on scenes/ at full size; each scene's full-size rays through B1's and B3's "
            "float32 gates")
    for name, width, err, lit in _oracle_scenes(dev):
        print(f"  {name} at {width} px, float64: max |d| {err:.3g} vs the oracle (limit 1e-7)"
              + (f", {lit} pixels lit by stars" if width == 16 else ", no stars"))
    scenes_dir = os.path.join(ROOT, "scenes")
    out_dir = os.path.join(ROOT, "build", "chip_smoke_scenes")  # gitignored
    try:
        b1.march_cuda.launches = b3.star_lookup_cuda.launches = 0
        geodesic.march.calls = StarGrid.lookup.calls = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli_render.main([scenes_dir, "-o", out_dir, "-f", "--stats"])
        batch_s = time.perf_counter() - t0
        scene_launches = {"b1": b1.march_cuda.launches, "b3": b3.star_lookup_cuda.launches}
        scene_plain = {"march": geodesic.march.calls, "lookup": StarGrid.lookup.calls}
        text = log.getvalue()
        print(f"  render CLI on scenes/ with -f: {batch_s:.1f} s (cold), rc {rc}, kernel "
              f"launches {scene_launches}, plain calls {scene_plain}")
        if rc != 0:
            raise AssertionError(f"render CLI returned {rc}")
        if scene_launches != {"b1": 9, "b3": 9} or max(scene_plain.values()) != 0:
            raise AssertionError("the scenes did not go through B1 and B3 alone, once a scene")
        truncated = [float(v) for v in re.findall(r"truncated=(\S+)", text)]
        pngs = sorted(glob.glob(os.path.join(out_dir, "*.png")))
        if len(pngs) != 9 or len(truncated) != 9:
            raise AssertionError(f"expected 9 PNGs and 9 stats lines: {pngs}, {truncated}")
        for path, trunc in zip(SCENES, truncated):
            name = os.path.basename(path)[:-5]
            cfg = load_config(path)
            rgb8 = read_png(os.path.join(out_dir, name + ".png"))
            w, h = cfg.scene.resolution
            if rgb8.shape != (h, w, 3) or rgb8.max() == 0:
                raise AssertionError(f"{name}.png is {rgb8.shape}, max {rgb8.max()}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for path, trunc in zip(SCENES, truncated):
        cfg = load_config(path)
        params, static = cfg.params(dev), cfg.static()
        dt = static.tdtype
        rw, rh = static.render_width, static.render_height
        wall_ms = _host_ms(lambda: encode_rgb8(render_rgb(params, static, grid32)).cpu(), 3)
        pos0, planes = generate_ray_components(params.camera, rw, rh, dtype=dt)
        safe = safe_distance(params, dt)
        ker = b1.march_cuda(pos0, planes, params, static, safe)
        ref = geodesic.march(pos0, torch.stack(planes, dim=-1), params, static, safe)
        cfg64 = dataclasses.replace(cfg, scene=dataclasses.replace(cfg.scene, dtype="float64"))
        params64 = cfg64.params(dev)
        ref64 = geodesic.march(pos0.double(), torch.stack(planes, dim=-1).double(), params64,
                               cfg64.static(), safe_distance(params64, torch.float64))
        torch.cuda.synchronize()
        print(f"  {os.path.basename(path)}: {cfg.scene.resolution[0]}x{cfg.scene.resolution[1]}"
              f"{' supersampled' if static.supersampling else ''}, {rw * rh} rays"
              f"{'' if rw % 8 == 0 and rh % 4 == 0 else ' (not whole 8x4 tiles)'}, step cap "
              f"{static.max_steps}; truncated share {trunc:.6g} (CLI); frame wall "
              f"{wall_ms:.3f} ms (render + bloom + uint8 copy, warm)  [{card}]")
        _check_march(ker, ref, "float32", ref64)
        del ref, ref64
        escaped = ker.status == ESCAPED
        inten, sat = params.stars.intensity, params.stars.saturation
        s_ker = b3.star_lookup_cuda(grid32, ker.vel, inten, sat, escaped, width=rw)
        s_ref = grid32.lookup(ker.vel, inten, sat, escaped)
        torch.cuda.synchronize()
        _check_stars(s_ker, s_ref, "float32", f", {int(escaped.sum())} escaped rays")
        del ker, s_ker, s_ref
        torch.cuda.empty_cache()
    return scene_launches


def _bloom_phase(dev, grid32, card):
    """Phase 20 (module docstring); returns B5's entry of the kernel table."""
    from blackstar_tpu_torch.ops import bloom_cuda as b5
    from blackstar_tpu_torch.ops.filters import box_blur
    from blackstar_tpu_torch.render import render
    from blackstar_tpu_torch.scripts import graph_ms

    _banner("20. B5 bloom kernel vs the plain bloom in float64: the blur's three production "
            "shapes, the 1920x1080 default frame; times on the graph clock")
    budget = 1.5e-5  # tests/test_filters.py::test_box_blur_f32_precision_at_production_scale
    rng = np.random.default_rng(0)
    cases = [(f"random {h}x{w}, r {r}", torch.from_numpy(rng.uniform(0, 1.3, (h, w, 3))).to(dev),
              1.0, r) for h, w, r in ((1080, 1920, 76), (32, 7680, 307), (4320, 64, 307))]
    cfg = _scene(1920, 1080, "float32")
    params, static = cfg.params(dev), cfg.static()
    frame = render(params, static, grid32)
    strength = params.bloom_strength.to(frame.dtype)
    r = 1920 // static.bloom_divider
    cases.append((f"default frame 1920x1080, r {r}", frame.double(), strength, r))
    err = 0.0
    for label, img, s, radius in cases:
        want = img + float(s) * box_blur(img, radius, passes=3)
        for dt, tol in ((torch.float32, budget), (torch.float64, 1e-12)):
            got = b5.bloom_radius_cuda(img.to(dt), s.to(dt) if torch.is_tensor(s) else s, radius)
            d = (got.double() - want).abs().max().item()
            print(f"  {label}, {str(dt)[6:]}: max |d| {d:.3g} vs the float64 plain bloom "
                  f"(limit {tol:g})")
            if not d <= tol:
                raise AssertionError(f"B5 at {label} in {dt} misses the plain bloom by {d:.3g}")
            if dt == torch.float32:
                err = max(err, d)
    del cases, want, got

    before = b5.bloom_cuda.launches
    with _sync_error():
        b5.bloom_cuda(frame, strength, static.bloom_divider)
    if b5.bloom_cuda.launches != before + 1:
        raise AssertionError("one bloom did not count one B5 launch")
    print("  B5's wrapper ran under sync-debug mode 'error': it never waited for the card; "
          "one bloom, one launch")

    kernel = lambda: b5.bloom_cuda(frame, strength, static.bloom_divider)  # noqa: E731
    plain = lambda: frame + strength * box_blur(frame, r, passes=3)  # noqa: E731
    kernel_ms, plain_ms = graph_ms(kernel, 50), graph_ms(plain, 20)
    wrapper_ms = _cuda_ms(kernel, 50)
    bound = _bound(2 * frame.numel() * frame.element_size(), 0)
    rows, cols = b5.plan(1080, 1920, 4, b5.smem_limit(dev.index))
    print(f"  B5 at 1920x1080x3 float32, r {r} (graph clock): {kernel_ms:.4f} ms (both launches), "
          f"bound {bound[0]:.4f} ms by {bound[1]} (share {bound[0] / kernel_ms:.3f}); plain bloom "
          f"{plain_ms:.4f} ms; wrapper {wrapper_ms:.4f} ms a host call  [{card}]")
    print(f"  plan: rows {rows}, columns {cols}")
    entry = {"name": "bloom (B5)", "route": "cuda", "source": "blackstar_tpu_torch/ops/csrc/bloom.cu",
             "replaces": None, "max_abs_err": err, "ms": wrapper_ms, "kernel_ms": kernel_ms,
             "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}
    entry.update(_pyramid_blur_phase(dev, grid32, card))
    return entry


def _pyramid_blur_phase(dev, grid32, card):
    """Phase 20's second half: B5 at one pass, the fit pyramid's blur
    (``box_blur_cuda``), and its gradient against the plain float64 blur at
    the pyramid's radii on a 1080p image; its time beside its bound; one
    ``fit_scene(pyramid=3)`` step through it. Returns the B5 entry's
    one-pass fields."""
    from blackstar_tpu_torch.fit import fit_scene, trainable_mask
    from blackstar_tpu_torch.ops import bloom_cuda as b5
    from blackstar_tpu_torch.ops.filters import box_blur
    from blackstar_tpu_torch.render import render
    from blackstar_tpu_torch.scripts import graph_ms

    budget = 1.5e-5  # as the bloom's
    radii = (4, 8, 16)  # fit --pyramid 3
    rng = np.random.default_rng(20)
    img = torch.from_numpy(rng.uniform(0, 1.3, (1080, 1920, 3))).to(dev)
    cot = torch.from_numpy(rng.uniform(-1, 1, (1080, 1920, 3))).to(dev)
    err = 0.0
    for r in radii:
        x64 = img.detach().requires_grad_()
        want = box_blur(x64, r, passes=1)
        want.backward(cot)
        for dt, tol in ((torch.float32, budget), (torch.float64, 1e-12)):
            x = img.to(dt).detach().requires_grad_()  # a leaf, also where dt is img's
            got = b5.box_blur_cuda(x, r)
            got.backward(cot.to(dt))
            d = (got.double() - want.detach()).abs().max().item()
            g = (x.grad.double() - x64.grad).abs().max().item()
            print(f"  one pass, random 1080x1920, r {r}, {str(dt)[6:]}: max |d| {d:.3g}, "
                  f"gradient of <blur(x), cot> {g:.3g} vs the float64 plain blur (limit {tol:g})")
            if not (d <= tol and g <= tol):
                raise AssertionError(f"B5's one-pass blur at r {r} in {dt} misses the plain "
                                     f"blur by {d:.3g} (gradient {g:.3g})")
            if dt == torch.float32:
                err = max(err, d, g)
    del x64, want, x, got

    img32 = img.float()
    pass_ms = {r: graph_ms(lambda r=r: b5.box_blur_cuda(img32, r), 50) for r in radii}
    # rows launch reads the image and writes tmp, columns launch reads tmp
    # and writes the blur: blur_roofline.pyramid's 2 axes × (read + write)
    bound = _bound(4 * img32.numel() * img32.element_size(), 0)
    print("  one pass at 1920x1080x3 float32 (graph clock): "
          + ", ".join(f"r {r} {ms:.4f} ms" for r, ms in pass_ms.items())
          + f" (both launches); bound {bound[0]:.4f} ms by {bound[1]}  [{card}]")
    del img, cot, img32

    cfg_t = _scene(1920, 1080, "float32", disk_outer=12.5)
    target = render(cfg_t.params(dev), cfg_t.static(), grid32)  # before bloom
    cfg = _scene(1920, 1080, "float32")
    params, static = cfg.params(dev), cfg.static()
    mask = trainable_mask(params, lambda path: "disk.outer" in path)
    b5.box_blur_cuda.launches = b5.box_blur_cuda.backward_launches = 0
    _, losses = fit_scene(params, static, target, grid32, steps=1, learning_rate=0.05,
                          grad_mask=mask, pyramid=3)
    counts = {"launches_pyramid": b5.box_blur_cuda.launches,
              "backward_launches_pyramid": b5.box_blur_cuda.backward_launches}
    print(f"  one fit_scene(pyramid=3) step at 1920x1080 float32: loss {losses[0]:.6g}, "
          f"B5 one-pass blurs {counts}")
    # the target's 3 levels once a job, the loss's 3 levels forward and back
    if counts != {"launches_pyramid": 9, "backward_launches_pyramid": 3}:
        raise AssertionError(f"the pyramid step did not blur through B5 9 times, 3 backward: "
                             f"{counts}")
    if not np.isfinite(losses[0]):
        raise AssertionError(f"the pyramid step's loss is {losses[0]}")
    return {"max_abs_err_pyramid": err, "kernel_ms_pyramid": pass_ms,
            "bound_ms_pyramid": bound[0], **counts}


def _star_build_phase(grid_path):
    """Phase 16 (module docstring): the generated grid equals the loaded one."""
    from blackstar_tpu_torch.cli import generate_grid as cli_generate_grid

    _banner("16. star build side: generate-grid stars.ppm at the production defaults")

    gen_path = os.path.join(ROOT, "build", "chip_smoke_grid.npz")  # gitignored
    try:
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli_generate_grid.main(["stars.ppm", gen_path, "-f"])
        print("  | " + log.getvalue().strip().replace("\n", "\n  | "))
        print(f"  generate-grid {time.perf_counter() - t0:.1f} s, rc {rc}")
        if rc != 0:
            raise AssertionError(f"generate-grid returned {rc}")
        with np.load(gen_path) as got, np.load(grid_path) as want:
            if sorted(got.files) != sorted(want.files):
                raise AssertionError(f"fields differ: {got.files} vs {want.files}")
            for key in want.files:
                if got[key].dtype != want[key].dtype or not np.array_equal(got[key], want[key]):
                    raise AssertionError(f"{key} differs from {grid_path}'s")
            print(f"  {len(want.files)} arrays equal to those of "
                  f"{os.path.relpath(grid_path, ROOT)} "
                  f"(the grid phase 4 loaded): {int(want['n_stars'])} stars, "
                  f"{want['counts'].size} cells, {want['star_ids'].size} slots")
    finally:
        if os.path.exists(gen_path):
            os.unlink(gen_path)


def _torchrun(args, timeout=600):
    """``torchrun --standalone --nproc-per-node 1 chip_smoke.py _cli ARGS``:
    the port's CLI (``python -m blackstar_tpu_torch ARGS``) on one rank
    under torchrun's environment, with its kernel counts on the last line.
    Returns (stdout, those counts)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", os.path.abspath(__file__), "_cli", *args]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} returned {out.returncode}:\n{out.stdout[-4000:]}"
                             f"\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    return "\n".join(lines[:-1]), json.loads(lines[-1])


def _cli_under_torchrun(argv):
    """``chip_smoke.py _cli ARGS`` (what :func:`_torchrun` launches): run
    the CLI, then print its kernel counts as JSON."""
    from blackstar_tpu_torch.__main__ import main as cli_main
    from blackstar_tpu_torch.scripts.multihost_check import counters

    rc = cli_main(argv)
    if rc:
        sys.exit(rc)
    print(json.dumps(counters()))


def _loss_lines(text):
    """The fit CLI's printed loss lines (each step's and the summary)."""
    return [line.strip() for line in text.splitlines()
            if re.match(r"\s*(step\s+\d+/\d+\s+loss |loss: )", line)]


def _sharded_phase(dev, grid32, grid_path, card, png5, fit9, target_img):
    """Phase 17 (module docstring); returns the kernel counts of the
    ``fit --sharded`` and ``render --sharded`` runs."""
    from blackstar_tpu_torch.imageio import encode_rgb8, write_png
    from blackstar_tpu_torch.parallel import initialize_distributed, make_mesh, render_sharded
    from blackstar_tpu_torch.render import render
    from blackstar_tpu_torch.scripts import multihost_check
    import yaml

    _banner("17. sharded slice: render and fit --sharded under torchrun (1 NCCL rank), 2 gloo "
            "ranks on the one card, sharded frame times")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = os.path.join(ROOT, "build", "chip_smoke_sharded")  # gitignored
    os.makedirs(work, exist_ok=True)
    try:
        # (a) the render CLI on one NCCL rank: phase 5's PNG, byte for byte.
        t0 = time.perf_counter()
        text, render_counts = _torchrun([
            "render", os.path.join("scenes", "default.yaml"), "-o", work, "--force",
            "--sharded"])
        print("  | " + text.strip().replace("\n", "\n  | "))
        with open(os.path.join(work, "default.png"), "rb") as f:
            same = f.read() == png5
        print(f"  (a) torchrun render --sharded, 1 rank (nccl): {time.perf_counter() - t0:.1f} s "
              f"(cold), kernel counts {render_counts}; PNG equal to phase 5's byte for byte: "
              f"{same}")
        if not same:
            raise AssertionError("the sharded render CLI's PNG differs from phase 5's")
        if min(render_counts["b1"], render_counts["b3"]) < 1 or render_counts["plain"]:
            raise AssertionError("the sharded render did not go through B1 and B3 alone")

        # (b) two gloo ranks on cuda:0 through multihost_check.
        with open(os.path.join(ROOT, "scenes", "default.yaml")) as f:
            base = yaml.safe_load(f)

        def case(name, w, h, dtype, **extra):
            cfg = {"camera": base["camera"], "scene": dict(base["scene"], resolution=[w, h],
                                                           dtype=dtype)}
            return {"name": name, "config": cfg, "starmap": grid_path, **extra}

        target = {"disk_outer": 12.5}
        spec = {"cases": [
            case("frame 1920x1080 f32", 1920, 1080, "float32", time_reps=5),
            case("frame 481x271 f32", 481, 271, "float32"),
            case("training step 480x270 f64", 480, 270, "float64", grad=True, target=target),
            case("training step 1920x1080 f32", 1920, 1080, "float32", grad=True,
                 target=target, ref64=True)]}
        out = os.path.join(work, "ranks2.pt")
        t0 = time.perf_counter()
        rc = multihost_check.launch(spec, 2, "cuda:0", "gloo", 600, out)
        if rc:
            raise AssertionError(f"the 2-rank gloo run exited with {rc}")
        res = torch.load(out)
        print(f"  (b) 2 ranks on cuda:0 ({res['backend']}): {time.perf_counter() - t0:.1f} s; "
              f"gather backward per rank {res['gather_backward_ok']}")
        if res["gather_backward_ok"] != [True, True]:
            raise AssertionError("the gather's backward is not the image gradient's rows")
        for name, r in res["cases"].items():
            equal = torch.equal(r["img"], r["ref"])
            print(f"    {name}: sharded == unsharded bit for bit: {equal}; per-rank counts "
                  f"{r['counts']}")
            if name.startswith("frame") and not equal:
                d = (r["img"] - r["ref"]).abs()
                raise AssertionError(f"{name}: the sharded frame differs from the unsharded one "
                                     f"on {int((d > 0).sum())} values (max {d.max().item():.3g})")
            keys = ("b1", "b2", "b3", "b4") if "train" in r else ("b1", "b3")
            if any(min(c[k] for k in keys) < 1 or c["plain"] for c in r["counts"]):
                raise AssertionError(f"{name}: a rank did not go through {keys} alone")
        r = res["cases"]["training step 480x270 f64"]
        for leaf, g in r["train"]["grads"].items():
            over, ratio, err = _rtol_excess(g, r["ref_train"]["grads"][leaf], 1e-9, 1e-12)
            if over:
                raise AssertionError(f"f64 sharded gradient {leaf}: {over} elements outside rtol "
                                     f"1e-9 (worst {ratio:.3g} x its limit)")
        print("    f64 480x270: every leaf's sharded gradient within rtol 1e-9 of the "
              "unsharded one")
        r = res["cases"]["training step 1920x1080 f32"]
        g32, g64 = r["ref_train"]["grads"], r["ref64_train"]["grads"]
        print("    f32 1920x1080, per leaf: max |sharded - unsharded| / max |unsharded f32 - "
              "unsharded f64|:")
        for leaf, g in r["train"]["grads"].items():
            deal = (g - g32[leaf]).abs().max().item()
            f32 = (g32[leaf].double() - g64[leaf]).abs().max().item()
            print(f"      {leaf:>18}: {deal:.3e} / {f32:.3e}")
            if deal > f32:
                raise AssertionError(f"f32 sharded gradient {leaf} is farther from the unsharded "
                                     f"one ({deal:.3g}) than that is from float64 ({f32:.3g})")
        loss_gap = abs(r["ref_train"]["losses"][0] - r["ref64_train"]["losses"][0])
        off = max(abs(a - b) for a, b in zip(r["train"]["losses"], r["ref_train"]["losses"]))
        print(f"    f32 1920x1080: the 2 steps' losses {r['train']['losses']}, unsharded "
              f"{r['ref_train']['losses']}: max |d| {off:.3e} against the f32 loss gap "
              f"{loss_gap:.3e} (unsharded f32 - f64, first step)")
        if off > loss_gap:
            raise AssertionError("the 2-rank sharded losses are off the unsharded ones beyond "
                                 "the f32 gap")
        f = res["cases"]["frame 1920x1080 f32"]
        two_rank_ms, unsharded_2_ms = f["sharded_ms"], f["unsharded_ms"]

        # (b) fit --sharded on one NCCL rank, as phase 9 runs it.
        target_png = os.path.join(work, "target.png")
        write_png(encode_rgb8(target_img).cpu().numpy(), target_png)
        fitted = os.path.join(work, "fitted.yaml")
        t0 = time.perf_counter()
        text, fit_counts = _torchrun([
            "fit", os.path.join("scenes", "default.yaml"), target_png, "--fit", "disk.outer",
            "--steps", "5", "--lr", "0.05", "--starmap", grid_path, "--force", "-o", fitted,
            "--sharded"])
        print("  | " + text.strip().replace("\n", "\n  | "))
        lines = _loss_lines(text)
        with open(fitted, "rb") as f:
            same_yaml = f.read() == fit9["yaml"]
        outer = yaml.safe_load(open(fitted))["scene"]["diskOuter"]
        print(f"  fit --sharded, 1 rank (nccl): {time.perf_counter() - t0:.1f} s (cold), kernel "
              f"counts {fit_counts}; loss lines equal to phase 9's: {lines == fit9['lines']} "
              f"({len(lines)} lines); fitted YAML equal to phase 9's byte for byte: {same_yaml}; "
              f"disk.outer 13 -> {outer}")
        if len(lines) != 6 or lines != fit9["lines"]:
            raise AssertionError(f"the sharded fit printed other losses than phase 9's: {lines} "
                                 f"against {fit9['lines']}")
        if not same_yaml:
            raise AssertionError("the sharded fit's YAML differs from phase 9's")
        if min(fit_counts[k] for k in ("b1", "b2", "b3", "b4")) < 1 or fit_counts["plain"]:
            raise AssertionError("the sharded fit did not go through the four kernels alone")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (c) one NCCL rank in this process: the sharded frame against the
    # unsharded one, in turns.
    cfg = _scene(1920, 1080, "float32")
    params, static = cfg.params(dev), cfg.static()
    initialize_distributed(device=dev)
    try:
        mesh = make_mesh(dev)
        if not torch.equal(render_sharded(params, static, grid32, mesh=mesh),
                           render(params, static, grid32)):
            raise AssertionError("the 1-rank sharded frame differs from the unsharded one")
        times = {"sharded": [], "unsharded": []}
        for _ in range(2):
            for name, fn in (("sharded", lambda: render_sharded(params, static, grid32,
                                                                 mesh=mesh)),
                             ("unsharded", lambda: render(params, static, grid32))):
                times[name].append(_host_ms(fn, 10))
    finally:
        torch.distributed.destroy_process_group()
    print(f"  (c) warm 1920x1080 f32 frame (render, no bloom), host clock: 1 rank (nccl) sharded "
          + " / ".join(f"{t:.3f}" for t in times["sharded"]) + " ms, unsharded "
          + " / ".join(f"{t:.3f}" for t in times["unsharded"]) + f" ms (in turns); 2 gloo "
          f"ranks on the one card {two_rank_ms:.3f} ms a frame against {unsharded_2_ms:.3f} ms "
          f"unsharded beside them  [{card}]")
    print(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return {"fit": fit_counts, "render": render_counts}


def main():
    if sys.argv[1:2] == ["_cli"]:
        return _cli_under_torchrun(sys.argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe-parent", metavar="CU",
                    help="another build of the gather probe's source (the same C interface) "
                    "that phase 13 times in turns with the package's")
    args = ap.parse_args()
    # ---- 1. the card --------------------------------------------------
    _banner("1. card")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; "
                           "this script runs only on a CUDA card")
    os.chdir(ROOT)
    from blackstar_tpu_torch import geodesic
    from blackstar_tpu_torch.camera import generate_ray_components
    import yaml

    from blackstar_tpu_torch.cli import fit as cli_fit
    from blackstar_tpu_torch.cli import render as cli_render
    from blackstar_tpu_torch.fit import image_loss, init_train_state, make_train_step
    from blackstar_tpu_torch.geodesic import ESCAPED
    from blackstar_tpu_torch.imageio import encode_rgb8, read_png, write_png
    from blackstar_tpu_torch.ops import bloom_cuda as b5
    from blackstar_tpu_torch.ops import march_adjoint_cuda as b2
    from blackstar_tpu_torch.ops import march_cuda as b1
    from blackstar_tpu_torch.ops.filters import box_blur
    from blackstar_tpu_torch.ops.march_vjp import (march_adjoint_from_checkpoints,
                                                   march_adjoint_reference)
    from blackstar_tpu_torch.parallel.mesh import Mesh
    from blackstar_tpu_torch.parallel.render import shard_pixels
    from blackstar_tpu_torch.render import render, render_image, safe_distance
    from blackstar_tpu_torch.stars import lookup_cuda as b3
    from blackstar_tpu_torch.stars.artifact import ensure_star_grid
    from blackstar_tpu_torch.stars.grid import StarGrid, load_star_grid_compact
    from blackstar_tpu_torch.scripts import (fit_partials, graph_ms, kernel_sass,
                                             march_accuracy, star_rows, step_profile)
    from blackstar_tpu_torch.scripts import probe_dynamic_gather as probe
    from blackstar_tpu_torch.scripts import proto_window_kernel as proto
    from blackstar_tpu_torch.stars import window
    from blackstar_tpu_torch.stars import window_cuda as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = _card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(card)

    # ---- 2. build ------------------------------------------------------
    # One nvcc per source, all started together; beside them B1's, B2's and
    # B3's + B4's cubins with `-Xptxas -v`, for their registers, stack and spills.
    _banner("2. build")
    t0 = time.perf_counter()
    jobs = {"B1 march": b1.LIBRARY.load, "B2 march adjoint": b2.LIBRARY.load,
            "B3 star lookup + B4 star VJP": b3.LIBRARY.load, "B5 bloom": b5.LIBRARY.load,
            "K1 + K2 windowed stage": wk.LIBRARY.load, "gather probe": probe.LIBRARY.load}
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 4) as pool:
        futures = [pool.submit(fn) for fn in jobs.values()]
        cubins = {m: pool.submit(kernel_sass.compile_cubin, m.SOURCE, m.FLAGS)
                  for m in (b1, b2, b3, b5)}
        for fut in futures:
            fut.result()
        ptxas = {m: kernel_sass.resources(fut.result()[0]) for m, fut in cubins.items()}
    print(f"  {len(jobs)} builds and {len(ptxas)} cubins in {time.perf_counter() - t0:.1f} s")

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
        ref64 = _march64(pos0, planes, 480, 270) if dtype == "float32" else None
        torch.cuda.synchronize()
        _check_march(ker, ref, dtype, ref64)

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
        _check_stars(ker, ref, dtype, ", 1920x1080 escaped rays")
        for label, v, act, hints, i, s in _star_cases(dtype, dev):
            ref = grid.lookup(v, i, s, act)
            for hint in hints:
                ker = b3.star_lookup_cuda(grid, v, i, s, act, width=hint)
                torch.cuda.synchronize()
                _check_stars(ker, ref, dtype, f", {label}, width hint {hint}")
        if dtype == "float32":
            grid32 = grid
        del grid, res, vel, ker, ref
        torch.cuda.empty_cache()

    # ---- 5. the slice through the CLI ----------------------------------
    _banner("5. slice: render CLI, scenes/default.yaml 1920x1080 float32")
    b1.march_cuda.launches = 0
    b3.star_lookup_cuda.launches = 0
    b5.bloom_cuda.launches = 0
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
        launches = {"b1": b1.march_cuda.launches, "b3": b3.star_lookup_cuda.launches,
                    "b5": b5.bloom_cuda.launches}
        plain_calls = {"march": geodesic.march.calls, "lookup": StarGrid.lookup.calls}
        print("  | " + log.getvalue().strip().replace("\n", "\n  | "))
        print(f"  CLI run {cli_s:.1f} s (cold: includes loading the star tables), rc {rc}, "
              f"kernel launches {launches}, plain calls {plain_calls}")
        if rc != 0:
            raise AssertionError(f"render CLI returned {rc}")
        if (min(launches.values()) < 1 or launches["b5"] != 1
                or max(plain_calls.values()) != 0):
            raise AssertionError("the render did not go through the kernels alone, bloom through "
                                 "B5 once")
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
        with open(png, "rb") as f:
            png5 = f.read()  # phase 17's sharded render must write these bytes
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
    ref64 = _march64(pos0, planes, 1920, 1080)
    torch.cuda.synchronize()
    print("  B1 at the frame's shape:")
    b1_err, b1_plain_err = _check_march(ker, ref, "float32", ref64)
    del ref64
    b1_ms = _cuda_ms(lambda: b1.march_cuda(pos0, planes, params, static, safe), 10)
    b1_kernel_ms = _kernel_ms(lambda: b1.march_cuda(pos0, planes, params, static, safe),
                              "march_kernel", 10)
    march_ms = _host_ms(lambda: geodesic.march(pos0, stacked, params, static, safe), 2)
    n_rays = 1920 * 1080
    ray_steps = torch.empty((n_rays,), dtype=torch.int32, device=dev)
    b1.march_cuda(pos0, planes, params, static, safe, ray_steps=ray_steps)
    frame_steps = int(ray_steps.sum())
    # 3 direction planes in; velocity, RGBA (7 planes) and status out.
    b1_bound = _bound(n_rays * (10 * 4 + 4), frame_steps * MARCH_OPS_PER_STEP)
    print(f"  B1 work: {frame_steps} advancing ray-steps ({frame_steps / n_rays:.1f} per ray), "
          f"bound {b1_bound[0]:.3f} ms by {b1_bound[1]}")
    # Useful lanes: the steps the rays need over the steps their group runs
    # (each lane as long as the group's longest ray), pixels in row-major order.
    def useful_share(steps, g):
        return frame_steps / (g * steps.view(-1, g).max(dim=1).values.double().sum().item())

    q = torch.quantile(ray_steps[::16].double(), torch.tensor([0.1, 0.9], device=dev, dtype=torch.float64))
    print(f"  useful lanes: warps of 32 neighbouring pixels {useful_share(ray_steps, 32):.4f}, "
          f"blocks of 128 {useful_share(ray_steps, 128):.4f}, warps of rays sorted by steps "
          f"{useful_share(ray_steps.sort().values, 32):.4f}; steps per ray: mean "
          f"{frame_steps / n_rays:.1f}, p10/p90 {q[0].item():.0f}/{q[1].item():.0f}, max "
          f"{int(ray_steps.max())}; truncated {int((ray_steps == static.max_steps).sum())}; "
          f"horizon share {(ker.status == geodesic.HORIZON).double().mean().item():.4f}")

    escaped = ker.status == ESCAPED
    inten, sat = params.stars.intensity, params.stars.saturation
    def b3_call():  # as the frame calls it: all rays, the escaped mask, the width hint
        return b3.star_lookup_cuda(grid32, ker.vel, inten, sat, escaped, width=1920)

    s_ker = b3_call()
    s_ref = grid32.lookup(ker.vel, inten, sat, escaped)
    torch.cuda.synchronize()
    print("  B3 at the frame's shape (all rays, escaped mask, width hint):")
    b3_err = _check_stars(s_ker, s_ref, "float32")
    with _sync_error():
        b3_call()
        b3.star_lookup_cuda(grid32, ker.vel, inten, sat, escaped, clamp=False, width=1920)
    print("  B3's wrapper (clamped and unclamped) ran under sync-debug mode 'error': it "
          "never waited for the card")
    b3_ms = _cuda_ms(b3_call, 10)
    # B3's kernel on the frame and on the band shard rank 0 of two renders
    # (phase 17's deal: rows of bands 0, 2, 4, ...; the frame's own rays,
    # since every stage is per ray), with and without the width hint.
    shard = shard_pixels(1080, 1920, Mesh(rank=0, size=2, device=dev))
    s_vel, s_esc = ker.vel[shard].contiguous(), escaped[shard]
    b3_kms = _kernel_ms_turns({
        "frame": b3_call,
        "shard": lambda: b3.star_lookup_cuda(grid32, s_vel, inten, sat, s_esc, width=1920),
        "shard, no hint": lambda: b3.star_lookup_cuda(grid32, s_vel, inten, sat, s_esc)},
        "star_lookup_kernel", 10)
    b3_kernel_ms = b3_kms["frame"]
    print(f"  B3 kernel (torch.profiler): frame {b3_kernel_ms:.4f} ms; rank 0's band shard of two "
          f"{b3_kms['shard']:.4f} ms with the width hint, {b3_kms['shard, no hint']:.4f} ms "
          f"without  [{card}]")
    lookup_ms = _host_ms(lambda: grid32.lookup(ker.vel, inten, sat, escaped), 2)
    n_escaped = int(escaped.sum())
    star_table_bytes, star_slots = _star_work(grid32, ker.vel, escaped)
    # Escaped rays' directions, the mask, the rows they need; 3 planes out.
    b3_bound = _bound(star_table_bytes + n_escaped * 12 + n_rays + n_rays * 12,
                      star_slots * STAR_OPS_PER_SLOT)
    print(f"  B3 work: {star_table_bytes / 2**20:.1f} MiB of distinct table rows, "
          f"{star_slots} slots scanned, bound {b3_bound[0]:.3f} ms by {b3_bound[1]}")
    print("  distinct table rows one warp load touches (scripts/star_rows.py):")
    star_rows.print_rows(grid32, ker.vel, escaped, 1920, 1080)
    for name, line in ptxas[b3].items():
        print(f"    ptxas -v, {name}: {line}")

    def plain_frame():
        """The same frame through the plain march, lookup and bloom."""
        p0, pl = generate_ray_components(params.camera, 1920, 1080, dtype=dt)
        res = geodesic.march(p0, torch.stack(pl, dim=-1), params, static,
                             safe_distance(params, dt))
        esc = res.status == ESCAPED
        star = grid32.lookup(res.vel, inten, sat, esc)
        rgb = res.acc_rgba[:, :3] + torch.where(esc[:, None], star, 0.0) * (1.0 - res.acc_rgba[:, 3:4])
        img = rgb.reshape(1080, 1920, 3)
        out = img + params.bloom_strength * box_blur(img, 1920 // static.bloom_divider, passes=3)
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
          f"B3 {b3_kernel_ms:.3f} ms (its wrapper {b3_ms - b3_kernel_ms:+.3f} ms)  [{card}]")

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

    # ---- 7. B1's checkpoints and B2 against the plain versions, 480×270 -
    _banner("7. B1 checkpointing variant vs plain checkpointing march; B2 march adjoint "
            "kernel, fed B1's checkpoints, vs plain adjoints; default scene 480x270")
    n_small = 480 * 270
    for dtype in ("float64", "float32"):
        cfg = _scene(480, 270, dtype)
        params, static = cfg.params(dev), cfg.static()
        dt = static.tdtype
        pos0, planes = generate_ray_components(params.camera, 480, 270, dtype=dt)
        stacked = torch.stack(planes, dim=-1)
        kw = march_accuracy.adjoint_args(params, static)
        fwd = b1.march_cuda(pos0, planes, params, static, kw["safe"])
        ckpt, rsteps = _ckpt_buffers(static, n_small, dev)
        fwd_ck = b1.march_cuda(pos0, planes, params, static, kw["safe"], ray_steps=rsteps,
                               checkpoints=ckpt)
        plain = geodesic.march_checkpointed(pos0, stacked, params, static, kw["safe"])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(fwd_ck, fwd)):
            raise AssertionError(f"{dtype}: B1's checkpointing variant changed its outputs")
        _check_checkpoints(ckpt, rsteps, plain, dtype)
        del fwd_ck, plain

        def adjoints(cot_acc, cot_vel, plain_from_ckpt=False):
            adj = dict(h=static.step_size, max_steps=static.max_steps, disk_on=static.disk_on,
                       cot_acc=cot_acc, cot_vel=cot_vel, **kw)
            ker = b2.march_adjoint_cuda(pos0, planes, cot_acc, cot_vel, static=static,
                                        checkpoints=ckpt, ray_steps=rsteps, **kw)
            if plain_from_ckpt:
                return ker, march_adjoint_from_checkpoints(pos0, stacked, ckpt, rsteps, **adj)
            return ker, march_adjoint_reference(pos0, stacked, **adj)

        cot_acc, cot_vel = march_accuracy.cotangents(n_small, 7, dt, dev)
        ker, ref = adjoints(cot_acc, cot_vel)
        print("  B2 vs the plain adjoint from nothing:")
        if dtype == "float64":
            _check_adjoint(ker, ref, fwd.status, dtype)
            print("  B2 vs the plain adjoint from B1's checkpoints:")
            _check_adjoint(ker, adjoints(cot_acc, cot_vel, True)[1], fwd.status, dtype)
        else:
            seeds = range(7, 15)  # 8 sets of cotangents

            def trio(i, keep=None):
                cot = march_accuracy.cotangents(n_small, seeds[i], dt, dev)
                if keep is not None:
                    cot = march_accuracy.masked_cotangents(*cot, keep)
                return (*adjoints(*cot), _adjoint64(pos0, planes, *cot, 480, 270))

            runs = [(ker, ref, _adjoint64(pos0, planes, cot_acc, cot_vel, 480, 270))]
            runs += [trio(i) for i in range(1, len(seeds))]
            _check_adjoint(ker, ref, fwd.status, dtype, runs, trio)
            del runs
        del ker, ref, fwd, ckpt

    # ---- 8. B4 against the plain star VJP, full grid, 1080p escapes ----
    _banner("8. B4 star VJP kernel vs plain star VJP, 470k-star grid, 1920x1080 escaped rays")
    w_np = np.random.default_rng(8).normal(size=(n_rays, 3))
    for dtype in ("float64", "float32"):
        cfg = _scene(1920, 1080, dtype)
        params, static = cfg.params(dev), cfg.static()
        dt = static.tdtype
        grid = grid32 if dtype == "float32" else compact.to_grid(dev, dtype=dt)
        pos0, planes = generate_ray_components(params.camera, 1920, 1080, dtype=dt)
        res = b1.march_cuda(pos0, planes, params, static, safe_distance(params, dt))
        esc = res.status == ESCAPED
        w = torch.from_numpy(w_np).to(dev, dt)
        inten, sat = params.stars.intensity, params.stars.saturation
        ker = b3.star_lookup_vjp_cuda(grid, res.vel, inten, sat, esc, w, width=1920)
        ref = grid.lookup_vjp(res.vel, inten, sat, esc, w)
        torch.cuda.synchronize()
        _check_star_vjp(ker, ref, dtype, int(esc.sum()), ", 1920x1080 frame, width hint 1920")
        for label, v, act, hints, i, s in _star_cases(dtype, dev):
            wc = torch.from_numpy(np.random.default_rng(9).normal(size=(v.shape[0], 3))).to(dev, dt)
            ref = grid.lookup_vjp(v, i, s, act, wc)
            for hint in hints:
                ker = b3.star_lookup_vjp_cuda(grid, v, i, s, act, wc, width=hint)
                torch.cuda.synchronize()
                _check_star_vjp(ker, ref, dtype, int(act.sum()),
                                f", {label}, width hint {hint}")
        del grid, res, ker, ref
        torch.cuda.empty_cache()

    # ---- 9. the training slice through the fit CLI ---------------------
    _banner("9. training slice: fit CLI, scenes/default.yaml 1920x1080 float32, "
            "470k-star sky, disk.outer 13 -> target 12.5")
    fit_dir = os.path.join(ROOT, "build", "chip_smoke_fit")  # gitignored
    os.makedirs(fit_dir, exist_ok=True)
    try:
        cfg_t = _scene(1920, 1080, "float32", disk_outer=12.5)
        target_img = render(cfg_t.params(dev), cfg_t.static(), grid32)  # before bloom
        target_png = os.path.join(fit_dir, "target.png")
        write_png(encode_rgb8(target_img).cpu().numpy(), target_png)
        out_yaml = os.path.join(fit_dir, "fitted.yaml")
        b1.march_cuda.launches = b2.march_adjoint_cuda.launches = 0
        b3.star_lookup_cuda.launches = b3.star_lookup_vjp_cuda.launches = 0
        geodesic.march.calls = march_adjoint_reference.calls = 0
        march_adjoint_from_checkpoints.calls = 0
        StarGrid.lookup.calls = StarGrid.lookup_vjp.calls = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli_fit.main([os.path.join("scenes", "default.yaml"), target_png,
                               "--fit", "disk.outer", "--steps", "5", "--lr", "0.05",
                               "--starmap", grid_path, "--force", "-o", out_yaml])
        fit_s = time.perf_counter() - t0
        fit_launches = {"b1": b1.march_cuda.launches, "b2": b2.march_adjoint_cuda.launches,
                        "b3": b3.star_lookup_cuda.launches,
                        "b4": b3.star_lookup_vjp_cuda.launches}
        fit_plain = {"march": geodesic.march.calls, "adjoint": march_adjoint_reference.calls,
                     "adjoint from checkpoints": march_adjoint_from_checkpoints.calls,
                     "lookup": StarGrid.lookup.calls, "star_vjp": StarGrid.lookup_vjp.calls}
        text = log.getvalue()
        print("  | " + text.strip().replace("\n", "\n  | "))
        print(f"  fit CLI run {fit_s:.1f} s (cold: includes loading the star tables), rc {rc}, "
              f"kernel launches {fit_launches}, plain calls {fit_plain}")
        if rc != 0:
            raise AssertionError(f"fit CLI returned {rc}")
        if min(fit_launches.values()) < 1 or max(fit_plain.values()) != 0:
            raise AssertionError("the fit did not go through the four kernels alone")
        losses = [float(v) for v in re.findall(r"step\s+\d+/\d+\s+loss (\S+)", text)]
        fit9 = {"lines": _loss_lines(text)}  # phase 17's sharded fit must print and write these
        with open(out_yaml, "rb") as f:
            fit9["yaml"] = f.read()
        fitted_outer = yaml.safe_load(open(out_yaml))["scene"]["diskOuter"]
        print(f"  losses {losses}; disk.outer 13 -> {fitted_outer} (target 12.5)")
        if len(losses) != 5 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        if not abs(fitted_outer - 12.5) < 0.5:
            raise AssertionError(f"disk.outer did not move toward 12.5: {fitted_outer}")
    finally:
        shutil.rmtree(fit_dir)

    # ---- 10. training-step times at the 1080p shapes -------------------
    _banner("10. times at the 1920x1080 float32 training shapes")
    cfg = _scene(1920, 1080, "float32")
    params, static = cfg.params(dev), cfg.static()
    dt = static.tdtype
    state = init_train_state(params, 1e-3)  # every leaf trainable
    step_fn = make_train_step(static, grid32)

    def forward():
        return image_loss(state.params, static, target_img, grid32)

    def forward_backward():
        forward().backward()
        state.optimizer.zero_grad(set_to_none=True)

    fwd_ms = _host_ms(forward, 3)
    fwd_bwd_ms = _host_ms(forward_backward, 3)
    step_ms = _host_ms(lambda: step_fn(state, target_img), 3)
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn(state, target_img)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20

    prof = step_profile.profile_steps(lambda: step_fn(state, target_img), 2)
    busy_ms, prof_wall_ms = prof["busy_ms"], prof["wall_ms"]
    print(f"  training step (all 12 leaves trainable): forward {fwd_ms:.3f} ms, forward + "
          f"backward {fwd_bwd_ms:.3f} ms, whole step {step_ms:.3f} ms; peak allocated "
          f"{peak_mib:.0f} MiB  [{card}]")
    print(f"  profile of a step: device busy {busy_ms:.3f} ms, wall {prof_wall_ms:.3f} ms "
          f"under the profiler (idle share {1 - busy_ms / prof_wall_ms:.3f}); by kernel:")
    for name, (ms, _n) in sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"    {ms:9.3f} ms  {name[:100]}")

    pos0, planes = generate_ray_components(params.camera, 1920, 1080, dtype=dt)
    stacked = torch.stack(planes, dim=-1)
    kw = march_accuracy.adjoint_args(params, static)
    fwd = b1.march_cuda(pos0, planes, params, static, kw["safe"])
    ckpt, rsteps = _ckpt_buffers(static, n_rays, dev)
    fwd_ck = b1.march_cuda(pos0, planes, params, static, kw["safe"], ray_steps=rsteps,
                           checkpoints=ckpt)
    plain = geodesic.march_checkpointed(pos0, stacked, params, static, kw["safe"])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(fwd_ck, fwd)):
        raise AssertionError("B1's checkpointing variant changed its outputs at 1080p")
    print("  B1's checkpointing variant at the training shape:")
    _check_checkpoints(ckpt, rsteps, plain, "float32")
    del plain, fwd_ck

    def b1_frame():
        return b1.march_cuda(pos0, planes, params, static, kw["safe"])

    def b1_ckpt():
        return b1.march_cuda(pos0, planes, params, static, kw["safe"], ray_steps=rsteps,
                             checkpoints=ckpt)

    b1_times = {"frame": [], "checkpointing": []}
    for _ in range(2):  # in turns
        for name, fn in (("frame", b1_frame), ("checkpointing", b1_ckpt)):
            b1_times[name].append(_kernel_ms(fn, "march_kernel", 10))
    b1_ckpt_ms = _cuda_ms(b1_ckpt, 10)
    b1_ckpt_kernel_ms = sum(b1_times["checkpointing"]) / 2
    print("  B1 kernel, frame variant " + " / ".join(f"{t:.3f}" for t in b1_times["frame"])
          + " ms, checkpointing variant " + " / ".join(f"{t:.3f}" for t in b1_times["checkpointing"])
          + f" ms (in turns; wrapper {b1_ckpt_ms:.3f} ms)  [{card}]")
    for name, line in ptxas[b1].items():
        print(f"    ptxas -v, {name}: {line}")

    cot_acc, cot_vel = march_accuracy.cotangents(n_rays, 10, dt, dev)

    # Both bind the 1080p rays and scene now: phase 18 calls them again.
    def b2_call(cot_acc=cot_acc, cot_vel=cot_vel, pos0=pos0, planes=planes, static=static,
                ckpt=ckpt, rsteps=rsteps, kw=kw):
        return b2.march_adjoint_cuda(pos0, planes, cot_acc, cot_vel, static=static,
                                     checkpoints=ckpt, ray_steps=rsteps, **kw)

    def plain_adjoint(cot_acc, cot_vel, chunk=1 << 18, pos0=pos0, stacked=stacked,
                      static=static, kw=kw):
        return march_adjoint_reference(pos0, stacked, h=static.step_size,
                                       max_steps=static.max_steps, disk_on=static.disk_on,
                                       cot_acc=cot_acc, cot_vel=cot_vel, chunk=chunk, **kw)

    ker = b2_call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain_adjoint(cot_acc, cot_vel)
    torch.cuda.synchronize()
    adjoint_ms = (time.perf_counter() - t0) * 1e3
    b2_ms = _cuda_ms(b2_call, 5)
    b2_kernel_ms = _kernel_ms(b2_call, "march_adjoint_kernel", 5)

    def b2_gate(ker=ker, ref=ref, status=fwd.status, cot=(cot_acc, cot_vel), pos0=pos0,
                planes=planes, dt=dt, b2_call=b2_call, plain_adjoint=plain_adjoint):
        """B2 held as in phase 7, over 4 sets of cotangents (seeds 10-13): run
        last, after every profile (the plain adjoints' millions of launches
        left the profiler blind to B2 when they ran before it)."""
        seeds = range(10, 14)

        def trio(i, keep=None):
            c = march_accuracy.cotangents(n_rays, seeds[i], dt, dev)
            if keep is not None:
                c = march_accuracy.masked_cotangents(*c, keep)
            return (b2_call(*c), plain_adjoint(*c, chunk=1 << 20),
                    _adjoint64(pos0, planes, *c, 1920, 1080))

        runs = [(ker, ref, _adjoint64(pos0, planes, *cot, 1920, 1080))]
        runs += [trio(i) for i in range(1, len(seeds))]
        return _check_adjoint(ker, ref, status, "float32", runs, trio)

    # 3 direction and 7 cotangent planes in; 3 gradient planes and status out.
    b2_bound = _bound(n_rays * (13 * 4 + 4), frame_steps * ADJOINT_OPS_PER_STEP)
    del ker, ref
    smem = geodesic.SEG_LEN * geodesic.CKPT_VALUES * b2.THREADS  # elements a block
    print(f"  B2: {b2.THREADS} threads a block; its replay array takes {smem * 4} B (f32) and "
          f"{smem * 8} B (f64) of shared memory a block, which leave room for "
          f"{233472 // (smem * 4 + 1024)} and {233472 // (smem * 8 + 1024)} blocks an SM "
          "(228 KB, 1 KB reserved a block)")
    for name, line in ptxas[b2].items():
        print(f"    ptxas -v, {name}: {line}")

    escaped = fwd.status == ESCAPED
    inten, sat = params.stars.intensity, params.stars.saturation
    w = torch.from_numpy(w_np).to(dev, dt)

    def b4_call():  # as the training step calls it, with the width hint
        return b3.star_lookup_vjp_cuda(grid32, fwd.vel, inten, sat, escaped, w, width=1920)

    s_ker = b4_call()
    with _sync_error():
        b4_call()
    print("  B4's wrapper ran under sync-debug mode 'error': it never waited for the card")
    for name, line in ptxas[b3].items():
        print(f"    ptxas -v, {name}: {line}")
    s_ref = grid32.lookup_vjp(fwd.vel, inten, sat, escaped, w)
    torch.cuda.synchronize()
    print("  B4 at the training shape (all rays, escaped mask, seeded random cotangents):")
    b4_err = _check_star_vjp(s_ker, s_ref, "float32", int(escaped.sum()))
    b4_ms = _cuda_ms(b4_call, 10)
    b4_kernel_ms = _kernel_ms(b4_call, "star_vjp_kernel", 10)
    star_vjp_ms = _host_ms(lambda: grid32.lookup_vjp(fwd.vel, inten, sat, escaped, w), 2)
    # The rows B3 needs; escaped rays' directions and cotangents, the mask;
    # 3 gradient planes out.
    b4_bound = _bound(star_table_bytes + n_escaped * 24 + n_rays + n_rays * 12,
                      star_slots * STAR_OPS_PER_SLOT)
    for what, ms, kms, plain, bound in (
            ("B2 march adjoint", b2_ms, b2_kernel_ms, adjoint_ms, b2_bound),
            ("B4 star VJP", b4_ms, b4_kernel_ms, star_vjp_ms, b4_bound)):
        print(f"  {what}: wrapper {ms:.3f} ms, kernel {kms:.3f} ms, plain {plain:.3f} ms, "
              f"bound {bound[0]:.3f} ms by {bound[1]}  [{card}]")

    # ---- 11. the windowed stage on the prototype's synthetic grid -------
    _banner("11. windowed star stage K1 + K2 vs plain passes, the prototype's synthetic grid")
    shade = (proto.INTENSITY, proto.SATURATION)
    for dtype, n_tiles in ((torch.float64, 4), (torch.float32, 507)):
        sgrid, sv, sesc = proto.synthetic_case(n_tiles, dtype, dev)
        inp = window.stage_inputs(sv, sesc, sgrid)  # one pre-pass for both
        ker = window.run_passes(inp, sgrid, *shade, wk.k1_cuda, wk.k2_cuda)
        ref = window.run_passes(inp, sgrid, *shade, window.k1_reference, window.k2_reference)
        torch.cuda.synchronize()
        print(f"  {dtype}, {n_tiles} tiles: covered {ker.covered.double().mean().item():.4f}, "
              f"ovf_missed {ker.ovf_missed.double().mean().item():.4f}, "
              f"rays with an overflow row {int((ker.optr > 0).sum())}")
        proto.compare_passes(ker, ref, dtype)
        if dtype == torch.float64:
            look = sgrid.lookup(sv, *(torch.tensor(x, dtype=dtype) for x in shade), sesc)
            m = ker.covered & ~ker.ovf_missed
            d = (ker.rgb[m] - look[m]).abs().max().item()
            print(f"  float64 stage vs plain per-ray lookup (covered, not missed): max |d| {d:.3e}")
            torch.testing.assert_close(ker.rgb[m], look[m], rtol=0, atol=1e-9)
        del sgrid, sv, sesc, inp, ker, ref
    torch.cuda.empty_cache()
    for f in (wk.k1_cuda, wk.k2_cuda):
        f.launches = 0
    window.k1_reference.calls = window.k2_reference.calls = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        proto_res = proto.main([])
    print("  | " + log.getvalue().strip().replace("\n", "\n  | "))
    window_path = proto_res["path"]
    print(f"  entry point run {time.perf_counter() - t0:.1f} s; the stage's run: {window_path}; "
          f"after the whole run: K1 {wk.k1_cuda.launches}, K2 {wk.k2_cuda.launches} launches")
    if (min(window_path["k1 launches"], window_path["k2 launches"]) < 1
            or max(window_path["k1 plain calls"], window_path["k2 plain calls"]) != 0
            or min(wk.k1_cuda.launches, wk.k2_cuda.launches) < 1):
        raise AssertionError("the windowed stage did not go through K1 and K2 alone")

    # ---- 12. the windowed stage on the 1080p frame ----------------------
    _banner("12. windowed star stage on the 1920x1080 frame's rays, 470k-star grid, float32")
    cfg = _scene(1920, 1080, "float32")
    params, static = cfg.params(dev), cfg.static()
    dt = static.tdtype
    pos0, planes = generate_ray_components(params.camera, 1920, 1080, dtype=dt)
    res = b1.march_cuda(pos0, planes, params, static, safe_distance(params, dt))
    n_tiles = -(-n_rays // window.T)
    n_pad = n_tiles * window.T - n_rays
    # Pad to whole tiles with non-escaped rays along the last ray's direction.
    fv = torch.cat([res.vel, res.vel[-1:].expand(n_pad, 3)])
    fesc = torch.cat([res.status == ESCAPED, torch.zeros((n_pad,), dtype=torch.bool, device=dev)])
    inten, sat = params.stars.intensity, params.stars.saturation
    fshade = (float(inten), float(sat))
    for f in (wk.k1_cuda, wk.k2_cuda):
        f.launches = 0
    window.k1_reference.calls = window.k2_reference.calls = 0
    w_rgb, w_cov, w_missed = window.window_stage(fv, fesc, grid32, *fshade)
    frame_counts = proto.counts()
    print(f"  {n_rays} rays + {n_pad} padding = {n_tiles} tiles; the stage's run: {frame_counts}")
    if (min(frame_counts["k1 launches"], frame_counts["k2 launches"]) < 1
            or max(frame_counts["k1 plain calls"], frame_counts["k2 plain calls"]) != 0):
        raise AssertionError("the frame's windowed stage did not go through K1 and K2 alone")
    n_esc = int(fesc.sum())
    coverage = int(w_cov.sum()) / n_esc
    missed_share = int(w_missed.sum()) / n_esc
    print(f"  escaped rays {n_esc}: covered {coverage:.4f}, ovf_missed {missed_share:.4f} "
          f"(of the escaped rays)")
    inp = window.stage_inputs(fv, fesc, grid32)
    ker = window.run_passes(inp, grid32, *fshade, wk.k1_cuda, wk.k2_cuda)
    ref = window.run_passes(inp, grid32, *fshade, window.k1_reference, window.k2_reference)
    torch.cuda.synchronize()
    proto.compare_passes(ker, ref, torch.float32)
    b3_rgb = b3.star_lookup_cuda(grid32, fv, inten, sat, fesc)
    m = w_cov & ~w_missed
    proto.f32_gate("stage vs B3 (covered, not missed)", w_rgb[m], b3_rgb[m])
    s2 = ker.s2
    del ker, ref, b3_rgb

    consts = grid32.psf_constants(dt)
    tbl3 = grid32.cell_data.reshape(grid32.n_rings, grid32.n_cols, -1)
    ovf_tbl, octets, _ = window.overflow_tables(grid32)
    k1_args = (inp.starts, inp.widx, inp.covered, inp.rx, inp.ry, inp.rz, tbl3, consts, *fshade)
    k1_out = wk.k1_cuda(*k1_args)
    k1_ref = window.k1_reference(*k1_args)
    cov = inp.covered
    k1_err = max((a[cov] - b[cov]).abs().max().item() for a, b in zip(k1_out[:3], k1_ref[:3]))
    if not torch.equal(k1_out[3][cov], k1_ref[3][cov]):
        raise AssertionError("K1's pointers differ from the plain pass's on covered rays")
    optr = torch.where(cov, k1_out[3], 0)
    k2_args = (s2, optr, cov, inp.rx, inp.ry, inp.rz, ovf_tbl, octets, consts, *fshade)
    k2_out = wk.k2_cuda(*k2_args)
    k2_ref = window.k2_reference(*k2_args)
    k2_err = max((a - b).abs().max().item() for a, b in zip(k2_out, k2_ref))
    print(f"  K1 vs plain (covered rays) max |d| {k1_err:.3e}; K2 vs plain max |d| {k2_err:.3e}")
    if max(k1_err, k2_err) > 3e-2:
        raise AssertionError("K1 or K2 differs from its plain pass beyond 3e-2")
    k1_ms = _cuda_ms(lambda: wk.k1_cuda(*k1_args), 10)
    k1_kernel_ms = _kernel_ms(lambda: wk.k1_cuda(*k1_args), "k1_kernel", 10)
    k1_plain_ms = _host_ms(lambda: window.k1_reference(*k1_args), 2)
    k2_ms = _cuda_ms(lambda: wk.k2_cuda(*k2_args), 10)
    k2_kernel_ms = _kernel_ms(lambda: wk.k2_cuda(*k2_args), "k2_kernel", 10)
    k2_plain_ms = _host_ms(lambda: window.k2_reference(*k2_args), 2)
    # The probe's graph clock (100 calls in one CUDA graph, replayed warm).
    k1_graph_ms = graph_ms(lambda: wk.k1_cuda(*k1_args), 100)
    k2_graph_ms = graph_ms(lambda: wk.k2_cuda(*k2_args), 100)
    stage_ms = _cuda_ms(lambda: window.window_stage(fv, fesc, grid32, *fshade), 10)
    frame_b3_ms = _cuda_ms(lambda: b3.star_lookup_cuda(grid32, fv, inten, sat, fesc), 10)
    prof = step_profile.profile_steps(lambda: window.window_stage(fv, fesc, grid32, *fshade), 3)
    n_launch = sum(n for _, n in prof["by_kernel"].values())
    print(f"  profile of the stage: device busy {prof['busy_ms']:.3f} ms in "
          f"{n_launch / 3:.0f} device operations, wall {prof['wall_ms']:.3f} ms under the "
          f"profiler; largest:")
    for name, (ms, _n) in sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {ms:9.4f} ms  {name[:100]}")
    dec = torch.rad2deg(torch.asin(inp.rz[fesc].double()))
    print(f"  escaped rays' declination: median {dec.median().item():.1f} deg, share above "
          f"60 deg {(dec > 60).double().mean().item():.4f}")

    # Bounds from this run's data. K1: the cover mask of every ray, the
    # direction and window index of the covered rays, the tile starts and
    # the distinct base rows of the covered rays' cells; out, every ray's
    # colour and pointer. K2: the cover mask of every ray, the pointers of
    # the covered ones, the directions of the taking-part rays, the window
    # starts and the used octets of the distinct overflow rows they read;
    # out, every ray's colour.
    esz = grid32.cell_data.element_size()
    n_all = fv.shape[0]
    t_of = torch.arange(n_all, device=dev) // window.T
    w = inp.widx.long()
    cells = ((inp.starts[t_of, 0].long() + w // window.DC) * grid32.n_cols
             + inp.starts[t_of, 1].long() + w % window.DC)[cov]
    n_cov = int(cov.sum())
    k1_bytes = (n_all + n_cov * (3 * esz + 4) + n_tiles * 8
                + torch.unique(cells).numel() * grid32.cell_data.shape[1] * esz
                + n_all * (3 * esz + 4))
    k1_bound = _bound(k1_bytes, n_cov * grid32.pad_k * STAR_OPS_PER_SLOT)
    s_ray = s2.repeat_interleave(window.T)
    part = cov & (optr > 0) & (optr >= s_ray) & (optr < s_ray + window.OVW)
    octs = octets.long()
    k2_rows = torch.unique(optr[part].long())
    k2_bytes = (n_all + n_cov * 4 + int(part.sum()) * 3 * esz + n_tiles * 4
                + int(octs[k2_rows].sum()) * 8 * window.ROW * esz + n_all * 3 * esz)
    k2_bound = _bound(k2_bytes, int((octs[optr[part].long()] * 8).sum()) * STAR_OPS_PER_SLOT)
    print(f"  work: K1 {n_cov} covered rays, {torch.unique(cells).numel()} distinct base rows; "
          f"K2 {int(part.sum())} rays with an overflow row in their window, {k2_rows.numel()} "
          f"distinct overflow rows")
    for what, ms, kms, gms, plain, bound in (
            ("K1", k1_ms, k1_kernel_ms, k1_graph_ms, k1_plain_ms, k1_bound),
            ("K2", k2_ms, k2_kernel_ms, k2_graph_ms, k2_plain_ms, k2_bound)):
        print(f"  {what}: wrapper {ms:.3f} ms, kernel {kms:.4f} ms (profiler) / {gms:.4f} ms "
              f"(graph clock), plain {plain:.3f} ms, bound {bound[0]:.4f} ms by {bound[1]}  "
              f"[{card}]")
    print(f"  windowed stage (pre-pass, K1, K2, glue) {stage_ms:.3f} ms against B3 {frame_b3_ms:.3f} "
          f"ms on the same {n_all} rays; coverage {coverage:.4f} of the escaped rays  [{card}]")
    del inp, k1_out, k1_ref, k2_out, k2_ref, w_rgb, fv
    torch.cuda.empty_cache()

    # ---- 13. the dynamic-gather probe ------------------------------------
    _banner("13. dynamic-gather probe through its entry point")
    for f, _plain in probe.WRAPPERS.values():
        f.launches = 0
        _plain.calls = 0
    probe_argv = []
    if args.probe_parent:
        probe_argv = ["--source", args.probe_parent, "--source", probe.SOURCE]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        probe_results, probe_path = probe.main(probe_argv)
    print("  | " + log.getvalue().strip().replace("\n", "\n  | "))
    for name in probe.WRAPPERS:
        if probe_path[f"{name} launches"] < 1 or probe_path[f"{name} plain calls"] != 0:
            raise AssertionError(f"the probe's {name} did not run through its kernel alone")
    probe_entries = []
    for name, (wrapper, _plain) in probe.WRAPPERS.items():
        if wrapper.launches < 1:
            raise AssertionError(f"the probe's {name} kernel was never launched")
        largest = [r for r in probe_results if r["kernel"] == name][-1]
        bound = _bound(largest["bytes"], 0)
        print(f"  {name} at {largest['size'].strip()} (graph clock): kernel "
              f"{largest['kernel_ms']:.5f} ms, floor {largest['floor_ms']:.5f}, plain "
              f"{largest['plain_ms']:.5f}, library {largest['library_ms']:.5f}, bound "
              f"{bound[0]:.5f} ms by bytes; wrapper {largest['ms']:.5f} ms a host call  [{card}]")
        probe_entries.append({
            "name": f"{name} (probe)", "route": "cuda",
            "source": "blackstar_tpu_torch/scripts/csrc/probe_dynamic_gather.cu",
            "replaces": PROBE_REPLACES[name], "launches": probe_path[f"{name} launches"],
            "max_abs_err": 0.0, "size": largest["size"].strip(), "ms": largest["ms"],
            "kernel_ms": largest["kernel_ms"], "floor_ms": largest["floor_ms"],
            "plain_ms": largest["plain_ms"], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": largest["library_ms"]})

    # ---- 14. the animation through its CLI -------------------------------
    ani_launches = _animation_phase(dev, grid32)

    # ---- 15. all nine scenes ---------------------------------------------
    scene_launches = _scenes_phase(dev, grid32, card)

    # ---- 16. the star build side -----------------------------------------
    _star_build_phase(grid_path)

    # ---- 17. the sharded slice ------------------------------------------
    sharded = _sharded_phase(dev, grid32, grid_path, card, png5, fit9, target_img)

    # ---- 18. B2's float32 gate at the training shape ---------------------
    _banner("18. B2 march adjoint kernel vs plain adjoints at the 1920x1080 float32 training "
            "shape, 4 sets of seeded random cotangents")
    torch.cuda.empty_cache()
    print("  B2 at the training shape (B1's checkpoints):")
    b2_err, b2_plain_err = b2_gate()

    # ---- 19. B2's float32 gradient gate at shared parameters -------------
    _banner("19. B2's float32 gradient gate: B2 f32 against the plain f32 adjoint, each against "
            "B2 f64, at 1920x1080 at the starts of three fits and iterates 5 and 10 of one")
    torch.cuda.empty_cache()
    grid64 = compact.to_grid(dev, dtype=torch.float64)
    gate = fit_partials.gradient_gate({torch.float32: grid32, torch.float64: grid64}, dev)
    if not gate["held"]:
        raise AssertionError("B2's float32 gradient misses the float64 one by more than "
                             f"{fit_partials.GATE_MARGIN} x the plain float32 adjoint's + "
                             f"{fit_partials.GATE_ATOL}: "
                             + "; ".join(f"{p}, {leaf}: B2 {a:.4e}, plain {b:.4e}"
                                         for p, leaf, a, b in gate["failures"]))
    del grid64

    # ---- 20. the bloom kernel B5 -----------------------------------------
    b5_entry = _bloom_phase(dev, grid32, card)
    b5_entry.update(launches_render=launches["b5"], launches_animation=ani_launches["b5"])

    # ---- results -------------------------------------------------------
    kernels = [
        {"name": "march (B1)", "route": "cuda",
         "source": "blackstar_tpu_torch/ops/csrc/march.cu",
         "replaces": "blackstar_tpu/ops/march_pallas.py:104",
         "launches": fit_launches["b1"], "launches_render": launches["b1"],
         "launches_animation": ani_launches["b1"], "launches_scenes": scene_launches["b1"],
         "launches_sharded": sharded["fit"]["b1"],
         "launches_sharded_render": sharded["render"]["b1"], "max_abs_err": b1_err,
         "plain_max_abs_err": b1_plain_err,
         "ms": b1_ms, "kernel_ms": b1_kernel_ms, "plain_ms": march_ms,
         "ckpt_ms": b1_ckpt_ms, "ckpt_kernel_ms": b1_ckpt_kernel_ms,
         "bound_ms": b1_bound[0], "bound_by": b1_bound[1], "library_ms": None},
        {"name": "march adjoint (B2)", "route": "cuda",
         "source": "blackstar_tpu_torch/ops/csrc/march_adjoint.cu",
         "replaces": "blackstar_tpu/ops/march_adjoint_pallas.py:92",
         "launches": fit_launches["b2"], "launches_sharded": sharded["fit"]["b2"],
         "max_abs_err": b2_err,
         "plain_max_abs_err": b2_plain_err,
         "ms": b2_ms,
         "kernel_ms": b2_kernel_ms, "plain_ms": adjoint_ms,
         "bound_ms": b2_bound[0], "bound_by": b2_bound[1], "library_ms": None},
        {"name": "star lookup (B3)", "route": "cuda",
         "source": "blackstar_tpu_torch/stars/csrc/star_lookup.cu",
         "replaces": "blackstar_tpu/stars/grid.py:717",
         "launches": fit_launches["b3"], "launches_render": launches["b3"],
         "launches_animation": ani_launches["b3"], "launches_scenes": scene_launches["b3"],
         "launches_sharded": sharded["fit"]["b3"],
         "launches_sharded_render": sharded["render"]["b3"], "max_abs_err": b3_err,
         "ms": b3_ms, "kernel_ms": b3_kernel_ms,
         "kernel_ms_band_shard": b3_kms["shard"],
         "kernel_ms_band_shard_no_hint": b3_kms["shard, no hint"], "plain_ms": lookup_ms,
         "ptxas": ptxas[b3].get("star_lookup_kernel<float>"),
         "bound_ms": b3_bound[0], "bound_by": b3_bound[1], "library_ms": None},
        {"name": "star VJP (B4)", "route": "cuda",
         "source": "blackstar_tpu_torch/stars/csrc/star_lookup.cu",
         "replaces": "blackstar_tpu/stars/grid.py:377",
         "launches": fit_launches["b4"], "launches_sharded": sharded["fit"]["b4"],
         "max_abs_err": b4_err, "ms": b4_ms,
         "ptxas": ptxas[b3].get("star_vjp_kernel<float>"),
         "kernel_ms": b4_kernel_ms, "plain_ms": star_vjp_ms,
         "bound_ms": b4_bound[0], "bound_by": b4_bound[1], "library_ms": None},
        {"name": "windowed stage base pass (K1)", "route": "cuda",
         "source": "blackstar_tpu_torch/stars/csrc/star_window.cu",
         "replaces": "scripts/proto_window_kernel.py:102",
         "launches": window_path["k1 launches"], "launches_frame": frame_counts["k1 launches"],
         "max_abs_err": k1_err, "ms": k1_ms, "kernel_ms": k1_kernel_ms,
         "graph_ms": k1_graph_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "windowed stage overflow pass (K2)", "route": "cuda",
         "source": "blackstar_tpu_torch/stars/csrc/star_window.cu",
         "replaces": "scripts/proto_window_kernel.py:136",
         "launches": window_path["k2 launches"], "launches_frame": frame_counts["k2 launches"],
         "max_abs_err": k2_err, "ms": k2_ms, "kernel_ms": k2_kernel_ms,
         "graph_ms": k2_graph_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
        b5_entry,
        *probe_entries,
    ]
    print()
    print(_card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
