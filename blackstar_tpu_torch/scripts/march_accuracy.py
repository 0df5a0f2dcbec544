"""The float32 accuracy gates of the march kernels B1 and B2.

B1 and B2 take r⁻⁵ by ``rsqrt`` powers and fuse multiply-adds
(``ops/csrc/march_step.cuh``); the plain march divides and fuses nothing.
In float32 the two round apart, and near the photon ring a few rays follow
other orbits: there the plain float32 march itself misses the float64 march
by far more than 2e-4 in RGBA. So a float32 kernel is not held to the plain float32
march, which holds only where the two round alike, but to the plain float64
march of the same rays, no worse than the plain float32 march is held to it.

:func:`march_gate` holds B1's float32 result (a ``MarchResult``):

(a) its status mismatches with float64 are at most the plain march's +
    1e-4·n;
(b) on the rays whose status agrees with float64 for both marches, the
    count of rays with max |ΔRGBA| > 2e-4 is at most 2 × the plain's + 10;
(c) on the same rays, |ΔRGBA| at p99.9 is at most 2 × the plain's + 1e-6;
(d) on those of them that escaped, the escape-direction error at p99.9 is
    at most 2 × the plain's + 1e-6, and the count over 2e-4 at most 2 × the
    plain's + 10;
(e) the executed step count (the longest-lived ray's) is within 2 of the
    plain march's, or no farther from the float64 march's than the plain
    march's is, + 2: the longest-lived ray can be one that both float32
    marches classify otherwise than float64 (``scenes/fartheraway.yaml`` at
    3840×2160: a ray float64 captures at step 256 escapes after 566 steps
    in B1 and 572 in the plain float32 march).

:func:`checkpoint_gate` holds B1's checkpoints and per-ray step counts to
the plain checkpointing march's: in float64, equal counts on all but 1e-4
of the rays and the written checkpoints of the others within
1e-7·max(1, |value|); in float32, at most 1e-3 of the rays with other
counts, at most 10 of them by more than 1.

:func:`adjoint_gate` holds B2's float32 gradients (an ``AdjointGrads``) to
the plain float64 adjoint of the same rays and cotangents, no worse than
the plain float32 adjoint is held to it:

(a) status mismatches at most the plain's + 1e-4·n;
(b) on the rays whose status agrees for both, the count of rays whose
    direction gradient misses float64 by more than 2e-4·|g| + 2e-5 (in
    any component) at most 1.25 × the plain's + 10 (the two counts were
    within 3% of each other over 8 cotangent seeds at 480×270 and 6 at
    1920×1080, 1.0-1.1k and 16.8-17.3k rays);
(c) each of the 10 scene partials (mass, inner, outer, opacity, disk RGB,
    camera position), summed over the rays on which both float32 adjoints
    agree with float64 (their status, and their direction gradient within
    (b)'s tolerance, for that set of cotangents): over several sets of
    cotangents, the kernel's RMS miss of float64's sum is at most 2 × the
    plain's RMS miss + 2e-4·σ + 2e-5·max σ, element by element, where σ is
    the RMS of float64's sums (the original float32 gate on the partials,
    rtol 2e-4 with a floor of 2e-5·max, taken against float64 and no worse
    than the plain).

(a) and (b) hold for every set of cotangents.

The partials are sums over all rays, and over all rays they are set by the
few whose float32 orbits part from float64's near the photon ring (those
are other rays in the two float32 adjoints): there both float32 adjoints
miss float64's mass partial by most of its value at 1920×1080. So (c)
sums over the rays that agree, which ``rerun`` computes again with the
cotangents of every other ray set to 0 (each partial is linear in them).
Over those rays a sum's float32 miss is itself a sum of many rounding
errors, as large as 4 × 2e-4 of the sum in one reading where the sum
cancels, so (c) takes the RMS over several cotangent sets, and σ does not
cancel. Which rays agree depends on the cotangents (a ray whose orbit
parts can pass (b)'s test under one set by chance), so each set has its
own mask: at 1920×1080 one mask for six sets let such rays in and raised
the RMS misses 15-50-fold. The RMS misses over all rays are reported
beside, for both.

Run on a card, ``python -m blackstar_tpu_torch.scripts.march_accuracy``
reads :func:`adjoint_gate` over several cotangent seeds at 480×270 and
1920×1080 (the readings behind its limits; see ``--help``).

Each gate returns the statistics of both float32 results and the list of
the clauses that failed (empty when it passes).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from blackstar_tpu_torch.geodesic import ESCAPED, SEG_LEN

RGBA_TOL = 2e-4  # a ray's RGBA is off beyond this
DIR_TOL = 2e-4  # an escape direction is off beyond this
QUANTILE = 0.999
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5  # a gradient is off beyond rtol·|g| + atol
PART_RTOL, PART_FLOOR = 2e-4, 2e-5  # a partial is off beyond rtol·|v| + floor·max|v|
SCALARS = ("mass", "inner", "outer", "opacity", "disk_rgb", "pos0")


def quantile(x: torch.Tensor, q: float = QUANTILE) -> float:
    """The value below which a share ``q`` of ``x`` lies (0 for no values)."""
    n = x.numel()
    if n == 0:
        return 0.0
    return x.flatten().sort().values[min(n - 1, max(0, math.ceil(q * n) - 1))].item()


class MarchStats(NamedTuple):
    """One float32 march against the float64 march of the same rays."""

    status_mismatches: int
    rgba_over: int
    rgba_p999: float
    rgba_max: float
    dir_over: int
    dir_p999: float
    dir_max: float
    steps: int

    def line(self) -> str:
        return (f"status mismatches {self.status_mismatches}, rays with |dRGBA| > {RGBA_TOL:g} "
                f"{self.rgba_over}, |dRGBA| p99.9 {self.rgba_p999:.3g} max {self.rgba_max:.3g}, "
                f"escape direction p99.9 {self.dir_p999:.3g} max {self.dir_max:.3g} over "
                f"{DIR_TOL:g} {self.dir_over}, steps {self.steps}")


def _march_stats(res, ref, common) -> MarchStats:
    rgba = (res.acc_rgba[common].double() - ref.acc_rgba[common].double()).abs().amax(dim=-1)
    esc = common & (ref.status == ESCAPED)
    kd = torch.nn.functional.normalize(res.vel[esc].double(), dim=-1)
    rd = torch.nn.functional.normalize(ref.vel[esc].double(), dim=-1)
    dirs = (kd - rd).norm(dim=-1)
    return MarchStats(
        status_mismatches=int((res.status != ref.status).sum()),
        rgba_over=int((rgba > RGBA_TOL).sum()), rgba_p999=quantile(rgba),
        rgba_max=rgba.max().item() if rgba.numel() else 0.0,
        dir_over=int((dirs > DIR_TOL).sum()), dir_p999=quantile(dirs),
        dir_max=dirs.max().item() if dirs.numel() else 0.0, steps=int(res.steps))


def march_gate(ker, plain, ref64):
    """Hold the float32 march ``ker`` to ``ref64``, the float64 march of the
    same rays, no worse than the plain float32 march ``plain`` is. Returns
    (kernel's stats, plain's stats, failed clauses)."""
    n = ref64.status.numel()
    common = (ker.status == ref64.status) & (plain.status == ref64.status)
    k, p = _march_stats(ker, ref64, common), _march_stats(plain, ref64, common)
    failed = []
    if k.status_mismatches > p.status_mismatches + 1e-4 * n:
        failed.append(f"(a) status mismatches {k.status_mismatches} > {p.status_mismatches} "
                      f"+ 1e-4 n")
    if k.rgba_over > 2 * p.rgba_over + 10:
        failed.append(f"(b) rays over {RGBA_TOL:g} RGBA {k.rgba_over} > 2 x {p.rgba_over} + 10")
    if k.rgba_p999 > 2 * p.rgba_p999 + 1e-6:
        failed.append(f"(c) |dRGBA| p99.9 {k.rgba_p999:.3g} > 2 x {p.rgba_p999:.3g} + 1e-6")
    if k.dir_p999 > 2 * p.dir_p999 + 1e-6:
        failed.append(f"(d) escape direction p99.9 {k.dir_p999:.3g} > 2 x {p.dir_p999:.3g} "
                      "+ 1e-6")
    if k.dir_over > 2 * p.dir_over + 10:
        failed.append(f"(d) escape directions over {DIR_TOL:g} {k.dir_over} > 2 x "
                      f"{p.dir_over} + 10")
    s64 = int(ref64.steps)
    if abs(k.steps - p.steps) > 2 and abs(k.steps - s64) > abs(p.steps - s64) + 2:
        failed.append(f"(e) steps {k.steps} vs the plain march's {p.steps} and the float64 "
                      f"march's {s64}")
    return k, p, failed


def checkpoint_gate(ckpt, ray_steps, plain):
    """Hold B1's checkpoints ``ckpt`` (n_seg, 7, N) and advancing counts
    ``ray_steps`` to ``plain``, the plain checkpointing march of the same
    rays in the same dtype. Returns (summary line, failed clauses)."""
    n = ray_steps.numel()
    d = (ray_steps.long() - plain.ray_steps.long()).abs()
    differ, by_more = int((d > 0).sum()), int((d > 1).sum())
    line = (f"ray_steps differ on {differ} of {n} rays ({by_more} by more than 1), "
            f"sum {int(ray_steps.sum())} vs {int(plain.ray_steps.sum())}")
    failed = []
    if ckpt.dtype == torch.float64:
        if differ > 1e-4 * n:
            failed.append(f"ray_steps differ on {differ} rays > 1e-4 n")
        starts = torch.arange(ckpt.shape[0], device=ckpt.device) * SEG_LEN
        written = ((ray_steps[None, :] > starts[:, None]) & (d == 0)[None, :])[:, None, :]
        want = plain.checkpoints
        err = torch.where(written, (ckpt - want).abs() / want.abs().clamp_min(1.0), 0)
        worst = err.max().item() if err.numel() else 0.0
        line += f"; {int(written.sum()) * ckpt.shape[1]} checkpoint values, max rel. |d| {worst:.3g}"
        if worst > 1e-7:
            failed.append(f"checkpoints differ by {worst:.3g} > 1e-7 max(1, |value|)")
    else:
        if differ > 1e-3 * n:
            failed.append(f"ray_steps differ on {differ} rays > 1e-3 n")
        if by_more > 10:
            failed.append(f"ray_steps differ by more than 1 on {by_more} rays > 10")
    return line, failed


class AdjointStats(NamedTuple):
    """One float32 adjoint against the float64 adjoint of the same rays,
    over several sets of cotangents."""

    status_mismatches: tuple  # per set
    rays_over: tuple  # per set
    grad_max: float  # max |d| of the direction gradients
    partial_err: dict  # name -> RMS |d| of the partial over all rays (max over elements)
    agree_err: dict  # name -> RMS |d| of the partial over the agreeing rays (max over elements)
    agree_tol: dict  # name -> that |d| over 2e-4·σ + 2e-5·max σ (max over elements)
    margin: dict = None  # the kernel's: name -> |d| over clause (c)'s limit (max over elements)

    def line(self) -> str:
        parts = ", ".join(
            f"{k} {self.agree_err[k]:.3g} ({self.agree_tol[k]:.3g} x tol"
            + ("" if self.margin is None else f", {self.margin[k]:.3g} x limit") + ")"
            for k in SCALARS)
        return (f"status mismatches {'/'.join(map(str, self.status_mismatches))}, rays over "
                f"the gradient gate {'/'.join(map(str, self.rays_over))}, max |d| "
                f"{self.grad_max:.3g}; partials' RMS |d| over the agreeing rays {parts}; over "
                "all rays " + ", ".join(f"{k} {v:.3g}" for k, v in self.partial_err.items()))


def rays_over(g, ref, common):
    """The rays of ``common`` whose direction gradient in ``g`` misses
    ``ref``'s by more than GRAD_RTOL·|g| + GRAD_ATOL in any component."""
    gk, gr = g.vel0.double(), ref.vel0.double()
    return common & ((gk - gr).abs() > GRAD_RTOL * gr.abs() + GRAD_ATOL).any(dim=-1)


def _partials(g) -> dict:
    """name -> the partial's elements, in float64 on the host."""
    return {k: getattr(g, k).double().reshape(-1).cpu() for k in SCALARS}


def _rms(xs) -> torch.Tensor:
    return torch.stack(xs).pow(2).mean(dim=0).sqrt()


def adjoint_gate(runs, rerun):
    """Hold a float32 adjoint (the kernel) to the float64 adjoint of the same
    rays and cotangents, no worse than the plain float32 adjoint is.
    ``runs`` lists, for each of several sets of cotangents, the three
    adjoints (kernel, plain, float64); ``rerun(i, keep)`` returns set i's
    three again with the cotangents of the rays outside the mask ``keep``
    set to 0. Returns (kernel's stats, plain's stats, failed clauses)."""
    failed = []
    over, masked = {"k": [], "p": []}, []
    status = {"k": [], "p": []}
    grad = {"k": 0.0, "p": 0.0}
    for i, (ker, plain, ref) in enumerate(runs):
        n = ref.status.numel()
        common = (ker.status == ref.status) & (plain.status == ref.status)
        for who, g in (("k", ker), ("p", plain)):
            over[who].append(rays_over(g, ref, common))
            status[who].append(int((g.status != ref.status).sum()))
            d = (g.vel0[common].double() - ref.vel0[common].double()).abs()
            grad[who] = max(grad[who], d.max().item() if d.numel() else 0.0)
        n_k, n_p = int(over["k"][-1].sum()), int(over["p"][-1].sum())
        if status["k"][-1] > status["p"][-1] + 1e-4 * n:
            failed.append(f"(a) set {i}: status mismatches {status['k'][-1]} > "
                          f"{status['p'][-1]} + 1e-4 n")
        if n_k > 1.25 * n_p + 10:
            failed.append(f"(b) set {i}: rays over the gradient gate {n_k} > 1.25 x {n_p} + 10")
        masked.append([_partials(g) for g in rerun(i, common & ~over["k"][-1] & ~over["p"][-1])])
    full = [[_partials(g) for g in trio] for trio in runs]

    def rms_miss(sets, j):
        return {k: _rms([t[j][k] - t[2][k] for t in sets]) for k in SCALARS}

    sigma = {k: _rms([t[2][k] for t in masked]) for k in SCALARS}
    tol = {k: (PART_RTOL * v + PART_FLOOR * v.max()).clamp_min(1e-300) for k, v in sigma.items()}
    e = {"k": rms_miss(masked, 0), "p": rms_miss(masked, 1)}
    e_full = {"k": rms_miss(full, 0), "p": rms_miss(full, 1)}
    margin = {k: (e["k"][k] / (2 * e["p"][k] + tol[k])).max().item() for k in SCALARS}

    def stats(who, margin=None):
        return AdjointStats(
            status_mismatches=tuple(status[who]),
            rays_over=tuple(int(o.sum()) for o in over[who]), grad_max=grad[who],
            partial_err={k: v.max().item() for k, v in e_full[who].items()},
            agree_err={k: e[who][k].max().item() for k in SCALARS},
            agree_tol={k: (e[who][k] / tol[k]).max().item() for k in SCALARS}, margin=margin)

    k, p = stats("k", margin), stats("p")
    for name, ratio in margin.items():
        if ratio > 1:
            failed.append(f"(c) {name} partial over the agreeing rays off by {ratio:.3g} x its "
                          f"limit (RMS |d| {k.agree_err[name]:.3g}, the plain's "
                          f"{p.agree_err[name]:.3g})")
    return k, p, failed


def masked_cotangents(cot_acc, cot_vel, keep):
    """The cotangents with those of the rays outside ``keep`` set to 0."""
    w = keep[:, None].to(cot_acc.dtype)
    return cot_acc * w, cot_vel * w


def cotangents(n, seed, dtype, device):
    """Seeded standard-normal cotangents of the march's RGBA (n, 4) and
    final velocity (n, 3), drawn with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, 4))).to(device, dtype),
            torch.from_numpy(rng.normal(size=(n, 3))).to(device, dtype))


def _scene(width, height, dtype, dev):
    import dataclasses
    import os

    from blackstar_tpu_torch.config import Config, load_config

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base = load_config(os.path.join(root, "scenes", "default.yaml"))
    cfg = Config(scene=dataclasses.replace(base.scene, resolution=(width, height), dtype=dtype),
                 camera=base.camera)
    return cfg.params(dev), cfg.static()


def adjoint_args(params, static):
    """The scene inputs of the march adjoint, as the training path gives them."""
    from blackstar_tpu_torch.color import hsi_to_rgb
    from blackstar_tpu_torch.render import safe_distance

    dt = static.tdtype
    disk = params.disk
    return dict(mass=params.mass.to(dt), inner=disk.inner.to(dt), outer=disk.outer.to(dt),
                opacity=disk.opacity.to(dt), disk_rgb=hsi_to_rgb(disk.color_hsi.to(dt)),
                safe=safe_distance(params, dt))


def main(argv=None) -> list:
    """Read :func:`adjoint_gate` for B2 over several cotangent seeds."""
    import argparse
    import json
    import subprocess

    ap = argparse.ArgumentParser(
        description="B2's float32 adjoint gate over seeds of random cotangents, default "
                    "scene, on the card: both float32 adjoints (the kernel from B1's "
                    "checkpoints, the plain adjoint from nothing) against the plain float64 "
                    "adjoint, through adjoint_gate with one set of cotangents per seed.")
    ap.add_argument("--sizes", nargs="+", default=["480x270", "1920x1080"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[7, 10, 1, 2, 3, 4])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("march_accuracy: needs a CUDA card")

    from blackstar_tpu_torch.camera import generate_ray_components
    from blackstar_tpu_torch.geodesic import CKPT_VALUES, n_segments
    from blackstar_tpu_torch.ops import march_adjoint_cuda as b2
    from blackstar_tpu_torch.ops import march_cuda as b1
    from blackstar_tpu_torch.ops.march_vjp import march_adjoint_reference

    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    results = []
    for size in args.sizes:
        width, height = (int(x) for x in size.split("x"))
        params, static = _scene(width, height, "float32", dev)
        p64, s64 = _scene(width, height, "float64", dev)
        kw, kw64 = adjoint_args(params, static), adjoint_args(p64, s64)
        pos0, planes = generate_ray_components(params.camera, width, height,
                                               dtype=torch.float32)
        stacked = torch.stack(planes, dim=-1)
        n = stacked.shape[0]
        ckpt = torch.empty((n_segments(static.max_steps), CKPT_VALUES, n),
                           dtype=torch.float32, device=dev)
        rsteps = torch.empty((n,), dtype=torch.int32, device=dev)
        b1.march_cuda(pos0, planes, params, static, kw["safe"], ray_steps=rsteps,
                      checkpoints=ckpt)

        def adjoints(cot_acc, cot_vel):
            ker = b2.march_adjoint_cuda(pos0, planes, cot_acc, cot_vel, static=static,
                                        checkpoints=ckpt, ray_steps=rsteps, **kw)
            plain = march_adjoint_reference(
                pos0, stacked, h=static.step_size, max_steps=static.max_steps,
                disk_on=static.disk_on, cot_acc=cot_acc, cot_vel=cot_vel, **kw)
            ref = march_adjoint_reference(
                pos0.double(), stacked.double(), h=s64.step_size, max_steps=s64.max_steps,
                disk_on=s64.disk_on, cot_acc=cot_acc.double(), cot_vel=cot_vel.double(),
                **kw64)
            return ker, plain, ref

        cots = [cotangents(n, seed, torch.float32, dev) for seed in args.seeds]
        runs = [adjoints(*cot) for cot in cots]
        kept = []

        def rerun(i, keep):
            kept.append(int(keep.sum()))
            return adjoints(*masked_cotangents(*cots[i], keep))

        k, p, failed = adjoint_gate(runs, rerun)
        del runs
        print(f"{size}, seeds {args.seeds}: {n} rays, {min(kept)}-{max(kept)} agreeing\n"
              f"  kernel {k.line()}\n  plain  {p.line()}\n  failed: {failed or 'none'}",
              flush=True)
        results.append({"size": size, "seeds": args.seeds, "rays": n, "agreeing": kept,
                        "kernel": k._asdict(), "plain": p._asdict(), "failed": failed})
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
