"""What the march adjoint kernel B2's float32 scene partials cost a fit: one
fit, three backward passes.

``scenes/default.yaml`` at 1920×1080 with the 470k-star sky, every
parameter leaf trainable, fitted for N Adam steps (learning rate 1e-3 by
default) from the scene's own parameters toward a target rendered in
float64 with ``diskOuter`` 12.5 (before bloom; ``--target FIELD=VALUE``
sets other ``Scene`` fields instead), three times from the same start:

* ``b2_f32``: the training path in float32 (B1 forward, B2 backward);
* ``b2_f64``: the training path in float64 (the scene, the star tables and
  both kernels in float64): the reference path;
* ``plain_f32``: float32, with the march's backward through the plain
  adjoint (``ops.march_vjp.march_adjoint_from_checkpoints``, on the card,
  fed B1's float32 checkpoints: B2's arithmetic replaced by the plain
  float32 one along the same orbits).

Run on a CUDA card from the checkout's root::

    python -m blackstar_tpu_torch.scripts.fit_partials [--steps 10] [--lr 1e-3]
        [--target disk_outer=12.5 [--target mass=1.02 ...]]

It prints each run's losses, then for each float32 run and each leaf: the
relative error of the first step's gradient (all three runs start from the
same parameters, so this is the partials' own error) against the float64
run's, and the largest distance of its parameter path from the float64
run's (over the steps and the leaf's elements). The last line is one JSON
object of these numbers. The path distance is information only: a float32
fit amplifies any change of the camera and mass gradients, which both
float32 adjoints miss alike, so one path is no criterion (a ~1e-7 change
of B2's sums once moved it by up to 21%).

The criterion is :func:`gradient_gate` (``--gate``, and ``chip_smoke.py``
phase 19): at shared parameters (the scene's own, for three targets, and
iterates of the float64 fit) B2's float32 gradient must miss the float64
gradient by no more than the plain float32 adjoint's does, leaf by leaf,
within :data:`GATE_MARGIN` and :data:`GATE_ATOL`::

    python -m blackstar_tpu_torch.scripts.fit_partials --gate [--iterates 5,10]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def plain_adjoint():
    """Route the differentiable march's backward through the plain adjoint
    from B1's checkpoints, on the rays' device."""
    from blackstar_tpu_torch.ops import march_diff
    from blackstar_tpu_torch.ops.march_vjp import march_adjoint_from_checkpoints

    def adjoint(pos0, planes, cot_acc, cot_vel, *, static, checkpoints, ray_steps, **scene):
        return march_adjoint_from_checkpoints(
            pos0, torch.stack(planes, dim=-1), checkpoints, ray_steps, h=static.step_size,
            max_steps=static.max_steps, disk_on=static.disk_on, cot_acc=cot_acc,
            cot_vel=cot_vel, **scene)

    kernel = march_diff.march_adjoint_cuda
    march_diff.march_adjoint_cuda = adjoint
    try:
        yield
    finally:
        march_diff.march_adjoint_cuda = kernel


# The gradient gate. B2's float32 error against the float64 gradient may
# exceed the plain float32 adjoint's by GATE_MARGIN (the two agree within 1%
# at the shared start, so 5% is the margin over that) plus GATE_ATOL.
GATE_MARGIN = 1.05
GATE_ATOL = 1e-7
GATE_TARGETS = ({"disk_outer": 12.5}, {"mass": 1.02}, {"disk_inner": 2.2, "disk_opacity": 0.85})
GATE_LR = 1e-3
GATE_ITERATES = (5, 10)  # of the first target's float64 fit at GATE_LR


def scene_config(dtype: str, **overrides):
    """``scenes/default.yaml`` at 1920×1080 in ``dtype`` with ``Scene``
    fields overridden."""
    from blackstar_tpu_torch.config import Config, load_config

    base = load_config(os.path.join(ROOT, "scenes", "default.yaml"))
    return Config(scene=dataclasses.replace(base.scene, resolution=(1920, 1080), dtype=dtype,
                                            **overrides), camera=base.camera)


def render_target(fields: dict, grid64, device) -> torch.Tensor:
    """The float64 render (before bloom) of the scene with ``fields``."""
    from blackstar_tpu_torch.render import render

    cfg = scene_config("float64", **fields)
    with torch.no_grad():
        return render(cfg.params(device), cfg.static(), grid64)


def gradient(leaves: dict, cfg, target, grid, device) -> dict:
    """Per leaf that gets one, the gradient (float64 numpy) of the training
    loss against ``target`` at the parameter ``leaves`` (float64 numpy, in
    ``param_leaves`` order), computed in ``cfg``'s dtype through the
    training path."""
    from blackstar_tpu_torch.config import param_leaves, params_from_leaves
    from blackstar_tpu_torch.fit import image_loss

    static = cfg.static()
    params = params_from_leaves(
        torch.tensor(v, dtype=static.tdtype, device=device).requires_grad_(True)
        for v in leaves.values())
    image_loss(params, static, target.to(static.tdtype), grid).backward()
    return {name: v.grad.double().cpu().numpy() for name, v in param_leaves(params)
            if v.grad is not None}


def relative_errors(grads: dict, ref: dict) -> dict:
    """Per leaf of ``ref``, |g − ref| / |ref| (Euclidean norms over the
    leaf's elements)."""
    return {name: float(np.linalg.norm(grads[name] - g) / max(np.linalg.norm(g), 1e-300))
            for name, g in ref.items()}


def gate_failures(err_b2: dict, err_plain: dict) -> list:
    """The leaves on which B2's error exceeds :data:`GATE_MARGIN` × the
    plain adjoint's + :data:`GATE_ATOL`."""
    return [leaf for leaf, e in err_b2.items()
            if not e <= GATE_MARGIN * err_plain[leaf] + GATE_ATOL]


def gradient_gate(grids: dict, device, iterates=GATE_ITERATES) -> dict:
    """B2's float32 gradient held to the plain float32 adjoint's at shared
    parameters, each against B2's float64 gradient there.

    The points: the scene's own parameters with each of :data:`GATE_TARGETS`,
    and ``iterates`` of the float64 fit toward the first target (Adam at
    :data:`GATE_LR`, every leaf trainable; each iterate cast to float32 for
    the float32 gradients). At each, three gradients of the same loss: B2 in
    float64; B2 in float32 from B1's float32 checkpoints; the plain float32
    adjoint from the same checkpoints (:func:`plain_adjoint`). ``grids``
    maps torch.float32 and torch.float64 to the star tables. Prints a table
    per point and returns ``{"points": [{"point", "norm", "b2", "plain",
    "ratio", "failures"}], "failures": [(point, leaf, b2 error, plain
    error)], "held", "s"}``; the caller decides what a failure does."""
    from blackstar_tpu_torch.config import param_leaves
    from blackstar_tpu_torch.ops.march_adjoint_cuda import march_adjoint_cuda
    from blackstar_tpu_torch.ops.march_vjp import march_adjoint_from_checkpoints

    t0 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    cfg = {f32: scene_config("float32"), f64: scene_config("float64")}
    labels = [", ".join(f"{k} {v}" for k, v in t.items()) for t in GATE_TARGETS]
    targets = {lab: render_target(t, grids[f64], device) for lab, t in zip(labels, GATE_TARGETS)}
    start = {name: v.double().cpu().numpy() for name, v in param_leaves(cfg[f64].params(device))}
    points = [(f"start, target {lab}", start, lab) for lab in labels]
    if iterates:
        path = fit_path(cfg[f64], targets[labels[0]], grids[f64], max(iterates), GATE_LR,
                        device)["path"]
        points += [(f"iterate {k} of the float64 fit to {labels[0]}", path[k - 1], labels[0])
                   for k in iterates]

    def counted(label, want_b2, want_plain, fn):
        b2_before, plain_before = march_adjoint_cuda.launches, march_adjoint_from_checkpoints.calls
        g = fn()
        got = (march_adjoint_cuda.launches - b2_before,
               march_adjoint_from_checkpoints.calls - plain_before)
        if got != (want_b2, want_plain):
            raise AssertionError(f"{label}: B2 launched {got[0]} times, the plain adjoint "
                                 f"called {got[1]} times (want {want_b2}, {want_plain})")
        return g

    out = {"points": [], "failures": []}
    for point, leaves, lab in points:
        target = targets[lab]
        g64 = counted("B2 f64", 1, 0, lambda: gradient(leaves, cfg[f64], target, grids[f64], device))
        g_b2 = counted("B2 f32", 1, 0, lambda: gradient(leaves, cfg[f32], target, grids[f32], device))
        with plain_adjoint():
            g_plain = counted("plain f32", 0, 1,
                              lambda: gradient(leaves, cfg[f32], target, grids[f32], device))
        e_b2, e_plain = relative_errors(g_b2, g64), relative_errors(g_plain, g64)
        failures = gate_failures(e_b2, e_plain)
        rec = {"point": point, "norm": {k: float(np.linalg.norm(v)) for k, v in g64.items()},
               "b2": e_b2, "plain": e_plain,
               "ratio": {k: e_b2[k] / max(e_plain[k], 1e-300) for k in e_b2},
               "failures": failures}
        out["points"].append(rec)
        out["failures"] += [(point, leaf, e_b2[leaf], e_plain[leaf]) for leaf in failures]
        print(f"  {point}: per leaf |g64|, the f32 errors against g64 (B2 / plain) and their "
              f"ratio; gate B2 <= {GATE_MARGIN} x plain + {GATE_ATOL}")
        for leaf in e_b2:
            print(f"    {leaf:>18} {rec['norm'][leaf]:.3e}  {e_b2[leaf]:.4e} / "
                  f"{e_plain[leaf]:.4e}  {rec['ratio'][leaf]:.4f}"
                  + ("  FAILS" if leaf in failures else ""), flush=True)
    out["held"] = not out["failures"]
    out["s"] = time.perf_counter() - t0
    print(f"  gradient gate {'held' if out['held'] else 'FAILED'} at {len(points)} points in "
          f"{out['s']:.1f} s" + "".join(f"\n    fails at {p}, {leaf}: B2 {a:.4e}, plain {b:.4e}"
                                       for p, leaf, a, b in out["failures"]))
    return out


def fit_path(cfg, target, grid, steps: int, lr: float, device) -> dict:
    """Losses, the first step's gradients and the parameter leaves (float64
    numpy) after each of ``steps`` Adam steps from ``cfg``'s parameters."""
    from blackstar_tpu_torch.config import param_leaves
    from blackstar_tpu_torch.fit import init_train_state, make_train_step

    state = init_train_state(cfg.params(device), lr)
    step = make_train_step(cfg.static(), grid)
    losses, path, grad0 = [], [], None
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, target.to(cfg.static().tdtype))
        losses.append(float(loss))
        if grad0 is None:
            grad0 = {name: v.grad.double().cpu().numpy().copy()
                     for name, v in param_leaves(state.params) if v.grad is not None}
        path.append({name: v.detach().double().cpu().numpy().copy()
                     for name, v in param_leaves(state.params)})
    torch.cuda.synchronize(device)
    return {"losses": losses, "path": path, "grad0": grad0, "s": time.perf_counter() - t0}


def path_distance(run: dict, ref: dict) -> dict:
    """Per leaf, the largest |run − ref| over the steps and the leaf's
    elements; ``"all"`` the largest of them."""
    out = {name: max(float(abs(a[name] - b[name]).max()) for a, b in zip(run["path"], ref["path"]))
           for name in ref["path"][0]}
    out["all"] = max(out.values())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10, help="Adam steps (default 10)")
    ap.add_argument("--lr", type=float, default=1e-3, help="Adam learning rate (default 1e-3)")
    ap.add_argument("--target", action="append", default=[], metavar="FIELD=VALUE",
                    help="a Scene field of the target render (repeatable; default "
                    "disk_outer=12.5)")
    ap.add_argument("--gate", action="store_true",
                    help="run the gradient gate instead of the fits (exits 1 if it fails)")
    ap.add_argument("--iterates", default=",".join(map(str, GATE_ITERATES)),
                    help="the gate's iterates of the float64 fit, comma-separated (default "
                    "%(default)s; empty: the starts alone)")
    args = ap.parse_args(argv)
    target_fields = dict(t.split("=", 1) for t in args.target) or {"disk_outer": "12.5"}
    target_fields = {k: float(v) for k, v in target_fields.items()}
    if not torch.cuda.is_available():
        raise SystemExit("fit_partials: needs a CUDA card")

    from blackstar_tpu_torch.ops.march_adjoint_cuda import march_adjoint_cuda
    from blackstar_tpu_torch.ops.march_vjp import march_adjoint_from_checkpoints
    from blackstar_tpu_torch.stars.artifact import ensure_star_grid
    from blackstar_tpu_torch.stars.grid import load_star_grid_compact

    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    grid_path = ensure_star_grid()
    if grid_path is None:
        raise SystemExit("fit_partials: stars.ppm is missing")
    compact = load_star_grid_compact(grid_path)
    grids = {dt: compact.to_grid(dev, dtype=dt) for dt in (torch.float32, torch.float64)}
    print(card)
    if args.gate:
        iterates = tuple(int(k) for k in args.iterates.split(",") if k.strip())
        result = gradient_gate(grids, dev, iterates)
        result["card"] = card
        print(json.dumps(result))
        if not result["held"]:
            raise SystemExit(1)
        return result
    target = render_target(target_fields, grids[torch.float64], dev)
    print(f"target: the scene with {target_fields}, lr {args.lr}, {args.steps} steps")
    runs = {}
    for name in ("b2_f64", "b2_f32", "plain_f32"):
        cfg = scene_config("float64" if name.endswith("f64") else "float32")
        grid = grids[cfg.static().tdtype]
        b2_before, plain_before = march_adjoint_cuda.launches, march_adjoint_from_checkpoints.calls
        with plain_adjoint() if name == "plain_f32" else contextlib.nullcontext():
            runs[name] = fit_path(cfg, target, grid, args.steps, args.lr, dev)
        b2 = march_adjoint_cuda.launches - b2_before
        plain = march_adjoint_from_checkpoints.calls - plain_before
        if (b2, plain) != ((0, args.steps) if name == "plain_f32" else (args.steps, 0)):
            raise AssertionError(f"{name}: B2 launched {b2} times, the plain adjoint called "
                                 f"{plain} times in {args.steps} steps")
        print(f"{name}: {args.steps} steps in {runs[name]['s']:.1f} s (B2 {b2}, plain adjoint "
              f"{plain}); losses " + ", ".join(f"{v:.6e}" for v in runs[name]["losses"]))
    dist = {name: path_distance(runs[name], runs["b2_f64"]) for name in ("b2_f32", "plain_f32")}
    gerr = {name: relative_errors(runs[name]["grad0"], runs["b2_f64"]["grad0"])
            for name in ("b2_f32", "plain_f32")}
    print("per leaf: the first step's gradient error against b2_f64's (relative), and the largest "
          "distance of the parameter path from b2_f64's:")
    for leaf in dist["b2_f32"]:
        g = ""
        if leaf in gerr["b2_f32"]:
            g = f"{gerr['b2_f32'][leaf]:.3e} / {gerr['plain_f32'][leaf]:.3e}"
        print(f"  {leaf:>20}: gradient b2_f32 / plain_f32 {g:>23}; path b2_f32 "
              f"{dist['b2_f32'][leaf]:.3e}, plain_f32 {dist['plain_f32'][leaf]:.3e}")
    worse = [leaf for leaf in dist["b2_f32"] if dist["b2_f32"][leaf] > dist["plain_f32"][leaf]]
    print(f"b2_f32 parts from b2_f64 by more than plain_f32 on {len(worse) - ('all' in worse)} of "
          f"{len(dist['b2_f32']) - 1} leaves" + (", and in all" if "all" in worse else
                                                   ", not in all")
          + " (information: the criterion is --gate)")
    result = {"card": card, "steps": args.steps, "lr": args.lr, "target": target_fields,
              "grad_error": gerr,
              "losses": {k: v["losses"] for k, v in runs.items()},
              "final": {k: {leaf: v["path"][-1][leaf].tolist() for leaf in v["path"][-1]}
                        for k, v in runs.items()},
              "distance": dist, "b2_worse_leaves": worse}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
