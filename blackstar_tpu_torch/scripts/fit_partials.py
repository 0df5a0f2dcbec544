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
run's (over the steps and the leaf's elements). B2's float32 partials cost
the fit more than float32 arithmetic must when ``b2_f32`` parts from
``b2_f64`` by more than ``plain_f32`` does. The last line is one JSON
object of these numbers.
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


def grad_error(run: dict, ref: dict) -> dict:
    """Per leaf that gets a gradient, |grad − ref grad| / |ref grad|
    (Euclidean norms over the leaf's elements) of the first step."""
    return {name: float(np.linalg.norm(run["grad0"][name] - g) / max(np.linalg.norm(g), 1e-300))
            for name, g in ref["grad0"].items()}


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
    args = ap.parse_args(argv)
    target_fields = dict(t.split("=", 1) for t in args.target) or {"disk_outer": "12.5"}
    target_fields = {k: float(v) for k, v in target_fields.items()}
    if not torch.cuda.is_available():
        raise SystemExit("fit_partials: needs a CUDA card")

    from blackstar_tpu_torch.config import Config, load_config
    from blackstar_tpu_torch.ops.march_adjoint_cuda import march_adjoint_cuda
    from blackstar_tpu_torch.ops.march_vjp import march_adjoint_from_checkpoints
    from blackstar_tpu_torch.render import render
    from blackstar_tpu_torch.stars.artifact import ensure_star_grid
    from blackstar_tpu_torch.stars.grid import load_star_grid_compact

    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    base = load_config(os.path.join(ROOT, "scenes", "default.yaml"))

    def scene(dtype, **overrides):
        return Config(scene=dataclasses.replace(base.scene, resolution=(1920, 1080), dtype=dtype,
                                                **overrides), camera=base.camera)

    grid_path = ensure_star_grid()
    if grid_path is None:
        raise SystemExit("fit_partials: stars.ppm is missing")
    compact = load_star_grid_compact(grid_path)
    grids = {dt: compact.to_grid(dev, dtype=dt) for dt in (torch.float32, torch.float64)}
    cfg_t = scene("float64", **target_fields)
    with torch.no_grad():
        target = render(cfg_t.params(dev), cfg_t.static(), grids[torch.float64])

    print(card)
    print(f"target: the scene with {target_fields}, lr {args.lr}, {args.steps} steps")
    runs = {}
    for name in ("b2_f64", "b2_f32", "plain_f32"):
        cfg = scene("float64" if name.endswith("f64") else "float32")
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
    gerr = {name: grad_error(runs[name], runs["b2_f64"]) for name in ("b2_f32", "plain_f32")}
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
                                                   ", not in all"))
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
