"""Inverse rendering demo on the PyTorch/CUDA port: recover black-hole mass
and disk shape from pixels.

Renders a ground-truth image, perturbs the Schwarzschild radius (mass) and
the disk radii, then gradient-descends those parameters until the render
matches: on a CUDA card through the march and star kernels and their
backward kernels (``--device cpu``: their plain PyTorch versions).

Run:  python examples/fit_black_hole_mass_torch.py [--steps 250] [--lr 1e-2] [--out fit_progress.png]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--out", default="fit_progress.png")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args()

    from blackstar_tpu_torch.config import Config, param_leaves, params_from_leaves
    from blackstar_tpu_torch.fit import init_train_state, make_train_step, trainable_mask
    from blackstar_tpu_torch.imageio import write_png
    from blackstar_tpu_torch.render import render

    device = torch.device(args.device)
    cfg = Config.from_dict(
        {
            "camera": {
                "position": [0, 1, -20],
                "lookAt": [2, 0, 0],
                "upVec": [-0.2, 1, 0],
                "fov": 1.5,
            },
            "scene": {
                "resolution": [96, 54],
                "diskOpacity": 0.95,
                "diskInner": 1.8,
                "diskOuter": 13.0,
                "maxSteps": 400,
                "dtype": "float32",
            },
        }
    )
    static = cfg.static()
    truth = cfg.params(device)
    print("Rendering ground truth...")
    with torch.no_grad():
        target = render(truth, static)

    # Perturb what we'll recover. (Mass and fov are nearly degenerate at low
    # resolution: both scale the apparent size. So fov stays at truth and
    # the physical parameters are recovered.)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    start = dataclasses.replace(
        truth,
        mass=f32(1.25),
        disk=dataclasses.replace(truth.disk, inner=f32(2.6), outer=f32(10.5)),
    )
    mask = trainable_mask(start, lambda p: p in (".mass", ".disk.inner", ".disk.outer"))
    state = init_train_state(start, args.lr)
    # A cosine decay to 5% of the rate, as optax.cosine_decay_schedule(alpha=0.05).
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(state.optimizer, args.steps,
                                                       eta_min=0.05 * args.lr)
    step = make_train_step(static, grad_mask=mask)
    for i in range(args.steps):
        state, loss = step(state, target)
        sched.step()
        if i % 10 == 0 or i == args.steps - 1:
            p = state.params
            print(
                f"step {i:4d} loss {float(loss):.3e}  mass {float(p.mass.detach()):.4f} "
                f"inner {float(p.disk.inner.detach()):.3f} outer {float(p.disk.outer.detach()):.3f} "
                f"fov {float(p.camera.fov.detach()):.4f}"
            )
    fitted = params_from_leaves(v.detach() for _, v in param_leaves(state.params))

    print("\n          truth   start   fitted")
    rows = [
        ("mass", 1.0, 1.25, float(fitted.mass)),
        ("diskInner", 1.8, 2.6, float(fitted.disk.inner)),
        ("diskOuter", 13.0, 10.5, float(fitted.disk.outer)),
    ]
    for name, t, s, f in rows:
        print(f"{name:>10}  {t:6.3f}  {s:6.3f}  {f:6.3f}")

    with torch.no_grad():
        side = np.concatenate(
            [render(start, static).cpu().numpy(), render(fitted, static).cpu().numpy(),
             target.cpu().numpy()],
            axis=1,
        )
    write_png(side, args.out)
    print(f"\nstart | fitted | target -> {args.out}")


if __name__ == "__main__":
    main()
