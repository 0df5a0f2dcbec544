"""Fit CLI — inverse rendering: recover scene parameters from an image.

Usage::

    python -m blackstar_tpu_torch fit SCENE.yaml TARGET.png [-o FITTED.yaml]
        [--steps 200] [--lr 1e-2] [--fit mass,disk] [--pyramid 2]
        [--starmap stars.grid.npz] [--checkpoint ck.npz] [--force]
        [--device cuda] [--sharded]

The port of ``blackstar_tpu/cli/fit.py``. It gradient-descends the scene's
differentiable parameters (camera pose/fov, disk inner/outer/opacity/colour,
star intensity/saturation, black-hole mass) until the pre-bloom render
matches a target PNG, then writes the fitted scene YAML. The target must
match the scene resolution and be an sRGB PNG (it is decoded back to linear
before the L2 loss). ``--fit`` restricts which parameters move: a comma
list of substrings matched against dotted leaf paths (``.mass``,
``.disk.outer``, ``.camera.position``, …); default all. ``--device``
(default ``cuda``) picks where the fit runs: on a CUDA device through the
march and star kernels and their backward kernels, on ``cpu`` through
their plain PyTorch versions. ``--sharded`` spreads each step's rays over
the ranks of a ``torch.distributed`` group, one process per card, and sums
the parameter gradients over them (``torchrun --nproc-per-node N -m
blackstar_tpu_torch fit ... --sharded``; without ``torchrun``'s environment
the group is this process alone); only rank 0 prints and writes files.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from blackstar_tpu_torch.util import normalize_path, prompt_overwrite_file, time_action


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="blackstar_tpu_torch fit")
    p.add_argument("scene", help="initial-guess scene YAML")
    p.add_argument("target", help="target image (sRGB PNG, scene resolution)")
    p.add_argument("-o", "--output", default="", metavar="PATH",
                   help="fitted scene YAML (default: <scene>-fitted.yaml)")
    p.add_argument("--steps", type=int, default=200, help="optimisation steps")
    p.add_argument("--lr", type=float, default=1e-2, help="adam learning rate")
    p.add_argument(
        "--fit", default="", metavar="PATHS",
        help="comma list of parameter-path substrings to optimise "
        "(e.g. 'mass,disk.outer'); default: every differentiable leaf",
    )
    p.add_argument("--pyramid", type=int, default=0,
                   help="extra box-blurred loss levels for long-range gradients")
    p.add_argument("--starmap", default="", metavar="PATH",
                   help="star grid (needed if the target has stars)")
    p.add_argument("--sharded", action="store_true",
                   help="shard each step's rays over the ranks (launch with torchrun)")
    p.add_argument("--checkpoint", default="", metavar="PATH",
                   help="also save the fitted parameters as .npz")
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite the output without asking")
    p.add_argument("--device", default="cuda",
                   help="torch device to fit on (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sharded:
        from blackstar_tpu_torch.parallel.mesh import sharded_session

        with sharded_session(args.device) as mesh:
            return _main(args, mesh.device, mesh)
    return _main(args, torch.device(args.device))


def _main(args, device: torch.device, mesh=None) -> int:
    from blackstar_tpu_torch.config import config_with_params, load_config, save_config
    from blackstar_tpu_torch.fit import fit_scene, save_params, trainable_mask
    from blackstar_tpu_torch.imageio import read_png, srgb_decode

    scene_path = normalize_path(args.scene)
    try:
        cfg = load_config(scene_path)
    except Exception as e:  # a bad scene file is reported, not raised
        print(f"Error when decoding config:\n{e}")
        return 1
    params, static = cfg.params(device), cfg.static()

    rgb8 = read_png(normalize_path(args.target))
    w, h = cfg.scene.resolution
    if rgb8.shape[:2] != (h, w):
        print(f"target is {rgb8.shape[1]}x{rgb8.shape[0]} but the scene "
              f"resolution is {w}x{h} — resize one of them.")
        return 1
    target = srgb_decode(torch.from_numpy(rgb8.copy()).to(device=device, dtype=static.tdtype) / 255.0)
    if cfg.scene.bloom_strength != 0.0:
        print("Note: the fit compares pre-bloom renders; a bloomed target "
              "biases bright regions (set bloomStrength: 0 when rendering "
              "fitting targets).")

    star_grid = None
    if args.starmap:
        from blackstar_tpu_torch.stars.grid import load_star_grid

        star_grid = load_star_grid(args.starmap, device, dtype=static.tdtype)

    grad_mask = None
    if args.fit:
        keys = [k.strip() for k in args.fit.split(",") if k.strip()]
        grad_mask = trainable_mask(params, lambda path: any(k in path for k in keys))

    n_report = max(1, args.steps // 10)

    def progress(i, state, loss):
        if (i + 1) % n_report == 0 or i == 0:
            print(f"step {i + 1:5d}/{args.steps}  loss {float(loss):.3e}")

    print(f"Fitting {scene_path} to {args.target} ({args.steps} steps)...")
    with time_action("Fitting"):
        fitted, losses = fit_scene(
            params, static, target, star_grid,
            steps=args.steps, learning_rate=args.lr,
            grad_mask=grad_mask, pyramid=args.pyramid, callback=progress, mesh=mesh,
        )
    if losses:
        print(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e}")
    if mesh is not None and mesh.rank:
        return 0  # rank 0 writes the files

    out = normalize_path(args.output) if args.output else (
        os.path.splitext(scene_path)[0] + "-fitted.yaml"
    )
    fitted_cfg = config_with_params(cfg, fitted)
    if prompt_overwrite_file(out, lambda p: save_config(fitted_cfg, p), force=args.force):
        print(f"Fitted scene written to {out}.")
    if args.checkpoint:
        save_params(fitted, args.checkpoint)
        print(f"Parameter checkpoint written to {args.checkpoint}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
