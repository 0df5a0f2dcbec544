"""Animate CLI — keyframe expansion (reference app/Animate.hs:33-66).

Usage::

    python -m blackstar_tpu_torch animate ANIM.yaml [-o DIR] [--force]
        [--render [--preview] [--starmap stars.grid.npz] [--device cuda] [--sharded]]

The port of ``blackstar_tpu/cli/animate.py``. Without ``--render`` it
writes one scene YAML per frame (``<basename>_<paddedIdx>.yaml``) into the
output directory, byte for byte the files the JAX package's CLI writes;
rendering them is a separate batch ``render`` run, and
``scripts/ffmpeg-animate`` muxes the stills into a video. With ``--render``
it renders the frames straight to PNG (``video.render_animation``) on
``--device`` (default ``cuda``: through the march and star kernels; ``cpu``:
through their plain PyTorch versions). With ``--render``, ``--sharded``
spreads each frame's rays over the ranks of a ``torch.distributed`` group,
one process per card (``torchrun --nproc-per-node N -m blackstar_tpu_torch
animate ANIM.yaml --render --sharded``; without ``torchrun``'s environment
the group is this process alone); only rank 0 prints and writes the PNGs.
"""

from __future__ import annotations

import argparse
import os
import sys

from blackstar_tpu_torch.animation import (frame_filename, generate_frames, load_animation,
                                           validate_keyframes)
from blackstar_tpu_torch.util import normalize_path, prompt_overwrite_file


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="blackstar_tpu_torch animate")
    p.add_argument("inputfile", help="animation YAML file")
    p.add_argument("-o", "--output", default="", metavar="PATH", help="output directory")
    p.add_argument("-f", "--force", action="store_true", help="overwrite files without asking")
    p.add_argument(
        "--render", action="store_true",
        help="render frames straight to PNG on the device instead of expanding "
        "per-frame YAMLs",
    )
    p.add_argument("--preview", action="store_true", help="with --render: preview size")
    p.add_argument("--starmap", default="stars.grid.npz", metavar="PATH",
                   help="with --render: star grid path (the default is built from "
                   "stars.ppm on first use)")
    p.add_argument("--device", default="cuda",
                   help="with --render: torch device to render on (default: cuda)")
    p.add_argument("--sharded", action="store_true",
                   help="with --render: shard each frame's rays over the ranks (launch "
                   "with torchrun)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    in_path = args.inputfile
    basename = os.path.splitext(os.path.basename(in_path))[0]
    if not os.path.isfile(in_path):
        print("Couldn't open input file.")
        return 1

    out_path = normalize_path(args.output) if args.output else os.getcwd()
    os.makedirs(out_path, exist_ok=True)

    try:
        anim = load_animation(in_path)
    except Exception as e:  # the CLI boundary: a bad file is reported (app/Animate.hs)
        print(f"Error when decoding config:\n{e}")
        return 1
    try:
        validate_keyframes(sorted(anim.keyframes, key=lambda k: k.time))
    except ValueError as e:
        print(e)
        return 1

    if args.render:
        if args.sharded:
            from blackstar_tpu_torch.parallel.mesh import sharded_session

            with sharded_session(args.device) as mesh:
                return _render(args, anim, out_path, basename, mesh)
        return _render(args, anim, out_path, basename)

    from blackstar_tpu_torch.config import save_config

    for idx, frame in enumerate(generate_frames(anim)):
        filename = os.path.join(out_path, frame_filename(basename, anim.n_frames, idx))
        prompt_overwrite_file(
            filename, lambda p, cfg=frame: save_config(cfg, p), force=args.force
        )
    return 0


def _render(args, anim, out_path: str, basename: str, mesh=None) -> int:
    from blackstar_tpu_torch import native
    from blackstar_tpu_torch.cli.render import _load_stars
    from blackstar_tpu_torch.config import torch_dtype
    from blackstar_tpu_torch.parallel.mesh import rank_zero_first
    from blackstar_tpu_torch.video import frame_path, render_animation, require_device

    device = require_device(args.device if mesh is None else mesh.device)
    if not args.force:
        # Frames are written asynchronously, so no per-frame prompt is
        # possible: -f is checked up front instead of overwriting a previous
        # run's frames.
        existing = [p for p in (frame_path(out_path, basename, anim.n_frames, i)
                                for i in range(anim.n_frames)) if os.path.exists(p)]
        if existing:
            print(f"{len(existing)} frame(s) already exist in {out_path} (e.g. "
                  f"{existing[0]}) — pass -f/--force to overwrite.")
            return 1

    with rank_zero_first(mesh):  # one rank builds a missing star grid
        star_grid = _load_stars(args.starmap, device)
    if star_grid is not None:
        star_grid = star_grid.get(torch_dtype(anim.scene.dtype))
    if native.available():
        print(f"PNG writer: native pool ({native.pool_threads()} threads)")
    else:
        print(f"PNG writer: pure Python, one frame at a time (native library unavailable: "
              f"{native.load_error})")
    paths = render_animation(
        anim, out_path, star_grid=star_grid, basename=basename, preview=args.preview,
        device=device, sharded=mesh is not None,
        progress=lambda i, n: print(f"Frame {i}/{n}", end="\r"),
    )
    print(f"\nRendered {len(paths)} frames to {out_path}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
