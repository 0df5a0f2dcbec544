"""Render CLI (reference app/Main.hs:43-125).

Usage::

    python -m blackstar_tpu_torch render SCENE.yaml [-o DIR] [--preview] [--force]
                                         [--starmap stars.grid.npz] [--stats]
                                         [--resume] [--device cuda] [--sharded]
                                         [--profile DIR] [--shard-scenes I/N]

A directory input renders every ``*.yaml`` inside it in sorted order (batch
mode, app/Main.hs:64-78); ``--shard-scenes I/N`` renders only scenes
I, I+N, I+2N, ... of them (one host of N), and with ``--force`` the frames
go to the native writer pool, which writes a scene's PNG while the next
scene renders. ``--profile DIR`` records a torch.profiler trace of the
renders (CPU and, on a CUDA device, CUDA activity) into DIR. ``--preview``
caps the long side at 300 px and disables supersampling/bloom
(app/Main.hs:93-103), prefixing outputs with ``prev-``. ``--device``
(default ``cuda``) picks where the frame is rendered: on a CUDA device
through the march and star kernels, on ``cpu`` through their plain PyTorch
versions. The default starmap, missing on a
fresh checkout, is built from ``stars.ppm`` on first use.

``--sharded`` spreads each frame's rays over the ranks of a
``torch.distributed`` group, one process per card (``render.render`` with
a ``parallel`` mesh; NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``)::

    torchrun --nproc-per-node 4 -m blackstar_tpu_torch render SCENE.yaml --sharded

Without ``torchrun``'s environment the group is this process alone. Only
rank 0 prints and writes the PNGs; ``--stats`` is ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch

from blackstar_tpu_torch.util import clear_screen, normalize_path, prompt_overwrite_file, time_action

DEFAULT_STARMAP = "stars.grid.npz"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="blackstar_tpu_torch render")
    p.add_argument("inputfile", help="scene YAML file or directory of scenes")
    p.add_argument("-o", "--output", default="", metavar="PATH", help="output directory")
    p.add_argument("--preview", action="store_true", help="preview render (small size)")
    p.add_argument("-f", "--force", action="store_true", help="overwrite images without asking")
    p.add_argument(
        "--starmap", default=DEFAULT_STARMAP, metavar="PATH",
        help=f"path to star grid (default: {DEFAULT_STARMAP})",
    )
    p.add_argument("--sharded", action="store_true",
                   help="shard each frame's rays over the ranks (launch with torchrun)")
    p.add_argument("--stats", action="store_true", help="print per-render ray statistics")
    p.add_argument(
        "--resume", action="store_true",
        help="batch mode: skip scenes whose output PNG already exists",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument(
        "--profile", metavar="DIR", default="",
        help="record a torch.profiler trace of the renders into DIR",
    )
    p.add_argument(
        "--shard-scenes", metavar="I/N", default="",
        help="batch mode across hosts: render only scenes i, i+N, i+2N, ... "
        "(e.g. --shard-scenes 0/4 on host 0 of 4)",
    )
    return p


class _StarGridCache:
    """Per-dtype star-grid loader: the .npz stores float64 values, so each
    scene dtype gets a grid loaded at that precision (a float64 golden run
    must not see f32-rounded star data). Tables go to the device once."""

    def __init__(self, path: str, device: torch.device):
        self.path = path
        self.device = device
        self._grids = {}

    def get(self, dtype: torch.dtype):
        if dtype not in self._grids:
            from blackstar_tpu_torch.stars.grid import load_star_grid

            self._grids[dtype] = load_star_grid(self.path, self.device, dtype=dtype)
        return self._grids[dtype]


def _load_stars(path: str, device: torch.device):
    """A missing starmap is a warning, not an error — scenes render with a
    black sky (the reference exits instead, app/Main.hs:46-50). The
    repository's default grid is built from ``stars.ppm`` when missing."""
    if not os.path.exists(path):
        from blackstar_tpu_torch.stars import artifact

        if os.path.exists(path + ".npz"):
            path = path + ".npz"
        elif os.path.abspath(path) == artifact.default_grid_path() and \
                os.path.exists(artifact.default_catalog_path()):
            print(f"Building the star grid {path} from stars.ppm...")
            with time_action("Star grid build"):
                path = artifact.ensure_star_grid(os.path.abspath(path))
        else:
            print(f"Warning: starmap {path} not found; rendering without stars.")
            return None
    # Defer the actual load until the first scene's dtype is known.
    print("Starmap found.")
    return _StarGridCache(path, device)


def _sync(device: torch.device) -> None:
    """Wait for the device, so the printed times are the work's."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def handle_scene(args, star_grid, outdir: str, filename: str, device: torch.device,
                 writer=None, mesh=None) -> bool:
    from blackstar_tpu_torch.config import apply_preview, load_config
    from blackstar_tpu_torch.imageio import encode_rgb8, write_png
    from blackstar_tpu_torch.ops.filters import bloom
    from blackstar_tpu_torch.render import render

    scene_name = os.path.splitext(os.path.basename(filename))[0]
    if args.preview:
        out_name = os.path.join(outdir, "prev-" + scene_name + ".png")
    else:
        out_name = os.path.join(outdir, scene_name + ".png")
    if args.resume and os.path.exists(out_name):
        print(f"Skipping {filename} ({out_name} exists).")
        return True
    print(f"Reading {filename}...")
    try:
        cfg = load_config(filename)
    except Exception as e:  # the batch boundary: a bad scene is reported and skipped (app/Main.hs:91)
        print(f"Error when decoding config:\n{e!r}")
        return False
    print("Scene successfully read.")
    if args.preview:
        cfg = apply_preview(cfg)
        scene_name = "prev-" + scene_name

    params, static = cfg.params(device), cfg.static()
    grid = star_grid.get(static.tdtype) if star_grid is not None else None

    with_stats = args.stats
    if mesh is not None and with_stats:
        print("Note: --stats is not supported with --sharded; ignoring.")
        with_stats = False
    print(f"Rendering {scene_name}...")
    with time_action("Rendering"):
        if with_stats:
            img, stats = render(params, static, grid, with_stats=True)
        else:
            img = render(params, static, grid, mesh=mesh)
        _sync(device)
    if mesh is not None and mesh.rank:
        return True  # rank 0 writes the frame
    if with_stats:
        print(
            f"steps={int(stats.steps)} escaped={float(stats.escaped_frac):.3f} "
            f"horizon={float(stats.horizon_frac):.3f} "
            f"truncated={float(stats.truncated_frac):.6g}"
        )

    if cfg.scene.bloom_strength != 0.0:
        print("Applying bloom...")
        with time_action("Bloom"):
            img = bloom(img, params.bloom_strength.to(img.dtype), static.bloom_divider)
            _sync(device)

    # sRGB + uint8 quantisation on the device: a quarter of the bytes cross
    # to the host.
    rgb8 = encode_rgb8(img).cpu().numpy()

    print(f"Saving to {out_name}...")
    if writer is not None:
        # Batch mode with the native pool (--force is the overwrite
        # consent): a writer thread writes the frame while the next scene
        # renders.
        writer.submit(out_name, rgb8)
    else:
        prompt_overwrite_file(out_name, lambda p: write_png(rgb8, p), force=args.force)
    return True


def _profiler(outdir: str, device: torch.device):
    """A torch.profiler session that exports its trace into ``outdir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def export(prof):
        path = os.path.join(outdir, f"render-{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"Profile written to {path}.")

    return profile(activities=activities, on_trace_ready=export)


def _make_writer(args, mesh=None):
    """The native PNG pool for batch mode: needs --force and the library
    (and, sharded, rank 0)."""
    from blackstar_tpu_torch import native

    if not args.force or (mesh is not None and mesh.rank) or not native.available():
        return None
    return native.AsyncFrameWriter()


def _render_batch(args, star_grid, outdir: str, dirname: str, device: torch.device,
                  mesh=None) -> int:
    print(f"{dirname} is a directory. Rendering all scenes inside it...")
    files = sorted(os.path.join(dirname, f) for f in os.listdir(dirname) if f.endswith(".yaml"))
    if args.shard_scenes:
        # Frame-parallel batch across hosts (the reference's manual
        # multi-node workflow, README.md:89-93, made a flag).
        try:
            i, n = (int(v) for v in args.shard_scenes.split("/"))
            if not 0 <= i < n:
                raise ValueError
        except ValueError:
            print(f"invalid --shard-scenes {args.shard_scenes!r} (expected I/N with 0 <= I < N)")
            return 2
        files = files[i::n]
    writer = _make_writer(args, mesh)
    oks = []
    try:
        for idx, scn in enumerate(files, 1):
            clear_screen()
            print(f"Batch mode progress: {idx}/{len(files)}")
            oks.append(handle_scene(args, star_grid, outdir, scn, device, writer=writer,
                                    mesh=mesh))
    finally:
        if writer is not None:
            errors = writer.wait()
            writer.close()
            if errors:
                print(f"Warning: {errors} frame(s) failed to write.")
    # Reference batch semantics: failures are printed and skipped
    # (app/Main.hs:72-78); exit non-zero only if nothing rendered.
    if files and not any(oks):
        print(f"Error: all {len(files)} scene(s) failed to render.")
        return 1
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sharded:
        from blackstar_tpu_torch.parallel.mesh import sharded_session

        with sharded_session(args.device) as mesh:
            return _main(args, mesh.device, mesh)
    return _main(args, torch.device(args.device))


def _main(args, device: torch.device, mesh=None) -> int:
    from blackstar_tpu_torch.parallel.mesh import rank_zero_first

    with rank_zero_first(mesh):  # one rank builds a missing star grid
        star_grid = _load_stars(args.starmap, device)

    outdir = normalize_path(args.output) if args.output else os.getcwd()
    os.makedirs(outdir, exist_ok=True)

    filename = normalize_path(args.inputfile)
    with _profiler(args.profile, device) if args.profile else contextlib.nullcontext():
        if os.path.isdir(filename):
            rc = _render_batch(args, star_grid, outdir, filename, device, mesh)
            if rc:
                return rc
        elif not handle_scene(args, star_grid, outdir, filename, device, mesh=mesh):
            return 1
    print("Everything done. Thank you!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
