"""Whole-animation rendering: keyframes -> frames -> PNGs on the device.

The port of ``blackstar_tpu/video.py``. The reference renders an animation
through a YAML round-trip (``animate`` expands the keyframes into N scene
files, the render CLI renders them one by one; app/Animate.hs,
app/Main.hs:64-78); ``cli/animate.py`` keeps that surface. This module is
the fast path that skips it: the cameras are interpolated on the device
(:func:`blackstar_tpu_torch.animation.camera_at`), each frame runs
``render`` → ``bloom`` → ``encode_rgb8`` where the scene's parameters live
(on a CUDA device through the march kernel B1 and the star kernel B3), and
the finished uint8 frames go to the native writer pool, whose threads
compress and write them while the card renders the next ones.

Frames leave the card through two pinned host buffers in turn: frame k's
copy is queued (``non_blocking``) with an event behind it, frame k+1 is
queued, and only then is frame k handed on, after its event has completed.
The writer copies a frame at submit, so its buffer is free again for frame
k+2. Each frame renders on its own, so the last frames need no padding.

``sharded=True`` renders each frame sharded over the ranks of the default
``torch.distributed`` group (``render.render`` with a mesh, one process per
card, each on ``cuda:LOCAL_RANK``): every rank renders its shard of every
frame, and rank 0 alone blooms, encodes, copies and writes the frames.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from blackstar_tpu_torch.animation import Animation, camera_at, pad_zero, validate_keyframes
from blackstar_tpu_torch.config import (CameraParams, Config, apply_preview,
                                        default_max_steps)

WRITER_THREADS = 4  # the native pool's threads: PNG compression runs beside the renders


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it is a CUDA device and no
    CUDA device is present (the animation never moves to the CPU by
    itself: only an explicit ``cpu`` takes the plain versions)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' (--device cpu) "
                           "to render through the plain PyTorch versions")
    return device


def animation_config(anim: Animation, preview: bool = False) -> Config:
    """The one Config every frame shares, with the first keyframe's camera.

    Its step cap, unless the scene sets one, is the largest that any
    keyframe's camera needs: |pos| is largest at a keyframe under linear
    interpolation, so no frame in between needs more."""
    keys = sorted(anim.keyframes, key=lambda k: k.time)
    validate_keyframes(keys)
    scene = anim.scene
    if scene.max_steps is None:
        scene = dataclasses.replace(scene, max_steps=max(
            default_max_steps(Config(scene=scene, camera=k.camera)) for k in keys))
    cfg = Config(scene=scene, camera=keys[0].camera)
    return apply_preview(cfg) if preview else cfg


def frames(anim: Animation, *, star_grid=None, preview: bool = False,
           device="cuda", sharded: bool = False) -> Iterator[Tuple[int, np.ndarray]]:
    """Render the animation's frames in order on ``device``; yields
    ``(index, rgb8)`` with ``rgb8`` an (H, W, 3) uint8 host array.

    ``rgb8`` is a view of one of the two host buffers and is overwritten two
    frames later: use or copy it before asking for the next frame.
    ``star_grid`` must be on ``device`` at the scene's dtype. With
    ``sharded`` (module docstring) ``device`` is this rank's
    (``parallel.mesh.rank_device``), and only rank 0 yields frames.
    """
    from blackstar_tpu_torch.imageio import encode_rgb8
    from blackstar_tpu_torch.ops.filters import bloom
    from blackstar_tpu_torch.render import render

    device = require_device(device)
    mesh = None
    if sharded:
        from blackstar_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device)
        device = mesh.device
    cfg = animation_config(anim, preview)
    base = cfg.params(device)
    static = cfg.static()
    dt = static.tdtype
    n = anim.n_frames
    ts = torch.arange(n, dtype=torch.float64, device=device) / max(n - 1, 1)
    cams = camera_at(anim.keyframes, ts)
    cams = CameraParams(*(getattr(cams, f.name).to(dt) for f in dataclasses.fields(cams)))
    with_bloom = cfg.scene.bloom_strength != 0.0
    strength = base.bloom_strength.to(dt)

    on_card = device.type == "cuda"
    shape = (static.height, static.width, 3)
    bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=on_card) for _ in range(2)]
    pending = []  # (index, buffer, copy event or None), oldest first
    for i in range(n):
        cam = CameraParams(cams.position[i], cams.look_at[i], cams.up[i], cams.fov[i])
        img = render(dataclasses.replace(base, camera=cam), static, star_grid, mesh=mesh)
        if mesh is not None and mesh.rank:
            continue  # rank 0 encodes and hands on the frames
        if with_bloom:
            img = bloom(img, strength, static.bloom_divider)
        buf = bufs[i % 2]
        buf.copy_(encode_rgb8(img), non_blocking=on_card)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        pending.append((i, buf, event))
        if len(pending) > 1:
            yield _finished(pending.pop(0))
    while pending:
        yield _finished(pending.pop(0))


def _finished(entry) -> Tuple[int, np.ndarray]:
    i, buf, event = entry
    if event is not None:
        event.synchronize()
    return i, buf.numpy()


def frame_path(out_dir: str, basename: str, n_frames: int, idx: int) -> str:
    """``<out_dir>/<basename>_<paddedIdx>.png``."""
    return os.path.join(out_dir, f"{basename}_{pad_zero(n_frames - 1, idx)}.png")


def render_animation(
    anim: Animation,
    out_dir: str,
    *,
    star_grid=None,
    basename: str = "frame",
    preview: bool = False,
    device="cuda",
    sharded: bool = False,
    writer_threads: int = WRITER_THREADS,
    progress: Optional[Callable[[int, int], None]] = None,
) -> List[str]:
    """Render every frame of ``anim`` to ``out_dir`` as PNGs; returns their
    paths in frame order.

    Frames go to the native writer pool (``writer_threads`` threads) when
    the library is available, else they are written one by one by
    ``imageio.write_png``. Raises if a frame failed to write, and if
    ``device`` is a CUDA device and none is present. With ``sharded``
    (:func:`frames`) only rank 0 writes; the other ranks return ``[]``.
    """
    from blackstar_tpu_torch import native
    from blackstar_tpu_torch.imageio import write_png

    device = require_device(device)
    os.makedirs(out_dir, exist_ok=True)
    n = anim.n_frames
    writer = None
    if not (sharded and torch.distributed.get_rank()) and native.available():
        writer = native.AsyncFrameWriter(writer_threads)
    paths = []
    try:
        for i, rgb8 in frames(anim, star_grid=star_grid, preview=preview, device=device,
                              sharded=sharded):
            path = frame_path(out_dir, basename, n, i)
            if writer is not None:
                writer.submit(path, rgb8)
            else:
                write_png(rgb8, path)
            paths.append(path)
            if progress is not None:
                progress(i + 1, n)
        errors = writer.wait() if writer is not None else 0
    finally:
        if writer is not None:
            writer.close()
    if errors:
        raise IOError(f"{errors} animation frame(s) failed to write")
    return paths
