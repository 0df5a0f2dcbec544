"""What the runners share: the inputs made from a cell's files for the
program and for the reference, and the comparison of frames.

Both sides are handed the same scene: the upstream file's contents, kept in
the configuration file, with the camera the seed chose. The program gets it
through its own parser (``Config.from_dict``, ``Animation.from_dict``), the
reference through ``benchmark.reference.scene``. The star catalogue is the
one raw file both read: the program builds (once per checkout) and loads its
star table from it, the reference its own search.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference import render as ref
from benchmark.reference.stars import Sky

# A pixel is wrong when one of its channels is more than this many 8-bit
# sRGB levels from the reference's (float32 against float64 rounds to one).
LEVELS = 2


def contents(cell, size: Optional[Tuple[int, int]] = None) -> dict:
    """The scene or animation file of the cell's configuration; ``size``
    (width, height) replaces its resolution (tests only)."""
    d = copy.deepcopy(cell.config["contents"])
    if size is not None:
        d["scene"]["resolution"] = list(size)
    return d


def stars_path(cell, stars: Optional[str] = None) -> str:
    return stars or os.path.join(cell.root, cell.config["stars"])


def program_grid(cell, device, stars: Optional[str] = None):
    """The program's star table on ``device``: the checkout's default grid
    (built from the catalogue on the first run in a checkout, then loaded),
    or one built in memory from another catalogue (tests)."""
    dtype = torch.float32 if cell.config["dtype"] == "float32" else torch.float64
    if stars is None:
        from blackstar_tpu_torch.stars.artifact import default_star_grid

        grid = default_star_grid(device, dtype)
        if grid is None:
            raise RuntimeError("the star catalogue is missing from the checkout")
        return grid
    from blackstar_tpu_torch.stars.artifact import CELL_SIZE, K0, RADIUS
    from blackstar_tpu_torch.stars.catalog import read_catalog
    from blackstar_tpu_torch.stars.grid import build_star_grid_compact

    return build_star_grid_compact(read_catalog(stars), cell_size=CELL_SIZE, radius=RADIUS,
                                   k0=K0).to_grid(device, dtype=dtype)


def program_scene(cell, d: dict) -> dict:
    """``d`` for the program: the precision the configuration states added
    in the program's schema (its ``dtype`` key, which the reference has no
    use for)."""
    d = copy.deepcopy(d)
    d["scene"]["dtype"] = cell.config["dtype"]
    return d


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ReferenceFrames:
    """The reference's frames of one scene at a precision (float64 is the
    reference; a lower one is the control)."""

    def __init__(self, cell, device, dtype=torch.float64, stars: Optional[str] = None):
        self.device, self.dtype = device, dtype
        self.cap = int(cell.config["max_steps"])
        self.sky = Sky.from_ppm(stars_path(cell, stars), device, dtype)

    def linear(self, scene, with_bloom: bool = True) -> torch.Tensor:
        p = ref.scene_params(scene, self.device, self.dtype)
        with torch.no_grad():
            img, _ = ref.render_linear(scene, p, self.sky, cap=self.cap, with_bloom=with_bloom)
        return img

    def rgb8(self, scene) -> torch.Tensor:
        return ref.srgb8(self.linear(scene))

    def ray_steps(self, scene, p=None) -> int:
        """RK4 steps all the scene's rays advance in the reference's march
        (at the parameters ``p``, float64, or the scene's own)."""
        p = ref.scene_params(scene, self.device, torch.float64) if p is None else p
        rw, rh = scene.render_size
        with torch.no_grad():
            m = ref.march(p, ref.camera_rays(p, rw, rh), step=scene.step, cap=self.cap,
                          disk_on=scene.disk_opacity != 0.0)
        return int(m.steps.sum())


def frame_numbers(program_rgb8: torch.Tensor, reference_rgb8: torch.Tensor) -> Dict[str, float]:
    """``bad_px_share``: the share of pixels with a channel more than
    :data:`LEVELS` levels off; ``mean_gap``: the mean gap of a channel, in
    levels."""
    if program_rgb8.shape != reference_rgb8.shape:
        return {"bad_px_share": 1.0, "mean_gap": 255.0}
    gap = (program_rgb8.to(reference_rgb8.device).int() - reference_rgb8.int()).abs()
    return {"bad_px_share": float((gap.amax(-1) > LEVELS).double().mean()),
            "mean_gap": float(gap.double().mean())}


def worst(numbers: List[Dict[str, float]], limits: Dict[str, float]):
    """The checks of a run: each number's largest reading over the outputs
    compared, beside its limit; and how many outputs failed one."""
    checks = [{"name": k, "value": max(n[k] for n in numbers), "limit": float(limits[k])}
              for k in sorted(limits)] if numbers else []
    failed = sum(any(n[k] > limits[k] for k in limits) for n in numbers)
    return checks, failed
