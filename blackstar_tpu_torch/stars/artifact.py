"""The repository's default full-scale star-grid artifact.

The reference requires a star map (it exits when ``stars.kdt`` is missing,
app/Main.hs:46-50). The analogue here is ``stars.grid.npz`` at the
repository root, built deterministically from the committed ``stars.ppm``
catalogue (470k synthetic stars). The file is not committed: it is built
with this package's numpy grid build on first use and cached at that path, in
the same v6 format the JAX package reads and writes.

The build parameters are the JAX package's: a 6 mrad cell size with a
7.5 mrad insertion radius leaves a 6 mrad margin beyond the 3w query radius, which
lets the lookup take the fast bounded-error cell ids, and 32 base slots per
cell hold the typical cell.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

CELL_SIZE = 0.006
RADIUS = 0.0075
K0 = 32


def repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def default_grid_path() -> str:
    return os.path.join(repo_root(), "stars.grid.npz")


def default_catalog_path() -> str:
    return os.path.join(repo_root(), "stars.ppm")


def ensure_star_grid(path: Optional[str] = None) -> Optional[str]:
    """Return the path of the default grid artifact, building and caching
    it from ``stars.ppm`` if needed. None if unavailable."""
    path = path or default_grid_path()
    if os.path.exists(path):
        return path
    ppm = default_catalog_path()
    if not os.path.exists(ppm):
        return None
    from blackstar_tpu_torch.stars.catalog import read_catalog
    from blackstar_tpu_torch.stars.grid import build_star_grid_compact, save_star_grid

    compact = build_star_grid_compact(
        read_catalog(ppm), cell_size=CELL_SIZE, radius=RADIUS, k0=K0
    )
    return save_star_grid(compact, path)


def default_star_grid(device, dtype: torch.dtype = torch.float32):
    """Load (building if necessary) the default full-scale star grid onto
    ``device``. Returns None when neither the cache nor the catalogue
    exists."""
    path = ensure_star_grid()
    if path is None:
        return None
    from blackstar_tpu_torch.stars.grid import load_star_grid

    return load_star_grid(path, device, dtype=dtype)
