from blackstar_tpu_torch.stars.catalog import parse_ppm, SPECTRAL_COLORS, spectral_color
from blackstar_tpu_torch.stars.grid import (
    CompactStarGrid,
    StarGrid,
    build_star_grid,
    build_star_grid_compact,
    load_star_grid,
    save_star_grid,
)

__all__ = [
    "parse_ppm",
    "SPECTRAL_COLORS",
    "spectral_color",
    "CompactStarGrid",
    "StarGrid",
    "build_star_grid",
    "build_star_grid_compact",
    "load_star_grid",
    "save_star_grid",
]
