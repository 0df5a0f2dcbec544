"""generate-grid CLI — offline star-grid build (reference
app/GenerateTree.hs:11-29, ``generate-tree PPM stars.kdt``).

Usage::

    python -m blackstar_tpu_torch generate-grid CATALOG OUT.npz [--kdt] [--force]
        [--cell-size 0.006] [--radius 0.0075] [--k0 32]

The port of ``blackstar_tpu/cli/generate_grid.py``. It parses the star
catalogue (the binary PPM format, StarMap.hs:44-58, or with ``--kdt`` a
reference ``stars.kdt``), builds the bucketed spherical grid that replaces
the reference's k-d tree (numpy, on the host), and writes it as the v6
``.npz`` that both packages read. The defaults are the production build of
``stars/artifact.py``: the cell size, halo radius and base slots the
repository's ``stars.grid.npz`` is built with.
"""

from __future__ import annotations

import argparse
import os
import sys

from blackstar_tpu_torch.stars import artifact
from blackstar_tpu_torch.util import prompt_overwrite_file, time_action


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="blackstar_tpu_torch generate-grid")
    p.add_argument(
        "catalog",
        help="star catalogue: a PPM binary file, or an existing reference "
        "stars.kdt (pass --kdt) to migrate a serialized tree directly",
    )
    p.add_argument("output", help="output star-grid path (.npz)")
    p.add_argument(
        "--kdt", action="store_true",
        help="parse CATALOG as a reference stars.kdt (cereal-encoded k-d tree, "
        "StarMap.hs:82-88) instead of a PPM catalogue",
    )
    p.add_argument("-f", "--force", action="store_true", help="overwrite without asking")
    p.add_argument("--cell-size", type=float, default=artifact.CELL_SIZE,
                   help="grid ring height (rad)")
    p.add_argument(
        "--radius", type=float, default=artifact.RADIUS,
        help="build halo radius (rad); its excess over 3·psf_width is the margin "
        "that lets the lookup take the fast cell ids",
    )
    p.add_argument("--k0", type=int, default=artifact.K0,
                   help="base-table candidate slots per cell (the excess goes to the "
                   "overflow table)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from blackstar_tpu_torch.stars.catalog import read_catalog
    from blackstar_tpu_torch.stars.grid import build_star_grid_compact, save_star_grid

    if not os.path.isfile(args.catalog):
        print(f"Error: file {args.catalog} doesn't exist.")
        return 1

    print(f"Reading {args.catalog}...")
    if args.kdt:
        from blackstar_tpu_torch.stars.kdt import read_kdt

        catalog = read_kdt(args.catalog)
    else:
        catalog = read_catalog(args.catalog)
    print(f"Parsed {catalog.n_stars} stars.")

    with time_action("Building the star grid"):
        # The compact form (float64 slots) is what is written; loaders
        # densify at each scene's dtype.
        grid = build_star_grid_compact(catalog, cell_size=args.cell_size, radius=args.radius,
                                       k0=args.k0)

    out = args.output if args.output.endswith(".npz") else args.output + ".npz"
    if prompt_overwrite_file(out, lambda p: save_star_grid(grid, p), force=args.force):
        print("Star grid saved.")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
