"""CLI dispatcher: ``python -m blackstar_tpu_torch <command> ...``.

The commands mirror the JAX package's: ``render`` (reference app/Main.hs),
``animate`` (app/Animate.hs), ``generate-grid`` (app/GenerateTree.hs, the
k-d tree replaced by the bucketed star grid) and ``fit`` (inverse
rendering, the training path).
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {"render": "blackstar_tpu_torch.cli.render",
                "animate": "blackstar_tpu_torch.cli.animate",
                "generate-grid": "blackstar_tpu_torch.cli.generate_grid",
                "fit": "blackstar_tpu_torch.cli.fit"}
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in commands:
        print("usage: python -m blackstar_tpu_torch {render,animate,generate-grid,fit} ...")
        print()
        print("  render         render scene YAML(s) to PNG")
        print("  animate        expand a keyframe animation into frame YAMLs, or render it")
        print("  generate-grid  build the star grid from a PPM catalogue or a stars.kdt")
        print("  fit            fit scene parameters to a target PNG")
        return 0 if argv and argv[0] in ("-h", "--help") else 2

    import importlib

    return importlib.import_module(commands[argv[0]]).main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
