"""CLI dispatcher: ``python -m blackstar_tpu_torch <command> ...``.

The port has the ``render`` command (reference app/Main.hs) and ``fit``
(inverse rendering, the training path) so far.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {"render": "blackstar_tpu_torch.cli.render",
                "fit": "blackstar_tpu_torch.cli.fit"}
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in commands:
        print("usage: python -m blackstar_tpu_torch {render,fit} ...")
        print()
        print("  render         render scene YAML(s) to PNG")
        print("  fit            fit scene parameters to a target PNG")
        return 0 if argv and argv[0] in ("-h", "--help") else 2

    import importlib

    return importlib.import_module(commands[argv[0]]).main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
