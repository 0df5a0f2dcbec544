"""Small CLI utilities (the reference's ``src/Util.hs``)."""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Callable


def prompt_overwrite_file(path: str, do_write: Callable[[str], None], force: bool = False) -> bool:
    """Write via ``do_write`` unless the file exists and the user declines
    (Util.hs:18-27). Returns True if written."""
    if force or not os.path.exists(path):
        do_write(path)
        return True
    if not sys.stdin.isatty():
        # Non-interactive run (nohup/CI): take the prompt's safe default
        # instead of crashing a long batch with EOFError mid-run.
        print(f"{path} exists and stdin is not a terminal — not overwriting "
              "(pass --force to overwrite).")
        return False
    answer = input(f"Overwrite {path}? [y/N] ")
    if answer in ("y", "Y"):
        do_write(path)
        return True
    print("Nothing was written.")
    return False


def normalize_path(path: str) -> str:
    """Normalise relative to the current directory (Util.hs:29-31)."""
    return os.path.normpath(os.path.relpath(path)) if path else path


@contextmanager
def time_action(name: str):
    """Wall-clock a block, printing "<name> completed in X min Y sec."
    (Util.hs:33-41)."""
    t0 = time.perf_counter()
    yield
    secs = int(round(time.perf_counter() - t0))
    print(f"{name} completed in {secs // 60} min {secs % 60} sec.")


def clear_screen() -> None:
    """ANSI clear + home (app/Main.hs:73-74)."""
    if sys.stdout.isatty():
        sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.flush()
