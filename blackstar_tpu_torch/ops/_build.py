"""Build and load the package's CUDA kernels.

Each kernel is one ``.cu`` file with a plain C interface. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``build/`` at
the repository root, at first use, and loaded with ``ctypes``. The library's
file name carries a hash of the source, of the local headers it includes
(``#include "..."``) and of the flags, so an edited kernel or header
rebuilds and an unchanged one is reused. Nothing here runs at import time.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, because a refused launch (too many
registers, threads or shared memory) never runs and a later synchronise
does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> list:
    """``source`` and the local headers it includes, directly or through
    another local header (each once, in the order first included)."""
    seen, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            for name in _LOCAL_INCLUDE.findall(f.read()):
                todo.append(os.path.join(os.path.dirname(path), name.decode()))
    return seen


def library_path(source: str, extra_flags=()) -> str:
    """Where the library built from ``source`` with ``extra_flags`` lives."""
    key = hashlib.sha256()
    for path in _sources(source):
        with open(path, "rb") as f:
            key.update(f.read())
    key.update(repr(NVCC_FLAGS + tuple(extra_flags)).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{key.hexdigest()[:16]}.so")


def load(source: str, extra_flags=()) -> ctypes.CDLL:
    """Build ``source`` (if its library is missing) and load it. Returns the
    same CDLL on every call in a process."""
    path = library_path(source, extra_flags)
    lib = _loaded.get(path)
    if lib is not None:
        return lib
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # Build into a temporary name and rename: a concurrent or cut-off
        # build never leaves a truncated library at the final path.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, source]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {source}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
        print(f"built {os.path.basename(path)} in {time.perf_counter() - t0:.1f} s"
              + (f"\n{proc.stderr.strip()}" if proc.stderr.strip() else ""))
    lib = ctypes.CDLL(path)
    _loaded[path] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def check_tensor(what: str, t, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and ``dtype``
    on ``device``: what a kernel reads or writes through a raw pointer."""
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {tuple(shape)} {dtype} tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
