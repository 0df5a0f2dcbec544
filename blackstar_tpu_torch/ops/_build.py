"""Build, load and bind the port's compiled libraries.

Each library is one source file with a plain C interface: a CUDA kernel
(``.cu``), compiled by ``nvcc`` for Hopper (``sm_90a``), or the native PNG
library (``.cpp``), compiled by ``g++``. It is built into a shared library
under ``build/`` at the repository root, at first use, and loaded with
``ctypes``. The library's file name carries a hash of the source, of the
local headers it includes (``#include "..."``) and of the flags, so an
edited source or header rebuilds and an unchanged one is reused. Nothing
here runs at import time.

A :class:`Library` declares one such library: its source, its flags and a
table of its C entry points (:class:`Entry`), from which every entry is
bound (``argtypes``, ``restype``) when the library is first loaded.
:meth:`Library.call` launches an entry: the dtype's variant, with the
stream handle appended where the entry takes one.

Every kernel entry point returns ``cudaGetLastError()`` after its launch;
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
from typing import NamedTuple

import torch

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
# The suffix of a dtype's entry point: ``bs_march_f32`` for ``bs_march``.
DTYPES = {torch.float32: "_f32", torch.float64: "_f64"}

# ctypes parameter types of the C interfaces.
P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _cxx() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    return cxx


def _command(source: str, extra_flags, out: str) -> list:
    """The compiler command that builds ``source`` into ``out``: ``nvcc``
    for a ``.cu``, ``g++`` for a ``.cpp`` (its extra flags, the libraries
    it links, after the source)."""
    if source.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", out, source]
    return [_cxx(), *CXX_FLAGS, source, "-o", out, *extra_flags]


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
    flags = NVCC_FLAGS if source.endswith(".cu") else CXX_FLAGS
    key.update(repr(flags + tuple(extra_flags)).encode())
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
        try:
            cmd = _command(source, extra_flags, tmp)
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cmd[0])} failed ({proc.returncode}) for {source}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        print(f"built {os.path.basename(path)} in {time.perf_counter() - t0:.1f} s"
              + (f"\n{proc.stderr.strip()}" if proc.stderr.strip() else ""))
    lib = ctypes.CDLL(path)
    _loaded[path] = lib
    return lib


class Entry(NamedTuple):
    """One C entry point of a library: its parameter types (ctypes, the
    C prototype's in order) and return type. With ``dtyped`` the source has
    one entry a dtype of :data:`DTYPES`, the name followed by the dtype's
    suffix; with ``stream`` the last parameter is the ``cudaStream_t``,
    which :meth:`Library.call` appends; an ``optional`` entry may be missing
    from a build (an older source)."""

    args: tuple
    returns: object = I
    dtyped: bool = False
    stream: bool = True
    optional: bool = False

    def names(self, name: str) -> list:
        """The C names of the entry table's ``name``."""
        return [name + s for s in DTYPES.values()] if self.dtyped else [name]


class Library:
    """A compiled library: ``source`` built with ``flags``, its C entry
    points declared by ``entries`` (``{name: Entry}``). Built, loaded and
    bound at first use; the load is shared by every Library of the same
    path in a process."""

    def __init__(self, source: str, flags=(), entries=None):
        self.source, self.flags, self.entries = source, tuple(flags), dict(entries or {})
        self._lib = None
        self._fns = {}

    @property
    def path(self) -> str:
        return library_path(self.source, self.flags)

    def load(self) -> ctypes.CDLL:
        """Build (if needed), load and bind the library, once; raises
        ``AttributeError`` if it lacks an entry that is not optional."""
        if self._lib is None:
            lib = load(self.source, self.flags)
            for name, entry in self.entries.items():
                for cname in entry.names(name):
                    fn = getattr(lib, cname, None)
                    if fn is None and not entry.optional:
                        raise AttributeError(f"{self.source} has no entry point {cname}")
                    if fn is not None:
                        fn.argtypes, fn.restype = entry.args, entry.returns
                        self._fns[cname] = fn
            self._lib = lib
        return self._lib

    def _cname(self, name: str, dtype) -> str:
        return name + DTYPES[dtype] if self.entries[name].dtyped else name

    def entry(self, name: str, dtype=None):
        """The bound C function of the table's ``name`` (``dtype``'s, for a
        dtyped entry); None for an optional entry this build lacks."""
        self.load()
        return self._fns.get(self._cname(name, dtype))

    def call(self, name: str, *args, dtype=None, device=None) -> None:
        """Call the table's ``name`` (``dtype``'s) with ``args``, followed
        by the current stream of ``device`` where the entry takes one, and
        raise if it returns a non-zero code."""
        fn = self.entry(name, dtype)
        if self.entries[name].stream:
            args += (stream_handle(device),)
        check(fn(*args), self._cname(name, dtype))


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
    return torch.cuda.current_stream(device).cuda_stream
