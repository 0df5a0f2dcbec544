"""ctypes bindings to the native IO runtime (``native/blackstar_native.cpp``).

The library holds the production IO path of batch and animation renders:
zlib PNG writing and an asynchronous frame-writer pool whose threads
compress and write frames while the card renders the next ones. The C++
source has no framework in it; the JAX package binds the same file.

The port builds its own copy with ``g++ -lz`` at first use, into ``build/``
at the repository root, under a name that carries a hash of the source and
of the flags (as ``ops/_build.py`` names the kernels), so the two packages
never share a build product and an edited source rebuilds. Nothing is built
or loaded at import. Without ``g++`` or ``zlib.h`` the library is
unavailable: :func:`available` is False and :data:`load_error` says why;
:func:`blackstar_tpu_torch.imageio.write_png` then writes through its
pure-Python encoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

from blackstar_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
    "blackstar_native.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
LD_FLAGS = ("-lz", "-pthread")

_lib = None
_tried = False
load_error: Optional[str] = None  # why the library is unavailable, once a load failed


def library_path() -> str:
    """Where the library built from :data:`SOURCE` with these flags lives."""
    key = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        key.update(f.read())
    key.update(repr(CXX_FLAGS + LD_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libblackstar_native-{key.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build into a temporary name and rename: a concurrent or cut-off build
    # never leaves a truncated library at the final path.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LD_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    c_int = ctypes.c_int
    lib.bs_write_png_rgb8.argtypes = [ctypes.c_char_p, u8p, c_int, c_int, c_int]
    lib.bs_write_png_rgb8.restype = c_int
    lib.bs_write_png_linear.argtypes = [ctypes.c_char_p, f32p, c_int, c_int, c_int, c_int]
    lib.bs_write_png_linear.restype = c_int
    lib.bs_writer_create.argtypes = [c_int]
    lib.bs_writer_create.restype = ctypes.c_void_p
    lib.bs_writer_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, f32p, c_int, c_int, c_int]
    lib.bs_writer_submit.restype = None
    lib.bs_writer_submit_rgb8.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u8p, c_int, c_int,
                                          c_int]
    lib.bs_writer_submit_rgb8.restype = None
    lib.bs_writer_wait.argtypes = [ctypes.c_void_p]
    lib.bs_writer_wait.restype = c_int
    lib.bs_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.bs_writer_destroy.restype = None
    return lib


def load():
    """The native library, built at first use; None if it cannot be built
    or loaded (:data:`load_error` then says why). The outcome is kept for
    the life of the process."""
    global _lib, _tried, load_error
    if _tried:
        return _lib
    _tried = True
    try:
        path = library_path()
        if not os.path.exists(path):
            _compile(path)
        _lib = _bind(ctypes.CDLL(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        load_error = str(e)
    return _lib


def available() -> bool:
    return load() is not None


def _image(img: np.ndarray, dtype) -> np.ndarray:
    arr = np.ascontiguousarray(img, dtype=dtype)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    return arr


def write_png_rgb8(rgb8: np.ndarray, path: str, *, level: int = 6) -> bool:
    """Write an sRGB uint8 (H, W, 3) image as a PNG. Returns False if the
    library is unavailable; raises IOError if the write fails."""
    lib = load()
    if lib is None:
        return False
    arr = _image(rgb8, np.uint8)
    h, w, _ = arr.shape
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.bs_write_png_rgb8(path.encode(), ptr, w, h, level)
    if rc != 0:
        raise IOError(f"native PNG write failed (rc={rc}) for {path}")
    return True


def write_png_linear(img: np.ndarray, path: str, *, level: int = 6, n_threads: int = 4) -> bool:
    """Write a linear-RGB (H, W, 3) image as an sRGB PNG, encoded in float32
    by the library (it may differ by 1 on the uint8 scale from the float64
    encoder of ``imageio``). Returns False if the library is unavailable."""
    lib = load()
    if lib is None:
        return False
    arr = _image(img, np.float32)
    h, w, _ = arr.shape
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.bs_write_png_linear(path.encode(), ptr, w, h, level, n_threads)
    if rc != 0:
        raise IOError(f"native PNG write failed (rc={rc}) for {path}")
    return True


class AsyncFrameWriter:
    """Asynchronous PNG writer pool (the batch and animation IO path).

    A frame is copied at :meth:`submit`, so the caller may reuse or free its
    buffer as soon as the call returns; :meth:`wait` blocks until every
    frame submitted so far is on disk and returns the count of failed
    writes since the pool was made.
    """

    def __init__(self, n_threads: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {load_error}")
        self._lib = lib
        self._handle = lib.bs_writer_create(n_threads)
        if not self._handle:
            raise RuntimeError("bs_writer_create failed (allocation or thread start)")

    def _check_open(self) -> None:
        # A NULL handle would be dereferenced inside the library.
        if not self._handle:
            raise RuntimeError("writer closed")

    def submit(self, path: str, img: np.ndarray, *, level: int = 6) -> None:
        """Queue a frame: an sRGB uint8 (H, W, 3) image as it is, any other
        dtype as linear RGB encoded by the library in float32."""
        self._check_open()
        if np.asarray(img).dtype == np.uint8:
            arr = _image(img, np.uint8)
            h, w, _ = arr.shape
            self._lib.bs_writer_submit_rgb8(self._handle, path.encode(),
                                            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                            w, h, level)
            return
        arr = _image(img, np.float32)
        h, w, _ = arr.shape
        self._lib.bs_writer_submit(self._handle, path.encode(),
                                   arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                   w, h, level)

    def wait(self) -> int:
        """Block until every submitted frame is written; the error count."""
        self._check_open()
        return self._lib.bs_writer_wait(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.bs_writer_wait(self._handle)
            self._lib.bs_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
