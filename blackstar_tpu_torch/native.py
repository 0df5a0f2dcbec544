"""ctypes bindings to the port's native IO runtime
(``blackstar_tpu_torch/csrc/blackstar_native.cpp``).

The library holds the production IO path of batch and animation renders:
zlib PNG writing and an asynchronous frame-writer pool, one thread for each
usable host CPU (:func:`pool_threads`), that deflates frames in bands and
writes them while the card renders the next ones. The C++ source has no
framework in it. It is the port's own copy, forked from the JAX package's
``native/blackstar_native.cpp``, which stays as it is: the synchronous
writers and the sRGB encode write the same bytes in both, and a frame the
pool deflates as one band is byte-identical to theirs; a larger one is cut
into primed bands (the source's header comment) and decodes to the same
pixels.

The port builds its copy with ``g++ -lz`` at first use, through
``ops/_build.py`` as it builds the kernels: into ``build/`` at the
repository root, under a name that carries a hash of the source and of the
flags, so an edited source rebuilds. Nothing is built or loaded at import.
Without ``g++`` or ``zlib.h`` the library is unavailable: :func:`available`
is False and :data:`load_error` says why;
:func:`blackstar_tpu_torch.imageio.write_png` then writes through its
pure-Python encoder.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
from typing import Optional

import numpy as np

from blackstar_tpu_torch.ops import _build
from blackstar_tpu_torch.ops._build import I, L, P

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "blackstar_native.cpp")
FLAGS = ("-lz", "-pthread")  # linked after the source
CPU_MAX = "/sys/fs/cgroup/cpu.max"  # the cgroup's CPU quota and period, where one is set

_U8P, _F32P, _F64P = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_float, ctypes.c_double))
_STR = ctypes.c_char_p
LIBRARY = _build.Library(SOURCE, FLAGS, {
    name: _build.Entry(args, returns, stream=False) for name, args, returns in (
        ("bs_srgb_encode", (_F32P, _U8P, L, I), None),
        ("bs_write_png_rgb8", (_STR, _U8P, I, I, I), I),
        ("bs_write_png_linear", (_STR, _F32P, I, I, I, I), I),
        ("bs_writer_create", (I,), P),
        ("bs_writer_submit", (P, _STR, _F32P, I, I, I), None),
        ("bs_writer_submit_rgb8", (P, _STR, _U8P, I, I, I), None),
        ("bs_writer_wait", (P,), I),
        ("bs_writer_stats", (P, _F64P), None),
        ("bs_writer_destroy", (P,), None))
})

_lib = None
_tried = False
load_error: Optional[str] = None  # why the library is unavailable, once a load failed


def library_path() -> str:
    """Where the library built from :data:`SOURCE` with these flags lives."""
    return LIBRARY.path


def load():
    """The native library, built at first use; None if it cannot be built
    or loaded (:data:`load_error` then says why). The outcome is kept for
    the life of the process."""
    global _lib, _tried, load_error
    if _tried:
        return _lib
    _tried = True
    try:
        _lib = LIBRARY.load()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        load_error = str(e)
    return _lib


def available() -> bool:
    return load() is not None


def pool_threads() -> int:
    """The writer pool's threads: the CPUs this process may run on, capped
    by the cgroup's CPU quota where :data:`CPU_MAX` sets one; at least 1."""
    n = len(os.sched_getaffinity(0))
    try:
        with open(CPU_MAX) as f:
            quota, period = f.read().split()[:2]
        if quota != "max":
            n = min(n, math.ceil(int(quota) / int(period)))
    except (OSError, ValueError):
        pass  # no cgroup v2 quota here
    return max(1, n)


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
    """Asynchronous PNG writer pool (the batch and animation IO path), with
    :func:`pool_threads` threads.

    A frame is copied at :meth:`submit`, so the caller may reuse or free its
    buffer as soon as the call returns; its filtered rows are deflated in
    bands of about 512 KiB, each a task for any of the threads, and the
    thread that deflates its last band writes the file. :meth:`wait` blocks
    until every frame submitted so far is on disk and returns the count of
    failed frames since the pool was made (a failed band or write fails its
    frame once).
    """

    STATS = ("frames", "bands", "deflate_s", "write_s", "bytes")

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {load_error}")
        self._lib = lib
        self.threads = pool_threads()
        self._handle = lib.bs_writer_create(self.threads)
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

    def stats(self) -> dict:
        """Since the pool was made: ``frames`` written, ``bands`` deflated,
        ``deflate_s`` and ``write_s`` (seconds summed over the threads:
        deflating bands, writing files) and ``bytes`` written."""
        self._check_open()
        out = (ctypes.c_double * len(self.STATS))()
        self._lib.bs_writer_stats(self._handle, out)
        return {k: (v if k.endswith("_s") else int(v)) for k, v in zip(self.STATS, out)}

    def close(self) -> None:
        if self._handle:
            self._lib.bs_writer_wait(self._handle)
            self._lib.bs_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
