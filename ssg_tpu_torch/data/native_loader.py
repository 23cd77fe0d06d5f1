"""ctypes bindings for libssg_data, the native C++ host data pipeline.

The port's own copy of ``ssg_tpu/data/native_loader.py``, over the same C++
sources (``native/ssg_data/{image,loader}.cc``): fused JPEG/PNG/PPM decode
(sniffed by magic bytes, whatever the file's extension) + bilinear resize +
threaded batch assembly, and a background-prefetching loader that decodes
the next batches while the card works on the current one.

Where the JAX package runs ``make`` inside ``native/ssg_data``, the port
compiles the sources itself with the Makefile's flags and libraries, once,
into ``ssg_tpu_torch/_build/`` (git-ignored; keyed by a hash of the sources
and the command, written under a temporary name and renamed). If that build
fails (no ``g++``, no ``jpeglib.h`` / ``png.h``), ``is_available()`` is
False, ``last_build_error()`` holds the compiler's output, and callers
decode with PIL, as the JAX package's do. ``SSG_TPU_NO_NATIVE=1`` forces
that fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native" / "ssg_data"
BUILD_DIR = _PKG / "_build"
SOURCES = ("image.cc", "loader.cc")
# native/ssg_data/Makefile's CXXFLAGS and LDLIBS.
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread"]
LDLIBS = ["-ljpeg", "-lpng", "-pthread"]

_lib = None
_lib_lock = threading.Lock()
_load_attempted = False
_build_error: str | None = None


def _lib_path() -> Path:
    digest = hashlib.sha256(" ".join(CXXFLAGS + LDLIBS).encode())
    for name in (*SOURCES, "ssg_data.h"):
        digest.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libssg_data-{digest.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """Compile the library unless a current one exists; None on failure,
    with the compiler's output kept for ``last_build_error``."""
    global _build_error
    try:
        out = _lib_path()
    except OSError as e:  # the C++ sources are not beside the package
        _build_error = f"native sources unreadable: {e}"
        return None
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, "-shared", "-o", str(tmp),
           *(str(NATIVE_DIR / s) for s in SOURCES), *LDLIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_error = f"{' '.join(cmd)}: {e}"
        return None
    if proc.returncode != 0:
        _build_error = f"{' '.join(cmd)} (exit {proc.returncode}):\n{proc.stderr}"
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _try_load():
    global _lib, _load_attempted, _build_error
    with _lib_lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("SSG_TPU_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = f"loading {path}: {e}"
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.ssg_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p]
        lib.ssg_decode_resize.restype = ctypes.c_int
        lib.ssg_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p, ctypes.c_int, i32p,
        ]
        lib.ssg_load_batch.restype = ctypes.c_int
        lib.ssg_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.ssg_loader_create.restype = ctypes.c_void_p
        lib.ssg_loader_next.argtypes = [ctypes.c_void_p, u8p, i32p]
        lib.ssg_loader_next.restype = ctypes.c_int
        lib.ssg_loader_reset.argtypes = [ctypes.c_void_p]
        lib.ssg_loader_reset.restype = None
        lib.ssg_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.ssg_loader_destroy.restype = None
        lib.ssg_data_version.argtypes = []
        lib.ssg_data_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def is_available() -> bool:
    return _try_load() is not None


def last_build_error() -> str | None:
    """Why the library could not be built or loaded (the compiler's
    output), or None."""
    return _build_error


def _paths_array(paths: list[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def decode_resize(path: str, height: int, width: int) -> np.ndarray:
    """Decode one image file and bilinear-resize to (height, width, 3) u8."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError("libssg_data unavailable")
    out = np.empty((height, width, 3), dtype=np.uint8)
    rc = lib.ssg_decode_resize(
        path.encode(), height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise IOError(f"ssg_decode_resize({path!r}) failed with code {rc}")
    return out


def load_batch(paths: list[str], height: int, width: int,
               num_threads: int = 0) -> np.ndarray:
    """Threaded decode+resize of a batch -> (N, height, width, 3) u8.

    Failed items raise (the native layer zero-fills and reports them)."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError("libssg_data unavailable")
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    err = np.full((n,), -1, dtype=np.int32)
    nfail = lib.ssg_load_batch(
        _paths_array(paths), n, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads,
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if nfail:
        bad = [paths[i] for i in err if i >= 0]
        raise IOError(f"{nfail} image(s) failed to decode: {bad[:5]}")
    return out


class BatchLoader:
    """Background-prefetching epoch iterator over a file list.

    Yields (images_u8 (B,H,W,3), valid) with the tail batch zero-padded;
    decode of batch i+1..i+prefetch proceeds while the consumer holds
    batch i (overlap with the card's work).
    """

    def __init__(self, paths: list[str], batch_size: int, height: int,
                 width: int, num_threads: int = 0, prefetch: int = 2):
        lib = _try_load()
        if lib is None:
            raise RuntimeError("libssg_data unavailable")
        self._lib = lib
        self._shape = (batch_size, height, width, 3)
        self.num_batches = (len(paths) + batch_size - 1) // batch_size
        self._handle = lib.ssg_loader_create(
            _paths_array(paths), len(paths), batch_size, height, width,
            num_threads, prefetch,
        )
        if not self._handle:
            raise RuntimeError("ssg_loader_create failed")

    def __iter__(self):
        self._lib.ssg_loader_reset(self._handle)
        valid = ctypes.c_int(0)
        while True:
            out = np.empty(self._shape, dtype=np.uint8)
            ok = self._lib.ssg_loader_next(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(valid),
            )
            if not ok:
                return
            yield out, int(valid.value)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.ssg_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
