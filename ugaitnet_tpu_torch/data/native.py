"""ctypes binding for the native batch gather (``csrc/gaitloader.cpp``).

Port of ``ugaitnet_tpu/data/native.py``.  The library is built with the host
C++ compiler at first use into ``build/native/`` beside the package (listed
in ``.gitignore``), never beside the source; without a compiler the gather
is ``np.take``.  Either path refuses out-of-range and negative indices and a
mistyped ``out=``, so a result never depends on which path a host uses.
This is host code: the copy to the card happens after it
(``data/pipeline.py``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "gaitloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libgaitloader.so")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")
ABI_VERSION = 3          # must match ug_version() in gaitloader.cpp

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
# a prefetch thread and the main thread can race the first call: without
# the lock both would compile and one would load a library the other is
# replacing
_LIB_LOCK = threading.Lock()


def _compiler() -> Optional[str]:
    for name in (os.environ.get("CXX", ""), "c++", "g++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def _build() -> bool:
    """Compile the source into LIB_PATH (atomically: a temporary file is
    renamed into place); False without a compiler or on a failed build."""
    cxx = _compiler()
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            return False
        os.replace(tmp, LIB_PATH)
        return True
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _needs_rebuild() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    return os.path.getmtime(SRC) > os.path.getmtime(LIB_PATH)


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(LIB_PATH)
    lib.ug_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    lib.ug_gather_rows.restype = ctypes.c_int
    lib.ug_version.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None without a toolchain."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None or _TRIED:   # the thread we waited on resolved it
            return _LIB
        _TRIED = True
        if _needs_rebuild() and not _build():
            return None
        try:
            lib = _load()
            if lib.ug_version() != ABI_VERSION:
                # a stale library from an older ABI: rebuild once
                if not _build():
                    return None
                lib = _load()
                if lib.ug_version() != ABI_VERSION:
                    return None
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def native_available() -> bool:
    return get_lib() is not None


def gather_rows(src: np.ndarray, idx: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[i] = src[idx[i]] for a C-contiguous (or memory-mapped) 2D+ array.

    Uses the native thread pool (all of its threads) when the library is
    available and both arrays are C-contiguous, ``np.take`` otherwise.
    """
    idx = np.ascontiguousarray(np.asarray(idx, dtype=np.int64))
    n = len(idx)
    row_shape = src.shape[1:]
    if n and idx.min() < 0:
        # negative indices would wrap in np.take but fail the native bounds
        # check: refuse them on both paths
        raise IndexError(f"negative gather index {idx.min()}")
    if out is None:
        out = np.empty((n, *row_shape), dtype=src.dtype)
    elif out.shape != (n, *row_shape) or out.dtype != src.dtype:
        # the native path copies n * row_bytes blindly into out's buffer: a
        # too-small or mistyped out would be a heap overrun, not an error
        raise ValueError(
            f"out has shape {out.shape} dtype {out.dtype}; need "
            f"{(n, *row_shape)} {src.dtype}")
    lib = get_lib()
    row_bytes = int(np.prod(row_shape)) * src.dtype.itemsize
    c_ok = (getattr(src, "flags", None) is not None
            and src.flags["C_CONTIGUOUS"] and out.flags["C_CONTIGUOUS"]
            and out.flags["WRITEABLE"])
    if lib is None or not c_ok:
        np.take(src, idx, axis=0, out=out)
        return out
    rc = lib.ug_gather_rows(
        src.ctypes.data_as(ctypes.c_void_p), int(src.shape[0]), row_bytes,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.c_void_p), 0)
    if rc != 0:
        raise IndexError(
            f"gather index out of range [0, {src.shape[0]}) "
            f"(min {idx.min()}, max {idx.max()})")
    return out
