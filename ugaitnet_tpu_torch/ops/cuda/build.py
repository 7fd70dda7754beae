"""Build a CUDA source of ``ugaitnet_tpu_torch/csrc`` into a shared library.

Each source has a plain C interface and is compiled by ``nvcc`` for Hopper
(``sm_90a``: ``wgmma`` and ``setmaxnreg`` exist only there) at first use,
then loaded with ``ctypes``.  The library goes to ``build/kernels/`` beside
the package (listed in ``.gitignore``) and is rebuilt when its source, or a
header of ``csrc`` (``*.cuh``), is newer.  Nothing is built at import time.

The TMA kernels (``conv3x3.cu``, ``probes.cu``) encode their tensor maps
with the driver-API function ``cuTensorMapEncodeTiled``, which they reach
through the runtime's ``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh``):
the libraries link no ``-lcuda``, so NVCC_FLAGS names no driver library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is missing or stale; return
    the library's path.  The compiler's report (``-Xptxas -v``) is kept in
    ``<name>.log`` beside the library."""
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    newest = max(os.path.getmtime(p) for p in [src] + [
        os.path.join(CSRC, h) for h in os.listdir(CSRC) if h.endswith(".cuh")])
    if os.path.exists(lib) and os.path.getmtime(lib) >= newest:
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
