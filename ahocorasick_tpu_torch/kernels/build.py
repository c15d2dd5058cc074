"""Build the CUDA kernels of ``csrc/`` with nvcc into a plain-C shared
library, and load it with ctypes.

The library is built at first use, from the package's own sources, into
``ahocorasick_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited kernel is never served from a stale build.  A
temporary file plus ``os.replace`` keeps concurrent builders from loading a
half-written library.  Building needs ``nvcc`` (``$CUDA_HOME/bin``,
``/usr/local/cuda/bin`` or ``PATH``); the ptxas report (registers, shared
memory, spills) is kept beside the library as ``<name>.log``.

    python -m ahocorasick_tpu_torch.kernels.build
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG, "csrc", "packed_scan.cu"),)
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libpacked_scan-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a build of these exact sources exists;
    returns the library path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    proc = subprocess.run(
        [_nvcc(), *FLAGS, "-o", tmp, *SOURCES],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    with open(out[: -len(".so")] + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        args = [
            ctypes.c_void_p,  # table
            ctypes.c_void_p,  # windows
            ctypes.c_int,  # window_bytes
            ctypes.c_int64,  # num_windows
            ctypes.c_int,  # width
            ctypes.c_int,  # halo
            ctypes.c_int,  # num_classes (table row stride)
            ctypes.c_int,  # state_bits
            ctypes.c_void_p,  # out
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        for fn in (lib.packed_scan_count, lib.packed_scan_planes):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


if __name__ == "__main__":
    print(build())
