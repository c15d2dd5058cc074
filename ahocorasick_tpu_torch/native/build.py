"""Build the port's native host library with g++ (the counterpart of
``ahocorasick_tpu/native/build.py``).

The library is compiled from the port's own copy of the source,
``native/src/ac_native.cpp``, into ``ahocorasick_tpu_torch/_build/`` at first
use of ``native.lib`` (best-effort there: every caller has a pure-numpy
path), or explicitly:

    python -m ahocorasick_tpu_torch.native.build
"""

from __future__ import annotations

import os
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src", "ac_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
OUT = os.path.join(BUILD_DIR, "libac_native.so")


def build(force: bool = False) -> str:
    """Compile if missing/stale; returns the .so path."""
    if (
        not force
        and os.path.exists(OUT)
        and os.path.getmtime(OUT) >= os.path.getmtime(SRC)
    ):
        return OUT
    os.makedirs(BUILD_DIR, exist_ok=True)
    # A per-process temporary plus os.replace: concurrent first uses never
    # load a half-written library.
    tmp = f"{OUT}.tmp.{os.getpid()}"
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-o",
        tmp,
        SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, OUT)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return OUT


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    print(path)
