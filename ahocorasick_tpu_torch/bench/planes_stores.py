"""The packed planes kernel's designs, timed side by side on the card.

    python -m ahocorasick_tpu_torch.bench.planes_stores

``csrc/packed_scan.cu`` reads each lane's classes a 32-bit word at a time
and stores its emit words through a shared-memory tile of 16 steps with
16-byte stores.  This script builds the other designs measured for that
choice from ``planes_stores.cu`` beside it (a 32-step tile with one class
load a step, the same tile with word loads, and a TMA bulk store of each
lane's run committed while the next tile is scanned), checks each against
the package's kernel bit for bit at the main path's windows (the 10k
headline dictionary, 65,536 x 524 uint8 windows of class-space word soup),
and times the package's kernel at K = 1, 2 and 4 lanes per window on the
first 8,192, 32,768 and 65,536 windows (the rule of
``kernels/scan_block.segments``).  Prints one JSON line: ms per launch of
each (CUDA events, best of 3 timings of 20 launches after a warm-up; the
designs timed in the order package, alternatives, alternatives reversed,
package) and of the count kernel, with the card's name and power limit.
The package never launches these designs.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from ahocorasick_tpu_torch.kernels import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "planes_stores.cu")
DESIGNS = ("planes_tile32_bytes", "planes_tile32_words", "planes_bulk")
SWEEP_WINDOWS = (8_192, 32_768, 65_536)


def library() -> ctypes.CDLL:
    """``planes_stores.cu`` built like the package's kernels
    (``kernels/build.build``), loaded."""
    path = build.build((SOURCE,), "libplanes_stores")
    with open(path[: -len(".so")] + ".log") as fh:
        for line in fh.read().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas: {line.strip()}")
    lib = ctypes.CDLL(path)
    for name in DESIGNS:
        getattr(lib, name).argtypes = build.ARGTYPES["packed_scan_planes"]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main() -> None:
    from ahocorasick_tpu_torch.bench import _seconds_per_rep
    from ahocorasick_tpu_torch.bench.headline import (
        BASE_UNITS, CHUNK, N_KEYWORDS, SEED, TEXT_UNITS, make_dictionary, make_text_classes)
    from ahocorasick_tpu_torch.kernels import scan_block
    from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet
    from ahocorasick_tpu_torch.ops import scan_batched

    if not torch.cuda.is_available():
        raise SystemExit("planes_stores: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(SEED)
    keywords = make_dictionary(rng, N_KEYWORDS)
    m = AhoCorasickSet(keywords, engine="device", device=dev)
    pd = m.dev.packed_dfa
    base = make_text_classes(m, keywords, rng, BASE_UNITS)
    cls = np.tile(base, TEXT_UNITS // BASE_UNITS)
    w = scan_batched.classes_to_device(
        scan_batched.chunk_classes(cls, CHUNK, pd.halo, m.compiled.num_classes),
        m.compiled.num_classes, dev)
    B, W = w.shape
    K, L = scan_block.segments(B, W - pd.halo, pd.halo)
    args = (pd.table, w, pd.halo, pd.state_bits)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def design(name):
        def run():
            out = torch.empty((1, B * (W - pd.halo)), dtype=torch.uint32, device=dev)
            rc = getattr(lib, name)(pd.table.data_ptr(), w.data_ptr(), 1, B, W, pd.halo,
                                    pd.table.shape[1], pd.state_bits, K, L, out.data_ptr(),
                                    dev.index or 0, stream)
            if rc != 0:
                raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
            return out
        return run

    runs = {"packed_scan_planes": lambda: scan_block.packed_scan_planes(*args)}
    runs.update({name: design(name) for name in DESIGNS})
    want = runs["packed_scan_planes"]()
    errs = {}
    for name in DESIGNS:
        got = runs[name]()
        torch.cuda.synchronize()
        errs[name] = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if errs[name]:
            raise AssertionError(f"{name}: {errs[name]} words differ from packed_scan_planes")
    order = ["packed_scan_planes", *DESIGNS, *reversed(DESIGNS), "packed_scan_planes"]
    ms = {name: [] for name in runs}
    for name in order:
        ms[name].append(_seconds_per_rep(runs[name], 20, dev) * 1e3)
    count_ms = _seconds_per_rep(lambda: scan_block.packed_scan_count(*args), 20, dev) * 1e3
    # The package's kernel with K forced, on the first B windows.
    lanes = {}
    C = W - pd.halo
    for b in SWEEP_WINDOWS:
        out = torch.empty((1, b * C), dtype=torch.uint32, device=dev)
        for k in (1, 2, 4):
            seg = -(-C // (4 * k)) * 4

            def run(b=b, k=k, seg=seg, out=out):
                build.call("packed_scan_planes", pd.table.data_ptr(), w.data_ptr(), 1, b, W,
                           pd.halo, pd.table.shape[1], pd.state_bits, k, seg, out.data_ptr(),
                           dev.index or 0, stream)
            run()
            if not torch.equal(out, want[:, : b * C]):
                raise AssertionError(f"packed_scan_planes B={b} K={k} differs from the wrapper's")
            lanes[f"B={b} K={k}"] = _seconds_per_rep(run, 20, dev) * 1e3
    print(json.dumps({"card": smi, "windows": [B, W], "halo": pd.halo, "segments": [K, L],
                      "ms": ms, "packed_scan_count_ms": count_ms, "words_differing": errs,
                      "segments_ms": lanes}))

if __name__ == "__main__":
    main()
