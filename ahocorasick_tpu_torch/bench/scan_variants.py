"""The count kernel's and the hotstate plane's designs, timed side by side on
the card.

    python -m ahocorasick_tpu_torch.bench.scan_variants

``csrc/packed_scan.cu``'s ``packed_scan_count`` reads each lane's classes a
32-bit word at a time into a 32-step register tile and runs K lanes per
window; ``csrc/huge_scan.cu``'s ``packedcount_hotstate_plane`` runs the
planes kernels' lane (``tile.cuh`` ``planes_lane``: word loads, the 16-step
shared-memory store tile, K lanes per window).  This script builds the other
designs measured for those choices from ``scan_variants.cu`` beside it (the
count with one class load a step and one lane per window, the count with two
chains a thread, the hotstate plane with one class load a step and a 4-byte
store per lane at its own row, the same plane through the store tile with
one class load a step), and times them with the package's kernels at K = 1,
2 and 4 lanes per window on the first 8,192, 32,768 and 65,536 windows of
two cells: the count on the 10k headline dictionary (65,536 x 524 uint8
windows of class-space word soup, ``bench.headline``) and the hotstate plane
on the 1M-keyword dictionary of ``tests/test_full_random_1m.py`` (seed 77,
a 470 MB count-packed table) over BASELINE config #5's word soup, 32 Mi
units in 512-class windows.  Every variant is checked bit for bit against
the package's wrapper on the same windows first.  Prints one JSON line: ms
per launch of each (CUDA events, best of 3 timings of 20 launches after a
warm-up; each window count's variants timed in order, then in reverse, and
the lower of the two kept), the K that the package's rules pick, and the
card's name and power limit.  The package never launches these designs.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from ahocorasick_tpu_torch.kernels import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scan_variants.cu")
STEM = "libscan_variants"
VARIANTS = ("count_bytes", "count_chains2", "hotstate_rows", "hotstate_tile_bytes")
SWEEP_WINDOWS = (8_192, 32_768, 65_536)
ONE_M_SEED = 77  # tests/test_full_random_1m.py
ONE_M_CANDIDATES = 1_100_000


def one_m_keywords(n_cand: int = ONE_M_CANDIDATES):
    """The seed-77 generator of ``tests/test_full_random_1m.py``: sorted
    distinct random lowercase keywords of 3-12 letters, the first million;
    returns the generator too, for the text that follows it, and the
    letters."""
    rng = np.random.default_rng(ONE_M_SEED)
    lens = rng.integers(3, 13, size=n_cand)
    flat = rng.integers(0, 26, size=int(lens.sum()))
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    chars = letters[flat].tobytes().decode()
    offs = np.concatenate([[0], np.cumsum(lens)])
    kws = {chars[offs[i]: offs[i + 1]] for i in range(n_cand)}
    return sorted(kws)[:1_000_000], rng, letters


def library() -> ctypes.CDLL:
    """``scan_variants.cu`` built like the package's kernels
    (``kernels/build.build``), loaded."""
    path = build.build((SOURCE,), STEM)
    lib = ctypes.CDLL(path)
    for name in VARIANTS:
        getattr(lib, name).argtypes = build.ARGTYPES["packed_scan_count"]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _seg_len(body: int, k: int) -> int:
    return body if k == 1 else -(-body // (4 * k)) * 4


def _sweep(runs: dict, check) -> dict:
    """``{label: ms}`` for ``runs`` (``label: launch``), each checked by
    ``check(label, launch)`` first, timed in order and in reverse."""
    from ahocorasick_tpu_torch.bench import _seconds_per_rep

    for label, launch in runs.items():
        check(label, launch)
    ms = {}
    for label in [*runs, *reversed(runs)]:
        t = _seconds_per_rep(runs[label], 20, torch.device("cuda")) * 1e3
        ms[label] = min(ms.get(label, t), t)
    return ms


def run(count_cell: tuple, hot_cell: tuple, lib=None) -> dict:
    """The A/B of both kernels.  ``count_cell``: ``(table uint32[S, A],
    windows, halo, state_bits)`` of ``packed_scan_count``; ``hot_cell``:
    ``(table_flat, windows, halo, state_bits, num_classes)`` of
    ``packedcount_hotstate_plane``; both on the card with at least 65,536
    windows.  Returns the record ``main`` prints."""
    from ahocorasick_tpu_torch.kernels import scan_batched as khuge
    from ahocorasick_tpu_torch.kernels import scan_block

    lib = library() if lib is None else lib
    table, w, halo, sb = count_cell
    dev = w.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    B, W = w.shape
    C = W - halo
    wb = scan_block._WINDOW_BYTES[w.dtype]
    A = table.shape[1]
    count_out = torch.zeros(1, dtype=torch.int64, device=dev)

    def count_launch(fn, b, k):
        def launch():
            count_out.zero_()
            rc = fn(table.data_ptr(), w.data_ptr(), wb, b, W, halo, A, sb, k, _seg_len(C, k),
                    count_out.data_ptr(), dev.index or 0, stream)
            if rc != 0:
                raise RuntimeError(f"count variant launch failed: CUDA error {rc}")
        return launch

    package_count = build.library().packed_scan_count
    count = {}
    for b in SWEEP_WINDOWS:
        want = int(scan_block.packed_scan_count(table, w[:b], halo, sb))

        def check(label, launch, want=want, b=b):
            launch()
            got = int(count_out[0])
            if got != want:
                raise AssertionError(f"count B={b} {label}: {got} != the wrapper's {want}")

        runs = {"bytes K=1": count_launch(lib.count_bytes, b, 1)}
        runs.update({f"words K={k}": count_launch(package_count, b, k) for k in (1, 2, 4)})
        runs.update({f"chains2 K={k}": count_launch(lib.count_chains2, b, k) for k in (2, 4)})
        count[f"B={b}"] = _sweep(runs, check)

    flat, wh, hhalo, hsb, hA = hot_cell
    hB, hW = wh.shape
    hC = hW - hhalo
    hwb = scan_block._WINDOW_BYTES[wh.dtype]
    want_plane = khuge.packedcount_hotstate_plane(*hot_cell).view(torch.int32)
    plane = torch.empty((1, hB * hC), dtype=torch.int32, device=dev)

    def hot_launch(fn, b, k):
        def launch():
            rc = fn(flat.data_ptr(), wh.data_ptr(), hwb, b, hW, hhalo, hA, hsb, k,
                    _seg_len(hC, k), plane.data_ptr(), dev.index or 0, stream)
            if rc != 0:
                raise RuntimeError(f"hotstate variant launch failed: CUDA error {rc}")
        return launch

    package_hot = build.library().packedcount_hotstate_plane
    hot = {}
    for b in SWEEP_WINDOWS:
        def check(label, launch, b=b):
            plane.fill_(-1)
            launch()
            bad = int((plane[:, : b * hC] != want_plane[:, : b * hC]).sum())
            if bad:
                raise AssertionError(f"hotstate B={b} {label}: {bad} words differ from the "
                                     f"wrapper's")

        runs = {"rows K=1": hot_launch(lib.hotstate_rows, b, 1)}
        runs.update({f"tile_bytes K={k}": hot_launch(lib.hotstate_tile_bytes, b, k)
                     for k in (1, 2, 4)})
        runs.update({f"tile_words K={k}": hot_launch(package_hot, b, k) for k in (1, 2, 4)})
        hot[f"B={b}"] = _sweep(runs, check)
    torch.cuda.synchronize()
    return {
        "count_cell": {"windows": [B, W], "halo": halo, "table_bytes": table.nbytes,
                       "rule_K": {f"B={b}": scan_block.segments(
                           b, C, halo, scan_block.COUNT_MAX_LANES)[0] for b in SWEEP_WINDOWS}},
        "count_ms": count,
        "hotstate_cell": {"windows": [hB, hW], "halo": hhalo, "table_bytes": flat.nbytes,
                          "rule_K": {f"B={b}": scan_block.segments(
                              b, hC, hhalo, khuge.HOTSTATE_MAX_LANES)[0]
                              for b in SWEEP_WINDOWS}},
        "hotstate_ms": hot,
    }


def main() -> None:
    from ahocorasick_tpu_torch.bench.__main__ import word_soup
    from ahocorasick_tpu_torch.bench.headline import (
        BASE_UNITS, CHUNK, N_KEYWORDS, SEED, TEXT_UNITS, make_dictionary, make_text_classes)
    from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet
    from ahocorasick_tpu_torch.ops import scan_batched

    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lib = library()
    rng = np.random.default_rng(SEED)
    keywords = make_dictionary(rng, N_KEYWORDS)
    m = AhoCorasickSet(keywords, engine="device", device=dev)
    pd = m.dev.packed_dfa
    base = make_text_classes(m, keywords, rng, BASE_UNITS)
    w = scan_batched.classes_to_device(
        scan_batched.chunk_classes(np.tile(base, TEXT_UNITS // BASE_UNITS), CHUNK, pd.halo,
                                   m.compiled.num_classes), m.compiled.num_classes, dev)
    kws1m, _, _ = one_m_keywords()
    m1 = AhoCorasickSet(kws1m, engine="device", device=dev)
    flat, sb, halo = m1.dev.count_packed_dfa
    A = m1.compiled.num_classes
    text = word_soup(np.random.default_rng(SEED + 6), kws1m, BASE_UNITS)
    cls = np.tile(m1._classes(text), TEXT_UNITS // BASE_UNITS)
    wh = scan_batched.classes_to_device(scan_batched.chunk_classes(cls, CHUNK, halo, A), A, dev)
    record = run((pd.table, w, pd.halo, pd.state_bits), (flat, wh, halo, sb, A), lib)
    print(json.dumps({"card": smi, **record}))


if __name__ == "__main__":
    main()
