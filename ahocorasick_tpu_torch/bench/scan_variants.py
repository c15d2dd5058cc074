"""The designs of four scan kernels, timed side by side on the card.

    python -m ahocorasick_tpu_torch.bench.scan_variants

``csrc/packed_scan.cu``'s ``packed_scan_count`` and ``csrc/huge_scan.cu``'s
``packedcount_count`` run the count lane (``tile.cuh`` ``count_lane``: the
classes read a 32-bit word at a time into a 32-step register tile, K lanes
per window); ``csrc/huge_scan.cu``'s ``packedcount_hotstate_plane`` and
``split_emit_planes`` run the planes lane (``tile.cuh`` ``planes_lane``: word
loads, the 16-step shared-memory store tile, K lanes per window; the split
planes' emit loads after each tile's lookups).  This script builds the other
designs measured for those choices from ``scan_variants.cu`` beside it (the
count with one class load a step and one lane per window, the count with two
chains a thread, the hotstate plane with one class load a step and a 4-byte
store per lane at its own row, the same plane through the store tile with
one class load a step, the count-packed count with one class load a step
and one lane per window, the split planes with one class load a step, the
emit loads in the chain and 4-byte row stores, and the split planes on the
planes lane with one plane loaded in the chain, or gathered during the next
tile's lookups), and times them with the
package's kernels at K = 1, 2 and 4 lanes per window on the first 8,192,
32,768 and 65,536 windows of two cells: the count on the 10k headline
dictionary (65,536 x 524 uint8 windows of class-space word soup,
``bench.headline``), and the other three on the 1M-keyword dictionary of
``tests/test_full_random_1m.py`` (seed 77: a 470 MB count-packed table, and
its split tables, a 470 MB bare-state table and 17 MB of emit planes) over
BASELINE config #5's word soup, 32 Mi units in 512-class windows.  Every
variant is checked bit for bit against the package's wrapper on the same
windows first.  Prints one JSON line: ms per launch of each (CUDA events,
best of 3 timings of 20 launches after a warm-up; each window count's
variants timed in order, then in reverse, and the lower of the two kept),
the K that the package's rules pick, and the card's name and power limit.
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

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scan_variants.cu")
STEM = "libscan_variants"
VARIANTS = ("count_bytes", "count_chains2", "hotstate_rows", "hotstate_tile_bytes",
            "packedcount_bytes")
SPLIT_VARIANTS = ("split_rows", "split_inline", "split_pipelined")
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
    for name in SPLIT_VARIANTS:
        getattr(lib, name).argtypes = build.ARGTYPES["split_emit_planes"]
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


def _launcher(fn, tables, w, b, halo, mid, k, out):
    """A launch of ``fn(*tables, windows, window_bytes, b, W, halo, *mid, K,
    L, out, device, stream)`` on the first ``b`` windows, K lanes each."""
    from ahocorasick_tpu_torch.kernels import scan_block

    dev = w.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    W = w.shape[1]
    ptrs = [t.data_ptr() for t in tables]

    def launch():
        rc = fn(*ptrs, w.data_ptr(), scan_block._WINDOW_BYTES[w.dtype], b, W, halo, *mid, k,
                _seg_len(W - halo, k), out.data_ptr(), dev.index or 0, stream)
        if rc != 0:
            raise RuntimeError(f"variant launch failed: CUDA error {rc}")
    return launch


def _count_ab(label, w, wrapper, runs_at) -> dict:
    """``{"B=b": {label: ms}}`` of the count launches ``runs_at(b, out)``
    gives, each equal to ``wrapper(b)`` (the package's count on the first b
    windows)."""
    out = torch.zeros(1, dtype=torch.int64, device=w.device)
    ms = {}
    for b in SWEEP_WINDOWS:
        want = int(wrapper(b))

        def check(name, launch, want=want, b=b):
            out.zero_()
            launch()
            got = int(out[0])
            if got != want:
                raise AssertionError(f"{label} B={b} {name}: {got} != the wrapper's {want}")

        ms[f"B={b}"] = _sweep(runs_at(b, out), check)
    return ms


def _planes_ab(label, w, halo, planes, want, runs_at) -> dict:
    """``{"B=b": {label: ms}}`` of the planes launches ``runs_at(b, out)``
    gives, each equal on the first b windows to ``want`` (the package's
    wrapper on all of them, ``[planes, B*C]``)."""
    B, W = w.shape
    C = W - halo
    want = want.view(torch.int32).reshape(planes, B, C)
    out = torch.empty((planes, B * C), dtype=torch.int32, device=w.device)
    ms = {}
    for b in SWEEP_WINDOWS:
        def check(name, launch, b=b):
            out.fill_(-1)
            launch()
            got = out[:, : b * C].reshape(planes, b, C)
            bad = int((got != want[:, :b]).sum())
            if bad:
                raise AssertionError(f"{label} B={b} {name}: {bad} words differ from the "
                                     f"wrapper's")

        ms[f"B={b}"] = _sweep(runs_at(b, out), check)
    return ms


def _rule_k(body: int, halo: int, cap: int) -> dict:
    """The K the package's rule picks at each window count."""
    from ahocorasick_tpu_torch.kernels import scan_block

    return {f"B={b}": scan_block.segments(b, body, halo, cap)[0] for b in SWEEP_WINDOWS}


def run(count_cell: tuple, hot_cell: tuple, split_cell: tuple, lib=None) -> dict:
    """The A/B of the four kernels.  ``count_cell``: ``(table uint32[S, A],
    windows, halo, state_bits)`` of ``packed_scan_count``; ``hot_cell``:
    ``(table_flat, windows, halo, state_bits, num_classes)`` of
    ``packedcount_hotstate_plane`` and ``packedcount_count``;
    ``split_cell``: ``(dfa_flat, emit_tab, windows, halo, num_classes,
    num_planes)`` of ``split_emit_planes``; all on the card with at least
    65,536 windows.  Returns the record ``main`` prints."""
    from ahocorasick_tpu_torch.kernels import scan_batched as khuge
    from ahocorasick_tpu_torch.kernels import scan_block

    lib = library() if lib is None else lib
    package = build.library()
    ks = (1, 2, 4)

    table, w, halo, sb = count_cell
    mid = (table.shape[1], sb)

    def count_runs(b, out):
        runs = {"bytes K=1": _launcher(lib.count_bytes, (table,), w, b, halo, mid, 1, out)}
        runs.update({f"words K={k}": _launcher(package.packed_scan_count, (table,), w, b, halo,
                                                mid, k, out) for k in ks})
        runs.update({f"chains2 K={k}": _launcher(lib.count_chains2, (table,), w, b, halo, mid,
                                                  k, out) for k in (2, 4)})
        return runs

    count = _count_ab("count", w,
                      lambda b: scan_block.packed_scan_count(table, w[:b], halo, sb), count_runs)

    flat, wh, hhalo, hsb, hA = hot_cell
    hmid = (hA, hsb)

    def hot_runs(b, out):
        runs = {"rows K=1": _launcher(lib.hotstate_rows, (flat,), wh, b, hhalo, hmid, 1, out)}
        runs.update({f"tile_bytes K={k}": _launcher(lib.hotstate_tile_bytes, (flat,), wh, b,
                                                     hhalo, hmid, k, out) for k in ks})
        runs.update({f"tile_words K={k}": _launcher(package.packedcount_hotstate_plane, (flat,),
                                                     wh, b, hhalo, hmid, k, out) for k in ks})
        return runs

    hot = _planes_ab("hotstate", wh, hhalo, 1, khuge.packedcount_hotstate_plane(*hot_cell),
                     hot_runs)

    def packedcount_runs(b, out):
        runs = {"bytes K=1": _launcher(lib.packedcount_bytes, (flat,), wh, b, hhalo, hmid, 1,
                                       out)}
        runs.update({f"lane K={k}": _launcher(package.packedcount_count, (flat,), wh, b, hhalo,
                                               hmid, k, out) for k in ks})
        return runs

    packedcount = _count_ab("packedcount", wh,
                            lambda b: khuge.packedcount_count(flat, wh[:b], hhalo, hsb, hA),
                            packedcount_runs)

    dfa, emit, ws, shalo, sA, P = split_cell
    smid = (sA, P)

    def split_runs(b, out):
        runs = {"rows K=1": _launcher(lib.split_rows, (dfa, emit), ws, b, shalo, smid, 1, out)}
        if P == 1:
            for name in ("inline", "pipelined"):
                fn = getattr(lib, f"split_{name}")
                runs.update({f"{name} K={k}": _launcher(fn, (dfa, emit), ws, b, shalo, smid, k,
                                                         out) for k in ks})
        runs.update({f"lane K={k}": _launcher(package.split_emit_planes, (dfa, emit), ws, b,
                                               shalo, smid, k, out) for k in ks})
        return runs

    split = _planes_ab("split", ws, shalo, P, khuge.split_emit_planes(*split_cell), split_runs)
    torch.cuda.synchronize()
    C, hC, sC = w.shape[1] - halo, wh.shape[1] - hhalo, ws.shape[1] - shalo
    return {
        "count_cell": {"windows": list(w.shape), "halo": halo, "table_bytes": table.nbytes,
                       "rule_K": _rule_k(C, halo, scan_block.COUNT_MAX_LANES)},
        "count_ms": count,
        "hotstate_cell": {"windows": list(wh.shape), "halo": hhalo, "table_bytes": flat.nbytes,
                          "rule_K": _rule_k(hC, hhalo, khuge.HOTSTATE_MAX_LANES),
                          "packedcount_rule_K": _rule_k(hC, hhalo,
                                                        khuge.PACKEDCOUNT_MAX_LANES)},
        "hotstate_ms": hot,
        "packedcount_ms": packedcount,
        "split_cell": {"windows": list(ws.shape), "halo": shalo, "planes": P,
                       "table_bytes": dfa.nbytes + emit.nbytes,
                       "rule_K": _rule_k(sC, shalo, khuge.SPLIT_PLANES_MAX_LANES)},
        "split_ms": split,
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
    dfa, emit, shalo = m1.dev.split_dfa
    ws = wh if shalo == halo else scan_batched.classes_to_device(
        scan_batched.chunk_classes(cls, CHUNK, shalo, A), A, dev)
    record = run((pd.table, w, pd.halo, pd.state_bits), (flat, wh, halo, sb, A),
                 (dfa, emit, ws, shalo, A, emit.shape[1]), lib)
    print(json.dumps({"card": smi, **record}))


if __name__ == "__main__":
    main()
