"""The designs of the scan kernels, timed side by side on the card.

    python -m ahocorasick_tpu_torch.bench.scan_variants

``csrc/packed_scan.cu``'s ``packed_scan_count`` and ``csrc/huge_scan.cu``'s
``packedcount_count`` and ``split_count`` run the count lane (``tile.cuh``
``count_lane``: the classes read a 32-bit word at a time into a 32-step
register tile, K lanes per window; the split count's emit loads after each
16 of a tile's lookups); ``csrc/huge_scan.cu``'s
``packedcount_hotstate_plane`` and ``split_emit_planes`` run the planes lane
(``tile.cuh`` ``planes_lane``: word loads, the 16-step shared-memory store
tile, K lanes per window; the split planes' emit loads after each tile's
lookups).  This script builds the other
designs measured for those choices from ``scan_variants.cu`` beside it (the
count with one class load a step and one lane per window, the count with two
chains a thread, the hotstate plane with one class load a step and a 4-byte
store per lane at its own row, the same plane through the store tile with
one class load a step, the count-packed count with one class load a step
and one lane per window, the split planes with one class load a step, the
emit loads in the chain and 4-byte row stores, the split planes on the
planes lane with one plane loaded in the chain, or gathered during the next
tile's lookups, the split count with one class load a step, one lane per
window and its emit loads in the chain, and the split count on the count
lane gathering the emit loads of 32 steps at once instead of 16), and times
them with the
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

Two more A/Bs run on the package's own entry points.  ``rowdfa2_ab``: the
stride-2 count and planes (``csrc/rowdfa2_scan.cu``, the count and planes
lanes with a pair a step) at K = 1, 2 and 4 beside their first designs (one
lane per window, a class load a step, the planes' pairs stored at the lane's
own row; ``rowdfa2_count_bytes`` and ``rowdfa2_planes_first`` here) on the
first 8,192, 32,768 and 65,536 windows of the 10k dictionary's stride-2
table (152 MB).
``seq_ab``: the sequential scan's serial walk (``seq_states``, up to 64 Ki
units) beside its lane scan (``seq_states_sync``) at several lane lengths L,
on 1 Ki, 4 Ki, 64 Ki and 32 Mi units of the 10k dense table and of a
55,040-class RowTable (``wide_soup`` over the demo dictionary of
``graft_entry``), each checked against the wrapper.  ``tp_ab``: the
row-sharded scan (``csrc/table_sharded.cu``, the lane loops over row shards)
at K = 1, 2 and 4 beside its first design (``table_sharded_first`` here) on
the first 8,192, 32,768 and 65,536 windows of the 10k table in 8 shards.
``sweep_ab``: the whole-word-longest die sweep (``csrc/sweep.cuh``) at
several loads a group, staged in shared memory and not, beside its first
design, at the 10k cell's start slots and at every position of 4 Mi.

    python -m ahocorasick_tpu_torch.bench.scan_variants --against DIR

times instead the kernels on ``csrc/tile.cuh``'s lane loops whose entry
points two checkouts share (``packed_scan_count``, ``packed_scan_planes``,
``packedcount_count``, ``packedcount_hotstate_plane``, ``split_emit_planes``,
``rowdfa2_count``, and ``table_sharded_scan`` in its count and planes modes)
built from this checkout and from the ``csrc/`` of another checkout at
``DIR`` (the parent commit, unpacked with ``git archive``), in one process on
the same cells at the rule's K: each pair's outputs equal bit for bit, then
other, this, this, other.  Prints one JSON line.
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
SPLIT_COUNT_VARIANTS = ("split_count_first", "split_count_gather32")
SWEEP_WINDOWS = (8_192, 32_768, 65_536)
SEQ_UNITS = (1 << 10, 1 << 12, 1 << 16, 1 << 25)
SEQ_SERIAL_MAX = 1 << 16  # the serial walk takes about 70 ns a unit
SEQ_LANE_LENS = (16, 64, 256, 1024)  # beside the rule's L and the least, d rounded to 4
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
    lib.rowdfa2_count_bytes.argtypes = build.ARGTYPES["rowdfa2_count"]
    lib.rowdfa2_count_bytes.restype = ctypes.c_int
    lib.rowdfa2_planes_first.argtypes = build.ARGTYPES["rowdfa2_planes"]
    lib.rowdfa2_planes_first.restype = ctypes.c_int
    for name in SPLIT_COUNT_VARIANTS:
        getattr(lib, name).argtypes = build.ARGTYPES["split_count"]
        getattr(lib, name).restype = ctypes.c_int
    lib.table_sharded_first.argtypes = build.ARGTYPES["table_sharded_scan"]
    lib.table_sharded_first.restype = ctypes.c_int
    lib.sweep_variant.argtypes = [ctypes.c_int, ctypes.c_int, *build.ARGTYPES["wwl_sweep_at"]]
    lib.sweep_variant.restype = ctypes.c_int
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

    def split_count_runs(b, out):
        runs = {"first K=1": _launcher(lib.split_count_first, (dfa, emit), ws, b, shalo, smid, 1,
                                       out)}
        runs.update({f"lane K={k}": _launcher(package.split_count, (dfa, emit), ws, b, shalo,
                                               smid, k, out) for k in ks})
        runs.update({f"gather32 K={k}": _launcher(lib.split_count_gather32, (dfa, emit), ws, b,
                                                   shalo, smid, k, out) for k in ks})
        return runs

    split_count = _count_ab("split count", ws,
                            lambda b: khuge.split_count(dfa, emit, ws[:b], shalo, sA, P),
                            split_count_runs)
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
                       "rule_K": _rule_k(sC, shalo, khuge.SPLIT_PLANES_MAX_LANES),
                       "count_rule_K": _rule_k(sC, shalo, khuge.SPLIT_COUNT_MAX_LANES)},
        "split_ms": split,
        "split_count_ms": split_count,
    }


def rowdfa2_ab(cell: tuple, lib=None) -> dict:
    """The stride-2 count's and planes' A/B.  ``cell``: ``(table, windows,
    halo, state_bits, num_classes)`` of ``rowdfa2_count`` on the card, at
    least 65,536 windows."""
    from ahocorasick_tpu_torch.kernels import scan_rowdfa as krow

    lib = library() if lib is None else lib
    package = build.library()
    table, w, halo, sb, A = cell
    mid = (A, sb)

    def runs(b, out):
        out_runs = {"bytes K=1": _launcher(lib.rowdfa2_count_bytes, (table,), w, b, halo, mid, 1,
                                           out)}
        out_runs.update({f"lane K={k}": _launcher(package.rowdfa2_count, (table,), w, b, halo,
                                                   mid, k, out) for k in (1, 2, 4)})
        return out_runs

    ms = _count_ab("rowdfa2", w, lambda b: krow.rowdfa2_count(table, w[:b], halo, sb, A), runs)

    def planes_runs(b, out):
        out_runs = {"first K=1": _launcher(lib.rowdfa2_planes_first, (table,), w, b, halo, mid, 1,
                                           out)}
        out_runs.update({f"lane K={k}": _launcher(package.rowdfa2_planes, (table,), w, b, halo,
                                                   mid, k, out) for k in (1, 2, 4)})
        return out_runs

    planes_ms = _planes_ab("rowdfa2 planes", w, halo, 1, krow.rowdfa2_planes(*cell), planes_runs)
    torch.cuda.synchronize()
    C = w.shape[1] - halo
    return {"rowdfa2_cell": {"windows": list(w.shape), "halo": halo, "table_bytes": table.nbytes,
                             "rule_K": _rule_k(C, halo, krow.ROWDFA2_COUNT_MAX_LANES),
                             "planes_rule_K": _rule_k(C, halo, krow.ROWDFA2_PLANES_MAX_LANES)},
            "rowdfa2_count_ms": ms, "rowdfa2_planes_ms": planes_ms}


def _tp_launcher(fn, cell: tuple, mode: str, b: int, k: int, out):
    """A launch of ``fn`` (``table_sharded_scan``'s arguments) on ``cell``
    (``tp_ab``'s tuple) in ``mode``, on the first ``b`` windows, K lanes
    each."""
    import ctypes as ct

    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    st, w, halo, sb = cell
    dev = w.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = st.pointers(dev)
    owners = (ct.c_int * st.n_model)(*[t.device.index or 0 for t in st.shards])
    W = w.shape[1]

    def launch():
        rc = fn(ptrs.data_ptr(), owners, st.n_model, st.rows_per, st.stride, *st.divisor,
                w.data_ptr(), ktp._WINDOW_BYTES[w.dtype], b, W, halo, sb,
                ktp.MODES.index(mode), k, _seg_len(W - halo, k), out.data_ptr(),
                dev.index or 0, stream)
        if rc != 0:
            raise RuntimeError(f"row-sharded launch failed: CUDA error {rc}")
    return launch


def tp_ab(cell: tuple, lib=None, modes=("count", "planes", "hotstate")) -> dict:
    """The row-sharded scan's A/B.  ``cell``: ``(ShardedTable, windows, halo,
    state_bits)`` of ``table_sharded_scan`` on the card, at least 65,536
    windows.  Its first design (one lane per window, ``table_sharded_first``
    here) beside the package's kernel at K = 1, 2 and 4, in each of
    ``modes``, on the first 8,192, 32,768 and 65,536 windows."""
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    lib = library() if lib is None else lib
    package = build.library()
    st, w, halo, sb = cell
    C = w.shape[1] - halo
    record = {}
    for mode in modes:
        counting = mode in ("count", "count_packed")

        def runs(b, out, mode=mode):
            out_runs = {"first K=1": _tp_launcher(lib.table_sharded_first, cell, mode, b, 1, out)}
            out_runs.update({f"lane K={k}": _tp_launcher(package.table_sharded_scan, cell, mode,
                                                         b, k, out) for k in (1, 2, 4)})
            return out_runs

        if counting:
            record[mode] = _count_ab(
                f"row-sharded {mode}", w,
                lambda b: ktp.table_sharded_scan(st, w[:b], halo, sb, mode), runs)
        else:
            record[mode] = _planes_ab(f"row-sharded {mode}", w, halo, 1,
                                      ktp.table_sharded_scan(st, w, halo, sb, mode), runs)
    torch.cuda.synchronize()
    return {"tp_cell": {"windows": list(w.shape), "halo": halo, "shards": st.n_model,
                        "rows_per": st.rows_per,
                        "rule_K": {mode: {f"B={b}": ktp.lane_segments(b, C, halo, mode)[0]
                                          for b in SWEEP_WINDOWS} for mode in modes}},
            "tp_ms": record}


SWEEP_GROUPS = (1, 2, 4, 8, 16)


def sweep_launch(lib, group: int, staged: bool, cell: tuple, outs: tuple):
    """A launch of design ``(group, staged)`` of ``sweep_variant`` (group 0:
    the first design) on ``cell`` (``sweep_ab``'s tuple), writing ``outs``
    (``kernels.scan_wwl._empty_outcomes``)."""
    plane, entry, rows_flat, outrows, starts, n, d, id_bits, depth_bits, cross = cell
    dev = plane.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()

    def launch():
        rc = lib.sweep_variant(group, int(staged), plane.data_ptr(), ptr(entry), ptr(rows_flat),
                               outrows.data_ptr(), ptr(starts), n, plane.shape[0] - (d + 1), d,
                               id_bits, depth_bits, int(cross), *(t.data_ptr() for t in outs[:5]),
                               ptr(outs[5] if cross else None), dev.index or 0, stream)
        if rc != 0:
            raise RuntimeError(f"sweep variant launch failed: CUDA error {rc}")
    return launch


def sweep_ab(cells: dict, lib=None) -> dict:
    """The die sweep's A/B.  ``cells``: ``{label: (plane, entry, rows_flat,
    outrows, starts or None, n, d, id_bits, depth_bits, cross)}`` on the
    card, ``starts`` None for the sweep at every position 0 .. n-1
    (``wwl_sweep_all``).  Its first design (group 0) beside the grouped
    sweep at each of ``SWEEP_GROUPS``, staged and not, each checked against
    the package's wrapper first."""
    from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl

    lib = library() if lib is None else lib
    record = {}
    for label, cell in cells.items():
        plane, entry, rows_flat, outrows, starts, n, d, id_bits, depth_bits, cross = cell
        kw = dict(d=d, id_bits=id_bits, depth_bits=depth_bits, cross=cross)
        if starts is None:
            want = kwwl.wwl_sweep_all(plane, entry, rows_flat, outrows, n, **kw)
        else:
            want = kwwl.wwl_sweep_at(plane, entry, rows_flat, outrows, starts, **kw)
        outs = kwwl._empty_outcomes(n, plane.device, cross)
        runs = {"first": sweep_launch(lib, 0, False, cell, outs)}
        for g in SWEEP_GROUPS:
            runs[f"G={g}"] = sweep_launch(lib, g, False, cell, outs)
            runs[f"G={g} staged"] = sweep_launch(lib, g, True, cell, outs)

        def check(name, launch):
            for t in outs:
                t.zero_()
            launch()
            for g, x in zip(outs, want):
                if not torch.equal(g, x):
                    raise AssertionError(f"sweep {label} {name}: outcomes differ from the "
                                         f"wrapper's")

        record[label] = {"slots": n, "d": d, "ms": _sweep(runs, check)}
    return {"sweep_ms": record}


def seq_ab(cells: dict) -> dict:
    """The sequential scan's A/B.  ``cells``: ``{label: (table, row_id,
    classes, depth)}`` on the card, the classes ``int32[N]`` with N at least
    32 Mi, ``depth`` the table's synchronizing depth.  Returns ``{label:
    {"N=n": {run: ms}}}`` and the rule's L per cell and N."""
    from ahocorasick_tpu_torch.kernels import scan_dfa

    package = build.library()
    record, rule = {}, {}
    for label, (table, row_id, cls, depth) in cells.items():
        dev = cls.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rid = None if row_id is None else row_id.data_ptr()
        out = torch.empty(max(SEQ_UNITS), dtype=torch.int32, device=dev)
        record[label], rule[label] = {}, {}
        for n in SEQ_UNITS:
            c = cls[:n]
            want = scan_dfa.seq_states(table, row_id, c, 0, depth)

            def serial(c=c, n=n):
                rc = package.seq_states(table.data_ptr(), rid, c.data_ptr(), n, table.shape[1],
                                        0, out.data_ptr(), dev.index or 0, stream)
                if rc != 0:
                    raise RuntimeError(f"seq_states launch failed: CUDA error {rc}")

            def sync(L, c=c, n=n):
                def launch():
                    rc = package.seq_states_sync(table.data_ptr(), rid, c.data_ptr(), n,
                                                 table.shape[1], 0, depth, L, out.data_ptr(),
                                                 dev.index or 0, stream)
                    if rc != 0:
                        raise RuntimeError(f"seq_states_sync launch failed: CUDA error {rc}")
                return launch

            least = -(-depth // 4) * 4
            lens = sorted({least, scan_dfa.sync_lane_len(n, depth),
                           *(L for L in SEQ_LANE_LENS if L > least)})
            runs = {"serial": serial} if n <= SEQ_SERIAL_MAX else {}
            runs.update({f"sync L={L}": sync(L) for L in lens})

            def check(name, launch, n=n, want=want):
                out.fill_(-1)
                launch()
                if not torch.equal(out[:n], want):
                    raise AssertionError(f"seq {label} N={n} {name}: states differ from the "
                                         f"wrapper's")

            record[label][f"N={n}"] = _sweep(runs, check)
            rule[label][f"N={n}"] = scan_dfa.sync_lane_len(n, depth)
    return {"seq_ms": record, "seq_rule_L": rule}


AGAINST_KERNELS = ("packed_scan_count", "packed_scan_planes", "packedcount_count",
                   "packedcount_hotstate_plane", "split_emit_planes", "rowdfa2_count",
                   "table_sharded_scan")


def against(other_root: str, count_cell: tuple, hot_cell: tuple, split_cell: tuple,
            row_cell: tuple, tp_cell: tuple) -> dict:
    """The lane-loop kernels of this checkout and of ``other_root``'s
    ``csrc/`` on the cells of ``run``, ``rowdfa2_ab`` (``row_cell``) and
    ``tp_ab`` (``tp_cell``; the count and planes modes): ``{kernel: {"K",
    "other_ms", "this_ms", "this_over_other"}}`` (each ms list in the order
    timed)."""
    import glob

    from ahocorasick_tpu_torch.bench import _seconds_per_rep
    from ahocorasick_tpu_torch.kernels import scan_batched as khuge
    from ahocorasick_tpu_torch.kernels import scan_block
    from ahocorasick_tpu_torch.kernels import scan_rowdfa as krow
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    sources = tuple(sorted(glob.glob(os.path.join(other_root, "ahocorasick_tpu_torch", "csrc",
                                                  "*.cu"))))
    if not sources:
        raise FileNotFoundError(f"no ahocorasick_tpu_torch/csrc/*.cu under {other_root}")
    libs = {"other": ctypes.CDLL(build.build(sources, "libac_kernels_other")),
            "this": build.library()}
    for name in AGAINST_KERNELS:
        getattr(libs["other"], name).argtypes = build.ARGTYPES[name]
        getattr(libs["other"], name).restype = ctypes.c_int
    table, w, halo, sb = count_cell
    flat, wh, hhalo, hsb, hA = hot_cell
    dfa, emit, ws, shalo, sA, P = split_cell
    rtable, wr, rhalo, rsb, rA = row_cell
    cells = {  # tables, windows, halo, (A, state_bits or P), cap, planes out (0: a count)
        "packed_scan_count": ((table,), w, halo, (table.shape[1], sb),
                              scan_block.COUNT_MAX_LANES, 0),
        "packed_scan_planes": ((table,), w, halo, (table.shape[1], sb), scan_block.MAX_LANES, 1),
        "packedcount_count": ((flat,), wh, hhalo, (hA, hsb), khuge.PACKEDCOUNT_MAX_LANES, 0),
        "packedcount_hotstate_plane": ((flat,), wh, hhalo, (hA, hsb), khuge.HOTSTATE_MAX_LANES,
                                       1),
        "split_emit_planes": ((dfa, emit), ws, shalo, (sA, P), khuge.SPLIT_PLANES_MAX_LANES, P),
        "rowdfa2_count": ((rtable,), wr, rhalo, (rA, rsb), krow.ROWDFA2_COUNT_MAX_LANES, 0),
        "table_sharded_scan count": ((), tp_cell[1], tp_cell[2], "count", None, 0),
        "table_sharded_scan planes": ((), tp_cell[1], tp_cell[2], "planes", None, 1),
    }
    record = {}
    for name, (tables, win, h, mid, cap, planes) in cells.items():
        b, W = win.shape
        fn_name = name.split()[0]
        k = (scan_block.segments(b, W - h, h, cap)[0] if cap is not None
             else ktp.lane_segments(b, W - h, h, mid)[0])
        outs, runs = {}, {}
        for tree, lib in libs.items():
            outs[tree] = (torch.zeros(1, dtype=torch.int64, device=win.device) if not planes
                          else torch.empty((planes, b * (W - h)), dtype=torch.int32,
                                           device=win.device))
            fn = getattr(lib, fn_name)
            runs[tree] = (_launcher(fn, tables, win, b, h, mid, k, outs[tree]) if cap is not None
                          else _tp_launcher(fn, tp_cell, mid, b, k, outs[tree]))
        for tree in libs:
            outs[tree].zero_()
            runs[tree]()
        if not torch.equal(outs["other"], outs["this"]):
            raise AssertionError(f"{name}: the two checkouts' kernels differ")
        ms = {"other": [], "this": []}
        for tree in ("other", "this", "this", "other"):
            ms[tree].append(_seconds_per_rep(runs[tree], 20, win.device) * 1e3)
        record[name] = {"K": k, "other_ms": ms["other"], "this_ms": ms["this"],
                        "this_over_other": min(ms["this"]) / min(ms["other"])}
    return record


def main(argv=None) -> None:
    import argparse

    from ahocorasick_tpu_torch.bench.__main__ import word_soup
    from ahocorasick_tpu_torch.bench.headline import (
        BASE_UNITS, CHUNK, N_KEYWORDS, SEED, TEXT_UNITS, make_dictionary, make_text_classes)
    from ahocorasick_tpu_torch.graft_entry import _KEYWORDS as DEMO_KEYWORDS
    from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet
    from ahocorasick_tpu_torch.ops import scan_batched

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="DIR",
                        help="time the lane-loop kernels against another checkout's csrc/")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lib = None if opts.against else library()
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
    rd = m.dev.row_dfa
    w2 = w if rd.halo == pd.halo else scan_batched.classes_to_device(
        scan_batched.chunk_classes(np.tile(base, TEXT_UNITS // BASE_UNITS), CHUNK, rd.halo,
                                   m.compiled.num_classes), m.compiled.num_classes, dev)
    row_cell = (rd.table, w2, rd.halo, rd.state_bits, rd.num_classes)
    if opts.against:
        record = against(opts.against, (pd.table, w, pd.halo, pd.state_bits),
                         (flat, wh, halo, sb, A), (dfa, emit, ws, shalo, A, emit.shape[1]),
                         row_cell, ten_k_shards(m, dev, w))
        print(json.dumps({"card": smi, "against": opts.against, **record}))
        return
    record = run((pd.table, w, pd.halo, pd.state_bits), (flat, wh, halo, sb, A),
                 (dfa, emit, ws, shalo, A, emit.shape[1]), lib)
    record.update(rowdfa2_ab(row_cell, lib))
    wide = AhoCorasickSet([chr(c) for c in range(0x100, 0xD800)], engine="gold", device=dev)
    wide_cls = wide._classes(wide_soup(np.random.default_rng(SEED + 9), DEMO_KEYWORDS,
                                       BASE_UNITS))
    record.update(seq_ab({
        "10k dense": (*m.dev.seq_tables, _int32_classes(
            np.tile(base, TEXT_UNITS // BASE_UNITS), dev), max(m.compiled.max_depth, 1)),
        "wide RowTable": (*wide.dev.seq_tables, _int32_classes(
            np.tile(wide_cls, TEXT_UNITS // BASE_UNITS), dev), max(wide.compiled.max_depth, 1)),
    }))
    record.update(tp_ab(ten_k_shards(m, dev, w)))
    record.update(sweep_ab(ten_k_sweep_cells(keywords, dev)))
    print(json.dumps({"card": smi, **record}))


TP_SHARDS = 8  # the row-sharded cell: the 10k table in 8 shards on the one card


def ten_k_shards(m, dev, w) -> tuple:
    """``tp_ab``'s cell: ``m``'s packed table in ``TP_SHARDS`` row shards (each
    an allocation of its own on ``dev``), over the packed windows ``w``."""
    from ahocorasick_tpu_torch.ops import scan_batched
    from ahocorasick_tpu_torch.parallel import sharding

    pd = m.dev.packed_dfa
    table = scan_batched.build_packed(m.compiled).table
    tables, _, _ = sharding._table_sharded_build(table, pd.halo, pd.state_bits,
                                                 [dev] * TP_SHARDS, "count")
    return tables[0], w, pd.halo, pd.state_bits


def ten_k_sweep_cells(keywords, dev) -> dict:
    """``sweep_ab``'s cells: the whole-word-longest scan plane of ``keywords``
    over 32 Mi units of ``bench.py``'s word soup (a 1 Mi base tiled), the
    walks at its start slots, and at every position of its first 4 Mi units
    (one shard of eight)."""
    from ahocorasick_tpu_torch.bench.__main__ import word_soup
    from ahocorasick_tpu_torch.bench.headline import BASE_UNITS, SEED, TEXT_UNITS
    from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl
    from ahocorasick_tpu_torch.models.matchers import WholeWordLongestMatchSet
    from ahocorasick_tpu_torch.ops import scan_batched, scan_wwl

    m = WholeWordLongestMatchSet(keywords, engine="device", device=dev)
    sc = m.dev.wwl_scan
    text = word_soup(np.random.default_rng(SEED), keywords, BASE_UNITS)
    cls = np.tile(m._classes(text), TEXT_UNITS // BASE_UNITS)
    cls_p, starts, _, _, d = scan_wwl.compact_lanes(m.compiled, cls)
    w = scan_batched.classes_to_device(
        scan_batched.chunk_classes(cls_p, 512, d, sc.num_classes), sc.num_classes, dev)
    plane = kwwl.wwl_scan_plane(sc.table, w, d, sc.id_bits, sc.num_classes, False)[0]
    per_w = TEXT_UNITS // TP_SHARDS
    cell = (sc.outrows,)
    return {
        "at 10k starts": (plane, None, None, *cell, torch.from_numpy(starts).to(dev),
                          len(starts), d, sc.id_bits, sc.depth_bits, False),
        "all 4 Mi": (plane[: per_w + 512].contiguous(), None, None, *cell, None, per_w, d,
                     sc.id_bits, sc.depth_bits, False),
    }


def _int32_classes(cls: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(cls, dtype=np.int32)).to(dev)


def wide_soup(rng, words, n_units: int) -> str:
    """ASCII word soup over ``words`` with about 1% of its units drawn from
    U+0100..U+D7FF (the wide-alphabet dictionary's keywords)."""
    from ahocorasick_tpu_torch.bench.__main__ import word_soup

    units = np.frombuffer(word_soup(rng, words, n_units).encode("utf-16-le"),
                          dtype=np.uint16).copy()
    hits = rng.random(n_units) < 0.01
    units[hits] = rng.integers(0x100, 0xD800, size=int(hits.sum()))
    return units.tobytes().decode("utf-16-le")


if __name__ == "__main__":
    main()
