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
``seq_ab``: the sequential scan's first serial walk (``seq_serial_first``
here, up to 64 Ki units) beside its lane scan (``seq_states_sync``) at
several lane lengths L, on 1 Ki, 4 Ki, 64 Ki and 32 Mi units of the 10k
dense table and of a 55,040-class RowTable (``wide_soup`` over the demo
dictionary of ``graft_entry``), each checked against the wrapper.
``spec_ab``: the one-thread walks (``seq_serial_first``, ``shortest_first``
here: the serial walk and the shortest restart scan before speculate and
repair) beside speculate and repair (``seq_states_spec``) at the rule's
chunk length K and at K / 4, K / 2, 2 K and 4 K, on 64 Ki, 1 Mi and 32 Mi
units of the 10k shortest restart table (its ``shortest_states`` form over
the restart rows and uint8 classes, and its dense table), the 10k dense
table and the wide RowTable; every run held bit for bit against the
one-thread walk at every N, which is timed only up to 1 Mi; with each K's
repair statistics (chunks, mean and largest repair, chunks repaired to
their end).  Its best K sets ``kernels.scan_dfa.SPEC_REPAIR``.
``meet_ab``: the chunk stitch's first designs for tables that do not
synchronize (``maps_first``, ``rescan_first`` here: every lane over its
whole chunk, one thread a chunk's rescan) beside the package's forms for
any table (``state_maps_all``: the reference runs, then the lanes until
they meet them; ``rescan_serial``: speculate and repair by rows) and, on
the goto closures, the synchronized forms, at C x K = 1 x 32 Ki, 8 x 4 Ki,
8 x 32 Ki, 64 x 4 Ki and 1,024 x 256 on the 10k restart table, the 10k
closure and the demo dictionary, each launch held bit for bit against the
first design, with the meet positions and the repair lengths.  ``tp_ab``: the
row-sharded scan (``csrc/table_sharded.cu``, the lane loops over row shards)
at K = 1, 2 and 4 beside its first design (``table_sharded_first`` here) on
the first 8,192, 32,768 and 65,536 windows of the 10k table in 8 shards.
``sweep_ab``: the whole-word-longest die sweep (``csrc/sweep.cuh``) at
several loads a group, staged in shared memory and not, beside its first
design, at the 10k cell's start slots and at every position of 4 Mi.
``pfac_ab``: the PFAC v2 walk (``csrc/pfac_walk.cuh``: persistent blocks
whose warps take spans of starts, a prefix pass over staged classes and the
staged prefix table, a warp queue of the walks that go on with lanes that
refill) with the prefix read with ``__ldg``, at other block and pass widths
(``pfac_queue`` here), beside the walk over tiles with block barriers
(``pfac_tiles`` here: refills from the tile, one walk a thread, two
interleaved) and its first design (``pfac_first`` here: planes, the count,
and the count with each block's sum stored instead of its atomic add) on the
10k dictionary's 32 Mi lanes (``--pfac`` runs only this one).
``wwl_fused_ab``: the whole-word-longest fused scan (``csrc/wwl_scan.cu``:
each lane counts its next starts' deaths over a tile of entries in
registers, a record a start, and a resolve launch) at K = 1, 2, 4 and 8
lanes a window beside its first design (``wwl_fused_first`` here: a cursor
over the sorted starts in the chain); ``wwl_walk_ab``: the per-start walk
(``csrc/wwl_walk.cu``: a thread a start with a k-gram prefix lookup and one
outcome row a state) beside its first design (``wwl_walk_first`` here: the
bare trie and five outcome arrays), with each design's table loads a walk;
both at baseline-4 and the 10k cell of ``probes.probe_wwl_fused`` (``--wwl``
runs only these two).

    python -m ahocorasick_tpu_torch.bench.scan_variants --against DIR

times instead the kernels on ``csrc/tile.cuh``'s lane loops whose entry
points two checkouts share (``packed_scan_count``, ``packed_scan_planes``,
``packedcount_count``, ``packedcount_hotstate_plane``, ``split_emit_planes``,
``rowdfa2_count``, ``table_sharded_scan`` in its count and planes modes, and
the lane scan ``seq_states_sync`` at 64 Ki and 32 Mi units of the 10k dense
table, and the stitch's ``rescan`` on the same 32 Mi units as 8 chunks and
as one chunk of 32 Ki; and speculate and repair's one-row form
``seq_states_spec`` at 64 Ki, 1 Mi and 32 Mi units of the 10k restart
table, dense and as ``shortest_states``' restart rows; and the PFAC v1 walk
``pfac1_planes`` on the 10k dictionary's 32 Mi lanes) built from this
checkout and from the ``csrc/`` of
another checkout at
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
SPEC_UNITS = (1 << 16, 1 << 20, 1 << 25)
SPEC_FIRST_MAX = 1 << 20  # the one-thread walks are timed up to here
SPEC_K_SHIFTS = (-2, -1, 0, 1, 2)  # K at the rule's times 2**shift
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
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # (table, row_id or null, cls, n, num_classes, s0, out, device, stream)
    lib.seq_serial_first.argtypes = [P, P, P, I64, I, I, P, I, P]
    # (dfa_next, match_len, cls, cls_bytes, n, num_classes, out, device, stream)
    lib.shortest_first.argtypes = [P, P, P, I, I64, I, P, I, P]
    lib.seq_serial_first.restype = lib.shortest_first.restype = ctypes.c_int
    # (table, cls, num_chunks, chunk_len, num_states, num_classes, sigma,
    #  device, stream)
    lib.maps_first.argtypes = [P, P, I64, I64, I64, I, P, I, P]
    # (table, cls, entry, num_chunks, chunk_len, num_classes, out, device,
    #  stream)
    lib.rescan_first.argtypes = [P, P, P, I64, I64, I, P, I, P]
    lib.maps_first.restype = lib.rescan_first.restype = ctypes.c_int
    # (mode, then pfac2_planes' arguments up to num_planes, out, device, stream)
    head = build.ARGTYPES["pfac2_planes"][:12]
    lib.pfac_first.argtypes = [I, *head, P, I, P]
    # (arm, count_mode, *head, grid, tile, stage_len, staged_planes,
    #  prefix_shared, fill_rounds, out, device, stream)
    lib.pfac_tiles.argtypes = [I, I, *head, I, I, I, I, I, I, P, I, P]
    # (threads, per_lane, blocks, count_mode, *head, grid, span,
    #  prefix_shared, out, device, stream)
    lib.pfac_queue.argtypes = [I, I, I, I, *head, I, I64, I, P, I, P]
    lib.pfac_first.restype = lib.pfac_tiles.restype = lib.pfac_queue.restype = ctypes.c_int
    # the fused scan's arguments before this design's lane slots, then
    # (outrows, meta scratch, die_pos, has, m_start, m_end, m_val, cont, device,
    # stream)
    lib.wwl_fused_first.argtypes = [*build.ARGTYPES["wwl_scan_fused"][:15], P, P, P, P, P, P, P,
                                    P, I, P]
    # (trie_next, own_len, own_val, fail_len, fail_off, fail_val,
    #  class_is_word, num_states, stride, cls, cls_bytes, num_cls, starts,
    #  num_starts, max_depth, die_pos, has, m_start, m_end, m_val, device,
    #  stream)
    lib.wwl_walk_first.argtypes = [P, P, P, P, P, P, P, I, I, P, I, I64, P, I64, I, P, P, P, P,
                                   P, I, P]
    lib.wwl_fused_first.restype = lib.wwl_walk_first.restype = ctypes.c_int
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


def seq_ab(cells: dict, lib) -> dict:
    """The sequential scan's A/B.  ``cells``: ``{label: (table, row_id,
    classes, depth)}`` on the card, the classes ``int32[N]`` with N at least
    32 Mi, ``depth`` the table's synchronizing depth; ``lib`` this file's
    library.  Returns ``{label: {"N=n": {run: ms}}}`` and the rule's L per
    cell and N."""
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
                rc = lib.seq_serial_first(table.data_ptr(), rid, c.data_ptr(), n,
                                          table.shape[1], 0, out.data_ptr(), dev.index or 0,
                                          stream)
                if rc != 0:
                    raise RuntimeError(f"seq_serial_first launch failed: CUDA error {rc}")

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


def spec_ab(cells: dict, lib) -> dict:
    """Speculate and repair's A/B.  ``cells``: ``{label: (table, row_id,
    classes, match_len)}`` on the card, with at least 32 Mi classes;
    ``match_len`` None for the sequential scan's form (``int32`` classes,
    the one-thread arm ``seq_serial_first``), else the shortest scan's
    (``table`` the padded dfa_next, ``row_id`` its restart rows, the arm
    ``shortest_first``); ``lib`` this file's library.  Returns ``{"spec_ms":
    {label: {"N=n": {run: ms}}}, "spec_repair": {label: {"N=n": {"K=k":
    stats}}}, "spec_rule_K": {label: {"N=n": K}}}``."""
    from ahocorasick_tpu_torch.bench import _seconds_per_rep
    from ahocorasick_tpu_torch.kernels import scan_dfa

    package = build.library()
    times, repairs, rule = {}, {}, {}
    for label, (table, row_id, cls, match_len) in cells.items():
        dev = cls.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rid = None if row_id is None else row_id.data_ptr()
        cls_bytes = scan_dfa._CLASS_BYTES[cls.dtype]
        A = table.shape[1]
        out = torch.empty(max(SPEC_UNITS), dtype=torch.int32, device=dev)
        times[label], repairs[label], rule[label] = {}, {}, {}
        for n in SPEC_UNITS:
            c = cls[:n]

            def first(c=c, n=n):
                if match_len is None:
                    rc = lib.seq_serial_first(table.data_ptr(), rid, c.data_ptr(), n, A, 0,
                                              out.data_ptr(), dev.index or 0, stream)
                else:
                    rc = lib.shortest_first(table.data_ptr(), match_len.data_ptr(), c.data_ptr(),
                                            cls_bytes, n, A, out.data_ptr(), dev.index or 0,
                                            stream)
                if rc != 0:
                    raise RuntimeError(f"one-thread walk failed: CUDA error {rc}")

            def spec(K, repair=None, c=c, n=n):
                def launch():
                    rc = package.seq_states_spec(
                        table.data_ptr(), rid, c.data_ptr(), cls_bytes, n, A, 0, K,
                        out.data_ptr(), None if repair is None else repair.data_ptr(),
                        dev.index or 0, stream)
                    if rc != 0:
                        raise RuntimeError(f"seq_states_spec launch failed: CUDA error {rc}")
                return launch

            first()
            want = out[:n].clone()
            K0 = scan_dfa.spec_chunk_len(n)
            ks = sorted({min(max(K0 << s if s >= 0 else K0 >> -s, 1), n)
                         for s in SPEC_K_SHIFTS})
            runs = {"one thread": first} if n <= SPEC_FIRST_MAX else {}
            runs.update({f"spec K={K}": spec(K) for K in ks})
            repairs[label][f"N={n}"] = {}
            for K in ks:
                chunks = -(-n // K)
                repair = torch.zeros(chunks, dtype=torch.int32, device=dev)
                out.fill_(-1)
                spec(K, repair)()
                if not torch.equal(out[:n], want):
                    raise AssertionError(f"spec {label} N={n} K={K}: states differ from the "
                                         f"one-thread walk's")
                r = repair.to(torch.int64)
                lens = torch.clamp(n - K * torch.arange(chunks, device=dev), max=K)
                repairs[label][f"N={n}"][f"K={K}"] = {
                    "chunks": chunks, "mean": float(r.float().mean()), "max": int(r.max()),
                    "to_end": int(((r == lens) & (r > 0)).sum()), "total": int(r.sum())}
                if K == K0:  # chunks by repair length, the last bin 64 or more
                    repairs[label][f"N={n}"][f"K={K}"]["histogram"] = torch.bincount(
                        torch.clamp(r, max=64)).tolist()
            ms = {}
            for name in [*runs, *reversed(runs)]:
                reps = 1 if name == "one thread" else 5
                t = _seconds_per_rep(runs[name], reps, dev) * 1e3
                ms[name] = min(ms.get(name, t), t)
            times[label][f"N={n}"] = ms
            rule[label][f"N={n}"] = K0
    return {"spec_ms": times, "spec_repair": repairs, "spec_rule_K": rule}


MEET_SHAPES = ((1, 1 << 15), (8, 1 << 12), (8, 1 << 15), (64, 1 << 12), (1024, 256))


def meet_ab(cells: dict, lib) -> dict:
    """The chunk stitch's A/B for tables that do not synchronize.
    ``cells``: ``{label: (table, classes, depth)}`` on the card, a dense
    table, ``int32`` classes of at least 256 Ki units and the table's
    synchronizing depth or None; ``lib`` this file's library.  At each C x K
    of ``MEET_SHAPES`` it times the first designs (``maps_first``,
    ``rescan_first``) against the package's forms for any table (the maps
    meeting a reference run, the rescan by speculate and repair by rows)
    and, where ``depth`` is given, the synchronized forms, each launch held
    bit for bit against the first design; with the meet positions (mean,
    largest, lanes that never met) and the rescan's repair lengths.
    Returns ``{"meet_ms": {label: {"C x K": {run: ms}}}, "meet_stats": ...}``."""
    from ahocorasick_tpu_torch.bench import _seconds_per_rep
    from ahocorasick_tpu_torch.kernels import scan_dfa
    from ahocorasick_tpu_torch.kernels import stitch as kstitch

    package = build.library()
    times, stats = {}, {}
    for label, (table, cls, depth) in cells.items():
        dev = cls.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        S, A = table.shape
        times[label], stats[label] = {}, {}
        for C, K in MEET_SHAPES:
            c = cls[: C * K].reshape(C, K)
            sigma = torch.empty((C, S), dtype=torch.int32, device=dev)
            run = torch.empty((C, K), dtype=torch.int32, device=dev)
            meet = torch.empty((C, S), dtype=torch.int32, device=dev)
            agree = torch.empty(2 * C, dtype=torch.int32, device=dev)
            states = torch.empty((C, K), dtype=torch.int32, device=dev)
            repair = torch.zeros((C, -(-K // scan_dfa.spec_chunk_len(K))), dtype=torch.int32,
                                 device=dev)

            def checked(rc, name):
                if rc != 0:
                    raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

            def maps_first():
                checked(lib.maps_first(table.data_ptr(), c.data_ptr(), C, K, S, A,
                                       sigma.data_ptr(), dev.index or 0, stream), "maps_first")

            def maps_meet(with_meet=False):
                checked(package.state_maps_all(
                    table.data_ptr(), c.data_ptr(), C, K, S, A, scan_dfa.spec_chunk_len(K),
                    run.data_ptr(), sigma.data_ptr(), meet.data_ptr() if with_meet else None,
                    dev.index or 0, stream), "state_maps_all")

            def maps_sync():
                checked(package.state_maps(table.data_ptr(), c.data_ptr(), C, K, S, A, depth,
                                           agree.data_ptr(), sigma.data_ptr(), dev.index or 0,
                                           stream), "state_maps")

            maps_first()
            want = sigma.clone()
            entry = kstitch.entry_fold(want, 0)

            def rescan_first():
                checked(lib.rescan_first(table.data_ptr(), c.data_ptr(), entry.data_ptr(), C, K,
                                         A, states.data_ptr(), dev.index or 0, stream),
                        "rescan_first")

            def rescan_spec(with_repair=False):
                checked(package.rescan_serial(
                    table.data_ptr(), c.data_ptr(), entry.data_ptr(), C, K, A,
                    scan_dfa.spec_chunk_len(K), states.data_ptr(),
                    repair.data_ptr() if with_repair else None, dev.index or 0, stream),
                    "rescan_serial")

            def rescan_sync():
                checked(package.rescan(table.data_ptr(), c.data_ptr(), entry.data_ptr(), C, K, A,
                                       depth, scan_dfa.sync_lane_len(C * K, depth),
                                       states.data_ptr(), dev.index or 0, stream), "rescan")

            rescan_first()
            want_states = states.clone()
            maps = {"maps first": maps_first, "maps meet": maps_meet}
            rescans = {"rescan first": rescan_first, "rescan spec": rescan_spec}
            if depth is not None:
                maps["maps sync"] = maps_sync
                rescans["rescan sync"] = rescan_sync
            for name, launch in (*maps.items(), ("maps meet + meet", lambda: maps_meet(True))):
                sigma.fill_(-1)
                launch()
                if not torch.equal(sigma, want):
                    raise AssertionError(f"meet {label} C={C} K={K} {name}: sigma differs from "
                                         f"the first design's")
            for name, launch in (*rescans.items(),
                                 ("rescan spec + repair", lambda: rescan_spec(True))):
                states.fill_(-1)
                launch()
                if not torch.equal(states, want_states):
                    raise AssertionError(f"meet {label} C={C} K={K} {name}: states differ from "
                                         f"the first design's")
            m64, r64 = meet.to(torch.int64), repair.to(torch.int64)
            stats[label][f"{C} x {K}"] = {
                "meet_mean": float(m64.double().mean()), "meet_max": int(m64.max()),
                "never_met": int((m64 == K).sum()), "lanes": m64.numel(),
                "repair_mean": float(r64.double().mean()), "repair_max": int(r64.max()),
                "sub_chunk": scan_dfa.spec_chunk_len(K)}
            runs = {**maps, **rescans}
            ms = {}
            for name in [*runs, *reversed(runs)]:
                reps = 1 if name.endswith("first") else 5
                t = _seconds_per_rep(runs[name], reps, dev) * 1e3
                ms[name] = min(ms.get(name, t), t)
            times[label][f"{C} x {K}"] = ms
    return {"meet_ms": times, "meet_stats": stats}


# (threads, per_lane, blocks) of pfac_queue: threads a block, starts a lane
# in a prefix pass, blocks an SM (the register budget: 64 or 32 a thread)
PFAC_WIDTHS = ((1024, 4, 1), (1024, 4, 2), (512, 4, 2), (512, 8, 2), (256, 4, 4))
PFAC_TILE = 4096  # pfac_tiles' planes tile (its count takes 16 Ki)
PFAC_TILE_COUNT = 16384


def pfac_ab(cell: tuple, lib, grid: bool = True) -> dict:
    """The PFAC v2 walk's A/B on one cell: ``cell`` ``(ranked, classes,
    depth, num_classes)`` on the card (``RankedTables`` as
    ``_DeviceTables.ranked`` holds them, the ``pad_classes``-padded uint8
    classes).  Times, in one process, the first design (``pfac_first``: its
    planes, its count, and its count with each block's sum stored instead of
    the atomic add), the package's walk (``csrc/pfac_walk.cuh``) at its
    shape and with the prefix table in the other placement, and with
    ``grid``: the same walk at each (threads, per_lane) of ``PFAC_WIDTHS``
    and both placements (``pfac_queue``), and the tiled walk with block
    barriers (``pfac_tiles``: refills, one walk a thread, two interleaved);
    each launch held bit for bit against the package's wrapper first; ms per
    launch (the wrappers' allocations outside the timing)."""
    from ahocorasick_tpu_torch.bench import _seconds_per_rep
    from ahocorasick_tpu_torch.kernels import scan_pfac as kpf
    from ahocorasick_tpu_torch.kernels.scan_block import _popcount32, _widen

    rt, cls, depth, A = cell
    dev = cls.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, P, k = cls.numel() - depth, -(-depth // 32), rt.prefix_k
    cb = kpf._CLASS_BYTES[cls.dtype]
    E = rt.prefix.numel()
    package = build.library()
    want = kpf.pfac2_planes(rt.trie_next, rt.prefix, rt.match_threshold, cls, depth, P, k, A,
                            rt.dead_state)
    want_count = int(kpf.pfac2_count(rt.trie_next, rt.prefix, rt.match_threshold, cls, depth, k,
                                     A, rt.dead_state))
    pop = int(_popcount32(_widen(want)).sum())
    if pop != want_count:
        raise AssertionError(f"pfac A/B: the count {want_count} != the planes' {pop} bits")
    head = (rt.trie_next.data_ptr(), rt.trie_next.shape[1], rt.prefix.data_ptr(),
            rt.match_threshold, rt.dead_state, cls.data_ptr(), cb, n, depth, k, A, P)
    planes = torch.empty((P, n), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    slots = torch.zeros(-(-n // 256), dtype=torch.int64, device=dev)
    sms = kpf.sm_count(dev)
    tail = (dev.index or 0, stream)

    def checked(rc, name):
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    def out(count_mode):
        return (count if count_mode else planes).data_ptr()

    def first(mode, buf):
        return lambda: checked(lib.pfac_first(mode, *head, buf.data_ptr(), *tail), "pfac_first")

    def package_walk(count_mode, shared=None):
        sh = kpf.launch_shape(n, cb, E, sms)
        sh_p = int(sh.prefix_shared if shared is None else shared)
        if count_mode:
            return lambda: checked(package.pfac2_count(*head[:-1], sh.grid, sh.span, sh_p,
                                                       out(True), *tail), "pfac2_count")
        return lambda: checked(package.pfac2_planes(*head, sh.grid, sh.span, sh_p, out(False),
                                                    *tail), "pfac2_planes")

    def queue(count_mode, threads, per_lane, blocks, shared):
        sh = kpf.launch_shape(n, cb, E, sms, threads=threads, per_lane=per_lane, blocks=blocks)
        return lambda: checked(lib.pfac_queue(threads, per_lane, blocks, int(count_mode), *head,
                                              sh.grid, sh.span, int(shared), out(count_mode),
                                              *tail), "pfac_queue")

    def tiles(count_mode, arm):
        tile = PFAC_TILE_COUNT if count_mode else PFAC_TILE
        g = min(-(-n // tile), 2 * sms)
        return lambda: checked(lib.pfac_tiles(arm, int(count_mode), *head, g, tile, tile + depth,
                                              0 if count_mode else P, 1, 2, out(count_mode),
                                              *tail), "pfac_tiles")

    shared = kpf.launch_shape(n, cb, E, sms).prefix_shared
    other = "ldg" if shared else "shared"
    runs = {"planes first": (first(0, planes), "planes"),
            "count first": (first(1, count), "count"),
            "count first, no atomic": (first(2, slots), "slots"),
            "planes": (package_walk(False), "planes"),
            "count": (package_walk(True), "count"),
            f"planes, prefix {other}": (package_walk(False, not shared), "planes"),
            f"count, prefix {other}": (package_walk(True, not shared), "count")}
    if grid and cb == 1:
        for threads, per_lane, blocks in PFAC_WIDTHS:
            fits = kpf.launch_shape(n, cb, E, sms, threads=threads, per_lane=per_lane,
                                    blocks=blocks).prefix_shared
            for placed in (True, False) if fits else (False,):
                label = (f"{threads} threads, {per_lane} a lane, {blocks} a SM, prefix "
                         f"{'shared' if placed else 'ldg'}")
                runs[f"planes {label}"] = (queue(False, threads, per_lane, blocks, placed),
                                           "planes")
                runs[f"count {label}"] = (queue(True, threads, per_lane, blocks, placed), "count")
        for arm, label in ((0, "refills"), (1, "one walk a thread"), (2, "two interleaved")):
            runs[f"planes tiles, {label}"] = (tiles(False, arm), "planes")
            runs[f"count tiles, {label}"] = (tiles(True, arm), "count")
    want32 = want.view(torch.int32)
    for label, (launch, kind) in runs.items():
        planes.fill_(-1)
        count.zero_()
        slots.fill_(-1)
        launch()
        got = (torch.equal(planes, want32) if kind == "planes" else
               int(count[0]) == want_count if kind == "count" else
               int(slots.sum()) == want_count)
        if not got:
            raise AssertionError(f"pfac A/B {label}: differs from the package's wrapper")
    ms = {}
    for label in [*runs, *reversed(runs)]:
        t = _seconds_per_rep(runs[label][0], 20, dev) * 1e3
        ms[label] = min(ms.get(label, t), t)
    return {"pfac_ms": ms, "pfac_count": want_count, "pfac_lanes": n,
            "pfac_shape": kpf.launch_shape(n, cb, E, sms)._asdict(), "pfac_sm_count": sms}


FUSED_KS = (1, 2, 4, 8)  # the fused scan's lanes a window in its A/B


def _checked(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _same_outcomes(label, got, want) -> None:
    for k, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: output {k} differs")


def wwl_fused_ab(cells: dict, lib) -> dict:
    """The fused whole-word-longest scan's A/B.  ``cells``: ``{label: (sc,
    windows, starts, d)}`` on the card (``sc`` a dense ``WwlScan``, the
    ``chunk_classes_overlap`` windows, the sorted start slots).  Times, in
    one process, the first design (``wwl_fused_first``: the cursor in the
    chain and the resolve launch, at the planes' segments rule) and the
    package's kernel at each K of ``FUSED_KS`` that the segments rule's
    lengths allow (the package's K among them), each launch held bit for bit
    against the package's wrapper first, and the wrapper against its twin;
    ms per launch (the outputs allocated outside the timing)."""
    from ahocorasick_tpu_torch.kernels import scan_block
    from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl

    package = build.library()
    record = {}
    for label, (sc, wf, st, d) in cells.items():
        dev = wf.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        B, W = wf.shape
        C = W - d - (d + 1)
        cross = sc.has_cross
        kw = dict(halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits,
                  num_classes=sc.num_classes, d=d, cross=cross)
        want = kwwl.wwl_scan_fused(sc.table, sc.outrows, wf, st, **kw)
        _same_outcomes(f"wwl_fused {label}: the wrapper vs its twin", want,
                       kwwl.wwl_scan_fused_plain(sc.table, sc.outrows, wf, st, **kw))
        n = st.shape[0]
        slots = kwwl.lane_slots(st)
        stride = sc.table.shape[1] if sc.table.dim() == 2 else sc.num_classes
        head = (sc.table.data_ptr(), wf.data_ptr(), kwwl._CLASS_BYTES[wf.dtype], B, W, d, stride,
                d, sc.id_bits, sc.depth_bits, int(cross))
        outs = kwwl._empty_outcomes(n, dev, cross)
        ptrs = (*(t.data_ptr() for t in outs[:5]), outs[5].data_ptr() if cross else None)
        meta = torch.empty(n, dtype=torch.int32, device=dev)
        k_first, l_first = scan_block.segments(B, C, d)
        runs = {f"first K={k_first}": lambda: _checked(lib.wwl_fused_first(
            *head, k_first, l_first, st.data_ptr(), n, sc.outrows.data_ptr(), meta.data_ptr(),
            *ptrs, dev.index or 0, stream), "wwl_fused_first")}
        k_pkg = kwwl.fused_segments(B, C, d)[0]
        for k in FUSED_KS:
            kk, seg = scan_block.segments(B, C, d, 1 << 40, k)
            if kk != k:
                continue
            runs[f"K={k}"] = (lambda kk=kk, seg=seg: _checked(package.wwl_scan_fused(
                *head, kk, seg, st.data_ptr(), n, slots, sc.outrows.data_ptr(), meta.data_ptr(),
                *ptrs, dev.index or 0, stream), "wwl_scan_fused"))

        def check(name, launch):
            for t in outs:
                t.zero_()
            launch()
            _same_outcomes(f"wwl_fused {label} {name}", outs, want)

        record[label] = {"windows": [B, W], "slots": n, "lane_slots": slots, "d": d,
                         "package_K": k_pkg, "ms": _sweep(runs, check)}
    return {"wwl_fused_ms": record}


def walk_loads(tabs, derived, cls, starts, d) -> dict:
    """The table loads each walk makes: the first design's ``k_die + 1``
    trie loads (``d + 1`` for a walk that lives through every step), the
    package's one prefix load and ``k_die + 1 - k`` trie loads past the
    prefix; their sums, means and maxima over the start slots."""
    from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl

    trie = tabs[0]
    A, dead = trie.shape[1], trie.shape[0] - 1
    flat = trie.reshape(-1).to(torch.int64)
    cls_at = kwwl._class_reader(cls)
    w = starts.to(torch.int64)
    state = torch.zeros_like(w)
    steps = torch.full_like(w, d + 1)
    for k in range(d + 1):
        nxt = flat[state * A + cls_at(w + k)]
        steps = torch.where((steps > d) & (nxt == dead), k + 1, steps)
        state = nxt
    pk = derived.prefix_k
    first = steps
    package = 1 + (steps - pk).clamp(min=0)
    out = {}
    for name, x in (("first", first), ("package", package)):
        out[name] = {"loads": int(x.sum()), "mean": float(x.double().mean()), "max": int(x.max())}
    out["prefix_k"] = pk
    out["died_in_prefix"] = int((steps <= pk).sum())
    return out


def wwl_walk_ab(cells: dict, lib) -> dict:
    """The per-start walk's A/B.  ``cells``: ``{label: (tabs, derived,
    classes, starts, d)}`` on the card (``_DeviceTables.wwl_walk`` and
    ``wwl_walk_derived``, the padded classes, the start slots).  Times, in
    one process, the first design (``wwl_walk_first``: one thread a start
    over the bare trie and the five outcome arrays) and the package's walk
    (a thread a start with the k-gram prefix and the outcome rows), each
    launch held bit for bit against the twin first; ms per launch, and each
    design's table loads a walk (``walk_loads``) and their rate."""
    from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl

    package = build.library()
    record = {}
    for label, (tabs, derived, cls, st, d) in cells.items():
        dev = cls.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        S, A = tabs[0].shape
        n = st.shape[0]
        want = kwwl.wwl_walks_at_plain(*tabs, cls, st, d)
        _same_outcomes(f"wwl_walk {label}: the wrapper vs its twin",
                       kwwl.wwl_walks_at(*tabs, cls, st, d, walk_tables=derived), want)
        outs = kwwl._empty_outcomes(n, dev, False)
        ptrs = tuple(t.data_ptr() for t in outs)
        cb = kwwl._CLASS_BYTES[cls.dtype]
        tail = (dev.index or 0, stream)
        runs = {"first": lambda: _checked(lib.wwl_walk_first(
            *(t.data_ptr() for t in tabs), S, A, cls.data_ptr(), cb, cls.shape[0],
            st.data_ptr(), n, d, *ptrs, *tail), "wwl_walk_first"),
            f"package, k={derived.prefix_k}": lambda: _checked(package.wwl_walks_at(
                tabs[0].data_ptr(), derived.prefix.data_ptr(), derived.rows.data_ptr(),
                tabs[6].data_ptr(), S, A, derived.prefix_k, cls.data_ptr(), cb, cls.shape[0],
                st.data_ptr(), n, d, *ptrs, *tail), "wwl_walks_at")}

        def check(name, launch):
            for t in outs:
                t.zero_()
            launch()
            _same_outcomes(f"wwl_walk {label} {name}", outs, want)

        ms = _sweep(runs, check)
        loads = walk_loads(tabs, derived, cls, st, d)
        rate = {name: loads["first" if name == "first" else "package"]["loads"] / (t * 1e-3) / 1e9
                for name, t in ms.items()}
        record[label] = {"slots": n, "d": d, "ms": ms, "loads": loads, "g_loads_per_s": rate}
    return {"wwl_walk_ms": record}


def wwl_cells(m, cls) -> tuple:
    """``wwl_fused_ab``'s and ``wwl_walk_ab``'s cells of one matcher and
    text: the facade's start slots (``compact_lanes``) over the fused
    scan's windows and the walk's padded classes."""
    from ahocorasick_tpu_torch.ops import scan_batched, scan_wwl

    comp = m.compiled
    sc = m.dev.wwl_scan
    cls_p, starts, _lanes, _ws, d = scan_wwl.compact_lanes(comp, cls)
    dev = sc.outrows.device
    st = torch.from_numpy(starts).to(dev)
    wf = scan_batched.classes_to_device(
        scan_wwl.chunk_classes_overlap(cls_p, scan_wwl._CHUNK, d, d + 1, sc.num_classes),
        sc.num_classes, dev)
    walk_cls = scan_batched.classes_to_device(cls_p, comp.num_classes, dev)
    tabs = m.dev.wwl_walk
    return ((sc, wf, st, d), (tabs, scan_wwl.build_walk_tables(*tabs[:6], d), walk_cls, st, d))


AGAINST_KERNELS = ("packed_scan_count", "packed_scan_planes", "packedcount_count",
                   "packedcount_hotstate_plane", "split_emit_planes", "rowdfa2_count",
                   "table_sharded_scan", "seq_states_sync", "rescan", "seq_states_spec",
                   "pfac1_planes")
AGAINST_RESCAN = ((8, 1 << 22), (1, 1 << 15))  # the rescan's (C, K) in the comparison
AGAINST_SEQ_UNITS = (1 << 16, 1 << 25)  # the lane scan's N in the comparison
AGAINST_SPEC_UNITS = (1 << 16, 1 << 20, 1 << 25)  # speculate and repair's N (one row)


def against(other_root: str, count_cell: tuple, hot_cell: tuple, split_cell: tuple,
            row_cell: tuple, tp_cell: tuple, seq_cell: tuple, spec_cell: tuple,
            pfac_cell: tuple) -> dict:
    """The lane-loop kernels of this checkout and of ``other_root``'s
    ``csrc/`` on the cells of ``run``, ``rowdfa2_ab`` (``row_cell``) and
    ``tp_ab`` (``tp_cell``; the count and planes modes), the lane scan of
    ``seq_states`` (``seq_cell``: dense table, ``int32[N]`` classes, d) at
    ``AGAINST_SEQ_UNITS`` with the rule's L, and speculate and repair in its
    one-row form (``seq_states_spec``; ``spec_cell``: ``{label: (table,
    row_id or None, classes)}``, each with at least 32 Mi classes: the
    dense restart table and ``shortest_states``' restart rows) at
    ``AGAINST_SPEC_UNITS`` with the rule's K, and the PFAC v1 walk
    (``pfac1_planes``; ``pfac_cell``: ``(trie, is_match, classes, depth)``, the
    padded v1 trie whose last row is the dead state): ``{kernel: {"K" or "L",
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
    from ahocorasick_tpu_torch.kernels import scan_dfa

    table, cls, depth = seq_cell
    stream = torch.cuda.current_stream(cls.device).cuda_stream
    for n in AGAINST_SEQ_UNITS:
        L = scan_dfa.sync_lane_len(n, depth)
        outs, runs = {}, {}
        for tree, lib in libs.items():
            outs[tree] = torch.empty(n, dtype=torch.int32, device=cls.device)

            def launch(lib=lib, out=outs[tree]):
                rc = lib.seq_states_sync(table.data_ptr(), None, cls.data_ptr(), n,
                                         table.shape[1], 0, depth, L, out.data_ptr(),
                                         cls.device.index or 0, stream)
                if rc != 0:
                    raise RuntimeError(f"seq_states_sync launch failed: CUDA error {rc}")
            runs[tree] = launch
            launch()
        if not torch.equal(outs["other"], outs["this"]):
            raise AssertionError(f"seq_states N={n}: the two checkouts' lane scans differ")
        ms = {"other": [], "this": []}
        for tree in ("other", "this", "this", "other"):
            ms[tree].append(_seconds_per_rep(runs[tree], 20, cls.device) * 1e3)
        record[f"seq_states N={n}"] = {"L": L, "other_ms": ms["other"], "this_ms": ms["this"],
                                       "this_over_other": min(ms["this"]) / min(ms["other"])}
    for chunks, K in AGAINST_RESCAN:
        L = scan_dfa.sync_lane_len(chunks * K, depth)
        entry = torch.zeros(chunks, dtype=torch.int32, device=cls.device)
        outs, runs = {}, {}
        for tree, lib in libs.items():
            outs[tree] = torch.empty(chunks * K, dtype=torch.int32, device=cls.device)

            def launch(lib=lib, out=outs[tree]):
                rc = lib.rescan(table.data_ptr(), cls.data_ptr(), entry.data_ptr(), chunks, K,
                                table.shape[1], depth, L, out.data_ptr(), cls.device.index or 0,
                                stream)
                if rc != 0:
                    raise RuntimeError(f"rescan launch failed: CUDA error {rc}")
            runs[tree] = launch
            launch()
        if not torch.equal(outs["other"], outs["this"]):
            raise AssertionError(f"rescan C={chunks} K={K}: the two checkouts' rescans differ")
        ms = {"other": [], "this": []}
        for tree in ("other", "this", "this", "other"):
            ms[tree].append(_seconds_per_rep(runs[tree], 20, cls.device) * 1e3)
        record[f"rescan C={chunks} K={K}"] = {
            "L": L, "other_ms": ms["other"], "this_ms": ms["this"],
            "this_over_other": min(ms["this"]) / min(ms["other"])}
    for label, (table, row_id, cls) in spec_cell.items():
        rid = None if row_id is None else row_id.data_ptr()
        for n in AGAINST_SPEC_UNITS:
            K = scan_dfa.spec_chunk_len(n)
            outs, runs = {}, {}
            for tree, lib in libs.items():
                outs[tree] = torch.empty(n, dtype=torch.int32, device=cls.device)

                def launch(lib=lib, out=outs[tree]):
                    rc = lib.seq_states_spec(table.data_ptr(), rid, cls.data_ptr(),
                                             scan_dfa._CLASS_BYTES[cls.dtype], n, table.shape[1],
                                             0, K, out.data_ptr(), None, cls.device.index or 0,
                                             stream)
                    if rc != 0:
                        raise RuntimeError(f"seq_states_spec launch failed: CUDA error {rc}")
                runs[tree] = launch
                launch()
            if not torch.equal(outs["other"], outs["this"]):
                raise AssertionError(f"seq_states_spec {label} N={n}: the two checkouts' scans "
                                     f"differ")
            ms = {"other": [], "this": []}
            for tree in ("other", "this", "this", "other"):
                ms[tree].append(_seconds_per_rep(runs[tree], 5, cls.device) * 1e3)
            record[f"seq_states_spec {label} N={n}"] = {
                "K": K, "other_ms": ms["other"], "this_ms": ms["this"],
                "this_over_other": min(ms["this"]) / min(ms["other"])}
    trie, is_match, cls, depth = pfac_cell
    n, P = cls.numel() - depth, -(-depth // 32)
    outs, runs = {}, {}
    for tree, lib in libs.items():
        outs[tree] = torch.empty((P, n), dtype=torch.int32, device=cls.device)

        def launch(lib=lib, out=outs[tree]):
            rc = lib.pfac1_planes(trie.data_ptr(), trie.shape[1], is_match.data_ptr(),
                                  trie.shape[0] - 1, cls.data_ptr(), cls.element_size(), n,
                                  depth, P, out.data_ptr(), cls.device.index or 0, stream)
            if rc != 0:
                raise RuntimeError(f"pfac1_planes launch failed: CUDA error {rc}")
        runs[tree] = launch
        launch()
    if not torch.equal(outs["other"], outs["this"]):
        raise AssertionError("pfac1_planes: the two checkouts' walks differ")
    ms = {"other": [], "this": []}
    for tree in ("other", "this", "this", "other"):
        ms[tree].append(_seconds_per_rep(runs[tree], 20, cls.device) * 1e3)
    record["pfac1_planes"] = {"other_ms": ms["other"], "this_ms": ms["this"],
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
    parser.add_argument("--pfac", action="store_true",
                        help="only the PFAC v2 walk's A/B (pfac_ab) on the 10k cell")
    parser.add_argument("--wwl", action="store_true",
                        help="only the whole-word-longest walks' A/Bs (wwl_fused_ab, "
                             "wwl_walk_ab) at baseline-4 and the 10k cell")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lib = None if opts.against else library()
    if opts.wwl:
        print(json.dumps({"card": smi, **wwl_ab(dev, lib)}))
        return
    rng = np.random.default_rng(SEED)
    keywords = make_dictionary(rng, N_KEYWORDS)
    m = AhoCorasickSet(keywords, engine="device", device=dev)
    pd = m.dev.packed_dfa
    base = make_text_classes(m, keywords, rng, BASE_UNITS)
    if opts.pfac:
        print(json.dumps({"card": smi, **pfac_ab(ten_k_pfac_cell(m, base, dev)[0], lib)}))
        return
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
                         row_cell, ten_k_shards(m, dev, w),
                         (m.dev.seq_tables[0], _int32_classes(
                             np.tile(base, TEXT_UNITS // BASE_UNITS), dev),
                          max(m.compiled.max_depth, 1)),
                         _restart_spec_cells(keywords, dev), ten_k_pfac_cell(m, base, dev)[1])
        print(json.dumps({"card": smi, "against": opts.against, **record}))
        return
    record = run((pd.table, w, pd.halo, pd.state_bits), (flat, wh, halo, sb, A),
                 (dfa, emit, ws, shalo, A, emit.shape[1]), lib)
    record.update(rowdfa2_ab(row_cell, lib))
    wide = AhoCorasickSet([chr(c) for c in range(0x100, 0xD800)], engine="gold", device=dev)
    wide_cls = wide._classes(wide_soup(np.random.default_rng(SEED + 9), DEMO_KEYWORDS,
                                       BASE_UNITS))
    cls32 = _int32_classes(np.tile(base, TEXT_UNITS // BASE_UNITS), dev)
    wide32 = _int32_classes(np.tile(wide_cls, TEXT_UNITS // BASE_UNITS), dev)
    record.update(seq_ab({
        "10k dense": (*m.dev.seq_tables, cls32, max(m.compiled.max_depth, 1)),
        "wide RowTable": (*wide.dev.seq_tables, wide32, max(wide.compiled.max_depth, 1)),
    }, lib))
    restart_cells = ten_k_restart_cells(keywords, dev)
    record.update(spec_ab({**restart_cells,
                           "10k dense": (*m.dev.seq_tables, cls32, None),
                           "wide RowTable": (*wide.dev.seq_tables, wide32, None)}, lib))
    demo = AhoCorasickSet(DEMO_KEYWORDS, engine="device", device=dev)
    demo_cls = _int32_classes(demo._classes(word_soup(np.random.default_rng(SEED + 10),
                                                      DEMO_KEYWORDS, 1 << 18)), dev)
    record.update(meet_ab({
        "10k restart table": (restart_cells["10k restart table"][0],
                              restart_cells["10k restart table"][2], None),
        "10k closure": (m.dev.seq_tables[0], cls32, max(m.compiled.max_depth, 1)),
        "demo dictionary": (demo.dev.dfa_next, demo_cls, max(demo.compiled.max_depth, 1))},
        lib))
    record.update(tp_ab(ten_k_shards(m, dev, w)))
    record.update(sweep_ab(ten_k_sweep_cells(keywords, dev)))
    record.update(pfac_ab(ten_k_pfac_cell(m, base, dev)[0], lib))
    record.update(wwl_ab(dev, lib))
    print(json.dumps({"card": smi, **record}))


def wwl_ab(dev, lib) -> dict:
    """``wwl_fused_ab`` and ``wwl_walk_ab`` at baseline-4 and the 10k cell
    (``probes.probe_wwl_fused``'s cases)."""
    from ahocorasick_tpu_torch.probes import probe_wwl_fused

    fused, walk = {}, {}
    for label, make in (("baseline-4", probe_wwl_fused.baseline4),
                        ("10k", probe_wwl_fused.cell_10k)):
        fused[label], walk[label] = wwl_cells(*make(dev))
    return {**wwl_fused_ab(fused, lib), **wwl_walk_ab(walk, lib)}


def ten_k_pfac_cell(m, base, dev) -> tuple:
    """The PFAC walk's cells on the 10k matcher ``m`` over ``base`` tiled to
    32 Mi units: ``pfac_ab``'s (the ranked tables, the padded classes, the
    depth, the classes' count) and ``against``'s v1 cell (the padded trie,
    is_match, the classes, the depth)."""
    from ahocorasick_tpu_torch.bench.headline import BASE_UNITS, TEXT_UNITS
    from ahocorasick_tpu_torch.ops import scan_batched, scan_pfac
    from ahocorasick_tpu_torch.utils.lanes import LANE_BUCKET, bucket_depth

    c = m.compiled
    d = bucket_depth(c.max_depth)
    cp = scan_batched.classes_to_device(
        scan_pfac.pad_classes(np.tile(base, TEXT_UNITS // BASE_UNITS), d, bucket=LANE_BUCKET),
        c.num_classes, dev)
    return (m.dev.ranked, cp, d, c.num_classes), (m.dev.trie_next, m.dev.is_match, cp, d)


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


def ten_k_restart_cells(keywords, dev) -> dict:
    """``spec_ab``'s restart-table cells: the shortest matcher of
    ``keywords`` over 32 Mi units of ``bench.py``'s word soup (a 1 Mi base
    tiled), in the ``shortest_states`` form (the padded dfa_next, its
    restart rows and match_len, uint8 classes) and as the cursor's dense
    restart table (int32 classes)."""
    from ahocorasick_tpu_torch.bench.__main__ import word_soup
    from ahocorasick_tpu_torch.bench.headline import BASE_UNITS, SEED, TEXT_UNITS
    from ahocorasick_tpu_torch.core import stream
    from ahocorasick_tpu_torch.core.compiler import compile_matcher
    from ahocorasick_tpu_torch.models.matchers import ShortestMatchSet
    from ahocorasick_tpu_torch.ops import scan_batched

    m = ShortestMatchSet.from_compiled(compile_matcher(keywords, "shortest", True),
                                       engine="device", device=dev)
    cls = np.tile(m._classes(word_soup(np.random.default_rng(SEED), keywords, BASE_UNITS)),
                  TEXT_UNITS // BASE_UNITS)
    restart = stream.seq_tensors(stream._ShortestCursor._restart_table(m.compiled), dev)
    return {
        "10k shortest_states": (m.dev.dfa_next, m.dev.restart_row_id,
                                scan_batched.classes_to_device(cls, m.compiled.num_classes, dev),
                                m.dev.match_len),
        "10k restart table": (*restart, _int32_classes(cls, dev), None),
    }


def _restart_spec_cells(keywords, dev) -> dict:
    """``{label: (table, row_id, classes)}``: ``ten_k_restart_cells`` for
    ``against``, the cursor's dense restart table (int32 classes) and
    ``shortest_states``' restart rows (uint8 classes)."""
    return {label: cell[:3] for label, cell in ten_k_restart_cells(keywords, dev).items()}


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
