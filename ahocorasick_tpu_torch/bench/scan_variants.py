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
other, this, this, other; then the probes' lookup chain ``chain_gather``
(the load op at every residency-sweep size in every placement), the
one-hot product ``onehot_mma`` and the 2-D gather ``gather2d`` in every mode
(``against_probes``).  A parent from before the redesigned v1 walk or the
warp-row 2-D gather is called with its first design's arguments.  Prints one
JSON line.

    python -m ahocorasick_tpu_torch.bench.scan_variants --step [--against DIR]

times the table-sharded scan's step loop under a process group
(``csrc/table_sharded.cu`` ``table_sharded_step`` and its class-major prep
``table_sharded_classes``) at the three main-path shapes (the 10k planes and
count, the 1M count-packed count), one rank holding the whole table:
``step_sweep``, K = 1 to 32 lanes a window, each K's step, captured NCCL
all_reduce (world 1), prep, and whole loop replayed from its CUDA graph and
run eagerly, every result held to ``table_sharded_scan``; with
``--against``, ``step_against``, the loop against the other checkout's.

    python -m ahocorasick_tpu_torch.bench.scan_variants --probes [--against DIR]

times the probes' arms: the lookup chain's in global memory (``chain_ab``:
independent addresses, the random-request ceiling; the chains in flight;
``__ldcg``, the L1 carve-out, 2 and 4 chains a thread, one block an SM);
with ``--against``, only ``against_probes``.
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
    # (tab, rows, width, s0, n, reps, reduce, mod, out, device, stream)
    lib.row_chain_first.argtypes = [P, I64, I, P, I64, I, I, I64, P, I, P]
    # (sigma, num_chunks, num_states, s0, entry, device, stream)
    lib.entry_fold_first.argtypes = [P, I64, I64, I, P, I, P]
    lib.row_chain_first.restype = lib.entry_fold_first.restype = ctypes.c_int
    # (tab, T, n, reps, out, device, stream)
    lib.chain_independent.argtypes = [P, I64, I64, I, P, I, P]
    # (chains, cg, carveout, even, tab, T, idx, n, reps, out, device, stream)
    lib.chain_arm.argtypes = [I, I, I, I, P, I64, P, I64, I, P, I, P]
    lib.chain_independent.restype = lib.chain_arm.restype = ctypes.c_int
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


def _other_library(other_root: str, names) -> ctypes.CDLL:
    """The ``csrc/*.cu`` of the checkout at ``other_root`` built into one
    library, loaded, with the entry points ``names`` typed as the package's."""
    import glob

    sources = tuple(sorted(glob.glob(os.path.join(other_root, "ahocorasick_tpu_torch", "csrc",
                                                  "*.cu"))))
    if not sources:
        raise FileNotFoundError(f"no ahocorasick_tpu_torch/csrc/*.cu under {other_root}")
    lib = ctypes.CDLL(build.build(sources, "libac_kernels_other"))
    for name in names:
        getattr(lib, name).argtypes = build.ARGTYPES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


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
    from ahocorasick_tpu_torch.bench import _seconds_per_rep
    from ahocorasick_tpu_torch.kernels import scan_batched as khuge
    from ahocorasick_tpu_torch.kernels import scan_block
    from ahocorasick_tpu_torch.kernels import scan_rowdfa as krow
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    libs = {"other": _other_library(other_root, AGAINST_KERNELS), "this": build.library()}
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
        runs[tree] = pfac1_launcher(lib, _planned_v1(other_root) if tree == "other" else True,
                                    pfac_cell, outs[tree])
        runs[tree]()
    if not torch.equal(outs["other"], outs["this"]):
        raise AssertionError("pfac1_planes: the two checkouts' walks differ")
    ms = {"other": [], "this": []}
    for tree in ("other", "this", "this", "other"):
        ms[tree].append(_seconds_per_rep(runs[tree], 20, cls.device) * 1e3)
    record["pfac1_planes"] = {"other_ms": ms["other"], "this_ms": ms["this"],
                              "this_over_other": min(ms["this"]) / min(ms["other"])}
    return record


STEP_KS = (1, 2, 4, 8, 16, 32)  # the step loop's K sweep


def step_cells(pd_table, w, halo, sb, table1m, w1m, halo1m, sb1m) -> dict:
    """The step loop's three main-path shapes: ``{label: (shard, windows,
    halo, state_bits, mode)}``, each table one shard (the whole table, as
    one rank of a one-rank model axis would hold it) on the windows'
    device: the 10k planes and count, the 1M count-packed count."""
    from ahocorasick_tpu_torch.parallel import sharding

    ten = sharding._shard_tensor(pd_table, w.device)
    one_m = sharding._shard_tensor(table1m, w1m.device)
    return {"10k planes": (ten, w, halo, sb, "planes"), "10k count": (ten, w, halo, sb, "count"),
            "1M count_packed": (one_m, w1m, halo1m, sb1m, "count_packed")}


def _forced_k(k: int):
    """A context in which ``step_segments`` takes at most ``k`` lanes a
    window in every mode, whatever the windows' number."""
    import contextlib

    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    @contextlib.contextmanager
    def forced():
        saved = ktp.STEP_MAX_K, ktp.STEP_MAX_LANES
        ktp.STEP_MAX_K, ktp.STEP_MAX_LANES = dict.fromkeys(ktp.MODES, k), 1 << 40
        try:
            yield
        finally:
            ktp.STEP_MAX_K, ktp.STEP_MAX_LANES = saved

    return forced()


def _graph_ms(run, dev, reps: int = 5) -> float:
    """The card's ms of one ``run`` captured as a CUDA graph (after one
    eager run), best of 3 timings of ``reps`` replays."""
    from ahocorasick_tpu_torch.bench import _seconds_per_rep

    run()
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return _seconds_per_rep(graph.replay, reps, dev) * 1e3


def captured_all_reduce_ms(words: torch.Tensor, group, reps: int = 50) -> float:
    """ms of one ``all_reduce(SUM)`` of ``words`` (viewed as int32) over
    ``group``, captured: ``reps`` of them in one CUDA graph, replayed."""
    import torch.distributed as dist

    x = words.view(torch.int32)
    return _graph_ms(lambda: [dist.all_reduce(x, group=group) for _ in range(reps)],
                     words.device, 3) / reps


def step_sweep(cells: dict, group, ks=STEP_KS) -> dict:
    """The step loop of ``step_cells`` at K = ``ks`` lanes a window (at most:
    ``step_segments`` with ``STEP_MAX_K`` forced), one rank holding the
    whole table, its reduction an NCCL ``all_reduce`` over ``group`` (a
    process group of one rank on this card): per cell and K the steps and
    lanes, the step's card time (``t = halo + 1``, queued), the captured
    all_reduce of the lanes' words, the model ``steps x (step +
    all_reduce)``, the prep's card time, the whole loop as ``group_scan``
    replays it from its CUDA graph (through the call, and the bare replay)
    and eagerly, and the results' and the prep's max_abs_err against
    ``table_sharded_scan`` and the prep's twin (all 0 or it raises)."""
    import torch.distributed as dist

    from ahocorasick_tpu_torch.bench import _seconds_per_rep
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    def reduce(bufs):
        dist.all_reduce(bufs[0].view(torch.int32), group=group)

    def widen(x):
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF if x.dim() else x.reshape(1)

    record = {}
    for label, (shard, w, halo, sb, mode) in cells.items():
        dev = w.device
        B, W = w.shape
        C = W - halo
        mesh = widen(ktp.table_sharded_scan(ktp.ShardedTable([shard]), w, halo, sb, mode))
        counting = mode in ("count", "count_packed")
        rows = {}
        for k in ks:
            with _forced_k(k):
                K, L = ktp.step_segments(B, C, halo, mode)
                classes = ktp.step_classes(w, halo, (K, L))
                err = int((classes.view(ktp._signed(w.dtype)).to(torch.int64)
                           - ktp.step_classes_plain(w, halo, (K, L))
                           .view(ktp._signed(w.dtype)).to(torch.int64)).abs().max())
                words = torch.zeros(B * K, dtype=torch.uint32, device=dev)
                out = (torch.zeros(B * K, dtype=torch.int64, device=dev) if counting
                       else torch.empty((1, B * C), dtype=torch.uint32, device=dev))
                total = torch.zeros(1, dtype=torch.int64, device=dev) if counting else None

                def step(t=halo + 1):
                    ktp.table_sharded_step(shard, 0, words, classes, t, halo, sb, mode, (K, L), C,
                                           out, total)

                step_ms = _card_ms(step, 50, dev)
                ar_ms = captured_all_reduce_ms(words, group)
                prep_ms = _card_ms(lambda: ktp.step_classes(w, halo, (K, L), classes), 20, dev)
                del words, out, total, classes
                graphs = ktp.StepGraphs()

                def loop():
                    return ktp.group_scan([(0, shard)], w, halo, sb, mode, reduce, graphs)

                results = [loop()[0], loop()[0]]  # eager and captured, then a replay
                results.append(ktp.group_scan([(0, shard)], w, halo, sb, mode, reduce)[0])
                for got in results:
                    err = max(err, int((widen(got) - mesh).abs().max()))
                if err:
                    raise AssertionError(f"step sweep {label}, K={K}: the loop or the prep "
                                         f"differs from table_sharded_scan or the twin ({err})")
                graph_ms = _seconds_per_rep(loop, 5, dev) * 1e3
                (graph, *_), = graphs._graphs.values()
                replay_ms = _seconds_per_rep(graph.replay, 5, dev) * 1e3
                eager_ms = _seconds_per_rep(
                    lambda: ktp.group_scan([(0, shard)], w, halo, sb, mode, reduce), 2, dev) * 1e3
                del graphs, graph, results
                rows[f"K={K}"] = {
                    "K": K, "L": L, "steps": halo + L, "lanes": B * K, "step_ms": step_ms,
                    "all_reduce_ms": ar_ms, "model_ms": (halo + L) * (step_ms + ar_ms),
                    "prep_ms": prep_ms, "graph_ms": graph_ms, "replay_ms": replay_ms,
                    "eager_ms": eager_ms, "max_abs_err": err}
        record[label] = rows
    return {"step_sweep": record}


def _other_step(lib, shard, w, halo, sb, mode, segments, bufs):
    """The parent's step loop (``table_sharded_step`` reading the windows,
    its lanes ``lane_segments``'), one rank, no reduction."""
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    B, W = w.shape
    K, L = segments
    words, out, total = bufs

    def run():
        stream = torch.cuda.current_stream(w.device).cuda_stream  # the capture's, in a capture
        words.view(torch.int32).zero_()
        if total is not None:
            out.zero_()
            total.zero_()
        for t in range(halo + L + 1):
            rc = lib.table_sharded_step(shard.data_ptr(), shard.shape[0], shard.shape[1], 0,
                                        w.data_ptr(), ktp._WINDOW_BYTES[w.dtype], B, W, halo, sb,
                                        ktp.MODES.index(mode), K, L, t, words.data_ptr(),
                                        out.data_ptr(), 0 if total is None else total.data_ptr(),
                                        w.device.index or 0, stream)
            if rc != 0:
                raise RuntimeError(f"the parent's table_sharded_step failed: CUDA error {rc}")
    return run


def step_against(other_root: str, cells: dict) -> dict:
    """The step loop of this checkout (the class-major prep, then the steps
    at ``step_segments``' lanes) against ``other_root``'s (its
    ``table_sharded_step`` reading the windows at ``lane_segments``' lanes),
    one rank, no reduction, on ``step_cells``: the results equal bit for
    bit, then each loop's card time captured as a CUDA graph, other, this,
    this, other; and one step's card time each (``t = halo + 1``, queued),
    this design also at the parent's K."""
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    lib = _other_library(other_root, ("table_sharded_step",))
    record = {}
    for label, (shard, w, halo, sb, mode) in cells.items():
        dev = w.device
        B, W = w.shape
        C = W - halo
        counting = mode in ("count", "count_packed")
        segs = {"other": ktp.lane_segments(B, C, halo, mode),
                "this": ktp.step_segments(B, C, halo, mode)}

        def bufs(K):
            return (torch.zeros(B * K, dtype=torch.uint32, device=dev),
                    torch.zeros(B * K, dtype=torch.int64, device=dev) if counting
                    else torch.empty((1, B * C), dtype=torch.uint32, device=dev),
                    torch.zeros(1, dtype=torch.int64, device=dev) if counting else None)

        runs, outs = {}, {}
        for tree in ("other", "this"):
            K, L = segs[tree]
            b = bufs(K)
            outs[tree] = b
            if tree == "other":
                runs[tree] = _other_step(lib, shard, w, halo, sb, mode, (K, L), b)
            else:
                classes, loop_bufs = ktp._loop_buffers([(0, shard)], w, halo, sb, mode, (K, L))
                outs[tree] = loop_bufs[0][2:]
                runs[tree] = (lambda c=classes, lb=loop_bufs, s=(K, L):
                              ktp._loop(lb, w, c, halo, sb, mode, s, lambda words: None))
            runs[tree]()
        got = [o[2] if counting else o[1].view(torch.int32) for o in (outs["other"],
                                                                      outs["this"])]
        if not torch.equal(*got):
            raise AssertionError(f"step against {label}: the two checkouts' loops differ")
        ms = {"other": [], "this": []}
        for tree in ("other", "this", "this", "other"):
            ms[tree].append(_graph_ms(runs[tree], dev, 3))
        step_ms = {}
        for name, (K, L) in (("other", segs["other"]), ("this", segs["this"]),
                             ("this at the other's K", segs["other"])):
            words, out, total = bufs(K)
            if name == "other":
                def step(words=words, out=out, total=total, K=K, L=L):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    lib.table_sharded_step(shard.data_ptr(), shard.shape[0], shard.shape[1], 0,
                                           w.data_ptr(), ktp._WINDOW_BYTES[w.dtype], B, W, halo,
                                           sb, ktp.MODES.index(mode), K, L, halo + 1,
                                           words.data_ptr(), out.data_ptr(),
                                           0 if total is None else total.data_ptr(),
                                           dev.index or 0, stream)
            else:
                classes = ktp.step_classes(w, halo, (K, L))

                def step(words=words, out=out, total=total, K=K, L=L, classes=classes):
                    ktp.table_sharded_step(shard, 0, words, classes, halo + 1, halo, sb, mode,
                                           (K, L), C, out, total)
            step_ms[name] = {"K": K, "L": L, "step_ms": _card_ms(step, 50, dev)}
        record[label] = {"other_K": segs["other"][0], "this_K": segs["this"][0],
                         "other_ms": ms["other"], "this_ms": ms["this"],
                         "this_over_other": min(ms["this"]) / min(ms["other"]),
                         "steps": step_ms}
    return {"step_against": record}


CARD_THREADS = 132 * 2048  # threads the H100 holds at once
LATENCY_CHAINS = 32  # chains of the step-latency runs: one warp's worth


def _card_ms(run, reps: int, dev) -> float:
    """The card's ms a call: best of 3 timings of ``reps`` calls queued
    behind a sleep (``probes.probe_wwl_fused``'s timer), after a warm-up."""
    from ahocorasick_tpu_torch.probes.probe_wwl_fused import _time_calls

    run()
    return min(_time_calls(run, reps, dev, True) for _ in range(3))


def row_cells(dev, seed: int = 0, sizes=None) -> dict:
    """The row read's A/B cells: ``{label: (tab, s0, reps, mod)}``, the
    residency sweep's chain shape (65,536 chains x 524 steps) on the sweep's
    row table at the 10k dictionary's size (57,546 rows of 28 words: a
    stride-2 row) and on ``probe.py:160``'s 4,096 x 128 table; or, given
    ``sizes`` (entries), on the sweep's row table of each size (rows of 28
    words).  Each table is zero but for one random cycle through its rows in
    column 0, as the sweep's, so that no chain settles in a cache."""
    from ahocorasick_tpu_torch.probes import __main__ as probes_main

    gen = torch.Generator(device=dev).manual_seed(seed)
    words = probes_main.ROW_WORDS
    shapes = ([(max(n // words, 1), words) for n in sizes] if sizes is not None
              else [(probes_main.SWEEP_SIZES[3] // words, words), (4096, 128)])
    cells = {}
    for rows, width in shapes:
        tab = torch.zeros((rows, width), dtype=torch.int32, device=dev)
        tab[:, 0] = probes_main.cycle_table(rows, dev, gen)
        s0 = torch.randint(0, rows, (probes_main.SWEEP_CHAINS,), generator=gen, device=dev,
                           dtype=torch.int32)
        cells[f"{rows} x {width}"] = (tab, s0, probes_main.SWEEP_STEPS, rows)
    return cells


def row_ab(cells: dict, lib, every_group: bool = True) -> dict:
    """The row read's A/B (``csrc/probes.cu`` ``row_chain``, max form): its
    first design (``row_chain_first`` here, a warp a chain) and the package's
    kernel at each group size of ``kernels.probes.ROW_GROUPS``, each launch
    held bit for bit against the first design, timed in turns (the card's
    time, queued); and each one's step latency on an otherwise idle card:
    the same kernel on the first ``LATENCY_CHAINS`` chains, (time at 2 reps -
    time at reps) / reps, so that the launch cancels.  The latency floor of a
    call is reps x that latency x the waves its chains need, ceil(n G /
    ``CARD_THREADS``) (n for the first design's warps: ceil(32 n / ...)).
    ``cells``: ``row_cells``; ``every_group`` False: the first design and the
    rule's group only.  Returns ``{"row_ms", "row_step_us",
    "row_floor_ms", "row_rule"}``, each by cell label."""
    from ahocorasick_tpu_torch.kernels import probes as kp

    times, steps, floors, rule = {}, {}, {}, {}
    for label, (tab, s0, reps, mod) in cells.items():
        dev = s0.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows, width = tab.shape
        out = torch.empty_like(s0)

        def launcher(group, chains, r, out=out):
            if group is None:
                def run():
                    _checked(lib.row_chain_first(tab.data_ptr(), rows, width, s0.data_ptr(),
                                                 chains, r, 0, mod, out.data_ptr(),
                                                 dev.index or 0, stream), "row_chain_first")
            else:
                def run():
                    build.call("row_chain", tab.data_ptr(), rows, width, s0.data_ptr(), chains,
                               r, 0, mod, group, out.data_ptr(), dev.index or 0, stream)
            return run

        groups = kp.ROW_GROUPS if every_group else (kp.row_group(width),)
        arms = {"first": None, **{f"G={g}": g for g in groups}}
        launcher(None, s0.numel(), reps)()
        want = out.clone()
        for name, group in arms.items():
            out.fill_(-1)
            launcher(group, s0.numel(), reps)()
            if not torch.equal(out, want):
                raise AssertionError(f"row_chain {label} {name}: differs from the first design")
        ms = {}
        for name in [*arms, *reversed(arms)]:
            t = _card_ms(launcher(arms[name], s0.numel(), reps), 3, dev)
            ms[name] = min(ms.get(name, t), t)
        times[label], steps[label], floors[label] = ms, {}, {}
        for name, group in arms.items():
            t1 = _card_ms(launcher(group, LATENCY_CHAINS, reps), 3, dev)
            t2 = _card_ms(launcher(group, LATENCY_CHAINS, 2 * reps), 3, dev)
            step_ms = (t2 - t1) / reps
            lanes = 32 if group is None else group
            steps[label][name] = step_ms * 1e3
            floors[label][name] = reps * step_ms * -(-s0.numel() * lanes // CARD_THREADS)
        rule[label] = kp.row_group(width)
    return {"row_ms": times, "row_step_us": steps, "row_floor_ms": floors, "row_rule": rule}


def random_sigma(C: int, S: int, dev, seed: int = 0) -> torch.Tensor:
    """int32[C, S] of seeded uniform states: no map is constant, so every
    guess of the fold is wrong."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, S, (C, S), dtype=np.int32)).to(dev)


def fold_cells(dev) -> dict:
    """The fold's A/B cells: the demo dictionary's sigma at C = 4,096 chunks
    of 32 Mi units of its word soup, the 10k dictionary's at C = 8 chunks of
    32 Ki units (the sharded arrival path's shape, S = 65,536 padded states)
    and ``random_sigma`` at 4,096 x 1,024, each map made with the
    synchronized ``state_maps`` where the table is a goto closure."""
    from ahocorasick_tpu_torch.bench.__main__ import word_soup
    from ahocorasick_tpu_torch.bench.headline import (
        BASE_UNITS, N_KEYWORDS, SEED, TEXT_UNITS, make_dictionary, make_text_classes)
    from ahocorasick_tpu_torch.graft_entry import _KEYWORDS as DEMO_KEYWORDS
    from ahocorasick_tpu_torch.kernels import stitch as kstitch
    from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet

    demo = AhoCorasickSet(DEMO_KEYWORDS, engine="device", device=dev)
    demo_cls = np.tile(demo._classes(word_soup(np.random.default_rng(SEED + 10), DEMO_KEYWORDS,
                                               BASE_UNITS)), TEXT_UNITS // BASE_UNITS)
    rng = np.random.default_rng(SEED)
    keywords = make_dictionary(rng, N_KEYWORDS)
    m = AhoCorasickSet(keywords, engine="device", device=dev)
    ten = make_text_classes(m, keywords, rng, BASE_UNITS)[: 8 << 15]
    return {
        "demo C=4096": kstitch.state_maps(demo.dev.dfa_next,
                                          _int32_classes(demo_cls, dev).reshape(4096, -1),
                                          max(demo.compiled.max_depth, 1)),
        "10k C=8": kstitch.state_maps(m.dev.seq_tables[0], _int32_classes(ten, dev).reshape(8, -1),
                                      max(m.compiled.max_depth, 1)),
        "random 4096 x 1024": random_sigma(4096, 1024, dev)}


FOLD_LANES_AB = (32, 128, 256, 512, 1024)  # the fold's lanes at most, in its A/B


def fold_ab(cells: dict, lib) -> dict:
    """The fold's A/B (``csrc/stitch.cu`` ``entry_fold``): its first design
    (``entry_fold_first`` here, one thread) and the package's kernel, with
    and without its repair lengths and at each lane count of
    ``FOLD_LANES_AB``, each launch held bit for bit against the
    first design, the card's time (queued) taken in turns; with each cell's
    lanes, the lanes repaired and the longest repair.  The latency floor: a
    launch (the kernel on one chunk) plus a sigma load's latency x
    (``per`` + the longest repair), the latency from the first design's
    chain, (its time - a launch) / (C - 1).  ``cells``: ``{label: sigma}``
    on the card.  Returns ``{"fold_ms", "fold_repairs", "fold_floor_ms"}``."""
    from ahocorasick_tpu_torch.kernels import stitch as kstitch

    times, stats, floors = {}, {}, {}
    for label, sigma in cells.items():
        dev = sigma.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        C, S = sigma.shape
        per, lanes = kstitch.fold_shape(C)
        entry = torch.empty(C, dtype=torch.int32, device=dev)
        repair = torch.empty(lanes, dtype=torch.int32, device=dev)

        def first(c=C):
            _checked(lib.entry_fold_first(sigma.data_ptr(), c, S, 0, entry.data_ptr(),
                                          dev.index or 0, stream), "entry_fold_first")

        def spec(with_repair=False, c=C, lanes=None):
            build.call("entry_fold", sigma.data_ptr(), c, S, 0, lanes or kstitch.FOLD_LANES,
                       entry.data_ptr(), repair.data_ptr() if with_repair else None,
                       dev.index or 0, stream)

        first()
        want = entry.clone()
        runs = {"first": first, "spec": spec, "spec + repair": lambda: spec(True),
                **{f"P={p}": lambda p=p: spec(lanes=p) for p in FOLD_LANES_AB}}
        for name, run in runs.items():
            entry.fill_(-1)
            run()
            if not torch.equal(entry, want):
                raise AssertionError(f"entry_fold {label} {name}: differs from the first design")
        r64 = repair.to(torch.int64)
        stats[label] = {"C": C, "S": S, "per": per, "lanes": lanes,
                        "repaired": int((r64 > 0).sum()), "repair_max": int(r64.max()),
                        "repair_sum": int(r64.sum())}
        ms = {}
        for name in [*runs, *reversed(runs)]:
            t = _card_ms(runs[name], 20, dev)
            ms[name] = min(ms.get(name, t), t)
        times[label] = ms
        launch = _card_ms(lambda: spec(c=1), 20, dev)
        load = (ms["first"] - _card_ms(lambda: first(c=1), 20, dev)) / max(C - 1, 1)
        floors[label] = {"launch_ms": launch, "sigma_load_ns": load * 1e6,
                         "floor_ms": launch + load * (per + stats[label]["repair_max"])}
    return {"fold_ms": times, "fold_repairs": stats, "fold_floor_ms": floors}


CHAIN_CURVE = (1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17)  # chains in flight, arm (b)
CHAIN_ARMS = {  # name: (chains a thread, __ldcg, L1 carve-out at its largest, even spread)
    "ldg": (1, 0, 0, 0),
    "ldcg": (1, 1, 0, 0),
    "ldg, L1 carve-out max": (1, 0, 1, 0),
    "2 chains a thread": (2, 0, 0, 0),
    "4 chains a thread": (4, 0, 0, 0),
    "even spread": (1, 0, 0, 1),
}


def independent_sums(tab: torch.Tensor, n: int, reps: int) -> torch.Tensor:
    """What ``chain_independent`` (arm (a)) returns, in torch: for each of n
    chains the sum modulo 2**32 of ``tab[mix(chain, step) * T >> 32]`` over
    ``reps`` steps, ``mix`` the arm's 32-bit hash; int64[n]."""
    M = 0xFFFFFFFF
    T = tab.numel()
    t = tab.to(torch.int64) & M
    c = torch.arange(n, dtype=torch.int64, device=tab.device)
    total = torch.zeros(n, dtype=torch.int64, device=tab.device)
    for r in range(reps):
        h = (c * 0x9E3779B1 + r * 0x85EBCA77) & M
        h ^= h >> 15
        h = (h * 0x2C1B3C6D) & M
        h ^= h >> 12
        total += t[(h * T) >> 32]
    return total & M


def chain_cell(dev, n: int = None, chains: int = None) -> tuple:
    """The lookup chain's timed cell: ``(tab, starts, reps)``, the residency
    sweep's cycle table of n entries (the 10k dictionary's size, 1,611,296,
    by default) and ``chains`` random starts (``max(CHAIN_CURVE)`` by
    default, of which the first 65,536 are the sweep's chains), 524 steps."""
    from ahocorasick_tpu_torch.probes import __main__ as probes_main

    gen = torch.Generator(device=dev).manual_seed(probes_main.SEED)
    n = probes_main.SWEEP_SIZES[3] if n is None else n
    tab = probes_main.cycle_table(n, dev, gen)
    starts = torch.randint(0, n, (chains or max(CHAIN_CURVE),), generator=gen, device=dev,
                           dtype=torch.int32)
    return tab, starts, probes_main.SWEEP_STEPS


def chain_ab(cell: tuple, lib) -> dict:
    """The lookup chain's measurement arms in global memory (the load op of
    ``csrc/probes.cu`` ``chain_gather``), each launch that computes the chain
    held bit for bit against the package's kernel and arm (a) against
    ``independent_sums``, the card's time (queued) taken in turns: (a)
    ``chain_independent``, the same loads at addresses that do not depend on
    the loaded values, whose rate is the card's random-request ceiling for
    this table; (b) the package's kernel at each chain count of
    ``CHAIN_CURVE``;
    (c)-(e) ``chain_arm`` in each form of ``CHAIN_ARMS``.  ``cell``:
    ``chain_cell``.  An arm beats the package's kernel where its time is
    below the kernel's by more than the spread between repeats of one design
    (the kernel's two turns and the two of the ``"ldg"`` arm, the same
    code).
    The throughput floor of the chain is its lookups over arm (a)'s rate,
    that is arm (a)'s time.  Returns ``{"chain_ms", "chain_spread_ms",
    "chain_beats", "chain_curve", "chain_rate", "independent_rate",
    "throughput_floor_ms"}`` (rates in lookups/s)."""
    tab, starts, reps = cell
    dev = tab.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    T = tab.numel()
    chains = 1 << 16  # the sweep's
    idx = starts[:chains]
    out = torch.empty(chains, dtype=torch.int32, device=dev)

    def kernel(n=chains, o=out):
        build.call("chain_gather", tab.data_ptr(), T, starts.data_ptr(), n, reps, 2, 2, 0, 0,
                   o.data_ptr(), dev.index or 0, stream)

    def arm(form):
        def run():
            _checked(lib.chain_arm(*form, tab.data_ptr(), T, idx.data_ptr(), chains, reps,
                                   out.data_ptr(), dev.index or 0, stream), "chain_arm")
        return run

    def independent():
        _checked(lib.chain_independent(tab.data_ptr(), T, chains, reps, out.data_ptr(),
                                       dev.index or 0, stream), "chain_independent")

    kernel()
    want = out.clone()
    runs = {"kernel": kernel, **{name: arm(form) for name, form in CHAIN_ARMS.items()}}
    for name, run in runs.items():
        out.fill_(-1)
        run()
        if not torch.equal(out, want):
            raise AssertionError(f"chain_arm {name}: differs from the package's chain_gather")
    independent()
    if not torch.equal(out.to(torch.int64) & 0xFFFFFFFF, independent_sums(tab, chains, reps)):
        raise AssertionError("chain_independent: its sums differ from independent_sums")
    runs["(a) independent"] = independent
    ms = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        ms[name].append(_card_ms(runs[name], 3, dev))
    # the spread between repeats of one design: the kernel's turns and those
    # of the "ldg" arm, the same code built here
    same = ms["kernel"] + ms["ldg"]
    spread = max(same) - min(same)
    beats = [name for name in CHAIN_ARMS
             if name != "ldg" and min(same) - min(ms[name]) > spread]
    lookups = chains * reps
    curve_ms = {}
    for n in CHAIN_CURVE:
        o = torch.empty(n, dtype=torch.int32, device=dev)
        t = _card_ms(lambda n=n, o=o: kernel(n, o), 3, dev)
        curve_ms[n] = {"ms": t, "rate": n * reps / (t * 1e-3)}
    floor = min(ms["(a) independent"])
    return {"chain_ms": ms, "chain_spread_ms": spread, "chain_beats": beats,
            "chain_curve": curve_ms, "chain_rate": lookups / (min(ms["kernel"]) * 1e-3),
            "independent_rate": lookups / (floor * 1e-3), "throughput_floor_ms": floor}


def onehot_cell(dev) -> tuple:
    """The one-hot product's timed cell, probe.py's P4: ``(tab_h, idx,
    reps)``, ``tab_h`` = ``onehot_table`` of a seeded float32[2048, 128] of
    integers below 2,048, 1,024 rows, 128 steps."""
    from ahocorasick_tpu_torch.kernels import probes as kp

    rs = np.random.RandomState(0)
    tab = torch.from_numpy(rs.randint(0, 2048, (2048, 128)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rs.randint(0, 2048, (1024, 128), np.int32)).to(dev)
    return kp.onehot_table(tab), idx, 128


def _planned_v1(root: str) -> bool:
    """Whether the checkout at ``root`` has the redesigned v1 walk (its
    ``pfac1_planes`` takes the launch plan); before it, the first design's
    arguments."""
    return os.path.exists(os.path.join(root, "ahocorasick_tpu_torch", "csrc", "pfac1_walk.cuh"))


def _warp_rows(root: str) -> bool:
    """Whether the checkout at ``root`` has the warp-row 2-D gather (its
    ``gather2d`` takes rows and the launch shape); before it, 8-row tiles."""
    return os.path.exists(os.path.join(root, "ahocorasick_tpu_torch", "csrc", "gather2d.cuh"))


# The first designs' argument types, for a parent checkout that has them.
_FIRST_ARGS = {
    # (trie, stride, is_match, dead, cls, cls_bytes, n, depth, num_planes, out,
    #  device, stream)
    "pfac1_planes": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    # (tab, idx, tiles, reps, mask, mode, sum_out, out, device, stream)
    "gather2d": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
}


def pfac1_launcher(lib, planned: bool, cell: tuple, out):
    """A launch of ``lib``'s v1 walk on ``cell`` (``(trie, is_match, cls,
    depth)``) into ``out``: with ``planned`` at the package's
    ``kernels.scan_pfac.pfac1_plan``, else in the first design's
    arguments."""
    from ahocorasick_tpu_torch.kernels import scan_pfac as kpf

    trie, is_match, cls, depth = cell
    n, P = cls.numel() - depth, out.shape[0]
    dev = cls.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (trie.data_ptr(), trie.shape[1])
    tail = (is_match.data_ptr(), trie.shape[0] - 1, cls.data_ptr(), cls.element_size(), n, depth,
            P)
    if not planned:
        fn = getattr(lib, "pfac1_planes")
        fn.argtypes = _FIRST_ARGS["pfac1_planes"]
        return lambda: _checked(fn(*head, *tail, out.data_ptr(), dev.index or 0, stream),
                                "pfac1_planes")
    plan = kpf.pfac1_plan(n, trie.shape[1], kpf.sm_count(dev))
    fn = getattr(lib, "pfac1_planes")
    fn.argtypes = build.ARGTYPES["pfac1_planes"]
    args = (*head, trie.shape[0], *tail, plan.grid, int(plan.two_level), out.data_ptr(),
            dev.index or 0, stream)
    return lambda: _checked(fn(*args), "pfac1_planes")


G2_REPS = 1024  # probe3.py:142's and probe2.py:86's steps


def g2_cells(dev, seed: int = 0) -> dict:
    """The 2-D gather's timed shapes, one a mode, as chip_smoke's
    ``check_probe_kernels`` runs them: ``{label: (tab, idx, reps, mode,
    mask, sum_out)}``, seeded."""
    rs = np.random.RandomState(seed)

    def words(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32)).to(dev)

    t100, i8 = words(rs.randint(0, 100, (8, 128))), words(rs.randint(0, 8, (8, 128)))
    wide, i_wide = words(rs.randint(0, 1 << 32, (8, 128), np.int64)), words(
        rs.randint(0, 51200, (8, 128)))
    t1k, i1k = words(rs.randint(0, 1024, (8, 128))), words(rs.randint(0, 1024, (512, 128)))
    return {"sublane B=8": (t100, i8, 1, "sublane", 0, False),
            "sublane_chain B=8 reps=64": (wide, i_wide, 64, "sublane_chain", 0, False),
            f"gather2d_first B=512 reps={G2_REPS}": (t1k, i1k, G2_REPS, "gather2d_first", 1023,
                                                    False),
            f"gather2d_all B=512 reps={G2_REPS}, summed": (t1k, i1k, G2_REPS, "gather2d_all",
                                                           1023, True)}


def gather2d_launcher(lib, warp_rows: bool, cell: tuple, out):
    """A launch of ``lib``'s 2-D gather on ``cell`` (``g2_cells``) into
    ``out`` (zeroed first where it is a sum): with ``warp_rows`` at
    ``kernels.probes.gather2d_shape``, else in the first design's arguments
    (8-row tiles)."""
    from ahocorasick_tpu_torch.kernels import probes as kp

    tab, idx, reps, mode, mask, summed = cell
    rows = idx.shape[0]
    dev = idx.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (tab.data_ptr(), idx.data_ptr())
    tail = (reps, mask, kp.G2_MODES.index(mode), int(summed))
    fn = getattr(lib, "gather2d")
    if warp_rows:
        fn.argtypes = build.ARGTYPES["gather2d"]
        args = (*head, rows, *tail, *kp.gather2d_shape(rows, mode), out.data_ptr(),
                dev.index or 0, stream)
    else:
        fn.argtypes = _FIRST_ARGS["gather2d"]
        args = (*head, rows // 8, *tail, out.data_ptr(), dev.index or 0, stream)

    def run():
        if summed:
            out.zero_()
        _checked(fn(*args), "gather2d")
    return run


def against_probes(other_root: str, dev) -> dict:
    """The probes' lookup chain (``chain_gather``, the load op, at every
    residency-sweep size in every placement its table fits: 65,536 chains x
    524 steps on the sweep's cycle tables), the one-hot product
    (``onehot_mma`` at ``onehot_cell``) and the 2-D gather (``gather2d`` in
    every mode at its timed shape, ``g2_cells``) of this checkout and of
    ``other_root``'s ``csrc/``, each pair's outputs equal bit for bit, then
    the card's time (queued) other, this, this, other: ``{label: {"other_ms",
    "this_ms", "this_over_other"}}``."""
    from ahocorasick_tpu_torch.kernels import probes as kp
    from ahocorasick_tpu_torch.probes import __main__ as probes_main

    libs = {"other": _other_library(other_root, ("chain_gather", "onehot_mma")),
            "this": build.library()}
    rows_form = {"other": _warp_rows(other_root), "this": True}
    stream = torch.cuda.current_stream(dev).cuda_stream
    record = {}

    def compare(label, outs, runs, reps):
        for tree in libs:
            outs[tree].fill_(-1)
            runs[tree]()
        if not torch.equal(outs["other"], outs["this"]):
            raise AssertionError(f"{label}: the two checkouts' kernels differ")
        ms = {"other": [], "this": []}
        for tree in ("other", "this", "this", "other"):
            ms[tree].append(_card_ms(runs[tree], reps, dev))
        record[label] = {"other_ms": ms["other"], "this_ms": ms["this"],
                         "this_over_other": min(ms["this"]) / min(ms["other"])}

    for n in probes_main.SWEEP_SIZES:
        tab, start, steps = chain_cell(dev, n, probes_main.SWEEP_CHAINS)
        for p in kp.PLACEMENTS:
            if (p == "shfl" and n > 128) or (p == "shared" and 4 * n > kp.SHARED_BYTES):
                continue
            outs = {tree: torch.empty_like(start) for tree in libs}
            runs = {tree: (lambda lib=lib, o=outs[tree], p=p: _checked(lib.chain_gather(
                tab.data_ptr(), n, start.data_ptr(), start.numel(), steps, 2,
                kp.PLACEMENTS.index(p), 0, 0, o.data_ptr(), dev.index or 0, stream),
                "chain_gather")) for tree, lib in libs.items()}
            compare(f"chain_gather {n} {p}", outs, runs, 3)
        del tab
    tab_h, idx, reps = onehot_cell(dev)
    outs = {tree: torch.empty_like(idx) for tree in libs}
    runs = {tree: (lambda lib=lib, o=outs[tree]: _checked(lib.onehot_mma(
        tab_h.data_ptr(), tab_h.shape[1], tab_h.shape[0], idx.data_ptr(), idx.shape[0], reps,
        o.data_ptr(), dev.index or 0, stream), "onehot_mma")) for tree, lib in libs.items()}
    compare("onehot_mma T=2048 B=1024 ncols=128 reps=128", outs, runs, 5)
    for label, cell in g2_cells(dev).items():
        idx, summed = cell[1], cell[5]
        outs = {tree: torch.zeros(1 if summed else idx.shape, dtype=torch.int32, device=dev)
                for tree in libs}
        runs = {tree: gather2d_launcher(lib, rows_form[tree], cell, outs[tree])
                for tree, lib in libs.items()}
        compare(f"gather2d {label}", outs, runs, 5)
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
    parser.add_argument("--rows", action="store_true",
                        help="only the probes' row read's and the stitch's fold's A/Bs "
                             "(row_ab, fold_ab)")
    parser.add_argument("--probes", action="store_true",
                        help="only the probes' lookup chain arms (chain_ab); with --against, "
                             "only the probes' chain_gather, onehot_mma and gather2d against "
                             "the other checkout's (against_probes)")
    parser.add_argument("--step", action="store_true",
                        help="only the group form's step loop: its K sweep (step_sweep) under "
                             "an NCCL process group of one rank; with --against, also the "
                             "loop against the other checkout's (step_against)")
    parser.add_argument("--wwl", action="store_true",
                        help="only the whole-word-longest walks' A/Bs (wwl_fused_ab, "
                             "wwl_walk_ab) at baseline-4 and the 10k cell")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lib = None if opts.against or opts.step else library()
    if opts.probes:
        record = (against_probes(opts.against, dev) if opts.against else
                  chain_ab(chain_cell(dev), lib))
        print(json.dumps({"card": smi, "against": opts.against, **record}))
        return
    if opts.wwl:
        print(json.dumps({"card": smi, **wwl_ab(dev, lib)}))
        return
    if opts.rows:
        print(json.dumps({"card": smi, **row_ab(row_cells(dev), lib),
                          **fold_ab(fold_cells(dev), lib)}))
        return
    rng = np.random.default_rng(SEED)
    keywords = make_dictionary(rng, N_KEYWORDS)
    m = AhoCorasickSet(keywords, engine="device", device=dev)
    pd = m.dev.packed_dfa
    base = make_text_classes(m, keywords, rng, BASE_UNITS)
    if opts.pfac:
        print(json.dumps({"card": smi, **pfac_ab(ten_k_pfac_cell(m, base, dev)[0], lib)}))
        return
    if opts.step:
        print(json.dumps({"card": smi, "against": opts.against,
                          **step_main(m, base, opts.against, dev)}))
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
        record.update(against_probes(opts.against, dev))
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


def step_main(m, base, other_root, dev) -> dict:
    """``--step``: ``step_cells`` on the 10k matcher ``m`` (``base`` tiled to
    32 Mi units) and the 1M dictionary over BASELINE config #5's word soup,
    then ``step_sweep`` under an NCCL process group of one rank made here,
    and ``step_against`` where ``other_root`` is given."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from ahocorasick_tpu_torch.bench.__main__ import word_soup
    from ahocorasick_tpu_torch.bench.headline import BASE_UNITS, CHUNK, SEED, TEXT_UNITS
    from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet
    from ahocorasick_tpu_torch.ops import scan_batched

    A = m.compiled.num_classes
    pd = scan_batched.build_packed(m.compiled)
    w = scan_batched.classes_to_device(
        scan_batched.chunk_classes(np.tile(base, TEXT_UNITS // BASE_UNITS), CHUNK, pd.halo, A),
        A, dev)
    kws1m, _, _ = one_m_keywords()
    m1 = AhoCorasickSet(kws1m, engine="device", device=dev)
    flat, sb1, halo1 = scan_batched.build_count_packed(m1.compiled)
    A1 = m1.compiled.num_classes
    cls1 = np.tile(m1._classes(word_soup(np.random.default_rng(SEED + 6), kws1m, BASE_UNITS)),
                   TEXT_UNITS // BASE_UNITS)
    w1 = scan_batched.classes_to_device(scan_batched.chunk_classes(cls1, CHUNK, halo1, A1), A1,
                                        dev)
    cells = step_cells(pd.table, w, pd.halo, pd.state_bits,
                       flat.reshape(m1.compiled.num_states, A1), w1, halo1, sb1)
    torch.cuda.set_device(dev if dev.index is not None else 0)
    store = tempfile.mkdtemp(prefix="scan_variants_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        record = step_sweep(cells, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    if other_root:
        record.update(step_against(other_root, cells))
    return record


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
