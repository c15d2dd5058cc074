#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths on the device engine at ``bench.py``'s
configuration, 10,000 seeded keywords over 32 Mi UTF-16 units (64 MiB) of
word-soup text: ``AhoCorasickSet.count`` / ``.match``, the resolved kinds
``LongestMatchSet``, ``WholeWordMatchSet``, ``ShortestMatchSet`` and a map,
and ``WholeWordLongestMatchSet`` / ``Map`` on each of its routes; the
huge-dictionary layouts (count-packed count, hotstate plane, split scans)
at the 1M-keyword scale of ``tests/test_full_random_1m.py`` (995,169 seeded
keywords, 4,356,756 states: 23 state bits + depth 12 do not pack inline)
and on deep dictionaries; and the stream cursors (``stream().feed``,
``match_stream``, ``match_readable``) and the chunked early-stop listener
scan at the same sizes; and the data-parallel ``ShardedScanner`` /
``ShardedStream`` on eight shards of the one card, with the sigma stitch; and
the table-sharded ``TableShardedScanner`` with the table's rows in eight
separate allocations on the one card (1-axis and 2-axis meshes, its stream,
``sharded_table_count``, the 1M dictionary's 470 MB table), then
``parallel.corpus.scan_corpus``; and the benchmark entry points of
``ahocorasick_tpu_torch.bench`` (the BASELINE.json suite, the headline, the
scaling record, a profiled run) with the stride-2 row scan; and the lookup
probes (``python -m ahocorasick_tpu_torch.probes``: the four probe kernels and
the residency sweep) and the PFAC cross-check walk
(``device_engine="pfac2"``).  It imports the
port only, the dictionary and text generators included (``bench.headline``,
``bench.__main__``).  Phases, each raising on failure:

1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and power
   limit;
2. build the CUDA kernels from ``ahocorasick_tpu_torch/csrc`` with nvcc, and
   the port's native host library from ``ahocorasick_tpu_torch/native/src``
   with g++, and in a thread beside them the designs of
   ``bench/scan_variants.cu`` (a failed build raises: nothing carries on in
   numpy);
3. every kernel against its plain PyTorch twin on the card, bit for bit, on
   seeded dictionaries and shapes: the scans up to the main path's
   65,536 x 524 windows, the compaction on every planes tensor they make and
   on synthetic ones; the one-pass compaction, the segmented planes scan
   and count, the segmented hotstate plane and count-packed count and the
   segmented split planes at their edge shapes (no hot position, the hot
   count at ``limit`` and one past it, no limit, P = 1, 2, 3 and 5 with N
   past a tile, more than 16 Ki tiles twice in a row; C < 128, C not a
   multiple of the lanes per window or of 4, halo 0, one window, uint16
   windows, a keyword of length halo across every segment boundary,
   ``a``..``a * 12``, K = 1, 2 and 4 lanes per window for the counts, the
   hotstate plane and the split planes, the latter three on depth-39 and
   depth-30 uint16 dictionaries, the split planes also at P = 4, 13 and 14
   on ``a``..``a * 100`` / ``* 400`` / ``* 420``, ragged K > 1 segments; the
   split count at K = 1, 2 and 4 on each of those and on every dictionary of
   the huge-dictionary phase, 13 and 14 planes and uint16 windows included;
   the stride-2 count and planes at K = 1, 2 and 4 on ragged uint8 and uint16
   windows);
   the fused whole-word-longest scan and the
   segmented WWL scan plane at theirs (walk depths 4, 12 and 32, > 256
   classes, separators as keywords, crossing bits, row and flat layouts,
   narrow and int32 windows, texts of 0, 3, 511, 4097 and 40,000 units,
   starts negative, duplicated, at and past L; the plane at chunks that
   split windows into 2 or 4 lanes, halo 0, quotient entry planes; the fused
   scan refusing a quotient table); the shortest restart scan on fuzz
   dictionaries and on the 10k dictionary over 64 Ki units; the
   whole-word-longest scan plane and die sweep, and the fused scan against
   its twin and the sweep's outcomes, on fuzz (row and flat layouts), the
   full-node quotient dictionary (uint16 classes; no fused scan), a
   separator-spanning dictionary (crossing bits) and the 10k dictionary
   over 32 Mi units, and the per-start walk on
   fuzz and on the 10k dictionary's chain lanes over 32 Mi units; the
   count-packed count, hotstate plane and split count and planes on a deep
   dictionary (P = 2), ``a``..``a * 100`` (split, P = 4, against gold as
   ``tests/test_split.py`` drives it), a deep dictionary of > 256 classes
   (uint16 windows, P = 1) and the 1M dictionary at 65,536 x 524 windows
   (count-packed and hotstate, and split on its split tables); the
   sequential scan from an entry state, speculate and repair (the form for
   tables that do not synchronize) and the lane scan
   of the goto closure (``sync_depth`` = d), on the 10k dictionary's dense
   table (1 unit to 32 Mi: around the lane boundaries, ragged, the timed
   shapes 1 Ki, 4 Ki, 64 Ki and 32 Mi, lanes of exactly d; entry state 0 and
   not 0), on RowTables (a fuzz dictionary kept row-compressed, and a
   55,040-class alphabet up to 32 Mi units), on the depth-39 dictionary
   dense and row-compressed (from its deepest state) and, speculate and
   repair only, on the 10k shortest restart table; speculate and repair
   and the shortest restart scan at their edges (``check_spec_edges``: K =
   1, 2, 7, d, d + 1, 64 and K >= N forced, N = 0, 1, K - 1, K, K + 1 and
   many chunks, entry states root, live and padding, dense and RowTable,
   uint8, uint16 and int32 classes, the periodic ``ab``/``ba`` text whose
   every second chunk repairs to its end); the stitch's forms for any table
   at their edges (``check_meet_edges``: the maps meeting a reference run
   and the rescan by speculate and repair by rows, meet positions and repair
   lengths included, on restart tables, goto closures passed no depth, sink
   padding rows and ``ab``/``ba`` over ``abab...``, K = 0, 1, 2, 6, 7, 8, 68
   and 300, C = 1, 3 and 64, entry states root, live and padding); the
   every-position sweep beside the sweep at
   starts on each of those whole-word-longest planes; the sigma maps, the
   entry fold and the rescan, each map and rescan in its form for any table
   (``state_maps_all``, ``rescan_serial``) and, on the goto closures, in its
   synchronized form (``state_maps``, ``rescan``: ``sync_depth`` = d, the two
   forms' maps equal), on the demo dictionary (1, 8 and 4,096 chunks, ragged
   lengths, entry state 0 and not 0), on the 10k dense table (64 chunks of 1
   Ki units), at the synchronized forms' edges on both (d = 12 and 8: K = 1,
   d, d + 1, d + 2, L - 1, L, L + 1 and 5L + 3; 1, 3 and 64 chunks; entry
   states live and in a zero-filled padding row), on a copy of the 10k table
   whose padding rows are sinks (the maps' continuation), and, the forms for
   any table only, on the 10k shortest restart table, and the stitched scan == the
   sequential scan on each; the row-sharded scan in all
   five modes on fuzz tables cut into 1, 3 and 8 shards (one with more shards
   than rows), the 10k table at 65,536 x 524 windows, a whole-word-longest
   table in row and flat layout, and the 1M count-packed table in 8 shards;
   the row-sharded scan on the lane loops at its edge shapes (every mode, K
   = 1, 2 and 4 with the lane caps patched, C off a multiple of 4 K, uint8,
   uint16 and int32 windows, 1, 3 and 8 shards, halo 0, next states past the
   last shard); the step kernel of the same scan under a process group
   (``table_sharded_step``) and its class-major prep
   (``table_sharded_classes``) with 1, 3 and 8 ranks simulated in this
   process, the sum of their word buffers in place of the all_reduce: the
   prep's classes, every launch's buffers and every rank's result == the
   twins', the loop == ``table_sharded_scan``, in every mode
   (``check_step_edges``: rows_per not a power of two, more ranks than rows,
   states past the last shard, halo 0, uint8, uint16 and int32 windows,
   ``step_segments``' K and K = 1 to 26 forced, ragged segments); the
   grouped die sweeps, and every design of their A/B, on
   seeded planes (d = 0, 1, 12 and 39, dense and quotient, crossing bits on
   and off, sorted, unsorted, repeated, negative and past-L starts);
   the stride-2 count and planes against their twins and against the packed
   kernels on the fuzz, demo, uint16, quotient, halo-rounding, one-window,
   odd-length and state_bits + depth = 32 dictionaries, and on the 100-,
   1,000- and 10k-keyword dictionaries at 65,536 x 524 windows (timed beside
   the packed kernels), the count also at K = 1, 2 and 4 lanes a window on
   ragged 10k windows (an odd and an even number of pairs); the four probe kernels at every ``pl.pallas_call``
   site of ``tools/probes/`` at the JAX probes' sizes, ``chain_gather`` in
   every placement its table fits (warp registers, shared memory, global);
   the row read at its edges (``check_row_edges``: both reduce forms at
   every residency-sweep size, widths 1, 27, 28, 33 and 128 at every group
   size, 16-byte aligned and not, int32 and uint32 words, starts past the
   rows, mod 1, the rows and 2**32 - 1); the fold at its edges
   (``check_fold_edges``: C = 1, 2, 31, 32, 33, P - 1, P, P + 1, 4,096 and
   4,097, constant, identity, random and mixed maps, s0 = 0 and S - 1, the
   repair lengths too); the lookup chain at its edges (``check_chain_edges``:
   every op in every placement at T = 1, 2, 127, 128 and 129 to 58,112,
   n = 1, 31, 33 and 65,537, reps 0, 1 and 524, both ``sum_out``, entries
   past 256 and past T, mod 1 and T); the one-hot product at its edges
   (``check_onehot_edges``: T = 16, 64, 2,048, B = 1, 63, 65, 1,024,
   32 to 160 columns, reps 0, 1 and 128); the 2-D gather at its edges
   (``check_gather2d_edges``: every mode, B = 8, 16, 64 and 512, reps 0, 1,
   2 and 1,024, masks 0, 1,023 and 2**32 - 1, both ``sum_out``, an index
   tensor off a 16-byte boundary);
   the PFAC walk's three modes (v2 planes, v2 count, v1 planes, v1 == v2) on
   fuzz, demo and the 10k dictionary at 1 Mi units, and the v2 walk at its
   edges (``check_pfac_edges``: text lengths around a warp's prefix pass
   and, on one SM, around a warp's span; depths 31, 32, 33, 64, 65 and
   equal to prefix_k; every walk live to the depth; every walk dead; uint8,
   uint16 and int32 classes, classes off a 16-byte boundary; the prefix
   table staged and read with ``__ldg``; count == the planes' popcount);
   and the v1 walk at its edges (``check_pfac1_edges``: synthetic tries with
   an absorbing dead state at n = 1, 31, 33, a tile - 1, + 0, + 1 and 65,537,
   depths 4 to 200, uint8, uint16 and int32 classes, each staged table;
   dictionaries against v2 too);
4. each path through the public classes, its launch counters zeroed just
   before it and read just after: AC count == number of triples; every kind
   ``match`` == its gold matcher on 1 Mi units; 32 Mi-unit triples
   end-ascending (and non-overlapping for the resolved kinds) on the device
   engine; a case-folding map == gold; a listener's ``False`` stops
   delivery; a shortest matcher saved to npz and loaded back, and one
   loaded without its internal AC (the restart-scan kernel), == gold;
   whole-word-longest: the scan route on 32 Mi units (== gold on 1 Mi), the
   mixed route on BASELINE config #7's shape (10k keywords and 500 two-word
   phrases, apostrophe a word char; == gold on 1 Mi), each on the engine
   ``scan_walks_auto`` picks and again under the other ``FUSED_DEFAULT``
   (the same triples, == gold), config #4's Unicode
   map case-folded (== gold on 1 Mi), and the walk route == the scan
   route's triples on 32 Mi units; the 1M dictionary: ``AhoCorasickSet``
   count on the pinned 1 Mi-unit text == 1,282,185 and ``match`` on its
   128 Ki window == the naive oracle, ``LongestMatchSet`` count == 323,331
   and window == ``gold.gold_longest``; deep dictionaries (a map,
   WholeWord, Shortest with a deep inner AC) == gold; the split layout
   through the public classes with ``count_packable`` forced False (the
   dispatcher's branch for dictionaries of about 2**26 states) == gold; a
   dictionary that does not pack inline scans on the device under
   ``auto``; streams: the 10k dictionary over 32 Mi units through
   ``stream().feed`` in seeded uneven pieces (1 unit to 4 Mi, on both sides of
   the 16 Ki-unit device threshold) for each of the five kinds ==
   ``match_triples`` of the whole text, and a ``state_dict`` saved
   mid-stream, through JSON, into a fresh matcher's stream == the unbroken
   stream; the 1M dictionary's ``match_stream`` == 1,282,185 matches; a
   row-compressed 55,040-class dictionary through the gold branch on 32 Mi
   units (one cursor feed over the RowTable lane scan) == its device engine
   and, on a prefix, the per-character gold loop, and a row-compressed
   ``ShortestMatchSet`` through the same branch (speculate and repair over its
   restart table) == the gold loop; a stream resumed from a pre-tail
   ``{"state", "off"}`` point (the lane scan from that state) ==
   ``match_triples`` past it; each of these paths held to the sequential
   scan its tables allow (``seq_states``, the lane scan, or
   ``seq_states_serial``, speculate and repair) and the units that form scanned
   counted; ``match(text, listener)`` with
   ``False`` on the first match scans 16 Ki of the 32 Mi units;
   ``match_readable`` over a real file; the data-parallel sharded scanner on
   a mesh that names the card eight times (``ShardedScanner``): each of the
   five kinds and a map on 32 Mi units == the single-device matcher's count
   and triples (AC also on 1 and 3 shards, uneven cuts), the mixed-route
   dictionary, the walk branch (the scan tables forced off), the 1M
   dictionary's pinned counts and triples, ``sharded_arrival_states`` with
   ``sync_depth`` == speculate and repair == the lane scan (the demo dictionary
   and the 10k table on 32 Mi units; the two references made outside the
   path's counts; the synchronized stitch kernels launched, not the first
   designs), ``stitched_scan`` of the 10k shortest restart table without
   ``sync_depth`` (the forms for any table, not the synchronized ones),
   ``sharded_arrival_states`` without ``sync_depth`` == speculate and repair
   on the demo dictionary, the 10k table and the 10k restart table (the forms
   for any table),
   ``ShardedStream`` over the same uneven pieces and a resume in a
   fresh scanner, ``graft_entry.dryrun_multigpu(8)`` (the synchronized
   stitch) and ``entry()``; the
   table-sharded scanner on the same mesh read as a model mesh (eight row
   shards, each an allocation of its own): each of the five kinds and the
   mixed-route dictionary on 32 Mi units == the single-device triples, AC on
   (2, 4) and (4, 2) data x model meshes, ``sharded_table_count``, the 1M
   dictionary (layout ``hotstate``; count 1,282,185, triples == the
   single-device facade's), ``stream()`` over the same uneven pieces, and
   ``scan_corpus`` over 300 seeded documents == ``match`` per document; the
   group form under an NCCL process group of one rank in this process:
   ``TableShardedScanner(m, group=WORLD)`` for each kind (AC also under
   ``dp_tp_groups()``), its stream, ``sharded_table_count`` and the 1M count
   (1,282,185), its one-rank model axis through ``table_sharded_scan`` (the
   step loop not launched), and ``ShardedScanner(m, group=WORLD)`` for each
   kind and its stream, each == the mesh form's triples; the step loop
   (``group_scan`` with NCCL's all_reduce) at the three main-path shapes (the
   10k planes and count, the 1M count_packed): the step and its prep against
   their twins launch by launch, then the eager loop and the loop as a CUDA
   graph (captured, replayed on other windows, replayed again) == the twin
   == ``table_sharded_scan``; then 2 and 4 gloo ranks spawned on the one
   card with CUDA tensors (``gloo_rank``): the 1-axis group form at world 2
   and the (2, 2) layout at world 4, the eager step loop with halo + L + 1
   launches a mode, every mode == the mesh form;
   every
   AC-family kind through ``device_engine="batched2"`` == the default
   engine's triples, with its ``run_config`` record; the probes' entry point
   (every probe, then the residency sweep: 65,536 chains x 524 steps on
   tables of 128 entries to 470 MB, each result == the twin's); every AC-family kind under
   ``device_engine="pfac2"`` == the default engine's triples on 1 Mi units
   (the packed kernels not launched); the JAX package's PFAC conformance
   (v1 walk == v2 walk, count == popcount == the packed count) on 32 Mi
   units; ``bench.baseline_suite``
   (configs 1-4, 6, 7) with the count and planes kernel of each AC-family
   config; the headline's JSON line (its count == the facade's); the scaling
   record on the one card; ``--profile`` (the trace's events); every kernel
   of a path was launched;
5. times on the card with CUDA events (kernels) and the host clock
   (facade calls and stages), as GB/s = 2 x units / s, the ``bench.py``
   definition; the 1M dictionary's kernels and facade calls on 32 Mi units
   of BASELINE config #5's word soup, and its stages; the sequential scan per
   launch and per unit (the lane scan at 1 Ki, 4 Ki, 64 Ki and 32 Mi units,
   speculate and repair and the shortest restart scan at 64 Ki, 1 Mi and
   32 Mi, with one line of repair statistics), each streamed kind, the gold
   branch (and its
   stages: classes, upload, lane scan, download, emit expansion, triples)
   and the early stop; the sharded facades and the sharded count's stages; the step
   loop of the group form at K = 1 to 32 lanes a window (``step_sweep``: each
   K's step, captured all_reduce, prep and loops, eager and replayed), and
   at ``step_segments``' K its step (alone, in card time, with its NCCL
   all_reduce at world 1, one lane's launch), its prep, the eager loop and
   the graph replay beside ``table_sharded_scan`` on the same windows (the
   10k table's planes and count, the 1M table's count_packed); the row-sharded
   scan per mode beside the single-table kernels, the table-sharded facades
   and their stages; both forms of the maps and the rescan at C = 1, K = 32
   Ki, S = 65,536 (each held to its twin there), the forms for any table on
   the 10k restart table there, the meet positions (mean, largest, lanes
   that never met) on the 10k closure, the restart table and the demo
   dictionary, and the stitched scan of each form beside speculate and
   repair and the lane scan at the same length (also at 8 and 4,096 chunks
   of 32 Mi units of the 10k table, and on the restart table); the fold's
   first design against speculate and repair (``fold_ab``: the demo
   dictionary's sigma at C = 4,096, the 10k table's at C = 8, random maps at
   4,096 x 1,024) with its repairs and latency floor; the fused WWL scan
   against the plane and the sweep, the per-start walk beside them, at
   baseline-4 and the 10k cell (``probes.probe_wwl_fused``: card time with
   the calls queued ahead, and back to back), and the rule that sets
   ``FUSED_DEFAULT``; the ``"auto"``
   threshold sweep (gold against the device, first and warm calls of
   ``count`` and ``match_triples``, and the
   sequential-scan feed against the planes feed, 2**8 to 2**18 units on the
   100-, 1,000-, 10k- and 1M-keyword dictionaries, with each break-even);
   the redesigned count, hotstate plane, count-packed count, split planes
   and split count held against their twins at their timed shapes, then
   the A/B of their designs (``bench.scan_variants.run``: byte or word
   loads, one or two chains a thread, strided or tiled stores, the split
   planes' emit loads in the chain, after the tile or during the next one,
   the split count's first design and its emit loads gathered 16 or 32 at
   a time, K = 1, 2 and 4 at 8,192, 32,768 and 65,536 windows, each checked
   bit for bit, one JSON line), the stride-2 count's and planes'
   (``rowdfa2_ab``: their first designs against the lane loops at K = 1, 2
   and 4) and the sequential scan's
   (``seq_ab``: the first serial walk against the lane scan at several lane
   lengths, 1 Ki to 32 Mi units, the 10k dense table and the wide
   RowTable; ``spec_ab``: the one-thread walks against speculate and repair
   at five chunk lengths, 64 Ki to 32 Mi units, on the 10k restart table
   in both forms, the 10k dense table and the wide RowTable, every run held
   bit for bit against the one-thread walk), the stitch's (``meet_ab``:
   the first designs of the maps and the rescan for any table against the
   forms that meet a reference run and repair by rows, and the synchronized
   forms, at five C x K on the 10k restart table, the 10k closure and the
   demo dictionary), the row-sharded scan's (``tp_ab``: its first design against
   the lane loops at K = 1, 2 and 4 in the count, planes and hotstate modes)
   and the die sweep's (``sweep_ab``: its first design against G = 1, 2, 4,
   8 and 16 loads a group, staged in shared memory and not, at the 10k
   cell's start slots and at every position of a 4 Mi shard), and the plane
   sectors the sweep's walks touch;
   the probe kernels and the PFAC walk (at the sweep's shape, the JAX sizes
   and 32 Mi units) beside their twins, each result first held against the
   twin's at that shape, and, for the probes, the same chain as
   eager torch indexing; the row read's first design against its group
   sizes at widths 28 and 128 (``row_ab``), and the latency floors of the
   row read and of ``chain_gather`` (reps x the step latency of 32 chains on
   the idle card x the waves their chains need); the lookup chain's arms in
   global memory (``chain_ab``: independent addresses, whose time is its
   throughput floor, the chains in flight, ``__ldcg``, the L1 carve-out, 2
   and 4 chains a thread, one block an SM); the one-hot product's fp16 and
   fp32 library chains;
   the PFAC v2 walk's table
   loads a lane (mean,
   largest, a warp's longest) and the G loads/s of each mode, and its A/B
   (``ab pfac``: the first design's planes, count and count without the
   atomic add, the package's walk, its prefix table in the other
   placement); the ``device_engine="pfac2"`` facade beside the
   default; B17's bound; each kernel's bound (bytes over 3.35 TB/s or
   operations over 67 T/s, 989 T/s for the fp16 tensor cores, whichever is
   larger), the library-call times, and the kernels ranked by launches x
   (ms - bound), the latency chains' bound their latency floor where it is
   the larger (``chain_gather``'s the larger of its latency and throughput
   floors), the two sequential scans by the units their launches
   scanned (each modelled as a cost a launch plus a cost a unit).

It prints one JSON line of kernel records, then as its last line
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20260817  # bench.headline.SEED
N_KEYWORDS = 10_000  # bench.headline.N_KEYWORDS
BASE_UNITS = 1 << 20
TEXT_UNITS = 1 << 25  # 32 Mi units = 64 MiB of UTF-16
DEMO = [  # the 20-keyword demo dictionary of __graft_entry__._demo_matcher
    "he", "she", "his", "hers", "the", "then", "them", "there",
    "and", "hand", "sand", "stand", "standard", "art", "start",
    "ten", "tent", "intent", "content", "entropy",
]
KERNELS = {  # name: (source, the TPU kernel or device loop it replaces)
    "packed_scan_count": ("ahocorasick_tpu_torch/csrc/packed_scan.cu",
                          "ahocorasick_tpu/kernels/scan_block.py:152"),
    "packed_scan_planes": ("ahocorasick_tpu_torch/csrc/packed_scan.cu",
                           "ahocorasick_tpu/kernels/scan_block.py:209"),
    "compact_planes": ("ahocorasick_tpu_torch/csrc/compact.cu",
                       "ahocorasick_tpu/ops/scan_batched.py:500"),
    # speculate and repair over the restart rows, the kernels of seq_states_serial
    "shortest_states": ("ahocorasick_tpu_torch/csrc/seq_scan.cu",
                        "ahocorasick_tpu/ops/scan_dfa.py:37"),
    "wwl_scan_plane": ("ahocorasick_tpu_torch/csrc/wwl_scan.cu",
                       "ahocorasick_tpu/ops/scan_wwl.py:747"),
    "wwl_sweep_at": ("ahocorasick_tpu_torch/csrc/wwl_scan.cu",
                     "ahocorasick_tpu/ops/scan_wwl.py:685"),
    "wwl_walks_at": ("ahocorasick_tpu_torch/csrc/wwl_walk.cu",
                     "ahocorasick_tpu/ops/scan_wwl.py:137"),
    "packedcount_count": ("ahocorasick_tpu_torch/csrc/huge_scan.cu",
                          "ahocorasick_tpu/ops/scan_batched.py:190"),
    "packedcount_hotstate_plane": ("ahocorasick_tpu_torch/csrc/huge_scan.cu",
                                   "ahocorasick_tpu/ops/scan_batched.py:237"),
    # redesigned: the count lane, K lanes a window, the emit loads gathered
    "split_count": ("ahocorasick_tpu_torch/csrc/huge_scan.cu",
                    "ahocorasick_tpu/ops/scan_batched.py:460"),
    "split_emit_planes": ("ahocorasick_tpu_torch/csrc/huge_scan.cu",
                          "ahocorasick_tpu/ops/scan_batched.py:417"),
    "seq_states": ("ahocorasick_tpu_torch/csrc/seq_scan.cu",
                   "ahocorasick_tpu/core/stream.py:96"),
    # the form for tables that do not synchronize: speculate and repair
    "seq_states_serial": ("ahocorasick_tpu_torch/csrc/seq_scan.cu",
                          "ahocorasick_tpu/ops/scan_dfa.py:26"),
    "wwl_sweep_all": ("ahocorasick_tpu_torch/csrc/wwl_scan.cu",
                      "ahocorasick_tpu/ops/scan_wwl.py:1117"),
    # the stitch's maps and rescan in two forms each: synchronized
    # (sync_depth = d) and for any table (the maps meeting a reference run
    # that seq_scan.cu's rows of speculate and repair walk; the rescan as
    # those rows)
    "state_maps": ("ahocorasick_tpu_torch/csrc/stitch.cu",
                   "ahocorasick_tpu/ops/stitch.py:33"),
    "state_maps_all": ("ahocorasick_tpu_torch/csrc/stitch.cu",
                       "ahocorasick_tpu/ops/stitch.py:33"),
    "entry_fold": ("ahocorasick_tpu_torch/csrc/stitch.cu",
                   "ahocorasick_tpu/ops/stitch.py:48"),
    "rescan": ("ahocorasick_tpu_torch/csrc/seq_scan.cu",
               "ahocorasick_tpu/ops/stitch.py:68"),
    "rescan_serial": ("ahocorasick_tpu_torch/csrc/seq_scan.cu",
                      "ahocorasick_tpu/ops/stitch.py:68"),
    "table_sharded_scan": ("ahocorasick_tpu_torch/csrc/table_sharded.cu",
                           "ahocorasick_tpu/parallel/sharding.py:321"),
    # under a process group: a launch a step on this rank's shard, the words
    # summed by an all_reduce between launches; redesigned: lanes of its own
    # (step_segments, up to 32 a window) over class-major classes, which one
    # prep launch a call lays out; on NCCL a replayed CUDA graph
    "table_sharded_step": ("ahocorasick_tpu_torch/csrc/table_sharded.cu",
                           "ahocorasick_tpu/parallel/sharding.py:377"),
    "table_sharded_classes": ("ahocorasick_tpu_torch/csrc/table_sharded.cu",
                              "ahocorasick_tpu/parallel/sharding.py:377"),
    # redesigned, both: tile.cuh's lane loops over tile::Stride2, a pair a step
    "rowdfa2_count": ("ahocorasick_tpu_torch/csrc/rowdfa2_scan.cu",
                      "ahocorasick_tpu/ops/scan_rowdfa.py:248"),
    "rowdfa2_planes": ("ahocorasick_tpu_torch/csrc/rowdfa2_scan.cu",
                       "ahocorasick_tpu/ops/scan_rowdfa.py:286"),
    # B19: each probe kernel also replaces the other sites its source note lists
    "chain_gather": ("ahocorasick_tpu_torch/csrc/probes.cu", "tools/probes/probe.py:70"),
    "row_chain": ("ahocorasick_tpu_torch/csrc/probes.cu", "tools/probes/probe.py:160"),
    "onehot_mma": ("ahocorasick_tpu_torch/csrc/probes.cu", "tools/probes/probe.py:192"),
    # redesigned: csrc/gather2d.cuh's warp a row, no block barrier in the loop
    "gather2d": ("ahocorasick_tpu_torch/csrc/probes.cu", "tools/probes/probe2.py:56"),
    # redesigned, both: csrc/pfac_walk.cuh's warp spans, prefix pass and queue
    "pfac2_planes": ("ahocorasick_tpu_torch/csrc/pfac_scan.cu",
                     "ahocorasick_tpu/ops/scan_pfac2.py:163"),
    "pfac2_count": ("ahocorasick_tpu_torch/csrc/pfac_scan.cu",
                    "ahocorasick_tpu/ops/scan_pfac2.py:201"),
    # redesigned: csrc/pfac1_walk.cuh's persistent blocks, staged root and
    # two-level tables, a start a thread, grid-stride
    "pfac1_planes": ("ahocorasick_tpu_torch/csrc/pfac1_scan.cu",
                     "ahocorasick_tpu/ops/scan_pfac.py:74"),
    "wwl_scan_fused": ("ahocorasick_tpu_torch/csrc/wwl_scan.cu",
                       "ahocorasick_tpu/ops/scan_wwl.py:866"),
}
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory rate,
# the 32-bit rate outside the tensor cores, taken for these kernels'
# integer lookups, shifts and adds, and the dense fp16 tensor-core rate
# (onehot_mma).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_FP16_TENSOR_PER_S = 989e12
DEEP = ["a" * i for i in range(1, 40)] + ["the"]  # does not pack inline
SHORTEST_TWIN_UNITS = 1 << 16
N_SHARDS = 8  # the sharded scanner's mesh: eight shards on the one card
CORPUS_DOCS = 300  # scan_corpus: seeded documents of 0 to 4 Ki units
GLOO_JOIN_S = 300  # the gloo spawn's ranks: their collectives' and their join's timeout
ARRIVAL_UNITS_10K = 1 << 18  # sigma-stitched arrival states on the 10k table
# The 1M-keyword dictionary of tests/test_full_random_1m.py (seed 77) and its
# pinned facts, for its 1 Mi-unit text and the 128 Ki window at 300,000.
ONE_M = {"candidates": 1_100_000, "keywords": 995_169, "states": 4_356_756,
         "text_units": 1 << 20, "ac_count": 1_282_185, "longest_count": 323_331,
         "window": (300_000, 1 << 17)}


def one_m_text(rng, letters, kws, n_units: int) -> str:
    """The test's pinned text: random letters with 2,000 planted keywords."""
    text = list(letters[rng.integers(0, 26, size=n_units)].tobytes().decode())
    pos = rng.integers(0, n_units - 16, size=2000)
    kw_pick = rng.integers(0, len(kws), size=2000)
    for p, k in zip(pos, kw_pick):
        w = kws[k]
        text[p: p + len(w)] = w
    return "".join(text)[:n_units]


def word_soup(keywords, rng, n_units: int) -> str:
    """Seeded text: 10% dictionary words, 90% random lowercase noise words
    of 3-10 letters, space-separated (bench.make_text_classes's mix)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    kw_pool = list(rng.choice(keywords, size=512))
    noise_pool = ["".join(rng.choice(letters, size=int(rng.integers(3, 11))))
                  for _ in range(512)]
    k = n_units // 3
    is_kw = rng.random(k) < 0.10
    pick = rng.integers(0, 512, size=k)
    words = [kw_pool[i] if kw else noise_pool[i] for kw, i in zip(is_kw.tolist(), pick.tolist())]
    text = " ".join(words)
    assert len(text) >= n_units
    return text[:n_units]


def stream_pieces(seed: int, n_units: int) -> list:
    """Seeded uneven feed sizes summing to ``n_units``: log-uniform from 1
    unit to 4 Mi, so that feeds fall on both sides of the streams' device
    threshold (16 Ki units)."""
    rng = np.random.default_rng(seed)
    out, left = [], n_units
    while left:
        k = min(left, int(2 ** rng.uniform(0, 22)))
        out.append(k)
        left -= k
    return out


def fuzz_keywords(rng, alphabet: str, n: int, max_len: int):
    return sorted({"".join(rng.choice(list(alphabet), size=int(rng.integers(1, max_len + 1))))
                   for _ in range(n)})


def check_split_count_ks(label, args, errs, want=None):
    """The split count at K = 1, 2 and 4 lanes a window (its cap patched)
    against its twin in the same lanes and, where given, ``want``; ``args``
    are ``split_count``'s.  Returns the Ks that ran (K = 1 alone where the
    halo or the body allows no more) and the count."""
    import torch

    from ahocorasick_tpu_torch.kernels import scan_batched as khuge
    from ahocorasick_tpu_torch.kernels import scan_block

    w, halo = args[2], args[3]
    B, C = w.shape[0], w.shape[1] - halo
    cap, ran, count = khuge.SPLIT_COUNT_MAX_LANES, [], None
    try:
        for K in (1, 2, 4):
            khuge.SPLIT_COUNT_MAX_LANES = K * B
            if scan_block.segments(B, C, halo, khuge.SPLIT_COUNT_MAX_LANES)[0] != K:
                continue
            kc = int(khuge.split_count(*args))
            pc = int(khuge.split_count_plain(*args))
            torch.cuda.synchronize()
            e = max(abs(kc - pc), abs(kc - want) if want is not None else 0)
            errs["split_count"] = max(errs["split_count"], e)
            if e or (count is not None and kc != count):
                raise AssertionError(f"split_count {label} K={K}: kernel {kc}, twin {pc}, "
                                     f"want {want}")
            ran.append(K)
            count = kc
    finally:
        khuge.SPLIT_COUNT_MAX_LANES = cap
    print(f"  split_count {label}: B={B} W={w.shape[1]} halo={halo} P={args[-1]} "
          f"{str(w.dtype).replace('torch.', '')} K in {ran}: count={count} == twin")
    return ran, count


def check_rowdfa_ks(label, m, cls, body, dev, errs):
    """The stride-2 count and planes at K = 1, 2 and 4 lanes a window (their
    caps patched) on ``cls`` in ``body``-class windows, against their twins
    in the same lanes and the packed kernels on the same text.  Returns the
    Ks that ran."""
    import torch

    from ahocorasick_tpu_torch.kernels import scan_block
    from ahocorasick_tpu_torch.kernels import scan_rowdfa as krow
    from ahocorasick_tpu_torch.ops import scan_batched

    rd, pd, nc = m.dev.row_dfa, m.dev.packed_dfa, m.compiled.num_classes
    w = scan_batched.classes_to_device(scan_batched.chunk_classes(cls, body, rd.halo, nc), nc,
                                       dev)
    wp = scan_batched.classes_to_device(scan_batched.chunk_classes(cls, body, pd.halo, nc), nc,
                                        dev)
    args = (rd.table, w, rd.halo, rd.state_bits, rd.num_classes)
    packed_c = int(scan_block.packed_scan_count(pd.table, wp, pd.halo, pd.state_bits))
    packed_p = scan_block.packed_scan_planes(pd.table, wp, pd.halo, pd.state_bits)
    caps = krow.ROWDFA2_COUNT_MAX_LANES, krow.ROWDFA2_PLANES_MAX_LANES
    B, ran = w.shape[0], []
    try:
        for K in (1, 2, 4):
            krow.ROWDFA2_COUNT_MAX_LANES = krow.ROWDFA2_PLANES_MAX_LANES = K * B
            if scan_block.segments(B, body, rd.halo, K * B)[0] != K:
                continue
            kc, pc = int(krow.rowdfa2_count(*args)), int(krow.rowdfa_count_plain(*args))
            kp = krow.rowdfa2_planes(*args)
            pp = krow.rowdfa_emit_planes_plain(*args)
            torch.cuda.synchronize()
            e_count = max(abs(kc - pc), abs(kc - packed_c))
            e_planes = int(max((kp.view(torch.int32) != pp.view(torch.int32)).sum(),
                               (kp.view(torch.int32) != packed_p.view(torch.int32)).sum()))
            errs["rowdfa2_count"] = max(errs["rowdfa2_count"], e_count)
            errs["rowdfa2_planes"] = max(errs["rowdfa2_planes"], e_planes)
            print(f"  rowdfa2 K={K} {label}: {tuple(w.shape)} "
                  f"{str(w.dtype).replace('torch.', '')} windows, body {body} ({body // 2} "
                  f"pairs): count={kc} twin={pc} packed={packed_c}; planes words differing "
                  f"from the twin's or the packed kernel's: {e_planes}")
            if e_count or e_planes:
                raise AssertionError(f"rowdfa2 K={K} {label}: kernel disagrees with its twin "
                                     f"or the packed kernel")
            ran.append(K)
    finally:
        krow.ROWDFA2_COUNT_MAX_LANES, krow.ROWDFA2_PLANES_MAX_LANES = caps
    return ran


def check_redesign_edges(port, dev, errs):
    """The kernels redesigned for this card (the one-pass compaction, the
    segmented, coalesced planes scan, the counts on the count lane, the
    hotstate plane and the split planes on the planes lane) against their
    twins, bit for bit, at their edge shapes: K = 1, 2 and 4 lanes per
    window, halo 0, uint16 windows, C not a multiple of 4, one window, a
    last block that is not full, P = 1 to 14 split planes."""
    import torch

    from ahocorasick_tpu_torch.kernels import compact, scan_block
    from ahocorasick_tpu_torch.ops import scan_batched

    def words(t):
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def compact_pair(label, bits, limit):
        got = compact.compact_planes(bits, limit)
        want = compact.compact_planes_plain(bits, limit)
        torch.cuda.synchronize()
        if (got is None) != (want is None):
            e = 1
        elif got is None:
            e = 0
        elif got[1].shape != want[1].shape or got[2].shape != want[2].shape:
            e = 1
        else:
            e = abs(int(got[0]) - int(want[0]))
            if len(want[1]):
                e = max(e, int((got[1] - want[1]).abs().max()),
                        int((words(got[2]) - words(want[2])).abs().max()))
        errs["compact_planes"] = max(errs["compact_planes"], e)
        P, N = bits.shape
        print(f"  compact edge {label}: P={P} N={N} tiles={-(-N // 4096)} limit={limit} "
              f"-> {'None' if want is None else int(want[0])} max_abs_err={e}")
        if e:
            raise AssertionError(f"compact edge {label}: kernel disagrees with its twin")
        return want

    rng = np.random.default_rng(SEED + 10)

    def sparse(P, N, hot):
        bits = torch.zeros((P, N), dtype=torch.int32, device=dev)
        pos = torch.from_numpy(rng.choice(N, size=hot, replace=False)).to(dev)
        plane = torch.from_numpy(rng.integers(0, P, size=hot)).to(dev)
        vals = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=hot, dtype=np.int64)
                                .astype(np.int32)).to(dev)
        bits[plane, pos] = torch.where(vals == 0, torch.ones_like(vals), vals)
        return bits.view(torch.uint32)

    compact_pair("count 0", torch.zeros((1, 1 << 20), dtype=torch.uint32, device=dev), 1 << 18)
    bits = sparse(1, 1 << 22, 50_000)
    k = int((bits.view(torch.int32) != 0).sum())
    compact_pair("count == limit", bits, k)
    compact_pair("count == limit + 1", bits, k - 1)
    compact_pair("limit None", bits, None)
    compact_pair("all hot", sparse(1, 70_001, 70_001), None)
    for P in (1, 2, 3, 5):  # P = 5: more planes than the kernel holds in registers
        compact_pair(f"P = {P}, N past the tile", sparse(P, 3 * 4096 + 1_234 + P, 2_000), None)
    many = sparse(1, 16_384 * 4096 + 4_099, 200_000)
    compact_pair("more than 16 Ki tiles", many, None)
    compact_pair("more than 16 Ki tiles, again (descriptors reset)", many, None)
    del many

    def planes_pair(label, m, text, chunk, halo=None, want_k=None, want_count_k=None):
        pd = m.dev.packed_dfa
        halo = pd.halo if halo is None else halo
        cls = m._classes(text)
        w = scan_batched.classes_to_device(
            scan_batched.chunk_classes(cls, chunk, halo, m.compiled.num_classes),
            m.compiled.num_classes, dev)
        args = (pd.table, w, halo, pd.state_bits)
        B, C = w.shape[0], w.shape[1] - halo
        K, L = scan_block.segments(B, C, halo)
        Kc, Lc = scan_block.segments(B, C, halo, scan_block.COUNT_MAX_LANES)
        got = words(scan_block.packed_scan_planes(*args))
        want = words(scan_block.packed_scan_planes_plain(*args))
        count = int(scan_block.packed_scan_count(*args))
        count_twin = int(scan_block.packed_scan_count_plain(*args))
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        e_count = abs(count - count_twin)
        pop = int(sum(bin(x).count("1") for x in want[want != 0].tolist()))
        errs["packed_scan_planes"] = max(errs["packed_scan_planes"], e)
        errs["packed_scan_count"] = max(errs["packed_scan_count"], e_count)
        print(f"  planes edge {label}: B={B} W={w.shape[1]} halo={halo} K={K} L={L} "
              f"{str(w.dtype).replace('torch.', '')} bits={pop} max_abs_err={e}; count K={Kc} "
              f"L={Lc} lanes={B * Kc} kernel={count} twin={count_twin} max_abs_err={e_count}")
        if e or e_count or pop != count:
            raise AssertionError(f"planes edge {label}: kernel disagrees with its twin")
        if want_k is not None and K != want_k:
            raise AssertionError(f"planes edge {label}: K = {K}, not {want_k}")
        if want_count_k is not None and Kc != want_count_k:
            raise AssertionError(f"planes edge {label}: count K = {Kc}, not {want_count_k}")
        return Kc

    fr = np.random.default_rng(SEED + 11)
    kws = fuzz_keywords(fr, "abcd", 40, 6)
    m = port.AhoCorasickSet(kws, engine="device", device=dev)
    text = "".join(fr.choice(list("abcd "), size=300_001))
    count_ks = {planes_pair("C = 100 < 128", m, text, 100, want_k=2),
                planes_pair("C = 514, not a multiple of K (4-byte stores)", m, text, 514,
                            want_k=4),
                planes_pair("C = 127, last segment 31", m, text, 127, want_k=4),
                planes_pair("halo 0", m, text, 512, halo=0, want_k=1, want_count_k=1),
                planes_pair("one window", m, text[:600], 512)}
    wide_kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
    m = port.AhoCorasickSet(wide_kws, engine="device", device=dev)
    wide = "".join(chr(0x100 + int(c)) for c in fr.integers(0, 300, size=200_000))
    planes_pair("uint16 windows", m, wide, 512, want_k=4)
    kw = "abcdefghi"  # length 9 = halo, across every segment boundary
    m = port.AhoCorasickSet([kw, "bcd", "hia", "ia", "x"], engine="device", device=dev)
    chunk, seg = 144, 36
    chars = list(fr.choice(list("xyz"), size=1_000 * chunk))
    for wi in range(1_000):
        for k in range(1, 4):
            at = wi * chunk + k * seg - wi % len(kw)
            chars[at: at + len(kw)] = kw
    planes_pair("keyword of length halo across segment boundaries", m, "".join(chars), chunk,
                want_k=4)
    m = port.AhoCorasickSet(["a" * i for i in range(1, 13)], engine="device", device=dev)
    runs = fr.integers(1, 30, size=20_000)
    planes_pair("depth 12, a..a*12", m, "".join("a" * int(r) + "b" for r in runs), 512,
                want_k=4)
    if not {1, 2, 4} <= count_ks:
        raise AssertionError(f"count edges ran K in {sorted(count_ks)}, not 1, 2 and 4")

    # The hotstate plane (the planes lane over a count-packed table) and the
    # count-packed count (the count lane) on dictionaries whose state bits
    # plus depth exceed 32.
    from ahocorasick_tpu_torch.kernels import scan_batched as khuge

    def hot_pair(label, m, text, chunk, halo=None):
        flat, sb, table_halo = m.dev.count_packed_dfa
        halo = table_halo if halo is None else halo
        A = m.compiled.num_classes
        w = scan_batched.classes_to_device(
            scan_batched.chunk_classes(m._classes(text), chunk, halo, A), A, dev)
        args = (flat, w, halo, sb, A)
        B, C = w.shape[0], w.shape[1] - halo
        K, L = scan_block.segments(B, C, halo, khuge.HOTSTATE_MAX_LANES)
        Kc, Lc = scan_block.segments(B, C, halo, khuge.PACKEDCOUNT_MAX_LANES)
        got = words(khuge.packedcount_hotstate_plane(*args))
        want = words(khuge.packedcount_hotstate_plane_plain(*args))
        count = int(khuge.packedcount_count(*args))
        count_twin = int(khuge.packedcount_count_plain(*args))
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        e_count = abs(count - count_twin)
        hot = int((want != 0).sum())
        errs["packedcount_hotstate_plane"] = max(errs["packedcount_hotstate_plane"], e)
        errs["packedcount_count"] = max(errs["packedcount_count"], e_count)
        print(f"  hotstate edge {label}: B={B} W={w.shape[1]} halo={halo} K={K} L={L} "
              f"lanes={B * K} {str(w.dtype).replace('torch.', '')} hot={hot} max_abs_err={e}; "
              f"count K={Kc} L={Lc} kernel={count} twin={count_twin} max_abs_err={e_count}")
        if e or e_count or not hot or int((want >> sb).sum()) != count:
            raise AssertionError(f"hotstate edge {label}: kernel disagrees with its twin")
        return K, Kc

    m = port.AhoCorasickSet(DEEP, engine="device", device=dev)
    runs = fr.integers(1, 45, size=8_000)
    deep = "".join("a" * int(r) + str(fr.choice(["b", " the ", "x"])) for r in runs)[:200_001]
    ks = [hot_pair("depth 39, C = 1024", m, deep, 1024),
          hot_pair("depth 39, C = 512", m, deep, 512),
          hot_pair("depth 39, C = 1023, 4-byte stores", m, deep, 1023),
          hot_pair("depth 39, C = 128", m, deep, 128),
          hot_pair("halo 0", m, deep, 512, halo=0),
          hot_pair("one window", m, deep[:700], 1024)]
    wide_deep = wide_kws + ["".join(chr(0x100 + (11 * i) % 300) for i in range(30))]
    m_wide = port.AhoCorasickSet(wide_deep, engine="device", device=dev)
    wide_text = wide + wide_deep[-1] + wide[:5000] + wide_deep[-1]
    ks.append(hot_pair("uint16 windows, depth 30", m_wide, wide_text, 512))
    for i, name in enumerate(("hotstate", "count-packed count")):
        if not {1, 2, 4} <= {k[i] for k in ks}:
            raise AssertionError(f"{name} edges ran K in {sorted({k[i] for k in ks})}, "
                                 f"not 1, 2 and 4")

    # The split planes (the planes lane with the emit loads gathered after
    # each tile, P planes a step): P = 1, 2, 4, 13 (one block holds the 13
    # plane tiles: 226,304 B of dynamic shared memory) and 14 (two groups of
    # planes, each rescanning), ragged K > 1 segments.
    def split_pair(label, m, text, chunk, halo=None):
        dfa, emit, table_halo = m.dev.split_dfa
        halo = table_halo if halo is None else halo
        A, P = m.compiled.num_classes, emit.shape[1]
        w = scan_batched.classes_to_device(
            scan_batched.chunk_classes(m._classes(text), chunk, halo, A), A, dev)
        args = (dfa, emit, w, halo, A, P)
        B, C = w.shape[0], w.shape[1] - halo
        K, L = scan_block.segments(B, C, halo, khuge.SPLIT_PLANES_MAX_LANES)
        got = words(khuge.split_emit_planes(*args))
        want = words(khuge.split_emit_planes_plain(*args))
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        pop = int(scan_block._popcount32(want).sum())
        errs["split_emit_planes"] = max(errs["split_emit_planes"], e)
        print(f"  split edge {label}: B={B} W={w.shape[1]} halo={halo} P={P} K={K} L={L} "
              f"{str(w.dtype).replace('torch.', '')} bits={pop} max_abs_err={e}")
        if e or not int((want[-1] != 0).sum()):
            raise AssertionError(f"split edge {label}: kernel disagrees with its twin")
        count_ks, _ = check_split_count_ks(f"edge {label}", args, errs, want=pop)
        return P, K, tuple(count_ks)

    runs = fr.integers(1, 460, size=1_500)
    a_runs = "".join("a" * int(r) + "b" for r in runs)
    pk = [split_pair("depth 39, C = 1024", m, deep, 1024),
          split_pair("depth 39, C = 1023, ragged", m, deep, 1023),
          split_pair("depth 39, C = 512", m, deep, 512),
          split_pair("depth 39, C = 128", m, deep, 128),
          split_pair("halo 0", m, deep, 512, halo=0),
          split_pair("one window", m, deep[:700], 1024),
          split_pair("uint16 windows, depth 30", m_wide, wide_text, 512)]
    for depth, chunks in ((100, (1602, 1026, 512)), (400, (3302, 512, 6402)),
                          (420, (3402, 2048, 6722))):
        m_a = port.AhoCorasickSet(["a" * i for i in range(1, depth + 1)], engine="device",
                                  device=dev)
        pk += [split_pair(f"a..a*{depth}, C = {c}", m_a, a_runs, c) for c in chunks]
    planes = {P for P, _, _ in pk}
    if not ({1, 2, 4, 13, 14} <= planes and {1, 2, 4} <= {K for _, K, _ in pk}
            and {K for P, K, _ in pk if P > 2} - {1}):
        raise AssertionError(f"split edges ran (P, K) in {sorted({p[:2] for p in pk})}")
    # The split count ran K = 1, 2 and 4 on ragged (C % 4 == 3 and 2), uint16,
    # 13-plane and 14-plane windows.
    count_ks = {P: {k for p, _, ks in pk if p == P for k in ks} for P in planes}
    if not ({1, 2, 4} <= count_ks[13] and {1, 2, 4} <= count_ks[14]
            and {1, 2, 4} <= set(pk[1][2]) and {1, 2, 4} <= set(pk[6][2])):
        raise AssertionError(f"split count edges ran (P, K, count Ks) in {sorted(set(pk))}")


def fused_every_k(kwwl, sc, wf, st, kw) -> dict:
    """``{K: outcomes}``: the fused scan's kernel with its lanes a window
    forced to each K of 1, 2, 4 and 8 that the segments rule's lengths allow
    (``FUSED_MAX_K`` and ``FUSED_MAX_LANES`` patched)."""
    saved = kwwl.FUSED_MAX_K, kwwl.FUSED_MAX_LANES
    out = {}
    B, W = wf.shape
    try:
        for k in (1, 2, 4, 8):
            kwwl.FUSED_MAX_K, kwwl.FUSED_MAX_LANES = k, 1 << 40
            kk = kwwl.fused_segments(B, W - kw["halo"] - (kw["d"] + 1), kw["halo"])[0]
            if kk == k:
                out[k] = kwwl.wwl_scan_fused(sc.table, sc.outrows, wf, st, **kw)
    finally:
        kwwl.FUSED_MAX_K, kwwl.FUSED_MAX_LANES = saved
    return out


def walk_edge_cases(rng):
    """The per-start walk's edge cases: ``(label, keywords, text, max_depth or
    None for the matcher's, class dtype, starts rule)``.  Dictionaries whose
    walks die at every step 0..k-1 of the k-gram prefix or live past it,
    deep walks (a..a*29), > 256 classes, max_depth 0, 1 and 2 (k cut to
    max_depth + 1), starts at 0, at len(cls) (the pad slots), within d + 1 of
    the end, repeated, negative and past the classes, and every position;
    uint8, uint16 and int32 classes."""
    words = fuzz_keywords(rng, "abcde", 40, 6)
    deep = ["a" * i for i in range(1, 30)] + ["abc", "bca"]
    wide = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
    wide_text = "".join(chr(0x100 + int(c)) if c < 300 else " "
                        for c in rng.integers(0, 340, size=3000))
    soup = " ".join(rng.choice(words + ["zz", "a,"], size=600))
    cases = []
    for dtype in ("uint8", "uint16", "int32"):
        cases.append((f"word soup, {dtype}", words, soup, None, dtype, "lanes"))
        cases.append((f"word soup, every position, {dtype}", words, soup[:2000], None, dtype,
                      "every"))
        cases.append((f"word soup, odd starts, {dtype}", words, soup, None, dtype, "odd"))
    for md in (0, 1, 2):
        cases.append((f"max_depth {md}", words, soup, md, "uint8", "odd"))
    cases.append(("a..a*29, every position", deep, "".join(rng.choice(list("ab !"), size=3000)),
                  None, "uint8", "every"))
    cases.append(("a..a*29, lanes", deep, "a" * 40 + " " + "".join(rng.choice(list("ab !"),
                                                                              size=3000)),
                  None, "uint16", "lanes"))
    cases.append(("> 256 classes", wide, wide_text, None, "uint16", "lanes"))
    cases.append(("> 256 classes, odd starts", wide, wide_text, None, "int32", "odd"))
    cases.append(("empty text", words, "", None, "uint8", "odd"))
    return cases


def check_walk_edges(port, dev, errs):
    """The per-start walk (``wwl_walks_at``) against its twin and the
    kernel's prefix decomposition in plain PyTorch, bit for bit, at
    ``walk_edge_cases``.  Returns the cases driven."""
    import torch

    from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl
    from ahocorasick_tpu_torch.ops import scan_wwl

    cases = 0
    for label, kws, text, md, dtype, rule in walk_edge_cases(np.random.default_rng(SEED + 22)):
        m = port.WholeWordLongestMatchSet(kws, True, engine="device", device=dev)
        tabs = m.dev.wwl_walk
        cls_p, starts, lanes, _, d = scan_wwl.compact_lanes(m.compiled, m._classes(text))
        d = d if md is None else md
        n = len(cls_p)
        if rule == "every":
            st_np = np.arange(max(n - d - 1, 0), dtype=np.int32)
        elif rule == "odd":
            st_np = np.sort(np.array([-3, 0, 0, 1, 1, 1, n - d - 1, n - 2, n - 1, n, n, n + 7]
                                     + list(starts[: len(lanes)][:50]), dtype=np.int64)).astype(
                np.int32)
        else:
            st_np = starts
        host = cls_p.astype(np.int32)
        c = {"uint8": torch.from_numpy(host.astype(np.uint8)),
             "uint16": torch.from_numpy(host.astype(np.uint16).view(np.int16)).view(torch.uint16),
             "int32": torch.from_numpy(host)}[dtype].to(dev)
        st = torch.from_numpy(st_np).to(dev)
        derived = scan_wwl.build_walk_tables(*tabs[:6], d)
        want = kwwl.wwl_walks_at_plain(*tabs, c, st, d)
        split = kwwl.wwl_walks_prefix(tabs[0], tabs[6], c, st, d, derived)
        got = kwwl.wwl_walks_at(*tabs, c, st, d, walk_tables=derived)
        torch.cuda.synchronize()
        e = max(max_abs(split, want), max_abs(got, want))
        errs["wwl_walks_at"] = max(errs["wwl_walks_at"], e)
        cases += 1
        print(f"  walk edge {label}: {len(st_np)} starts, d={d}, k={derived.prefix_k}, "
              f"{tabs[0].shape[1]} padded classes; max_abs_err={e} (twin and prefix "
              f"decomposition)")
        if e:
            raise AssertionError(f"walk edge {label}: the kernel disagrees with its twin")
    return cases


def max_abs(got, want) -> int:
    """The largest |got - want| over outcome tuples (1 on a shape mismatch)."""
    import torch

    e = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return 1
        if g.numel():
            e = max(e, int((g.cpu().to(torch.int64) - w.cpu().to(torch.int64)).abs().max()))
    return e if len(got) == len(want) else max(e, 1)


def check_wwl_edges(port, dev, errs):
    """The fused whole-word-longest scan (``wwl_scan_fused``) against its
    plain twin (the JAX ring) and against the sweep kernel's outcomes, and
    the redesigned scan plane against its twin, bit for bit, at their edge
    shapes: walk depths d = 4, 12 and 32, a dense dictionary of > 256 classes
    (uint16 windows), separators kept as keywords, a separator-spanning one
    (crossing bits), row and flat layouts, narrow and int32 windows, empty
    and tiny texts and lengths off the 512-unit chunk (int32 windows at one
    length), starts negative,
    duplicated, at and past L; the plane at chunks that split windows into
    2 or 4 segments of lengths not a multiple of 4, with halo 0, and with a
    quotient table's entry plane.  Returns the cases driven."""
    import torch

    from ahocorasick_tpu_torch import convert
    from ahocorasick_tpu_torch.core.compiler import compile_matcher
    from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl
    from ahocorasick_tpu_torch.ops import scan_batched, scan_wwl

    def err(got, want):
        e = 0
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                return 1
            if g is None:
                continue
            if g.shape != w.shape:
                return 1
            if g.numel():
                to64 = ((lambda t: t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
                        if g.dtype == torch.uint32 else (lambda t: t.to(torch.int64)))
                e = max(e, int((to64(g) - to64(w)).abs().max()))
        return e if len(got) == len(want) else max(e, 1)

    def up(a, narrow_classes):
        if narrow_classes is None:
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
        return scan_batched.classes_to_device(a, narrow_classes, dev)

    fr = np.random.default_rng(SEED + 12)
    wwl = "whole_word_longest"
    dicts = {
        "d = 4": fuzz_keywords(fr, "abcehl", 30, 4),
        "d = 12": fuzz_keywords(fr, "abce", 40, 12),
        "d = 32 (a..a*29)": ["a" * i for i in range(1, 30)] + ["abc", "bca"],
        "> 256 classes": [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)],
        "separators as keywords": [" ", "!!", "abc", ",,", "ab"],
    }
    words = fuzz_keywords(fr, "abcde", 30, 4)
    dicts["separator-spanning"] = words + [f"{a} {b}" for a, b in zip(words[:8], words[8:16])]
    alphabets = {"d = 32 (a..a*29)": "abc !", "> 256 classes": None,
                 "separators as keywords": "abc ,!", "separator-spanning": "abcde ,"}
    cases = 0
    for label, kws in dicts.items():
        m = compile_matcher(kws, wwl, True)
        alpha = alphabets.get(label, "abcehl ,;")
        if alpha is None:
            text = "".join(chr(0x100 + int(c)) if c < 300 else " "
                           for c in fr.integers(0, 340, size=40_000))
        else:
            text = "".join(fr.choice(list(alpha), size=40_000))
        cls_all = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
        saved = scan_wwl._ROW_MAX_BYTES
        for flat in (False, True):
            scan_wwl._ROW_MAX_BYTES = 0 if flat else saved
            try:
                build = (scan_wwl.build_wwl_scan if scan_wwl.scan_applicable(m)
                         else scan_wwl.build_wwl_scan_mixed)
                sc = convert.wwl_scan_from_numpy(build(m), dev)
            finally:
                scan_wwl._ROW_MAX_BYTES = saved
            for n in (0, 3, 511, 4097, 40_000):
                cls = cls_all[:n]
                cls_p, starts, lanes, _, d = scan_wwl.compact_lanes(m, cls)
                if not scan_wwl.fused_applicable(sc, d):
                    raise AssertionError(f"wwl edge {label}: the fused scan does not apply")
                B = -(-len(cls_p) // 512)
                L = B * 512 - (d + 1)
                odd = np.array(sorted([-3, 0, 0, 2, 2, 2, L - 1, L, L, L + 5, B * 512 + 9]),
                               dtype=np.int32)
                for st_np in (starts, odd):
                    st = torch.from_numpy(st_np).to(dev)
                    # int32 windows once a layout, at 4097 units and the lanes' starts
                    int32_too = n == 4097 and st_np is starts
                    for narrow in (sc.num_classes, None) if int32_too else (sc.num_classes,):
                        wf = up(scan_wwl.chunk_classes_overlap(cls_p, 512, d, d + 1, narrow),
                                narrow and sc.num_classes)
                        ws = up(scan_batched.chunk_classes(cls_p, 512, d, narrow),
                                narrow and sc.num_classes)
                        kw = dict(halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits,
                                  num_classes=sc.num_classes, d=d, cross=sc.has_cross)
                        twin = kwwl.wwl_scan_fused_plain(sc.table, sc.outrows, wf, st, **kw)
                        got = fused_every_k(kwwl, sc, wf, st, kw)
                        pargs = (sc.table, ws, d, sc.id_bits, sc.num_classes, False)
                        plane = kwwl.wwl_scan_plane(*pargs)
                        plane_twin = kwwl.wwl_scan_plane_plain(*pargs)
                        sweep = kwwl.wwl_sweep_at(plane[0], None, None, sc.outrows, st, d=d,
                                                  id_bits=sc.id_bits, depth_bits=sc.depth_bits,
                                                  cross=sc.has_cross)
                        torch.cuda.synchronize()
                        e_f = max(max(err(g, twin) for g in got.values()),
                                  max(err(g, sweep) for g in got.values()))
                        e_p = err(plane, plane_twin)
                        errs["wwl_scan_fused"] = max(errs["wwl_scan_fused"], e_f)
                        errs["wwl_scan_plane"] = max(errs["wwl_scan_plane"], e_p)
                        cases += 1
                        if e_f or e_p:
                            raise AssertionError(
                                f"wwl edge {label}, {'flat' if flat else 'row'}, n={n}, "
                                f"{'odd' if st_np is odd else 'lane'} starts, "
                                f"{str(wf.dtype).replace('torch.', '')}: fused max_abs_err={e_f} "
                                f"(K = {sorted(got)}) plane max_abs_err={e_p}")
        print(f"  wwl edge {label}: d={d}, {m.num_classes} classes, row and flat, n = 0, 3, "
              f"511, 4097, 40,000, lane and odd starts, narrow windows (and int32 at 4097): "
              f"fused (K = 1, 2, 4, 8 where the segments allow) == twin == sweep, plane == twin")

    # The plane kernel's segments: chunks that split windows into 2 or 4 lanes
    # with lengths off a multiple of 4, halo 0, and quotient entry planes.
    full = compile_matcher([chr(c) for c in range(32, 0xD800)], wwl, True)
    quot = compile_matcher([chr(c) + chr(c + 1) for c in range(0x3000, 0x3400, 3)], wwl, True,
                           thresholder=_NeverDense())
    m12 = compile_matcher(dicts["d = 12"], wwl, True)
    for label, m, alpha in (("d = 12", m12, None), ("full-node quotient", full, (32, 0xD800)),
                            ("quotient rows", quot, (0x3000, 0x3400))):
        sc = convert.wwl_scan_from_numpy(scan_wwl.build_wwl_scan(m), dev)
        if alpha is None:
            text = "".join(fr.choice(list("abce ,"), size=60_000))
        else:
            text = "".join(chr(int(c)) for c in fr.integers(*alpha, size=60_000))
        cls = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
        d = scan_wwl.bucket_depth(m.max_depth)
        for chunk, halo in ((100, d), (127, d), (514, d), (512, d), (512, 0)):
            w = up(scan_batched.chunk_classes(cls, chunk, halo, sc.num_classes), sc.num_classes)
            pargs = (sc.table, w, halo, sc.id_bits, sc.num_classes, sc.quotient)
            got, want = kwwl.wwl_scan_plane(*pargs), kwwl.wwl_scan_plane_plain(*pargs)
            torch.cuda.synchronize()
            e = err(got, want)
            errs["wwl_scan_plane"] = max(errs["wwl_scan_plane"], e)
            cases += 1
            if e:
                raise AssertionError(f"wwl plane edge {label}, chunk {chunk}, halo {halo}: "
                                     f"max_abs_err={e}")
        if sc.quotient:
            try:
                kwwl.wwl_scan_fused(sc.table, sc.outrows, w, torch.zeros(1, dtype=torch.int32,
                                                                         device=dev),
                                    halo=0, id_bits=sc.id_bits, depth_bits=sc.depth_bits,
                                    num_classes=sc.num_classes, d=0, cross=False, quotient=True)
            except ValueError:
                pass
            else:
                raise AssertionError("the fused scan ran on a quotient table")
        print(f"  wwl plane edge {label}: {m.num_classes} classes, "
              f"{'quotient (entry plane)' if sc.quotient else 'dense'}, chunks 100, 127, 514, "
              f"512 with halo {d} and 512 with halo 0: plane == twin")
    return cases


def check_tp_lane_edges(port, dev, errs):
    """The row-sharded scan on the lane loops (``csrc/table_sharded.cu``)
    against its twin, bit for bit, at its edge shapes: every mode, K = 1, 2
    and 4 lanes per window (the caps patched), uint8, uint16 and int32
    windows, 1, 3 and 8 shards, ragged bodies, halo 0 (K = 1), and a table
    whose next states reach past the last shard.  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.kernels import scan_block
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp
    from ahocorasick_tpu_torch.ops import scan_batched
    from ahocorasick_tpu_torch.parallel import sharding

    def words(t):
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF if t.dim() else t

    def shards(table, n_model):
        return sharding._table_sharded_build(table, 1, 8, [dev] * n_model, "count")[0][0]

    def pair(label, st, w, halo, sb, modes=ktp.MODES, want_k=None):
        B, C = w.shape[0], w.shape[1] - halo
        seen = set()
        for mode in modes:
            K, L = ktp.lane_segments(B, C, halo, mode)
            got = ktp.table_sharded_scan(st, w, halo, sb, mode)
            want = ktp.table_sharded_scan_plain(st, w, halo, sb, mode)
            torch.cuda.synchronize()
            e = int((words(got) - words(want)).abs().max()) if got.shape == want.shape else 1
            errs["table_sharded_scan"] = max(errs["table_sharded_scan"], e)
            seen.add(K)
            if e:
                raise AssertionError(f"row-sharded lane edge {label}, mode {mode}, K={K} "
                                     f"L={L}: kernel disagrees with its twin ({e})")
        if want_k is not None and seen != {want_k}:
            raise AssertionError(f"row-sharded lane edge {label}: K in {sorted(seen)}, not "
                                 f"{want_k}")
        print(f"  row-sharded lane edge {label}: {st.n_model} shards of {st.rows_per} rows, "
              f"B={B} W={w.shape[1]} halo={halo} {str(w.dtype).replace('torch.', '')} K in "
              f"{sorted(seen)}, {len(modes)} modes: kernel == twin")
        return len(modes)

    fr = np.random.default_rng(SEED + 13)
    fuzz = port.AhoCorasickSet(fuzz_keywords(fr, "abcdef", 60, 8), engine="device", device=dev)
    pd_f = scan_batched.build_packed(fuzz.compiled)
    cls_f = fuzz._classes("".join(fr.choice(list("abcdefgh "), size=60_001)))
    A = fuzz.compiled.num_classes
    cases = 0
    saved = (scan_block.MAX_LANES, scan_block.COUNT_MAX_LANES)
    try:
        for n_model in (1, 3, 8):
            st = shards(pd_f.table, n_model)
            for chunk in (512, 514, 130):  # ragged: C not a multiple of 4 K
                w = scan_batched.classes_to_device(
                    scan_batched.chunk_classes(cls_f, chunk, pd_f.halo, A), A, dev)
                B = w.shape[0]
                for k, cap in ((4, 1 << 30), (2, 2 * B), (1, B)):
                    scan_block.MAX_LANES = scan_block.COUNT_MAX_LANES = cap
                    cases += pair(f"fuzz, C = {chunk}, caps {cap}", st, w, pd_f.halo,
                                  pd_f.state_bits, want_k=k)
                scan_block.MAX_LANES, scan_block.COUNT_MAX_LANES = saved
            w32 = torch.from_numpy(scan_batched.chunk_classes(cls_f, 512, pd_f.halo)).to(dev)
            cases += pair("fuzz, int32 windows", st, w32, pd_f.halo, pd_f.state_bits)
            w0 = scan_batched.classes_to_device(scan_batched.chunk_classes(cls_f, 512, 0, A),
                                                A, dev)
            cases += pair("fuzz, halo 0", st, w0, 0, pd_f.state_bits, want_k=1)
    finally:
        scan_block.MAX_LANES, scan_block.COUNT_MAX_LANES = saved
    wide_kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
    wide = port.AhoCorasickSet(wide_kws, engine="device", device=dev)
    pd_w = scan_batched.build_packed(wide.compiled)
    Aw = wide.compiled.num_classes
    cls_w = wide._classes("".join(chr(0x100 + int(c)) for c in fr.integers(0, 300, size=50_000)))
    ww = scan_batched.classes_to_device(scan_batched.chunk_classes(cls_w, 512, pd_w.halo, Aw),
                                        Aw, dev)
    if ww.dtype != torch.uint16:
        raise AssertionError("the wide dictionary's windows are not uint16")
    cases += pair("> 256 classes, uint16 windows", shards(pd_w.table, 3), ww, pd_w.halo,
                  pd_w.state_bits)
    # Next states up to 3 x S, past the last shard: every shard reads 0 there.
    S, A_r, sb = 97, 7, 9
    nxt = fr.integers(0, 3 * S, size=(S, A_r))
    table = (nxt | (fr.integers(0, 1 << 20, size=(S, A_r)) << sb)).astype(np.uint32)
    wr = torch.from_numpy(fr.integers(0, A_r, size=(600, 8 + 300)).astype(np.uint8)).to(dev)
    for n_model in (1, 3, 8):
        cases += pair(f"states past the last shard ({3 * S} of {S})", shards(table, n_model),
                      wr, 8, sb)
    return cases


def simulated_ranks(ranks, w, halo, sb, mode, record=None):
    """``group_scan`` with the model ranks simulated in this process: the sum
    of their word buffers replaces the all_reduce.  ``record`` (a list)
    receives every launch's word buffers before the sum (int32[n_model, N] on
    the host).  Returns the ranks' results."""
    import torch

    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    def reduce(bufs):
        stack = torch.stack([b.view(torch.int32) for b in bufs])
        if record is not None:
            record.append(stack.cpu())
        total = stack.sum(0, dtype=torch.int32)
        for b in bufs:
            b.view(torch.int32).copy_(total)

    return ktp.group_scan(ranks, w, halo, sb, mode, reduce)


def gloo_rank(rank, world, init_file, data, out_dir):
    """One rank of the smoke's gloo spawn on the one card: the table-sharded
    scan of the table and classes in ``data`` under ``group=`` (world 2: the
    process group; world 4: its (2, 2) layout), every mode, saved to
    ``out_dir/rank<r>.npz`` with the rank's launch counts."""
    import datetime

    import torch
    import torch.distributed as dist

    from ahocorasick_tpu_torch.kernels import build
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp
    from ahocorasick_tpu_torch.parallel import sharding

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=GLOO_JOIN_S))
    try:
        with np.load(data) as z:
            table, cls = z["table"], z["cls"]
            halo, sb = int(z["halo"]), int(z["state_bits"])
        form = dist.group.WORLD if world == 2 else sharding.dp_tp_groups((2, 2))
        build.reset_launches()
        out = {}
        for mode in ktp.MODES:
            got = sharding._table_sharded_run(table, cls, halo, sb, None, 512, mode, group=form)
            out[mode] = (np.asarray([got]) if isinstance(got, int)
                         else got.view(torch.int32).cpu().numpy())
        out["launches"] = np.asarray([build.launches["table_sharded_step"],
                                      build.launches["table_sharded_scan"],
                                      build.launches["table_sharded_classes"]])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def step_loop_vs_twin(label, shard, w, halo, sb, mode, mesh_table, errs):
    """``table_sharded_step`` and its prep ``table_sharded_classes`` against
    their twins at a main path's shape and ``step_segments``' K, one rank
    holding the whole table (``shard``): the class-major classes compared
    whole, then the whole loop, one launch and one twin step a step on
    buffers of their own (at one rank the all_reduce is the identity), every
    launch's words compared on the card; the planes start apart (-1 and 0),
    so a position either leaves unwritten differs.  Then the kernel's result
    == ``table_sharded_scan`` of ``mesh_table``.  Raises on a difference;
    returns the twin's result (int64: the count, or the plane's words)."""
    import torch

    from ahocorasick_tpu_torch.kernels import table_sharded as ktp

    def widen(x):
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    t0 = time.perf_counter()
    dev = w.device
    B, W = w.shape
    C = W - halo
    K, L = ktp.step_segments(B, C, halo, mode)
    counting = mode in ("count", "count_packed")
    classes = ktp.step_classes(w, halo, (K, L))
    signed = ktp._signed(w.dtype)
    e = int((classes.view(signed).to(torch.int64)
             - ktp.step_classes_plain(w, halo, (K, L)).view(signed).to(torch.int64)).abs().max())
    errs["table_sharded_classes"] = max(errs["table_sharded_classes"], e)
    if e:
        raise AssertionError(f"table_sharded_classes, {label}, {mode}: != its twin ({e})")

    def buffers():
        out = (torch.zeros(B * K, dtype=torch.int64, device=dev) if counting
               else torch.zeros((1, B * C), dtype=torch.uint32, device=dev))
        return (torch.zeros(B * K, dtype=torch.uint32, device=dev), out,
                torch.zeros(1, dtype=torch.int64, device=dev) if counting else None)

    kern, twin = buffers(), buffers()
    if not counting:
        kern[1].view(torch.int32).fill_(-1)
    err = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(halo + L + 1):
        ktp.table_sharded_step(shard, 0, kern[0], classes, t, halo, sb, mode, (K, L), C, kern[1],
                               kern[2])
        ktp.table_sharded_step_plain(shard, 0, twin[0], classes, t, halo, sb, mode, (K, L), C,
                                     twin[1], twin[2])
        err = torch.maximum(err, (widen(kern[0]) - widen(twin[0])).abs().max())
    results = [x[2] if counting else widen(x[1]) for x in (kern, twin)]
    mesh = ktp.table_sharded_scan(mesh_table, w, halo, sb, mode)
    results.append(mesh.reshape(1) if counting else widen(mesh))
    err = max(int(err), int((results[0] - results[1]).abs().max()),
              int((results[0] - results[2]).abs().max()))
    errs["table_sharded_step"] = max(errs["table_sharded_step"], err)
    if err:
        raise AssertionError(f"table_sharded_step, {label}, {mode}: the loop of {halo + L + 1} "
                             f"launches disagrees with its twin or the mesh form ({err})")
    print(f"  step vs twin, {label}, {mode}: the prep's {halo + L} x {B * K} classes == twin; "
          f"{halo + L + 1} launches of {B * K} lanes (K={K}), every launch's words and the "
          f"result == twin == table_sharded_scan ({time.perf_counter() - t0} s)")
    return results[1]


def check_step_edges(port, dev, errs):
    """The step kernel of the table-sharded scan under a process group
    (``table_sharded_step``, ``csrc/table_sharded.cu``) against its twin, bit
    for bit, with n_model = 1, 3 and 8 ranks simulated in one process: every
    launch's word buffers (each rank's, before the sum that replaces the
    all_reduce) and every rank's result; and the whole simulated loop ==
    ``table_sharded_scan`` (the mesh form's kernel), all five modes; and its
    prep ``table_sharded_classes`` == its twin in every case.  Edges: rows_per
    not a power of two, more shards than rows, next states past the last
    shard, halo 0, uint8, uint16 and int32 windows, ``step_segments``' K and K
    = 1, 2, 4, 8, 15 and 26 lanes a window (``STEP_MAX_K`` patched to 1 .. 32
    on bodies of 130) and ragged last segments.  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.kernels import scan_block
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp
    from ahocorasick_tpu_torch.ops import scan_batched
    from ahocorasick_tpu_torch.parallel import sharding

    def as_words(t):
        return t.view(torch.int32).cpu().to(torch.int64) & 0xFFFFFFFF if t.dim() else t.cpu()

    def pair(label, table, w, halo, sb, n_model, want_k=None, synchronizing=True):
        # A table that is not halo-synchronizing scans differently at every
        # lane split: the mesh form's lanes are not the step loop's, so only
        # the twin compares there.
        st = sharding._table_sharded_build(table, halo, sb, [dev] * n_model, "count")[0][0]
        on_card = list(enumerate(st.shards))
        on_host = [(k, t.cpu()) for k, t in on_card]
        B, C = w.shape[0], w.shape[1] - halo
        seen = set()
        for mode in ktp.MODES:
            K, L = ktp.step_segments(B, C, halo, mode)
            seen.add(K)
            signed = ktp._signed(w.dtype)
            e = int((ktp.step_classes(w, halo, (K, L)).view(signed).cpu().to(torch.int64)
                     - ktp.step_classes_plain(w.cpu(), halo, (K, L)).view(signed).to(torch.int64)
                     ).abs().max())
            errs["table_sharded_classes"] = max(errs["table_sharded_classes"], e)
            if e:
                raise AssertionError(f"step edge {label}, mode {mode}, K={K} L={L}: the prep "
                                     f"disagrees with its twin ({e})")
            got_words, want_words = [], []
            got = simulated_ranks(on_card, w, halo, sb, mode, got_words)
            want = simulated_ranks(on_host, w.cpu(), halo, sb, mode, want_words)
            mesh = ktp.table_sharded_scan(st, w, halo, sb, mode)
            torch.cuda.synchronize()
            e = 0 if len(got_words) == len(want_words) == halo + L else 1
            for g, x in zip(got_words, want_words):
                e = max(e, int((g.to(torch.int64) - x.to(torch.int64)).abs().max()))
            for g, x in zip(got, want):
                e = max(e, int((as_words(g) - as_words(x)).abs().max()))
                if synchronizing:
                    e = max(e, int((as_words(g) - as_words(mesh)).abs().max()))
            errs["table_sharded_step"] = max(errs["table_sharded_step"], e)
            if e:
                raise AssertionError(f"step edge {label}, mode {mode}, K={K} L={L}: the kernel "
                                     f"disagrees with its twin or the mesh form ({e})")
        if want_k is not None and seen != {want_k}:
            raise AssertionError(f"step edge {label}: K in {sorted(seen)}, not {want_k}")
        print(f"  step edge {label}: {n_model} ranks of {st.rows_per} rows, B={B} "
              f"W={w.shape[1]} halo={halo} {str(w.dtype).replace('torch.', '')} K in "
              f"{sorted(seen)}: classes, words a launch and results == twin"
              + (" == table_sharded_scan" if synchronizing else ""))
        rows.append(st.rows_per)

    fr = np.random.default_rng(SEED + 17)
    fuzz = port.AhoCorasickSet(fuzz_keywords(fr, "abcdef", 60, 8), engine="device", device=dev)
    pd_f = scan_batched.build_packed(fuzz.compiled)
    A = fuzz.compiled.num_classes
    cls_f = fuzz._classes("".join(fr.choice(list("abcdefgh "), size=12_001)))

    def narrow(chunk, halo):
        return scan_batched.classes_to_device(scan_batched.chunk_classes(cls_f, chunk, halo, A),
                                              A, dev)

    rows = []  # rows_per of every case
    for n_model in (1, 3, 8):
        pair("fuzz", pd_f.table, narrow(512, pd_f.halo), pd_f.halo, pd_f.state_bits, n_model)
    saved = (ktp.STEP_MAX_K, ktp.STEP_MAX_LANES)
    try:
        w = narrow(130, pd_f.halo)  # bodies of 130: ragged last segments
        for cap, k in ((32, 26), (16, 15), (8, 8), (4, 4), (2, 2), (1, 1)):
            ktp.STEP_MAX_K, ktp.STEP_MAX_LANES = dict.fromkeys(ktp.MODES, cap), 1 << 30
            pair(f"fuzz, C = 130, STEP_MAX_K {cap}", pd_f.table, w, pd_f.halo, pd_f.state_bits,
                 3, want_k=k)
    finally:
        ktp.STEP_MAX_K, ktp.STEP_MAX_LANES = saved
    w32 = torch.from_numpy(scan_batched.chunk_classes(cls_f, 512, pd_f.halo)).to(dev)
    pair("fuzz, int32 windows", pd_f.table, w32, pd_f.halo, pd_f.state_bits, 3)
    pair("fuzz, halo 0", pd_f.table, narrow(512, 0), 0, pd_f.state_bits, 3, want_k=1)
    wide_kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
    wide = port.AhoCorasickSet(wide_kws, engine="device", device=dev)
    pd_w = scan_batched.build_packed(wide.compiled)
    Aw = wide.compiled.num_classes
    cls_w = wide._classes("".join(chr(0x100 + int(c)) for c in fr.integers(0, 300, size=8_000)))
    ww = scan_batched.classes_to_device(scan_batched.chunk_classes(cls_w, 512, pd_w.halo, Aw),
                                        Aw, dev)
    if ww.dtype != torch.uint16:
        raise AssertionError("the wide dictionary's windows are not uint16")
    pair("> 256 classes, uint16 windows", pd_w.table, ww, pd_w.halo, pd_w.state_bits, 3)
    tiny = port.AhoCorasickSet(["x", "y"], engine="device", device=dev, thresholder=_NeverDense())
    pd_t = scan_batched.build_packed(tiny.compiled)
    if not pd_t.table.shape[0] < 8:
        raise AssertionError("the tiny quotient table has as many rows as ranks")
    At = tiny.compiled.num_classes
    wt = scan_batched.classes_to_device(scan_batched.chunk_classes(
        tiny._classes("xxyxy x!y" * 200), 64, pd_t.halo, At), At, dev)
    pair("more ranks than rows", pd_t.table, wt, pd_t.halo, pd_t.state_bits, 8)
    # Next states up to 3 x S, past the last shard: every rank reads 0 there.
    S, A_r, sb = 97, 7, 9
    nxt = fr.integers(0, 3 * S, size=(S, A_r))
    table = (nxt | (fr.integers(0, 1 << 20, size=(S, A_r)) << sb)).astype(np.uint32)
    wr = torch.from_numpy(fr.integers(0, A_r, size=(300, 8 + 300)).astype(np.uint8)).to(dev)
    for n_model in (1, 3, 8):
        pair(f"states past the last shard ({3 * S} of {S}), halo 0", table, wr, 0, sb, n_model,
             want_k=1)
        pair(f"states past the last shard ({3 * S} of {S}), halo 8 (not synchronizing: == the "
             f"twin only)", table, wr, 8, sb, n_model, synchronizing=False)
    if all(r & (r - 1) == 0 for r in rows) or min(rows) != 1:
        raise AssertionError(f"step edges: rows_per {sorted(set(rows))} lack a case that is "
                             f"not a power of two or one of a row")
    return len(rows) * len(ktp.MODES)


def check_spec_edges(dev, errs):
    """Speculate and repair against its twins, states and repair lengths bit
    for bit: ``seq_states_serial`` (``scan_dfa.spec_states`` and the
    ``seq_states`` wrapper) on the shortest restart table, dense and
    RowTable, padded with zero rows, from the root, a live state and a
    padding row; ``shortest_states`` on uint8 or uint16 and int32 classes
    over the cached restart rows; each at the forced chunk lengths K = 1, 2,
    7, d, d + 1, 64 and K >= N and at N = 0, 1, K - 1, K, K + 1 and many
    chunks, on the ``aa``/``aaa`` restart table, two fuzz dictionaries (one
    of > 256 classes) and ``ab``/``ba`` over ``abab...``, where every chunk
    that starts on a ``b`` must repair to its end.  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.core import stream
    from ahocorasick_tpu_torch.core.compiler import compile_matcher
    from ahocorasick_tpu_torch.kernels import scan_dfa
    from ahocorasick_tpu_torch.models.matchers import _DeviceTables
    from ahocorasick_tpu_torch.ops import scan_batched

    rng = np.random.default_rng(SEED + 18)
    wide = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
    dicts = {
        "aa/aaa": (["aa", "aaa"], "".join(rng.choice(list("ab"), size=2000, p=[.8, .2]))),
        "fuzz abcd": (fuzz_keywords(rng, "abcd", 40, 6),
                      "".join(rng.choice(list("abcd "), size=2000))),
        "fuzz > 256 classes": (wide, "".join(rng.choice(wide + ["x"], size=1000))),
        "periodic ab/ba": (["ab", "ba"], "ab" * 1000),
    }
    to64 = lambda t: t.to(torch.int64)
    rule, cases = scan_dfa.SPEC_CHUNK_LEN, 0
    try:
        for label, (kws, text) in dicts.items():
            m = compile_matcher(kws, "shortest", True)
            units = np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)
            cls = m.charmap[units].astype(np.int32)
            dense = stream._ShortestCursor._restart_table(m)
            dense = np.vstack([dense, np.zeros((3, dense.shape[1]), dtype=dense.dtype)])
            rows, row_id = np.unique(dense, axis=0, return_inverse=True)
            up = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            forms = {"dense": (up(dense), None), "RowTable": (up(rows), up(row_id.reshape(-1)))}
            tabs = _DeviceTables(m, dev)
            d = max(m.max_depth, 1)
            live = int(np.argmax(m.depth[: m.num_states]))
            c32 = up(cls)
            narrow = scan_batched.classes_to_device(cls, m.num_classes, dev)
            e_seq = e_short = 0
            for K in (1, 2, 7, d, d + 1, 64, None):
                k_len = 40 if K is None else K
                scan_dfa.SPEC_CHUNK_LEN = len(cls) + 1 if K is None else K
                for n in sorted({0, 1, k_len - 1, k_len, k_len + 1, max(600, 9 * k_len + 5)}):
                    if n > len(cls):
                        continue
                    for tab, rid in forms.values():
                        for s0 in (0, live, m.num_states):
                            got, rep = scan_dfa.spec_states(tab, rid, c32[:n], s0)
                            wrapped = scan_dfa.seq_states(tab, rid, c32[:n], s0)
                            want, rep_w = scan_dfa.spec_states_plain(tab, rid, c32[:n], s0)
                            torch.cuda.synchronize()
                            if n:
                                e_seq = max(e_seq, int((to64(got) - to64(want)).abs().max()),
                                            int((to64(rep) - to64(rep_w)).abs().max()),
                                            int((to64(wrapped) - to64(want)).abs().max()))
                            cases += 1
                    for c in (narrow[:n], c32[:n]):
                        got = scan_dfa.shortest_states(tabs.dfa_next, tabs.match_len, c,
                                                       tabs.restart_row_id)
                        want = scan_dfa.shortest_states_plain(tabs.dfa_next, tabs.match_len, c)
                        torch.cuda.synchronize()
                        if n:
                            e_short = max(e_short, int((to64(got) - to64(want)).abs().max()))
                        cases += 1
                if label.startswith("periodic") and K is not None and K % 2:
                    scan_dfa.SPEC_CHUNK_LEN = K
                    _, rep = scan_dfa.spec_states(*forms["RowTable"], c32, 0)
                    C = rep.shape[0]
                    lens = np.minimum(K, len(cls) - K * np.arange(C))
                    odd = (K * np.arange(C)) % 2 == 1
                    r = rep.cpu().numpy()
                    if not ((r[odd] == lens[odd]).all() and (r[~odd] == 0).all()):
                        e_seq = max(e_seq, 1)
                        print(f"  spec {label} K={K}: repairs {r.tolist()[:12]}.. are not "
                              f"every second chunk to its end")
            errs["seq_states_serial"] = max(errs["seq_states_serial"], e_seq)
            errs["shortest_states"] = max(errs["shortest_states"], e_short)
            print(f"  spec edges {label}: d={d}, {m.num_classes} classes "
                  f"({str(narrow.dtype).replace('torch.', '')}), K in 1, 2, 7, d, d + 1, 64, "
                  f">= N; max_abs_err seq_states_serial {e_seq}, shortest_states {e_short}")
            if e_seq or e_short:
                raise AssertionError(f"speculate and repair, {label}: a kernel disagrees with "
                                     f"its twin")
    finally:
        scan_dfa.SPEC_CHUNK_LEN = rule
    return cases


def check_meet_edges(dev, errs):
    """The stitch's forms for any table against their twins (run on CPU
    copies), bit for bit, side outputs included: ``state_maps_all`` (the
    reference runs by speculate and repair by rows, then the meet kernel;
    ``stitch.meet_maps``: sigma and each lane's meet position, and the
    ``state_maps`` wrapper) and ``rescan_serial`` (``stitch.spec_rescan``:
    states and each sub-chunk's repair length, and the ``rescan`` wrapper);
    the stitched scan == the sequential scan.  On the shortest restart
    tables of ``aa``/``aaa`` and of a fuzz dictionary, goto closures of depth
    6 and 39 passed with no depth (each lane must meet within d classes and
    each repair be at most d long), a copy of the first whose padding rows
    are sinks, and ``ab``/``ba`` over ``abab...`` (the lane of ``b`` never
    meets in a chunk that starts on an ``a``); every table padded with
    zero-filled rows; K = 0, 1, 2, 6, 7, 8 and 68 with sub-chunks of 7
    forced, and K = 300 under the rule; C = 1, 3 and 64; entry states the
    root, a live state and a padding row, and a vector cycling through them.
    Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.core import stream
    from ahocorasick_tpu_torch.core.compiler import compile_matcher
    from ahocorasick_tpu_torch.kernels import scan_dfa
    from ahocorasick_tpu_torch.kernels import stitch as kstitch
    from ahocorasick_tpu_torch.ops import stitch

    rng = np.random.default_rng(SEED + 19)
    fuzz = fuzz_keywords(rng, "abcd", 40, 6)
    deep = ["a" * i for i in range(1, 40)] + ["the", "abc", "ba", "tat"]

    def padded(t, sinks=False):
        t = np.vstack([t, np.zeros((3, t.shape[1]), dtype=t.dtype)]).astype(np.int32)
        if sinks:
            t[-3:] = np.arange(t.shape[0] - 3, t.shape[0], dtype=np.int32)[:, None]
        return t

    tables = {}
    for label, kws, kind, text in (
            ("restart aa/aaa", ["aa", "aaa"], "shortest",
             "".join(rng.choice(list("ab"), size=20_000, p=[.8, .2]))),
            ("restart fuzz a-j", [w for w in fuzz_keywords(rng, "abcdefghij", 80, 6)
                                  if len(w) > 2], "shortest",
             "".join(rng.choice(list("abcdefghij "), size=20_000))),
            ("goto fuzz abcd", fuzz, "ac", "".join(rng.choice(list("abcd"), size=20_000))),
            ("goto deep", deep, "ac", "".join(rng.choice(list("aaaaaaaaabt"), size=20_000))),
            ("goto fuzz abcd, sink padding", fuzz, "ac", "".join(rng.choice(list("abcd"),
                                                                           size=20_000))),
            ("restart ab/ba", ["ab", "ba"], "shortest", "ab" * 10_000)):
        m = compile_matcher(kws, kind, True)
        units = np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)
        t = stream._ShortestCursor._restart_table(m) if kind == "shortest" else m.dfa_next
        live = int(np.argmax(m.depth[: m.num_states]))
        d = max(m.max_depth, 1) if kind == "ac" and "sink" not in label else None
        tables[label] = (padded(t, "sink" in label), m.charmap[units].astype(np.int32),
                         (0, live, m.num_states), d, m)
    to64 = lambda t: t.to(torch.int64)

    def diff(got, want):
        if got.shape != want.shape:
            return 1
        return int((to64(got.cpu()) - to64(want.cpu())).abs().max()) if got.numel() else 0

    rule, cases = scan_dfa.SPEC_CHUNK_LEN, 0
    try:
        for label, (table, cls, entries, d, m) in tables.items():
            tab, tab_cpu = torch.from_numpy(table).to(dev), torch.from_numpy(table)
            e_maps = e_rescan = 0
            worst_meet = worst_repair = 0
            all_meet, never = [], 0
            for K in (0, 1, 2, 6, 7, 8, 68, 300):
                scan_dfa.SPEC_CHUNK_LEN = None if K == 300 else 7
                for C in (1, 3, 64):
                    c_cpu = torch.from_numpy(np.ascontiguousarray(cls[: C * K].reshape(C, K)))
                    c = c_cpu.to(dev)
                    sigma, meet = kstitch.meet_maps(tab, c)
                    wrapped = kstitch.state_maps(tab, c)
                    sigma_w, meet_w = kstitch.meet_maps_plain(tab_cpu, c_cpu)
                    mixed = torch.tensor(np.resize(np.asarray(entries), C), dtype=torch.int32)
                    states, repair = kstitch.spec_rescan(tab, c, mixed.to(dev))
                    states_w, repair_w = kstitch.spec_rescan_plain(tab_cpu, c_cpu, mixed)
                    torch.cuda.synchronize()
                    e_maps = max(e_maps, diff(sigma, sigma_w), diff(meet, meet_w),
                                 diff(wrapped, sigma_w))
                    e_rescan = max(e_rescan, diff(states, states_w), diff(repair, repair_w))
                    for s0 in entries:
                        entry = kstitch.entry_fold(sigma, s0)
                        got = kstitch.rescan(tab, c, entry)
                        whole = stitch.stitched_scan(tab, c, s0)
                        seq = scan_dfa.seq_states(tab, None, c.reshape(-1), s0)
                        want = kstitch.rescan_plain(tab_cpu, c_cpu, entry.cpu())
                        torch.cuda.synchronize()
                        e_rescan = max(e_rescan, diff(got, want), diff(whole.reshape(-1), seq),
                                       diff(whole, want))
                        cases += 1
                    if K:
                        all_meet.append(meet.reshape(-1).cpu())
                        never += int((meet == K).sum())
                        worst_meet = max(worst_meet, int(meet.max()))
                        worst_repair = max(worst_repair, int(repair.max()))
                        if d is not None and (int(meet.max()) > min(d, K)
                                              or int(repair.max()) > d):
                            e_maps = max(e_maps, 1)
                            print(f"  meet edges {label} K={K} C={C}: a lane met past d = {d} "
                                  f"or a repair ran past it")
                    if label.startswith("restart ab/ba") and K:
                        a, b = (int(table[0, m.charmap[ord(ch)]]) for ch in "ab")
                        starts = K * np.arange(C)
                        apart = torch.from_numpy(np.where(starts % 2 == 0, b, a))
                        if not bool((meet.cpu()[torch.arange(C), apart] == K).all()):
                            e_maps = max(e_maps, 1)
                            print(f"  meet edges {label} K={K}: a lane of the other phase met")
            scan_dfa.SPEC_CHUNK_LEN = rule
            errs["state_maps_all"] = max(errs["state_maps_all"], e_maps)
            errs["rescan_serial"] = max(errs["rescan_serial"], e_rescan)
            flat_meet = torch.cat(all_meet).to(torch.float64)
            print(f"  meet edges {label}: table {table.shape}, d={d}, K in 0, 1, 2, 6, 7, 8, 68 "
                  f"(sub-chunks of 7) and 300 (the rule), C in 1, 3, 64; meet positions: mean "
                  f"{float(flat_meet.mean())}, largest {worst_meet}, {never} of "
                  f"{flat_meet.numel()} lanes never met; largest repair {worst_repair}; "
                  f"max_abs_err state_maps_all {e_maps}, rescan_serial {e_rescan}")
            if e_maps or e_rescan:
                raise AssertionError(f"stitch for any table, {label}: a kernel disagrees with "
                                     f"its twin, or the stitched scan with the sequential one")
    finally:
        scan_dfa.SPEC_CHUNK_LEN = rule
    return cases


def check_sweep_edges(dev, errs, variants_lib=None):
    """The grouped die sweeps (``wwl_sweep_at``, ``wwl_sweep_all``) against
    their twins, bit for bit, on seeded planes: d = 0, 1, 12 and 39 (walks
    that die at k = 0, inside and past a group, and not at all), the dense
    and the quotient form, crossing bits on and off, starts sorted, unsorted,
    repeated, negative, at and past L, and slot counts off a warp.  With
    ``variants_lib`` (``bench/scan_variants.py``), every design of the A/B
    too.  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.bench import scan_variants
    from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl

    rng = np.random.default_rng(SEED + 14)
    id_bits, depth_bits, S = 10, 6, 1000
    to64 = lambda t: t.to(torch.int64)
    cases = 0
    for d in (0, 1, 12, 39):
        for quotient in (False, True):
            for cross in (False, True):
                n = 5_000 + 37 * d
                depth = rng.integers(0, d + 3, size=n)
                v = (rng.integers(0, S, size=n) | depth << id_bits
                     | rng.integers(0, 2, size=n) << (id_bits + depth_bits)
                     | rng.integers(0, 2, size=n) << (id_bits + depth_bits + 1))
                plane = torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(dev).view(
                    torch.uint32)
                outrows = torch.from_numpy(rng.integers(0, 6, size=(S, 8)).astype(np.int32)).to(
                    dev)
                entry = rows_flat = None
                if quotient:
                    entry = torch.from_numpy(rng.integers(0, 3 * S, size=n).astype(np.int32)).to(
                        dev)
                    rows_flat = torch.from_numpy(rng.integers(0, S, size=3 * S).astype(
                        np.int32)).to(dev)
                live = n - (d + 1)
                srt = np.sort(rng.integers(0, live, size=3_001))
                odd = np.concatenate([rng.permutation(srt), srt[:40], [-7, -1, live - 1, live,
                                                                        live + 3, n + 100]])
                kw = dict(d=d, id_bits=id_bits, depth_bits=depth_bits, cross=cross)
                for label, st_np in (("sorted", srt), ("unsorted, repeated, outside", odd)):
                    st = torch.from_numpy(st_np.astype(np.int32)).to(dev)
                    args = (plane, entry, rows_flat, outrows, st)
                    want = kwwl.wwl_sweep_at_plain(*args, **kw)
                    got = [kwwl.wwl_sweep_at(*args, **kw)]
                    every = kwwl.wwl_sweep_all(*args[:4], live, **kw)
                    every_twin = kwwl.wwl_sweep_all_plain(*args[:4], live, **kw)
                    if variants_lib is not None:
                        cell = (*args, len(st_np), d, id_bits, depth_bits, cross)
                        for g in (0, *scan_variants.SWEEP_GROUPS):
                            for staged in (False,) if g == 0 else (False, True):
                                got.append(kwwl._empty_outcomes(len(st_np), dev, cross))
                                scan_variants.sweep_launch(variants_lib, g, staged, cell,
                                                           got[-1])()
                    torch.cuda.synchronize()
                    e = max(max(int((to64(a) - to64(b)).abs().max()) for a, b in zip(g, want))
                            for g in got)
                    e_all = max(int((to64(a) - to64(b)).abs().max())
                                for a, b in zip(every, every_twin))
                    errs["wwl_sweep_at"] = max(errs["wwl_sweep_at"], e)
                    errs["wwl_sweep_all"] = max(errs["wwl_sweep_all"], e_all)
                    cases += 1
                    if e or e_all:
                        raise AssertionError(
                            f"sweep edge d={d} {'quotient' if quotient else 'dense'} cross={cross}"
                            f" {label}: max_abs_err={e}, every position {e_all}")
        print(f"  sweep edge d={d}: dense and quotient, cross on and off, sorted and unsorted / "
              f"repeated / outside starts, every position: kernel == twin"
              + (f" ({len(got) - 1} A/B designs too)" if variants_lib is not None else ""))
    return cases


class _NeverDense:
    """A thresholder that keeps every row compressed (the quotient layout)."""

    def is_over_threshold(self, size, lo, hi):
        return False


def check_probe_kernels(dev, errs, max_err):
    """The four probe kernels against their plain twins on the card, bit for
    bit: every ``pl.pallas_call`` site of ``tools/probes/`` at the JAX
    probes' own sizes, ``chain_gather`` in every placement its table fits."""
    import torch

    from ahocorasick_tpu_torch.kernels import probes as kp
    from ahocorasick_tpu_torch.probes import tensor

    rs = np.random.RandomState(SEED)

    def draw(high, shape):
        return tensor(rs.randint(0, high, shape, np.int32), dev)

    def check(name, label, plain, runs):
        want = plain()
        for where, run in runs:
            got = run()
            torch.cuda.synchronize()
            e = max_err((got,), (want,))
            errs[name] = max(errs[name], e)
            print(f"  {name} {label} [{where}]: max_abs_err={e}")
            if e:
                raise AssertionError(f"{name} {label} [{where}]: kernel disagrees with its twin")

    def chain(label, tab, idx, reps, op, **kw):
        T = tab.numel()
        fits = [p for p in kp.PLACEMENTS
                if not (p == "shfl" and T > 128) and not (p == "shared" and 4 * T > kp.SHARED_BYTES)]
        check("chain_gather", label, lambda: kp.chain_gather_plain(tab, idx, reps, op, **kw),
              [(p, lambda p=p: kp.chain_gather(tab, idx, reps, op, placement=p, **kw))
               for p in fits])

    chain("probe.py:70 T=128 B=512 reps=2048", draw(128, (8, 128))[0], draw(128, (512, 128)),
          2048, "add")
    chain("probe3.py:105 T=128 B=512 reps=2048, + r, summed", draw(128, (8, 128))[0],
          draw(128, (512, 128)), 2048, "add_r", sum_out=True)
    for T, reps, B in ((4096, 256, 256), (32768, 64, 128)):
        chain(f"probe.py:103 T={T} B={B} reps={reps}", draw(T, (T,)), draw(T, (B, 128)), reps,
              "add")
    for S, K in ((4096, 8), (262144, 16)):
        chain(f"probe.py:129 S={S} K={K} reps=4096", draw(S, (S,)), draw(S, (K,)), 4096, "load")
    chain("probe.py:239 T=1 Mi B=512 reps=64", draw(1 << 20, (1 << 20,)),
          draw(1 << 20, (512, 128)), 64, "add")
    for T, reps in ((4096, 4096), (32768, 512), (131072, 128)):
        chain(f"probe2.py:39 T={T} B=512 reps={reps}, + r", draw(T, (T,)), draw(T, (512, 128)),
              reps, "add_r")
    for T, B, reps in ((1024, 512, 1024), (4096, 512, 512), (16384, 256, 128)):
        chain(f"probe3.py:77 T={T} B={B} reps={reps}, + r, summed", draw(T, (T,)),
              draw(T, (B, 128)), reps, "add_r", sum_out=True)
    S, A = 51200, 32  # probe6's uint32 table, flat and as rows
    flat = tensor(rs.randint(0, S * A, S * A).astype(np.uint32), dev)
    idx0 = draw(S, (8, 128))
    chain("probe6.py:132/:142 S*A=1,638,400 uint32, 1,024 chains, 64 steps", flat, idx0, 64,
          "load_mod", mod=S)
    tab, s0 = draw(4096, (4096, 128)), draw(4096, (4,))
    check("row_chain", "probe.py:160 (4096, 128) K=4 reps=2048",
          lambda: kp.row_chain_plain(tab, s0, 2048, "max", 4096),
          [("global", lambda: kp.row_chain(tab, s0, 2048, "max", 4096))])
    rows = flat.reshape(S, A)
    check("row_chain", "probe6.py:152 (51200, 32) uint32, 1,024 chains, 64 steps",
          lambda: kp.row_chain_plain(rows, idx0, 64, "col0", S),
          [("global", lambda: kp.row_chain(rows, idx0, 64, "col0", S))])
    tabf = kp.onehot_table(tensor(rs.randint(0, 2048, (2048, 128)).astype(np.float32), dev))
    idx = draw(2048, (1024, 128))
    check("onehot_mma", "probe.py:192 T=2048 B=1024 reps=128",
          lambda: kp.onehot_mma_plain(tabf, idx, 128),
          [("shared, wgmma", lambda: kp.onehot_mma(tabf, idx, 128))])
    t8, i8 = draw(100, (8, 128)), draw(8, (8, 128))
    check("gather2d", "probe2.py:56 sublane, once", lambda: kp.gather2d_plain(t8, i8, 1, "sublane"),
          [("shared", lambda: kp.gather2d(t8, i8, 1, "sublane"))])
    t8, ib = draw(1024, (8, 128)), draw(1024, (512, 128))
    for mode, label, summed in (("gather2d_first", "probe2.py:86 first tile, B=512 reps=1024",
                                 False),
                                ("gather2d_all", "probe3.py:142 every tile, + r, summed, B=512 "
                                 "reps=1024", True)):
        check("gather2d", label,
              lambda: kp.gather2d_plain(t8, ib, 1024, mode, mask=1023, sum_out=summed),
              [("shared", lambda: kp.gather2d(t8, ib, 1024, mode, mask=1023, sum_out=summed))])
    wide = tensor(rs.randint(0, S * A, (8, 128)).astype(np.uint32), dev)
    check("gather2d", "probe6.py:162 sublane chain on a 128-column table, 64 steps",
          lambda: kp.gather2d_plain(wide, idx0, 64, "sublane_chain"),
          [("shared", lambda: kp.gather2d(wide, idx0, 64, "sublane_chain"))])


def check_row_edges(dev, errs):
    """``row_chain`` against its twin, bit for bit, in both reduce forms: at
    every residency-sweep size (the sweep's tables and chain shape, 65,536
    chains x 524 steps; the max form at the rule's group, the column-0 form
    one lane a chain); and at widths 1, 27, 28, 33 and 128 at every group
    size, on full-range words (0xFFFFFFFF included) read as int32 and as
    uint32, with the table's base 16-byte aligned and one word off (the
    4-byte path for any width), starts up to twice the rows (the clamp), mod
    1, the rows and 2**32 - 1.  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.kernels import probes as kp
    from ahocorasick_tpu_torch.probes import __main__ as probes_main

    def diff(got, want):
        if got.shape != want.shape:
            return 1
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    cases, e_all = 0, 0
    gen = torch.Generator(device=dev).manual_seed(probes_main.SEED + 1)
    steps, words = probes_main.SWEEP_STEPS, probes_main.ROW_WORDS
    for n in probes_main.SWEEP_SIZES:
        rows = max(n // words, 1)
        tab = torch.zeros((rows, words), dtype=torch.int32, device=dev)
        tab[:, 0] = probes_main.cycle_table(rows, dev, gen)
        s0 = torch.randint(0, rows, (probes_main.SWEEP_CHAINS,), generator=gen, device=dev,
                           dtype=torch.int32)
        for reduce in kp.REDUCES:
            got = kp.row_chain(tab, s0, steps, reduce, rows)
            e = diff(got, kp.row_chain_plain(tab, s0, steps, reduce, rows))
            e_all, cases = max(e_all, e), cases + 1
        del tab
    rng = np.random.default_rng(SEED + 22)
    for width in (1, 27, 28, 33, 128):
        rows = 1000
        w = rng.integers(0, 1 << 32, rows * width + 4, dtype=np.uint64).astype(np.uint32)
        w[::97] = 0xFFFFFFFF
        buf = torch.from_numpy(w.view(np.int32)).to(dev)
        s0 = torch.from_numpy(rng.integers(0, 2 * rows, 777).astype(np.int32)).to(dev)
        for offset in (0, 1):
            for as_uint in (False, True):
                tab = buf[offset: offset + rows * width].view(rows, width)
                tab = tab.view(torch.uint32) if as_uint else tab
                for mod in (1, rows, (1 << 32) - 1):
                    for reduce, groups in (("max", kp.ROW_GROUPS), ("col0", (1,))):
                        want = kp.row_chain_plain(tab, s0, 37, reduce, mod)
                        for g in groups:
                            e = diff(kp.row_chain(tab, s0, 37, reduce, mod, group=g), want)
                            e_all, cases = max(e_all, e), cases + 1
                            if e:
                                print(f"  row edges: width {width}, offset {offset} words, "
                                      f"{'uint32' if as_uint else 'int32'}, mod {mod}, {reduce}, "
                                      f"group {g}: max_abs_err {e}")
    torch.cuda.synchronize()
    errs["row_chain"] = max(errs["row_chain"], e_all)
    if e_all:
        raise AssertionError("row_chain: a kernel result disagrees with its twin at its edges")
    return cases


CHAIN_EDGE_T = {"shfl": (1, 2, 127, 128), "shared": (129, 1816, 1817, 4096, 57344, 58112)}
CHAIN_EDGE_N = (1, 31, 33, 65537)
CHAIN_EDGE_REPS = (0, 1, 524)


def check_chain_edges(dev, errs):
    """``chain_gather`` against its twin, bit for bit: every op in every
    placement its table fits, at T = 1, 2, 127 and 128 (registers, shared,
    global) and 129, 1,816, 1,817, 4,096, 57,344 and 58,112 (shared: 32, 16,
    8 and 1 copies; global), the add ops at the powers of two among them,
    ``load_mod`` with mod 1 and mod T; at n = 1, 31, 33 and 65,537 chains,
    reps 0, 1 and 524, with and without ``sum_out``; on tables whose entries
    are half below T and half any 32-bit word (values >= 256 and >= T: the
    load op's clamp and its full last value), from starts below 2 T and of
    any 32-bit word.  The chains are independent, so the twin runs once on
    all 65,537 starts: the first n of its values are the twin of n chains,
    and their sum modulo 2**32 its ``sum_out``.  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.kernels import probes as kp

    rng = np.random.default_rng(SEED + 23)
    M = 0xFFFFFFFF
    errs_at = []  # (case, max_abs_err on the card): one synchronisation at the end
    for home, sizes in CHAIN_EDGE_T.items():
        places = kp.PLACEMENTS[kp.PLACEMENTS.index(home):]
        for T in sizes:
            w = np.where(rng.random(T) < 0.5, rng.integers(0, T, T),
                         rng.integers(0, 1 << 32, T)).astype(np.uint32)
            tab = torch.from_numpy(w.view(np.int32)).to(dev)
            x = np.where(rng.random(max(CHAIN_EDGE_N)) < 0.8,
                         rng.integers(0, 2 * T, max(CHAIN_EDGE_N)),
                         rng.integers(0, 1 << 32, max(CHAIN_EDGE_N))).astype(np.uint32)
            starts = torch.from_numpy(x.view(np.int32)).to(dev)
            ops = [("load", None), ("load_mod", 1), ("load_mod", T)]
            if T & (T - 1) == 0:
                ops = [("add", None), ("add_r", None), *ops]
            for op, mod in ops:
                for reps in CHAIN_EDGE_REPS:
                    twin = kp.chain_gather_plain(tab, starts, reps, op, mod=mod).to(torch.int64) & M
                    for n in CHAIN_EDGE_N:
                        for summed in (False, True):
                            want = (twin[:n].sum() & M).reshape(()) if summed else twin[:n]
                            for p in places:
                                got = kp.chain_gather(tab, starts[:n], reps, op, placement=p,
                                                      mod=mod, sum_out=summed)
                                e = ((got.to(torch.int64) & M) - want).abs().max() \
                                    if got.shape == want.shape else torch.ones((), device=dev)
                                errs_at.append(((T, op, mod, n, reps, summed, p), e))
    e_case = torch.stack([e.to(torch.int64) for _, e in errs_at]).cpu().tolist()
    e_all = max(e_case)
    for (case, _), e in zip(errs_at, e_case):
        if e:
            print("  chain edges: T {}, {} mod {}, n {}, reps {}, sum_out {}, {}: max_abs_err "
                  "{}".format(*case, e))
    errs["chain_gather"] = max(errs["chain_gather"], e_all)
    if e_all:
        raise AssertionError("chain_gather: a kernel result disagrees with its twin at its edges")
    return len(errs_at)


V1_PASS = 528 * 512  # one pass of the v1 walk's grid on an H100 (132 SMs x 4 blocks of 512)
G2_EDGES = {"B": (8, 16, 64, 512), "reps": (0, 1, 2, 1024), "mask": (0, 1023, 0xFFFFFFFF)}


def check_gather2d_edges(dev, errs):
    """``gather2d`` against its twin, bit for bit: every mode at B = 8, 16,
    64 and 512 rows (``gather2d_shape``: 8 rows a block down to one), reps 0,
    1, 2 and 1,024, masks 0, 1,023 and 2**32 - 1 (the sublane modes take no
    mask), with and without ``sum_out``, and at 512 rows on an index tensor
    4 bytes off a 16-byte boundary; a table half below 1,024 and half any
    32-bit word, indices likewise.  Rows never exchange, so the twin runs
    once on 512 rows: its first B rows are the twin of B rows, and their sum
    modulo 2**32 its ``sum_out``.  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.kernels import probes as kp

    rng = np.random.default_rng(SEED + 24)
    M = 0xFFFFFFFF
    rows = max(G2_EDGES["B"])

    def words(shape):
        a = np.where(rng.random(shape) < 0.5, rng.integers(0, 1024, shape),
                     rng.integers(0, 1 << 32, shape)).astype(np.uint32)
        return torch.from_numpy(a.view(np.int32)).to(dev)

    tab, idx = words((8, 128)), words((rows, 128))
    shifted = torch.empty(rows * 128 + 1, dtype=torch.int32, device=dev)[1:].view(rows, 128)
    shifted.copy_(idx)
    errs_at = []  # (case, max_abs_err on the card): one synchronisation at the end
    for mode in kp.G2_MODES:
        masks = G2_EDGES["mask"] if mode.startswith("gather2d") else (0,)
        for reps in G2_EDGES["reps"]:
            for mask in masks:
                twin = kp.gather2d_plain(tab, idx, reps, mode, mask=mask).to(torch.int64) & M
                for B, x in [*((B, idx[:B]) for B in G2_EDGES["B"]), ("512, 4 B off", shifted)]:
                    n = rows if isinstance(B, str) else B
                    for summed in (False, True):
                        want = (twin[:n].sum() & M).reshape(()) if summed else twin[:n]
                        got = kp.gather2d(tab, x, reps, mode, mask=mask, sum_out=summed)
                        e = ((got.to(torch.int64) & M) - want).abs().max() \
                            if got.shape == want.shape else torch.ones((), device=dev)
                        errs_at.append(((mode, B, reps, mask, summed), e))
    e_case = torch.stack([e.to(torch.int64) for _, e in errs_at]).cpu().tolist()
    e_all = max(e_case)
    for (case, _), e in zip(errs_at, e_case):
        if e:
            print("  gather2d edges: {}, B {}, reps {}, mask {}, sum_out {}: max_abs_err "
                  "{}".format(*case, e))
    errs["gather2d"] = max(errs["gather2d"], e_all)
    if e_all:
        raise AssertionError("gather2d: a kernel result disagrees with its twin at its edges")
    return len(errs_at)


def synthetic_trie(rng, S: int, A: int, live: float, match: float) -> tuple:
    """A seeded trie-like table ``(trie int32[S, A], is_match bool[S])``
    whose last row is an absorbing dead state that emits nothing: each other
    entry goes to a random live state with probability ``live`` (class 0,
    ``PAD_CLASS``, never), else to the dead state; each live state matches
    with probability ``match``."""
    dead = S - 1
    trie = np.where(rng.random((S, A)) < live, rng.integers(0, max(dead, 1), (S, A)), dead)
    trie[:, 0] = dead
    trie[dead] = dead
    is_match = rng.random(S) < match
    is_match[dead] = False
    return trie.astype(np.int32), is_match


def chain_trie(depth: int) -> tuple:
    """The trie of ``a``, ``aa``, ..., ``a * depth`` (class 1; the odd
    lengths match) with the dead state last: every walk over ``a``s runs
    to the full depth."""
    S = depth + 2
    trie = np.full((S, 2), S - 1, dtype=np.int32)
    trie[:depth, 1] = np.arange(1, depth + 1)
    is_match = np.zeros(S, dtype=bool)
    is_match[1::2] = True
    is_match[S - 1] = False
    return trie, is_match


def pfac1_edge_cases(rng):
    """The PFAC v1 walk's edges: ``(label, (trie, is_match) or keywords,
    classes (int64) or text, depth, class dtype, classes off a 16-byte
    boundary)``.  Synthetic tries (``synthetic_trie``, ``chain_trie``) run
    every staged table without a dictionary build: n = 1, 31, 33, a
    block's run of starts - 1, + 0 and + 1, 65,537, and one pass of the
    grid + 1 (a second pass; ``V1_PASS`` starts); depths 4, 12, 32, 33 and
    64 (one and two planes) and 200 (seven planes); uint8, uint16 and int32
    classes; 32 classes (the two-level table), 128 and 5,000 (too many for
    it: the root read with __ldg); 300,000 states.  Dictionary cases,
    where the v2 walk's ranked table exists too: the fuzz dictionary,
    ``a``..``a * 64`` with it over int32 classes, and uint16 classes off a
    16-byte boundary."""
    from ahocorasick_tpu_torch.kernels import scan_pfac as kpf

    tile = kpf.V1_THREADS
    small = synthetic_trie(rng, 4096, 32, 0.75, 0.3)
    soup = lambda n, A: rng.integers(1, A, n)  # noqa: E731
    cases = []
    for n in (1, 31, 33, tile - 1, tile, tile + 1, 65537, V1_PASS + 1):
        cases.append((f"32 classes, n={n}", small, soup(n, 32), 12, "uint8", False))
    for d in (4, 12, 32, 33, 64):
        cases.append((f"32 classes, depth {d}", synthetic_trie(rng, 4096, 32, 0.93, 0.3),
                      soup(tile + 1, 32), d, "uint8", False))
    cases.append(("a..a^200 over a * 9,000 (seven planes)", chain_trie(200),
                  np.ones(9000, dtype=np.int64), 200, "uint8", False))
    cases.append(("a..a^64 over a * 9,000, int32", chain_trie(64), np.ones(9000, dtype=np.int64),
                  64, "int32", False))
    cases.append(("32 classes, uint16, 4 B off", small, soup(20001, 32), 33, "uint16", True))
    cases.append(("32 classes, int32, 4 B off", small, soup(20001, 32), 12, "int32", True))
    cases.append(("128 classes (no two-level table)", synthetic_trie(rng, 4096, 128, 0.85, 0.3),
                  soup(30000, 128), 33, "uint8", False))
    cases.append(("5,000 classes (the root read with __ldg)", synthetic_trie(rng, 64, 5000, 0.8,
                                                                             0.3),
                  soup(30000, 5000), 12, "uint16", False))
    cases.append(("300,000 states", synthetic_trie(rng, 300_000, 32, 0.9, 0.3),
                  soup(65537, 32), 32, "uint8", False))
    fuzz = fuzz_keywords(rng, "abcdef", 60, 8)
    text = lambda n, alpha="abcdefg ": "".join(rng.choice(list(alpha), size=n))  # noqa: E731
    cases.append(("fuzz dictionary", fuzz, text(tile * 3 + 5), None, "uint8", False))
    cases.append(("a..a^64 + fuzz, int32", ["a" * i for i in range(1, 65)] + fuzz,
                  text(20001, "aaaaaaab "), 64, "int32", False))
    cases.append(("fuzz, uint16, 4 B off", fuzz, text(9001), None, "uint16", True))
    return cases


def check_pfac1_edges(dev, errs):
    """The PFAC v1 kernel (``pfac1_planes``) against its twin, bit for bit,
    at ``pfac1_edge_cases``, and against the v2 kernel's planes where the
    case is a dictionary; prints each case's plan.  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.core.compiler import compile_matcher
    from ahocorasick_tpu_torch.kernels import scan_pfac as kpf
    from ahocorasick_tpu_torch.models import matchers
    from ahocorasick_tpu_torch.ops import scan_pfac
    from ahocorasick_tpu_torch.utils.lanes import bucket_depth

    M = 0xFFFFFFFF
    errs_at, plans = [], set()
    for label, table, cls, depth, dtype, shifted in pfac1_edge_cases(
            np.random.default_rng(SEED + 25)):
        v2 = None
        if isinstance(table, list):  # a dictionary: its tables, as the matcher holds them
            m = compile_matcher(table, "ac", True)
            tabs = matchers._DeviceTables(m, dev)
            depth = bucket_depth(m.max_depth) if depth is None else depth
            units = np.frombuffer(cls.encode("utf-16-le"), dtype=np.uint16)
            cls = m.charmap[units]
            trie, is_match, v2 = tabs.trie_next, tabs.is_match, (tabs.ranked, m.num_classes)
        else:
            trie = torch.from_numpy(table[0]).to(dev)
            is_match = torch.from_numpy(table[1]).to(dev)
        P = (depth + 31) // 32
        arr = scan_pfac.pad_classes(cls, depth).astype(dtype)
        c_np = torch.from_numpy(arr.view(np.int16)).view(torch.uint16) if dtype == "uint16" \
            else torch.from_numpy(arr)
        if shifted:  # the same classes one element past a 16-byte boundary
            c = torch.empty(c_np.numel() + 1, dtype=c_np.dtype, device=dev)[1:]
            c.copy_(c_np.to(dev))
        else:
            c = c_np.to(dev)
        dead = trie.shape[0] - 1
        plan = kpf.pfac1_plan(c.numel() - depth, trie.shape[1],
                              kpf.sm_count(dev) if dev.type == "cuda" else 132)
        plans.add(plan.two_level)
        got = kpf.pfac1_planes(trie, is_match, c, depth, P, dead)
        want = kpf.pfac1_planes_plain(trie, is_match, c, depth, P)
        e = ((got.view(torch.int32).to(torch.int64) & M)
             - (want.view(torch.int32).to(torch.int64) & M)).abs().max()
        if v2 is not None:
            rt, A = v2
            planes2 = kpf.pfac2_planes(rt.trie_next, rt.prefix, rt.match_threshold, c, depth, P,
                                       rt.prefix_k, A, rt.dead_state)
            e = torch.maximum(e, (got.view(torch.int32).to(torch.int64)
                                  - planes2.view(torch.int32).to(torch.int64)).abs().max())
        errs_at.append(((label, c.numel() - depth, depth, dtype, tuple(plan)), e))
    e_case = torch.stack([e.to(torch.int64) for _, e in errs_at]).cpu().tolist()
    for (case, _), e in zip(errs_at, e_case):
        print("  pfac1 edge {}: n={}, depth {}, {}; plan {}: max_abs_err {}".format(*case, e))
    e_all = max(e_case)
    errs["pfac1_planes"] = max(errs["pfac1_planes"], e_all)
    if e_all:
        raise AssertionError("pfac1_planes: the kernel disagrees with its twin or v2 at its edges")
    if plans != {False, True}:
        raise AssertionError(f"pfac1 edges: the staged tables' forms {sorted(plans)} miss one")
    return len(errs_at)


ONEHOT_EDGES = {"T": (16, 64, 2048), "B": (1, 63, 65, 1024), "ncols": (32, 64, 128, 160),
                "reps": (0, 1, 128)}


def check_onehot_edges(dev, errs):
    """``onehot_mma`` against its twin, bit for bit, at T = 16, 64 and
    2,048 (every kernel instance ``onehot_slab`` picks: one warpgroup, and
    two with groups of one and of 16 k-tiles), B = 1, 63, 65 and 1,024
    rows, 32, 64, 128 and 160 columns and 0, 1 and 128 steps, on seeded
    tables of integers below 2,048 (at 64 columns 4 bytes off 16-byte
    alignment) and starts below 2 T (a first step whose column 0 lies past
    the table adds nothing).  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.kernels import probes as kp

    rng = np.random.default_rng(SEED + 24)
    errs_at = []  # (case, max_abs_err on the card): one synchronisation at the end
    for T in ONEHOT_EDGES["T"]:
        for ncols in ONEHOT_EDGES["ncols"]:
            tab_h = kp.onehot_table(torch.from_numpy(
                rng.integers(0, 2048, (T, ncols)).astype(np.float32)).to(dev))
            if ncols == 64:  # a table 4 bytes off 16-byte alignment: 2-byte staging loads
                buf = torch.empty(tab_h.numel() + 8, dtype=torch.float16, device=dev)
                buf[2: 2 + tab_h.numel()] = tab_h.reshape(-1)
                tab_h = buf[2: 2 + tab_h.numel()].view(ncols, T)
            for B in ONEHOT_EDGES["B"]:
                idx = torch.from_numpy(rng.integers(0, 2 * T, (B, ncols)).astype(np.int32)).to(dev)
                for reps in ONEHOT_EDGES["reps"]:
                    got = kp.onehot_mma(tab_h, idx, reps)
                    want = kp.onehot_mma_plain(tab_h, idx, reps)
                    e = (got.to(torch.int64) - want.to(torch.int64)).abs().max() \
                        if got.shape == want.shape else torch.ones((), device=dev)
                    errs_at.append(((T, B, ncols, reps), e))
    e_case = torch.stack([e.to(torch.int64) for _, e in errs_at]).cpu().tolist()
    e_all = max(e_case)
    for ((T, B, ncols, reps), _), e in zip(errs_at, e_case):
        if e:
            print(f"  onehot edges: T {T}, B {B}, ncols {ncols}, reps {reps}, launch "
                  f"{kp.onehot_slab(T, ncols, B)}: max_abs_err {e}")
    errs["onehot_mma"] = max(errs["onehot_mma"], e_all)
    if e_all:
        raise AssertionError("onehot_mma: a kernel result disagrees with its twin at its edges")
    return len(errs_at)


def check_fold_edges(dev, errs):
    """``entry_fold`` (speculate and repair) against its twins, bit for bit:
    the wrapper against ``entry_fold_plain``, and ``spec_fold`` (entries and
    each lane's re-folded length) against ``spec_fold_plain``, at C = 1, 2,
    31, 32, 33, P - 1, P, P + 1, 4,096 and 4,097 (P = ``FOLD_LANES``), S = 97
    and 1,024, on constant maps (no lane may be repaired), identity maps,
    uniform random maps (every guess wrong) and a mix of constant, identity,
    random and permutation maps, entered in s0 = 0 and S - 1.  Returns
    ``(cases, {kind: [lanes repaired, lanes, longest repair]})``."""
    import torch

    from ahocorasick_tpu_torch.kernels import stitch as kstitch

    P = kstitch.FOLD_LANES
    rng = np.random.default_rng(SEED + 23)

    def maps(kind, C, S):
        if kind == "constant":
            return np.repeat(rng.integers(0, S, (C, 1)), S, axis=1)
        if kind == "identity":
            return np.tile(np.arange(S), (C, 1))
        if kind == "random":
            return rng.integers(0, S, (C, S))
        pick = rng.integers(0, 4, C)
        out = rng.integers(0, S, (C, S))
        out[pick == 0] = rng.integers(0, S, (int((pick == 0).sum()), 1))
        out[pick == 1] = np.arange(S)
        for c in np.flatnonzero(pick == 2):
            out[c] = rng.permutation(S)
        return out

    cases, e_all, stats = 0, 0, {}
    for S in (97, 1024):
        for C in sorted({1, 2, 31, 32, 33, P - 1, P, P + 1, 4096, 4097}):
            for kind in ("constant", "identity", "random", "mixed"):
                sig_cpu = torch.from_numpy(maps(kind, C, S).astype(np.int32))
                sig = sig_cpu.to(dev)
                for s0 in (0, S - 1):
                    entry, repair = kstitch.spec_fold(sig, s0)
                    plain = kstitch.entry_fold(sig, s0)
                    want, want_repair = kstitch.spec_fold_plain(sig_cpu, s0)
                    twin = kstitch.entry_fold_plain(sig_cpu, s0)
                    torch.cuda.synchronize()
                    e = 0 if (torch.equal(entry.cpu(), twin) and torch.equal(plain.cpu(), twin)
                              and torch.equal(want, twin)
                              and torch.equal(repair.cpu(), want_repair)) else 1
                    if kind == "constant" and int(repair.max()):
                        e = 1
                    if e:
                        print(f"  fold edges: C={C} S={S} {kind} s0={s0}: the kernel disagrees "
                              f"with its twins (repairs {repair.tolist()[:8]}.. against "
                              f"{want_repair.tolist()[:8]}..)")
                    e_all, cases = max(e_all, e), cases + 1
                    st = stats.setdefault(kind, [0, 0, 0])
                    st[0] += int((repair > 0).sum())
                    st[1] += repair.numel()
                    st[2] = max(st[2], int(repair.max()))
    errs["entry_fold"] = max(errs["entry_fold"], e_all)
    if e_all:
        raise AssertionError("entry_fold: the kernel disagrees with its twins at its edges")
    return cases, stats


def check_pfac_kernels(label, m, cls, dev, errs, max_err):
    """The PFAC walk's three modes against their twins on the matcher's
    tables over ``cls``, bit for bit, and the v1 planes == the v2 planes;
    returns the match count."""
    import torch

    from ahocorasick_tpu_torch.kernels import scan_pfac as kpf
    from ahocorasick_tpu_torch.ops import scan_batched, scan_pfac2
    from ahocorasick_tpu_torch.utils.lanes import LANE_BUCKET, bucket_depth

    c = m.compiled
    rt = m.dev.ranked
    d = bucket_depth(c.max_depth)
    P = (d + 31) // 32
    cp = scan_batched.classes_to_device(scan_pfac2.pad_classes(cls, d, bucket=LANE_BUCKET),
                                        c.num_classes, dev)
    v2 = (rt.trie_next, rt.prefix, rt.match_threshold, cp, d)
    trie = m.dev.trie_next  # padded, the dead state last (as the JAX package's)
    v1 = (trie, m.dev.is_match, cp, d, P)
    got = (kpf.pfac2_planes(*v2, P, rt.prefix_k, c.num_classes, rt.dead_state),
           kpf.pfac2_count(*v2, rt.prefix_k, c.num_classes, rt.dead_state),
           kpf.pfac1_planes(*v1, trie.shape[0] - 1))
    want = (kpf.pfac2_planes_plain(*v2, P, rt.prefix_k, c.num_classes),
            kpf.pfac2_count_plain(*v2, rt.prefix_k, c.num_classes),
            kpf.pfac1_planes_plain(*v1))
    torch.cuda.synchronize()
    for name, g, w in zip(("pfac2_planes", "pfac2_count", "pfac1_planes"), got, want):
        e = max_err((g,), (w,))
        if name == "pfac1_planes":
            e = max(e, max_err((g,), (got[0],)))
        errs[name] = max(errs[name], e)
    print(f"  pfac {label}: {len(cls)} units, depth {d}, prefix_k {rt.prefix_k}, ranked table "
          f"{tuple(rt.trie_next.shape)}, count {int(got[1])} (twin {int(want[1])}); max_abs_err "
          f"planes v2 {errs['pfac2_planes']}, count {errs['pfac2_count']}, v1 (twin and v2) "
          f"{errs['pfac1_planes']}")
    if errs["pfac2_planes"] or errs["pfac2_count"] or errs["pfac1_planes"]:
        raise AssertionError(f"pfac {label}: a walk kernel disagrees with its twin")
    return int(got[1])


def v1_warp_efficiency(work) -> float:
    """The work of a walk's starts (``work[i]``, start i, a thread a start)
    over 32 x the sum over warps of 32 consecutive starts of each warp's
    largest."""
    import torch

    w = torch.cat([work, work.new_zeros(-work.numel() % 32)]).to(torch.int64)
    return float(w.sum()) / (32 * float(w.reshape(-1, 32).max(dim=1).values.sum()))


def pfac_edge_cases(rng):
    """The PFAC v2 walk's edge cases (``tests/test_torch_pfac_lanes.py``
    holds the same against the JAX package on the CPU): ``(label, keywords,
    text, depth or None (the bucketed max depth), class dtype, the classes
    offset by one element (unaligned), patches of kernels.scan_pfac)``.
    Text lengths around a prefix pass (B - 1, B, B + 1, B + d) and around a
    warp's span on one SM (``sm_count`` patched to 1: many passes a warp,
    the queue's ring wrapping); depths 31, 32, 33, 64, 65 and equal to
    prefix_k; every lane live to the full depth (the queue full); every lane
    dead at once; uint8, uint16 and int32 classes; classes that start off a
    16-byte boundary; a 61-class alphabet whose 4 A^k bytes do not fit
    beside the warps' areas (the __ldg branch), and a small one with
    ``SM_SMEM`` patched down to the same end; widths (threads, starts a
    lane) as the package instantiates them."""
    from ahocorasick_tpu_torch.kernels import scan_pfac as kpf

    B = 32 * kpf.PER_LANE
    one_sm = {"sm_count": lambda dev: 1}
    fuzz = fuzz_keywords(rng, "abcdef", 60, 8)
    soup = lambda n, alpha="abcdefg ": "".join(rng.choice(list(alpha), size=n))
    cases = []
    for n in (B - 1, B, B + 1, B + 8):  # d = 8: the bucketed depth
        cases.append((f"fuzz n={n} (B={B})", fuzz, soup(n), None, "uint8", False, {}))
    span = kpf.launch_shape(300_000, 1, 7 ** 3, 1).span
    for n in (span - 1, span, span + 1, span + 8, 300_000):
        cases.append((f"fuzz n={n} on one SM (span {span})", fuzz, soup(n), None, "uint8",
                      False, one_sm))
    for d in (31, 32, 33, 64, 65):
        kws = ["a" * i for i in range(1, d + 1)]
        cases.append((f"a..a^{d} over a * 5,000 (every lane live)", kws, "a" * 5000, d, "uint8",
                      False, one_sm))
        cases.append((f"a..a^{d} + fuzz over mixed text, int32", kws + fuzz,
                      soup(4001, "aaaaaaab "), d, "int32", False, {}))
    cases.append(("depth == prefix_k (2)", ["ab", "b", "ba"], soup(5000, "ab"), 2, "uint16",
                  False, {}))
    cases.append(("depth == prefix_k (3)", ["abc", "ab", "c"], soup(5000, "abc"), 3, "uint8",
                  False, {}))
    cases.append(("every lane dead", fuzz, "zzzz " * 2000, None, "uint8", False, {}))
    cases.append(("fuzz, uint16, unaligned classes", fuzz, soup(9001), None, "uint16", True,
                  one_sm))
    cases.append(("fuzz, uint8, unaligned classes", fuzz, soup(9003), None, "uint8", True, {}))
    big = [chr(0x4E00 + i) for i in range(60)]
    big_kws = sorted(set(big) | {"".join(rng.choice(big, size=int(rng.integers(2, 5))))
                                 for _ in range(300)})
    cases.append(("61 classes, the prefix read with __ldg", big_kws,
                  "".join(rng.choice(big + [" "], size=9000)), None, "uint8", False, one_sm))
    cases.append(("fuzz, SM_SMEM 60,000 (the prefix read with __ldg)", fuzz, soup(9000), None,
                  "uint8", False, {"SM_SMEM": 60_000}))
    deep = ["a" * i for i in range(1, 70)] + ["ab", "ba"]
    cases.append(("a..a^69 + ab, ba, three planes", deep, "a" * 3000 + "ab" * 800, None,
                  "uint8", False, one_sm))
    return cases


def check_pfac_edges(dev, errs):
    """The PFAC v2 kernels (``pfac2_planes``, ``pfac2_count``) against their
    twins on CPU copies, bit for bit, at ``pfac_edge_cases``; the count ==
    the popcount of the planes.  Returns the cases."""
    import torch

    from ahocorasick_tpu_torch.core.compiler import compile_matcher
    from ahocorasick_tpu_torch.kernels import scan_pfac as kpf
    from ahocorasick_tpu_torch.kernels.scan_block import _popcount32, _widen
    from ahocorasick_tpu_torch.models import matchers
    from ahocorasick_tpu_torch.ops import scan_pfac
    from ahocorasick_tpu_torch.utils.lanes import bucket_depth

    cases = pfac_edge_cases(np.random.default_rng(SEED + 21))
    for label, kws, text, depth, dtype, shifted, patch in cases:
        m = compile_matcher(kws, "ac", True)
        rt = matchers._DeviceTables(m, dev).ranked
        rt_cpu = rt._replace(trie_next=rt.trie_next.cpu(), prefix=rt.prefix.cpu())
        d = bucket_depth(m.max_depth) if depth is None else depth
        P = (d + 31) // 32
        units = np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)
        arr = scan_pfac.pad_classes(m.charmap[units], d).astype(dtype)
        c_cpu = (torch.from_numpy(arr.view(np.int16)).view(torch.uint16) if dtype == "uint16"
                 else torch.from_numpy(arr))
        if shifted:  # the same classes one element past a 16-byte boundary
            c = torch.empty(c_cpu.numel() + 1, dtype=c_cpu.dtype, device=dev)[1:]
            c.copy_(c_cpu.to(dev))
        else:
            c = c_cpu.to(dev)
        v2 = (rt.match_threshold, c, d)
        saved = {k: getattr(kpf, k) for k in patch}
        try:
            for k, v in patch.items():
                setattr(kpf, k, v)
            shape = kpf.launch_shape(c.numel() - d, c.element_size(), rt.prefix.numel(),
                                     kpf.sm_count(dev) if dev.type == "cuda" else 132)
            planes = kpf.pfac2_planes(rt.trie_next, rt.prefix, *v2, P, rt.prefix_k,
                                      m.num_classes, rt.dead_state)
            count = kpf.pfac2_count(rt.trie_next, rt.prefix, *v2, rt.prefix_k, m.num_classes,
                                    rt.dead_state)
            torch.cuda.synchronize()
        finally:
            for k, v in saved.items():
                setattr(kpf, k, v)
        want = kpf.pfac2_planes_plain(rt_cpu.trie_next, rt_cpu.prefix, rt.match_threshold,
                                      c_cpu, d, P, rt.prefix_k, m.num_classes)
        want_count = int(kpf.pfac2_count_plain(rt_cpu.trie_next, rt_cpu.prefix,
                                               rt.match_threshold, c_cpu, d, rt.prefix_k,
                                               m.num_classes))
        got = planes.cpu()
        e_planes = (int((_widen(got) - _widen(want)).abs().max())
                    if got.shape == want.shape else 1)
        pop = int(_popcount32(_widen(got)).sum())
        e_count = max(abs(int(count) - want_count), abs(pop - want_count))
        errs["pfac2_planes"] = max(errs["pfac2_planes"], e_planes)
        errs["pfac2_count"] = max(errs["pfac2_count"], e_count)
        print(f"  pfac edge {label}: n={c.numel() - d}, depth {d}, k {rt.prefix_k}, "
              f"{m.num_classes} classes, {dtype}; shape {tuple(shape)}; count {int(count)} "
              f"(twin {want_count}, popcount {pop}); max_abs_err planes {e_planes}, count "
              f"{e_count}")
        if e_planes or e_count:
            raise AssertionError(f"pfac edge {label}: a v2 kernel disagrees with its twin")
    return len(cases)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    import ahocorasick_tpu_torch as port
    from ahocorasick_tpu_torch import convert
    from ahocorasick_tpu_torch.core import gold
    from ahocorasick_tpu_torch.core import stream as stream_mod
    from ahocorasick_tpu_torch.core.compiler import compile_matcher
    from ahocorasick_tpu_torch.kernels import build, compact, scan_block, scan_dfa
    from ahocorasick_tpu_torch.kernels import scan_batched as khuge
    from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl
    from ahocorasick_tpu_torch.kernels import stitch as kstitch
    from ahocorasick_tpu_torch.kernels import scan_rowdfa as krow
    from ahocorasick_tpu_torch.kernels import table_sharded as ktp
    from ahocorasick_tpu_torch.kernels import probes as kprobe
    from ahocorasick_tpu_torch.kernels import scan_pfac as kpfac
    from ahocorasick_tpu_torch.probes import __main__ as probes_main
    from ahocorasick_tpu_torch.probes import probe_wwl_fused
    from ahocorasick_tpu_torch.native import build as native_build
    from ahocorasick_tpu_torch.native import lib as native_lib
    from ahocorasick_tpu_torch import bench, graft_entry
    from ahocorasick_tpu_torch.bench import __main__ as bench_main
    from ahocorasick_tpu_torch.bench import headline, scan_variants
    from ahocorasick_tpu_torch.bench.scan_variants import one_m_keywords
    from ahocorasick_tpu_torch.bench.__main__ import english_like_keywords
    from ahocorasick_tpu_torch.bench.__main__ import word_soup as bench_word_soup
    from ahocorasick_tpu_torch.bench.headline import make_dictionary
    from ahocorasick_tpu_torch.ops import dispatch, scan_batched, scan_pfac, scan_pfac2
    from ahocorasick_tpu_torch.ops import scan_wwl, stitch
    from ahocorasick_tpu_torch.utils.lanes import LANE_BUCKET, bucket_depth
    from ahocorasick_tpu_torch.parallel import corpus, sharding
    from ahocorasick_tpu_torch.resolve.wholeword import follow_chain, word_starts
    from ahocorasick_tpu_torch.utils import chartables

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. The card.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # 2. Build (the A/B harness's variants in a thread beside the package's
    # kernels: both are nvcc processes).
    t0 = time.perf_counter()
    variants_build = concurrent.futures.ThreadPoolExecutor(1).submit(
        build.build, (scan_variants.SOURCE,), scan_variants.STEM)
    path = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({path})")
    t0 = time.perf_counter()
    native_path = native_build.build()  # raises if g++ fails: no numpy stand-in here
    if not native_lib.available():
        raise RuntimeError("the port's native host library did not load")
    print(f"native build: {time.perf_counter() - t0:.2f} s ({native_path})")
    variants_path = variants_build.result()  # raises if nvcc failed
    for lib_path in (path, variants_path):
        with open(lib_path[: -len(".so")] + ".log") as fh:
            for line in fh.read().splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}")

    def cuda_ms(fn, reps, queued=False):
        """ms per call of ``reps`` calls back to back; ``queued``: the calls
        queued behind a sleep long enough for the host to enqueue them all
        (about 0.2 ms a call at 2 GHz), so the card's time alone."""
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(400_000 * reps)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def windows(m, cls, chunk):
        pd = m.dev.packed_dfa
        w = scan_batched.chunk_classes(cls, chunk, pd.halo, m.compiled.num_classes)
        return scan_batched.classes_to_device(w, m.compiled.num_classes, dev)

    def widen(planes):
        return planes.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    errs = dict.fromkeys(KERNELS, 0)

    def check_compact(label, bits):
        got = compact.compact_planes(bits)
        want = compact.compact_planes_plain(bits)
        torch.cuda.synchronize()
        k = int(want[0])
        e = abs(int(got[0]) - k)
        if got[1].shape != want[1].shape or got[2].shape != want[2].shape:
            e = max(e, 1)
        elif k:
            e = max(e, int((got[1] - want[1]).abs().max()),
                    int((widen(got[2]) - widen(want[2])).abs().max()))
        errs["compact_planes"] = max(errs["compact_planes"], e)
        print(f"  compact {label}: P={bits.shape[0]} N={bits.shape[1]} hot={int(got[0])} "
              f"twin={k} max_abs_err={e}")
        if e:
            raise AssertionError(f"compact {label}: kernel disagrees with its plain twin")
        return k

    def check(label, m, cls, chunk):
        pd = m.dev.packed_dfa
        w = windows(m, cls, chunk)
        args = (pd.table, w, pd.halo, pd.state_bits)
        kc = int(scan_block.packed_scan_count(*args))
        pc = int(scan_block.packed_scan_count_plain(*args))
        planes = scan_block.packed_scan_planes(*args)
        kp = widen(planes)
        pp = widen(scan_block.packed_scan_planes_plain(*args))
        torch.cuda.synchronize()
        e_count = abs(kc - pc)
        e_planes = int((kp - pp).abs().max())
        errs["packed_scan_count"] = max(errs["packed_scan_count"], e_count)
        errs["packed_scan_planes"] = max(errs["packed_scan_planes"], e_planes)
        print(f"  {label}: B={w.shape[0]} W={w.shape[1]} halo={pd.halo} "
              f"{str(w.dtype).replace('torch.', '')} count={kc} twin={pc} "
              f"planes max_abs_err={e_planes}")
        if e_count or e_planes:
            raise AssertionError(f"{label}: kernel disagrees with its plain twin")
        check_compact(label, planes)
        return kc

    rowdfa_ms = {}  # dictionary label: kernel, twin and packed-kernel ms at the main shape

    def check_rowdfa(label, m, cls, chunk, timed=False):
        """The stride-2 kernels against their twins and against the packed
        kernels on the same text, bit for bit; with ``timed``, ms per launch
        of each beside the packed kernels in the same run."""
        t_build = time.perf_counter()
        rd = m.dev.row_dfa
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t_build
        pd = m.dev.packed_dfa
        nc = m.compiled.num_classes
        w2 = scan_batched.classes_to_device(
            scan_batched.chunk_classes(cls, chunk, rd.halo, nc), nc, dev)
        w1 = windows(m, cls, chunk)
        a2 = (rd.table, w2, rd.halo, rd.state_bits, rd.num_classes)
        a1 = (pd.table, w1, pd.halo, pd.state_bits)
        kc, pc = int(krow.rowdfa2_count(*a2)), int(krow.rowdfa_count_plain(*a2))
        packed_c = int(scan_block.packed_scan_count(*a1))
        kp = widen(krow.rowdfa2_planes(*a2))
        pp = widen(krow.rowdfa_emit_planes_plain(*a2))
        packed_p = widen(scan_block.packed_scan_planes(*a1))
        torch.cuda.synchronize()
        e_count = max(abs(kc - pc), abs(kc - packed_c))
        e_planes = max(int((kp - pp).abs().max()), int((kp - packed_p).abs().max()))
        errs["rowdfa2_count"] = max(errs["rowdfa2_count"], e_count)
        errs["rowdfa2_planes"] = max(errs["rowdfa2_planes"], e_planes)
        print(f"  rowdfa2 {label}: table {tuple(rd.table.shape)} ({rd.table.nbytes} B), "
              f"B={w2.shape[0]} W={w2.shape[1]} halo={rd.halo} (packed {pd.halo}) "
              f"{str(w2.dtype).replace('torch.', '')} state_bits={rd.state_bits} depth "
              f"{m.compiled.max_depth}; count={kc} twin={pc} packed={packed_c}; planes "
              f"max_abs_err={e_planes} (twin and packed)")
        if e_count or e_planes:
            raise AssertionError(f"rowdfa2 {label}: kernel disagrees with its twin or the packed "
                                 f"kernel")
        if timed:
            rowdfa_ms[label] = {
                "rowdfa2_count": cuda_ms(lambda: krow.rowdfa2_count(*a2), 20),
                "packed_scan_count": cuda_ms(lambda: scan_block.packed_scan_count(*a1), 20),
                "rowdfa2_planes": cuda_ms(lambda: krow.rowdfa2_planes(*a2), 20),
                "packed_scan_planes": cuda_ms(lambda: scan_block.packed_scan_planes(*a1), 20),
                "rowdfa2_count twin": cuda_ms(lambda: krow.rowdfa_count_plain(*a2), 2),
                "rowdfa2_planes twin": cuda_ms(lambda: krow.rowdfa_emit_planes_plain(*a2), 2),
                "table_bytes": rd.table.nbytes, "shape": tuple(w2.shape), "args": a2}
            t = rowdfa_ms[label]
            print(f"  time rowdfa2 {label} at {tuple(w2.shape)} windows: count "
                  f"{t['rowdfa2_count']} ms [packed_scan_count {t['packed_scan_count']} ms] = "
                  f"{t['rowdfa2_count'] / t['packed_scan_count']} x; planes "
                  f"{t['rowdfa2_planes']} ms [packed_scan_planes {t['packed_scan_planes']} ms] = "
                  f"{t['rowdfa2_planes'] / t['packed_scan_planes']} x; twins "
                  f"{t['rowdfa2_count twin']} / {t['rowdfa2_planes twin']} ms; the table's "
                  f"host build and upload (first use) {t_build * 1e3} ms [{smi}]")
        return kc

    def check_shortest(label, tabs, cls):
        c = scan_batched.classes_to_device(cls, tabs._m.num_classes, dev)
        got = scan_dfa.shortest_states(tabs.dfa_next, tabs.match_len, c)
        t = time.perf_counter()
        want = scan_dfa.shortest_states_plain(tabs.dfa_next, tabs.match_len, c)
        torch.cuda.synchronize()
        t_twin = time.perf_counter() - t
        e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        errs["shortest_states"] = max(errs["shortest_states"], e)
        restarts = int((tabs.match_len[want.to(torch.int64)] > 0).sum())
        print(f"  shortest {label}: N={len(cls)} {str(c.dtype).replace('torch.', '')} "
              f"match states={restarts} max_abs_err={e} (twin {t_twin:.2f} s)")
        if e:
            raise AssertionError(f"shortest {label}: kernel disagrees with its plain twin")
        return restarts

    def max_err(got, want):
        """Largest |kernel - twin| over tuples of integer tensors (uint32
        read unsigned); 1 where shapes or the presence of an output differ."""
        e = 0
        for g, w in zip(got, want):
            if (g is None) != (w is None) or (g is not None and g.shape != w.shape):
                return max(e, 1)
            if g is not None and g.numel():
                to64 = widen if g.dtype == torch.uint32 else (lambda t: t.to(torch.int64))
                e = max(e, int((to64(g) - to64(w)).abs().max()))
        return e if len(got) == len(want) else max(e, 1)

    def wwl_inputs(m, cls, num_classes):
        """The scan route's inputs on the card: windows of the padded
        classes, starts, and ``compact_lanes``' host arrays."""
        cls_p, starts, lanes, ws, d = scan_wwl.compact_lanes(m.compiled, cls)
        w = scan_batched.chunk_classes(cls_p, 512, d, num_classes)
        return (scan_batched.classes_to_device(w, num_classes, dev),
                torch.from_numpy(starts).to(dev), cls_p, lanes, d)

    def check_wwl_scan(label, m, cls, sc):
        wd, st, cls_p, lanes, d = wwl_inputs(m, cls, sc.num_classes)
        pargs = (sc.table, wd, d, sc.id_bits, sc.num_classes, sc.quotient)
        plane = kwwl.wwl_scan_plane(*pargs)
        plane_twin = kwwl.wwl_scan_plane_plain(*pargs)
        sargs = (plane[0], plane[1], sc.rows_flat if sc.quotient else None, sc.outrows, st)
        skw = dict(d=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits, cross=sc.has_cross)
        outs = kwwl.wwl_sweep_at(*sargs, **skw)
        outs_twin = kwwl.wwl_sweep_at_plain(*sargs, **skw)
        n_keep = plane[0].shape[0] - (d + 1)  # every position a walk can start at
        every = kwwl.wwl_sweep_all(*sargs[:4], n_keep, **skw)
        every_twin = kwwl.wwl_sweep_all_plain(*sargs[:4], n_keep, **skw)
        # The fused scan over the overlap windows of the same classes, against
        # its twin (the JAX ring) and the sweep's outcomes at every start slot.
        fused_note = "fused scan: not applicable (quotient)"
        e_fused = 0
        if scan_wwl.fused_applicable(sc, d):
            wf = scan_batched.classes_to_device(scan_wwl.chunk_classes_overlap(
                cls_p, 512, d, d + 1, sc.num_classes), sc.num_classes, dev)
            fkw = dict(halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits,
                       num_classes=sc.num_classes, d=d, cross=sc.has_cross)
            fused = fused_every_k(kwwl, sc, wf, st, fkw)
            fused_twin = kwwl.wwl_scan_fused_plain(sc.table, sc.outrows, wf, st, **fkw)
            torch.cuda.synchronize()
            e_fused = max(max(max_err(f, fused_twin), max_err(f, outs_twin))
                          for f in fused.values())
            errs["wwl_scan_fused"] = max(errs["wwl_scan_fused"], e_fused)
            fused_note = (f"fused scan over {tuple(wf.shape)} windows at K = {sorted(fused)} "
                          f"(the package's {kwwl.fused_segments(wf.shape[0], 512, d)[0]}) "
                          f"max_abs_err={e_fused} (twin and sweep)")
        torch.cuda.synchronize()
        e_plane, e_sweep = max_err(plane, plane_twin), max_err(outs, outs_twin)
        e_all = max_err(every, every_twin)
        errs["wwl_scan_plane"] = max(errs["wwl_scan_plane"], e_plane)
        errs["wwl_sweep_at"] = max(errs["wwl_sweep_at"], e_sweep)
        errs["wwl_sweep_all"] = max(errs["wwl_sweep_all"], e_all)
        n = len(lanes)
        has = int(outs_twin[1][:n].sum())
        cont = int(outs_twin[5][:n].sum()) if sc.has_cross else 0
        K, L = scan_block.segments(wd.shape[0], 512, d)
        print(f"  wwl scan {label}: B={wd.shape[0]} W={wd.shape[1]} K={K} L={L} "
              f"{str(wd.dtype).replace('torch.', '')} "
              f"{'row' if sc.row_layout else 'flat'}{' quotient' if sc.quotient else ''} "
              f"table {tuple(sc.table.shape)}, {n} lanes, {has} with a match, {cont} crossing; "
              f"plane max_abs_err={e_plane} sweep max_abs_err={e_sweep}; sweep at all "
              f"{n_keep} positions ({int(every_twin[1].sum())} with a match) max_abs_err={e_all}; "
              f"{fused_note}")
        if e_plane or e_sweep or e_all or e_fused:
            raise AssertionError(f"wwl scan {label}: kernel disagrees with its plain twin")
        return has, cont

    def check_wwl_walk(label, m, cls):
        cls_p, starts, lanes, _, d = scan_wwl.compact_lanes(m.compiled, cls)
        st = torch.from_numpy(starts).to(dev)
        tabs = m.dev.wwl_walk
        e = 0
        narrow = scan_batched.classes_to_device(cls_p, m.compiled.num_classes, dev)
        derived = m.dev.wwl_walk_derived
        for c in (narrow, torch.from_numpy(cls_p.astype(np.int32)).to(dev)):
            got = kwwl.wwl_walks_at(*tabs, c, st, d, walk_tables=derived)
            want = kwwl.wwl_walks_at_plain(*tabs, c, st, d)
            torch.cuda.synchronize()
            e = max(e, max_err(got, want))
        errs["wwl_walks_at"] = max(errs["wwl_walks_at"], e)
        has = int(want[1][: len(lanes)].sum())
        print(f"  wwl walk {label}: {len(cls_p)} classes ({str(narrow.dtype).replace('torch.', '')} "
              f"and int32), {len(lanes)} lanes, {has} with a match, prefix k={derived.prefix_k}, "
              f"max_abs_err={e}")
        if e:
            raise AssertionError(f"wwl walk {label}: kernel disagrees with its plain twin")
        return has

    def check_huge(label, m, cls, chunk=512):
        """The huge-dictionary kernels against their twins on the windows of
        ``cls``: the count-packed count and hotstate plane where the
        dictionary is count-packable, and the split count and planes on its
        split tables.  Returns the counts and the split planes."""
        comp, A = m.compiled, m.compiled.num_classes
        out = {}

        def win(halo):
            w = scan_batched.chunk_classes(cls, chunk, halo, A)
            return scan_batched.classes_to_device(w, A, dev)

        def report(kind, names, got, want, shape, extra):
            e_count = abs(int(got[0]) - int(want[0]))
            e_plane = max_err(got[1:], want[1:])
            for k, e in zip(names, (e_count, e_plane)):
                errs[k] = max(errs[k], e)
            print(f"  {kind} {label}: {shape} count={int(got[0])} twin={int(want[0])} "
                  f"count max_abs_err={e_count} plane max_abs_err={e_plane}{extra}")
            if e_count or e_plane:
                raise AssertionError(f"{kind} {label}: kernel disagrees with its plain twin")

        if scan_batched.count_packable(comp):
            flat, sb, halo = m.dev.count_packed_dfa
            w = win(halo)
            args = (flat, w, halo, sb, A)
            got = (khuge.packedcount_count(*args), khuge.packedcount_hotstate_plane(*args))
            want = (khuge.packedcount_count_plain(*args),
                    khuge.packedcount_hotstate_plane_plain(*args))
            torch.cuda.synchronize()
            hot = int((widen(want[1]) != 0).sum())
            report("count-packed", ("packedcount_count", "packedcount_hotstate_plane"), got,
                   want, f"B={w.shape[0]} W={w.shape[1]} {str(w.dtype).replace('torch.', '')} "
                   f"state_bits={sb}", f", {hot} hot positions")
            out["count"], out["hot"] = int(got[0]), hot
        dfa_flat, emit_tab, halo = m.dev.split_dfa
        P = emit_tab.shape[1]
        w = win(halo)
        args = (dfa_flat, emit_tab, w, halo, A, P)
        got = (khuge.split_count(*args), khuge.split_emit_planes(*args))
        want = (khuge.split_count_plain(*args), khuge.split_emit_planes_plain(*args))
        torch.cuda.synchronize()
        report("split", ("split_count", "split_emit_planes"), got, want,
               f"B={w.shape[0]} W={w.shape[1]} {str(w.dtype).replace('torch.', '')} P={P}", "")
        check_split_count_ks(label, args, errs, want=int(want[0]))
        out["split_count"], out["split_planes"] = int(got[0]), got[1]
        return out

    def gold_pairs(compiled, text):
        return [(a, b) for a, b, _ in gold.gold_match(compiled, text)]

    # 3. Kernels vs plain twins on the card.
    print("kernel vs plain twin:")
    rng = np.random.default_rng(SEED)
    for seed in range(3):
        r = np.random.default_rng(seed)
        kws = fuzz_keywords(r, "abcdef", 60, 8)
        m = port.AhoCorasickSet(kws, engine="device", device=dev)
        text = "".join(r.choice(list("abcdefgh "), size=20_000 + 77 * seed))
        check(f"fuzz seed {seed}", m, m._classes(text), 512)
        check_rowdfa(f"fuzz seed {seed}", m, m._classes(text), 512)
        sm = compile_matcher(kws[::3], "shortest", True)
        tabs = port.ShortestMatchSet.from_compiled(sm, device=dev).dev
        assert check_shortest(f"fuzz seed {seed}", tabs, sm.charmap[
            np.frombuffer(text[:3000].encode("utf-16-le"), dtype=np.uint16)]) > 0
    m = port.AhoCorasickSet(DEMO, engine="device", device=dev)
    demo_text = word_soup(DEMO, rng, 50_000)
    assert check("demo 20 keywords", m, m._classes(demo_text), 512) > 0
    check_rowdfa("demo 20 keywords", m, m._classes(demo_text), 512)
    wide_kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
    m = port.AhoCorasickSet(wide_kws, engine="device", device=dev)
    assert m.compiled.num_classes > 256
    wide_text = "".join(chr(0x100 + int(c)) for c in rng.integers(0, 300, size=30_000))
    assert check(">256 classes (uint16)", m, m._classes(wide_text), 512) > 0
    check_rowdfa(">256 classes (uint16)", m, m._classes(wide_text), 512)
    wide_m = m
    ws = port.ShortestMatchSet.from_compiled(
        compile_matcher(wide_kws, "shortest", True), device=dev)
    check_shortest(">256 classes (uint16)", ws.dev, ws._classes(wide_text[:2000]))
    m = port.AhoCorasickSet(["abcabcabcab", "bca", "cab", "a", "cc"], engine="device", device=dev)
    abc_text = "".join(rng.choice(list("abc "), size=9_999))
    assert check("halo 11 > chunk 4", m, m._classes(abc_text), 4) > 0
    check("one window", m, m._classes(abc_text[:300]), 512)
    check_rowdfa("depth 11 (halo rounded to 12) > chunk 4", m, m._classes(abc_text), 4)
    check_rowdfa("one window, odd length", m, m._classes(abc_text[:301]), 512)
    # state_bits + depth exactly 32 (12 + 20), and the stride-2 kernels on the
    # dictionaries of the suite's configs 1 and 4 and the 10k one, at the main
    # path's 65,536 x 524 windows, timed beside the packed kernels.
    r32 = np.random.default_rng(5)
    kws32 = sorted({"".join(r32.choice(list("abcdefgh"), size=int(r32.integers(3, 9))))
                    for _ in range(700)}) + ["abcdefghabcdefghabcd"]
    m = port.AhoCorasickSet(kws32, engine="device", device=dev)
    if max(int(m.compiled.num_states - 1).bit_length(), 1) + m.compiled.max_depth != 32:
        raise AssertionError("the boundary dictionary does not have state_bits + depth = 32")
    check_rowdfa("state_bits + depth = 32", m, m._classes(
        "".join(r32.choice(list("abcdefgh "), size=40_001)) + kws32[-1]), 512)
    # P = 2 with a ragged tile edge, from its own generator so that the main
    # path's text stays the one earlier runs measured.
    srng = np.random.default_rng(SEED + 1)
    synth = np.zeros((2, 3_000_017), dtype=np.uint32)
    hot = srng.choice(synth.shape[1], size=40_000, replace=False)
    synth[srng.integers(0, 2, size=hot.size), hot] = srng.integers(
        1, 1 << 32, size=hot.size, dtype=np.uint64).astype(np.uint32)
    synth_t = torch.from_numpy(synth.view(np.int32)).to(dev).view(torch.uint32)
    assert check_compact("synthetic P=2", synth_t) == 40_000
    assert check_compact("no bits set", torch.zeros_like(synth_t[:1])) == 0
    check_redesign_edges(port, dev, errs)
    t_edges = time.perf_counter()
    check_wwl_edges(port, dev, errs)
    t_walk = time.perf_counter()
    print(f"  wwl edges: {t_walk - t_edges} s; walk edges: {check_walk_edges(port, dev, errs)} "
          f"cases, kernel == twin == prefix decomposition, {time.perf_counter() - t_walk} s")
    print(f"  row-sharded lane edges: {check_tp_lane_edges(port, dev, errs)} cases, kernel == "
          f"twin")
    t_step = time.perf_counter()
    print(f"  step edges: {check_step_edges(port, dev, errs)} cases, kernel == twin == "
          f"table_sharded_scan, {time.perf_counter() - t_step} s")
    print(f"  sweep edges: {check_sweep_edges(dev, errs, scan_variants.library())} cases, "
          f"kernel and every A/B design == twin")

    keywords = make_dictionary(np.random.default_rng(SEED), N_KEYWORDS)
    big = port.AhoCorasickSet(keywords, engine="device", device=dev)
    base = word_soup(keywords, rng, BASE_UNITS)
    text = base * (TEXT_UNITS // BASE_UNITS)
    cls = big._classes(text)
    pd = big.dev.packed_dfa
    print(f"  10k dictionary: {big.compiled.num_states} states, "
          f"{big.compiled.num_classes} classes (table {tuple(pd.table.shape)}, "
          f"{pd.table.nbytes} B), depth {big.compiled.max_depth}, "
          f"state_bits {pd.state_bits}")
    count10k = check("10k keywords x 32 Mi units", big, cls, 512)
    suite_dicts = {"100 keywords (suite config 1)": english_like_keywords(np.random.default_rng(0), 100),
                   "1,000 keywords (suite config 4's size)": english_like_keywords(
                       np.random.default_rng(0), 1000)}
    for label, kws_r in suite_dicts.items():
        m = port.AhoCorasickSet(kws_r, engine="device", device=dev)
        base_r = bench_word_soup(np.random.default_rng(SEED + 12), kws_r, BASE_UNITS)
        check_rowdfa(f"{label} x 32 Mi units", m, m._classes(base_r * (TEXT_UNITS // BASE_UNITS)),
                     512, timed=True)
    if check_rowdfa("10k keywords x 32 Mi units", big, cls, 512, timed=True) != count10k:
        raise AssertionError("rowdfa2 10k count != the packed count")
    # The stride-2 count and planes at K = 1, 2 and 4 lanes a window (the caps
    # patched) on ragged windows, bodies of an odd and an even number of
    # pairs, uint8 and uint16.
    for label, m_k, c_k in (("10k", big, cls), ("> 256 classes", wide_m,
                                                 wide_m._classes(wide_text))):
        halo_k = m_k.dev.row_dfa.halo
        for body in (16 * max(halo_k, 8) + 6, 16 * max(halo_k, 8) + 8):
            if check_rowdfa_ks(label, m_k, c_k[: 40 * body + 77], body, dev, errs) != [1, 2, 4]:
                raise AssertionError(f"rowdfa2 {label}: the caps did not give K = 1, 2 and 4")
    short_compiled = compile_matcher(keywords, "shortest", True)
    restart = port.ShortestMatchSet.from_compiled(short_compiled, engine="device", device=dev)
    short_cls = restart._classes(text[:SHORTEST_TWIN_UNITS])
    check_shortest("10k keywords x 64 Ki units", restart.dev, short_cls)

    def int32_classes(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(dev)

    # The sequential scan from an entry state: dense, RowTable, restart table.
    def check_seq(label, table, row_id, cls_np, s0, sync=None):
        """Speculate and repair (``sync`` None) or the lane scan (``sync`` =
        d) against its twin."""
        c = torch.from_numpy(np.ascontiguousarray(cls_np, dtype=np.int32)).to(dev)
        got = scan_dfa.seq_states(table, row_id, c, s0, sync)
        t = time.perf_counter()
        want = scan_dfa.seq_states_plain(table, row_id, c, s0, sync)
        torch.cuda.synchronize()
        t_twin = time.perf_counter() - t
        e = max_err((got,), (want,))
        k = "seq_states_serial" if sync is None else "seq_states"
        errs[k] = max(errs[k], e)
        form = f"spec K={scan_dfa.spec_chunk_len(len(cls_np))}" if sync is None else (
            f"lanes d={sync} L={scan_dfa.sync_lane_len(len(cls_np), sync)}")
        print(f"  seq {label}, {form}: N={len(cls_np)} s0={s0} "
              f"{'rows ' + str(tuple(table.shape)) + ' row_id ' + str(tuple(row_id.shape)) if row_id is not None else 'dense ' + str(tuple(table.shape))} "
              f"last state={int(want[-1])} max_abs_err={e} (twin {t_twin:.2f} s)")
        if e:
            raise AssertionError(f"seq {label}: kernel disagrees with its plain twin")
        return got

    dense_tab = big.dev.seq_tables
    assert dense_tab[1] is None and dense_tab[0] is big.dev.dfa_next
    s_mid_10k = int(check_seq("10k dense, warm-up", *dense_tab, cls[:1000], 0)[-1]) or 1
    for n_seq in (1, 2, 2047, 2048, 2049, 1 << 16):
        for s0 in (0, s_mid_10k):
            check_seq("10k dense", *dense_tab, cls[5000: 5000 + n_seq], s0)
    # The lane scan of the goto closure (d-synchronizing): lengths around the
    # lane boundaries and ragged, entry states 0 and not 0, then the timed
    # shapes; then lanes of exactly d (sync_lane_len patched: scalar stores
    # where d is not a multiple of 4).
    d_seq = max(big.compiled.max_depth, 1)
    L_seq = scan_dfa.sync_lane_len(1 << 16, d_seq)
    for n_seq in (1, d_seq - 1, d_seq, L_seq - 1, L_seq, L_seq + 1, 5 * L_seq + 3, 2049):
        for s0 in (0, s_mid_10k):
            check_seq("10k dense", *dense_tab, cls[5000: 5000 + n_seq], s0, d_seq)
    for n_seq in (1 << 10, 1 << 12, 1 << 16, TEXT_UNITS):
        check_seq("10k dense, timed shape", *dense_tab, cls[:n_seq], 0, d_seq)
    lane_rule = scan_dfa.sync_lane_len
    scan_dfa.sync_lane_len = lambda n, depth: depth
    try:
        for n_seq in (d_seq + 1, 4099, 1 << 16):
            check_seq("10k dense, L = d", *dense_tab, cls[777: 777 + n_seq], s_mid_10k, d_seq)
    finally:
        scan_dfa.sync_lane_len = lane_rule

    class NeverDense:
        """A thresholder that keeps every table row-compressed."""

        def is_over_threshold(self, size, lo, hi):
            return False

    rows_rng = np.random.default_rng(SEED + 8)
    rows_kws = fuzz_keywords(rows_rng, "abcdef", 200, 9)
    rows_m = port.AhoCorasickSet(rows_kws, engine="gold", device=dev, thresholder=NeverDense())
    rows_tab = rows_m.dev.seq_tables
    rows_dev = port.AhoCorasickSet(rows_kws, engine="device", device=dev, thresholder=NeverDense())
    check_rowdfa("fuzz quotient rows", rows_dev, rows_dev._classes(
        "".join(rows_rng.choice(list("abcdefgh "), size=30_001))), 512)
    assert rows_m.compiled.is_row_compressed and rows_tab[1] is not None
    rows_cls = rows_m._classes("".join(rows_rng.choice(list("abcdefgh "), size=1 << 16)))
    s_mid = int(check_seq("fuzz RowTable, warm-up", *rows_tab, rows_cls[:1000], 0)[-1]) or 1
    d_rows = max(rows_m.compiled.max_depth, 1)
    for n_seq in (1, 2049, 1 << 16):
        for s0 in (0, s_mid):
            check_seq("fuzz RowTable", *rows_tab, rows_cls[:n_seq], s0)
            check_seq("fuzz RowTable", *rows_tab, rows_cls[:n_seq], s0, d_rows)
    # d = 39: the deep dictionary, dense and kept row-compressed, from the
    # root and from its deepest state, over runs of "a" up to past 39.
    drng = np.random.default_rng(SEED + 10)
    deep_text = "".join("a" * int(r) + str(drng.choice(list(" the")))
                        for r in drng.integers(1, 50, size=4000))
    for thr, form in ((None, "dense"), (NeverDense(), "RowTable")):
        deep_m = port.AhoCorasickSet(DEEP, engine="gold", device=dev, thresholder=thr)
        deep_tab = deep_m.dev.seq_tables
        d_deep = max(deep_m.compiled.max_depth, 1)
        if d_deep != 39 or (deep_tab[1] is not None) != (thr is not None):
            raise AssertionError(f"deep {form}: depth {d_deep}, row_id {deep_tab[1] is not None}")
        s_deep = int(np.argmax(deep_m.compiled.depth[: deep_m.compiled.num_states]))
        deep_cls = deep_m._classes(deep_text)
        L_deep = scan_dfa.sync_lane_len(1 << 16, d_deep)
        for n_seq in (1, d_deep - 1, d_deep, L_deep + 1, 5 * L_deep + 3, 1 << 16):
            for s0 in (0, s_deep):
                check_seq(f"deep {form}", *deep_tab, deep_cls[:n_seq], s0, d_deep)
        scan_dfa.sync_lane_len = lambda n, depth: depth
        try:
            check_seq(f"deep {form}, L = d", *deep_tab, deep_cls[:4097], s_deep, d_deep)
        finally:
            scan_dfa.sync_lane_len = lane_rule
    # A wide alphabet (55,040 classes): the compiler row-compresses it itself.
    wide_ac_kws = [chr(c) for c in range(0x100, 0xD800)]
    wide_gold = port.AhoCorasickSet(wide_ac_kws, engine="gold", device=dev)
    assert wide_gold.compiled.is_row_compressed
    wrng = np.random.default_rng(SEED + 9)

    wide_base = scan_variants.wide_soup(wrng, DEMO, BASE_UNITS)
    wide_tab = wide_gold.dev.seq_tables
    wide_cls = wide_gold._classes(wide_base[: 1 << 16])
    for s0 in (0, int(wide_cls[wide_cls > 0][0])):
        check_seq("wide alphabet RowTable", *wide_tab, wide_cls, s0)
        check_seq("wide alphabet RowTable", *wide_tab, wide_cls[:4097], s0, 1)
    wide_cls32 = np.tile(wide_gold._classes(wide_base), TEXT_UNITS // BASE_UNITS)
    check_seq("wide alphabet RowTable, timed shape", *wide_tab, wide_cls32, 0, 1)
    restart_tab = stream_mod.seq_tensors(
        stream_mod._ShortestCursor._restart_table(short_compiled), dev)
    got = check_seq("10k shortest restart table", *restart_tab, short_cls, 0)
    same = scan_dfa.shortest_states(restart.dev.dfa_next, restart.dev.match_len,
                                    scan_batched.classes_to_device(
                                        short_cls, short_compiled.num_classes, dev))
    if not torch.equal(got, same):
        raise AssertionError("restart-table scan != the lagged-restart kernel's states")
    t0 = time.perf_counter()
    print(f"  spec edges: {check_spec_edges(dev, errs)} cases, each == its twin "
          f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    print(f"  meet edges: {check_meet_edges(dev, errs)} cases, each == its twin "
          f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    fold_cases, fold_stats = check_fold_edges(dev, errs)
    print(f"  fold edges: {fold_cases} cases, each == its twins; lanes repaired, lanes, longest "
          f"repair by map kind: {json.dumps(fold_stats)} ({time.perf_counter() - t0:.2f} s)")

    # Chunk stitching: sigma maps, entry fold and rescan against their twins,
    # each map and rescan in its form for any table and, on a table declared
    # d-synchronizing (``d``), in its synchronized form too, and the stitched
    # scan of each form against the one sequential scan.
    def check_stitch(label, table, cls_np, chunks, s0, d=None, K=None, general=True):
        """``general`` False: the synchronized forms only."""
        K = len(cls_np) // chunks if K is None else K
        flat = torch.from_numpy(np.ascontiguousarray(cls_np[: chunks * K], dtype=np.int32)).to(dev)
        c = flat.reshape(chunks, K)
        seq = scan_dfa.seq_states(table, None, flat, s0)
        e = {}
        sigma_all = None
        forms = (((None, "state_maps_all", "rescan_serial"),) if general else ()) + (
            ((d, "state_maps", "rescan"),) if d is not None else ())
        for depth, maps_k, rescan_k in forms:
            sigma = kstitch.state_maps(table, c, depth)
            sigma_twin = kstitch.state_maps_plain(table, c, depth)
            entry, entry_twin = kstitch.entry_fold(sigma, s0), kstitch.entry_fold_plain(sigma, s0)
            states = kstitch.rescan(table, c, entry, depth)
            states_twin = kstitch.rescan_plain(table, c, entry, depth)
            whole = stitch.stitched_scan(table, c, s0, depth)
            torch.cuda.synchronize()
            e[maps_k] = max_err((sigma,), (sigma_twin,))
            e["entry_fold"] = max(e.get("entry_fold", 0), max_err((entry,), (entry_twin,)))
            e[rescan_k] = max_err((states,), (states_twin,))
            same = torch.equal(whole.reshape(-1), seq) and torch.equal(whole, states)
            if depth is None:
                sigma_all = sigma
            elif sigma_all is not None and not torch.equal(sigma, sigma_all):
                same = False
            if not same:
                e[rescan_k] = max(e[rescan_k], 1)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        print(f"  stitch {label}: C={chunks} K={K} table {tuple(table.shape)} s0={s0} d={d} "
              f"entry states {entry[:4].tolist()}..{entry[-1:].tolist()} max_abs_err {e}; "
              f"stitched_scan == seq_states (and both forms' sigma equal): "
              f"{not any(e.values())}")
        if any(e.values()):
            raise AssertionError(f"stitch {label}: a kernel disagrees with its plain twin, a "
                                 f"stitched scan with the sequential one, or the two forms' "
                                 f"maps with each other")
        return int(seq[-1]) if len(seq) else s0

    t_stitch = time.perf_counter()
    demo_m = port.AhoCorasickSet(DEMO, engine="device", device=dev)
    demo_cls = demo_m._classes(demo_text * 84)  # 4.2 M units
    demo_tab = demo_m.dev.dfa_next
    d_demo = max(demo_m.compiled.max_depth, 1)
    s_demo = check_stitch("demo, warm-up", demo_tab, demo_cls[:999], 3, 0, d_demo) or 1
    for chunks, units in ((1, 20_001), (8, 8 * 6_251), (4096, 4096 * 1_025), (4096, 4096 * 37)):
        for s0 in (0, s_demo):
            check_stitch("demo 20 keywords", demo_tab, demo_cls[:units], chunks, s0, d_demo)
    check_stitch("10k dense table", dense_tab[0], cls[:SHORTEST_TWIN_UNITS], 64, 0, d_seq)
    check_stitch("10k dense table", dense_tab[0], cls[5000: 5000 + SHORTEST_TWIN_UNITS], 64,
                 s_mid_10k, d_seq)
    # The synchronized forms' edges: K around d + 1 and the lane boundaries,
    # 1, 3 and 64 chunks, entry states live and in a zero-filled padding row.
    for label, table, m_e, tcls, d in (("10k dense table", dense_tab[0], big, cls, d_seq),
                                       ("demo 20 keywords", demo_tab, demo_m, demo_cls, d_demo)):
        L = scan_dfa.sync_lane_len(64 * 1024, d)
        live = m_e.compiled.num_states
        entries = (0, s_mid_10k if m_e is big else s_demo) + (
            (live,) if table.shape[0] > live else ())
        for chunks in (1, 3, 64):
            for K in sorted({1, d, d + 1, d + 2, L - 1, L, L + 1, 5 * L + 3}):
                for s0 in entries:
                    check_stitch(f"{label}, edge", table, tcls[7: 7 + chunks * K], chunks, s0, d,
                                 K, general=False)
    # Padding rows that are sinks (each maps to itself): phase 1 does not
    # converge and the continuation runs; no sink is reachable from the root,
    # so the declaration still holds.
    live10k = big.compiled.num_states
    sink_tab = dense_tab[0].clone()
    sink_tab[live10k:] = torch.arange(live10k, sink_tab.shape[0], dtype=torch.int32,
                                      device=dev)[:, None]
    for chunks, K in ((1, d_seq + 1), (3, 1024), (64, 5 * L_seq + 3)):
        for s0 in (0, s_mid_10k):
            check_stitch("10k table, sink padding", sink_tab, cls[11: 11 + chunks * K], chunks,
                         s0, d_seq, K, general=False)
    if restart_tab[1] is not None:
        raise AssertionError("the 10k shortest restart table is not dense")
    check_stitch("10k shortest restart table", restart_tab[0], short_cls, 64, 0)
    print(f"  stitch checks: {time.perf_counter() - t_stitch:.1f} s")

    wwl_rng = np.random.default_rng(SEED + 3)
    for seed in range(3):
        r = np.random.default_rng(seed)
        m = port.WholeWordLongestMatchSet(fuzz_keywords(r, "abcdef", 60, 8), engine="device",
                                          device=dev)
        text_f = "".join(r.choice(list("abcdefgh ,"), size=20_000 + 4096 * seed))
        cls_f = m._classes(text_f)
        assert check_wwl_scan(f"fuzz seed {seed}", m, cls_f, m.dev.wwl_scan)[0] > 0
        assert check_wwl_walk(f"fuzz seed {seed}", m, cls_f) > 0
        if seed == 0:
            saved = scan_wwl._ROW_MAX_BYTES
            scan_wwl._ROW_MAX_BYTES = 0  # force the flat layout
            try:
                flat = convert.wwl_scan_from_numpy(scan_wwl.build_wwl_scan(m.compiled), dev)
            finally:
                scan_wwl._ROW_MAX_BYTES = saved
            assert not flat.row_layout
            check_wwl_scan("fuzz seed 0, flat layout", m, cls_f, flat)
    m = port.WholeWordLongestMatchSet([chr(c) for c in range(32, 0xD800)], engine="device",
                                      device=dev)
    full_text = "".join(chr(int(c)) for c in wwl_rng.integers(32, 0xD800, size=30_000))
    sc = m.dev.wwl_scan
    assert sc.quotient and m.compiled.num_classes > 256
    check_wwl_scan("full-node quotient (uint16)", m, m._classes(full_text), sc)
    words = fuzz_keywords(wwl_rng, "abcde", 40, 4)
    mixed_kws = words + [f"{a} {b}" for a, b in zip(words[:10], words[10:20])]
    m = port.WholeWordLongestMatchSet(mixed_kws, engine="device", device=dev)
    mixed_text = " ".join(wwl_rng.choice(mixed_kws + ["zz", "a,"], size=20_000))
    assert check_wwl_scan("separator-spanning", m, m._classes(mixed_text),
                          m.dev.wwl_scan_mixed)[1] > 0
    big_wwl = port.WholeWordLongestMatchSet(keywords, engine="device", device=dev)
    cls_w = big_wwl._classes(text)
    sc10 = big_wwl.dev.wwl_scan
    print(f"  10k dictionary, whole-word-longest: table {tuple(sc10.table.shape)} "
          f"({sc10.table.nbytes} B), id_bits {sc10.id_bits}, depth_bits {sc10.depth_bits}")
    check_wwl_scan("10k keywords x 32 Mi units", big_wwl, cls_w, sc10)
    check_wwl_walk("10k keywords x 32 Mi units", big_wwl, cls_w)

    # The huge-dictionary kernels: deep dictionaries, then the 1M one.
    deep_m = port.AhoCorasickSet(DEEP, engine="device", device=dev)
    deep_text = "aaaa the " * 3000 + "a" * 45 + "b aab" + bench_word_soup(
        np.random.default_rng(SEED + 5), DEEP, 50_000)
    deep_cls = deep_m._classes(deep_text)
    got = check_huge("deep (depth 39)", deep_m, deep_cls)
    n_gold = len(gold.gold_match(deep_m.compiled, deep_text))
    if not got["count"] == got["split_count"] == n_gold > 0:
        raise AssertionError(f"deep dictionary: counts {got} != gold {n_gold}")
    a100 = port.AhoCorasickSet(["a" * i for i in range(1, 101)], engine="device", device=dev)
    for text_s, chunk in (("a" * 300 + "b" + "a" * 150, 512), ("aab" * 200 + "a" * 120, 128)):
        c = a100._classes(text_s)
        got = check_huge(f"a..a*100, {len(text_s)} units, chunk {chunk}", a100, c, chunk)
        s_, e_, _ = scan_batched.ac_matches_batched(a100.compiled, c, got["split_planes"])
        want = gold_pairs(a100.compiled, text_s)
        if list(zip(s_.tolist(), e_.tolist())) != want or got["split_count"] != len(want):
            raise AssertionError("a..a*100: split planes or count != gold")
    wide_deep = wide_kws + ["".join(chr(0x100 + (11 * i) % 300) for i in range(30))]
    wd_m = port.AhoCorasickSet(wide_deep, engine="device", device=dev)
    wd_text = wide_text + wide_deep[-1] + wide_text[:5000] + wide_deep[-1]
    got = check_huge("> 256 classes, depth 30 (uint16)", wd_m, wd_m._classes(wd_text))
    if not got["count"] == got["split_count"] == len(gold.gold_match(wd_m.compiled, wd_text)):
        raise AssertionError("wide deep dictionary: counts != gold")

    if not native_lib.available():
        raise RuntimeError("the native compiler library did not build (g++); the 1M "
                           "dictionary is not compiled in Python")
    kws1m, rng1m, letters1m = one_m_keywords(ONE_M["candidates"])
    t0 = time.perf_counter()
    ac1m = port.AhoCorasickSet(kws1m, engine="device", device=dev)
    t_compile = time.perf_counter() - t0
    c1m = ac1m.compiled
    print(f"  1M dictionary: {len(kws1m)} keywords, {c1m.num_states} states, "
          f"{c1m.num_classes} classes, depth {c1m.max_depth}; native compiler "
          f"available {native_lib.available()}, compile {t_compile} s; inline packable "
          f"{scan_batched.inline_packable(c1m)}, hotstate {scan_batched.hotstate_layout(c1m)}")
    if (len(kws1m), c1m.num_states) != (ONE_M["keywords"], ONE_M["states"]) or \
            not scan_batched.hotstate_layout(c1m):
        raise AssertionError("the 1M dictionary is not the pinned one")
    text1m = one_m_text(rng1m, letters1m, kws1m, ONE_M["text_units"])
    # BASELINE config #5's text shape: bench word soup over the dictionary.
    base5 = bench_word_soup(np.random.default_rng(SEED + 6), kws1m, BASE_UNITS)
    text5 = base5 * (TEXT_UNITS // BASE_UNITS)
    cls5 = ac1m._classes(text5)
    got = check_huge("1M keywords x 32 Mi units", ac1m, cls5)
    if got["count"] != got["split_count"]:
        raise AssertionError("1M dictionary: count-packed and split counts differ")
    count1m_32, hot1m_32 = got["count"], got["hot"]

    # The row-sharded scan: every mode against its twin, the shards separate
    # allocations on the one card.
    def check_tp(label, table, cls_np, halo, sb, n_model, chunk=512):
        tables, _, A = sharding._table_sharded_build(table, halo, sb, [dev] * n_model, "count")
        st = tables[0]
        if len({t.data_ptr() for t in st.shards}) != n_model or st.n_model != n_model:
            raise AssertionError(f"row-sharded {label}: the shards are not separate allocations")
        w = scan_batched.classes_to_device(
            scan_batched.chunk_classes(cls_np, chunk, halo, A), A, dev)
        out = {}
        t = time.perf_counter()
        for mode in ktp.MODES:
            got = ktp.table_sharded_scan(st, w, halo, sb, mode)
            want = ktp.table_sharded_scan_plain(st, w, halo, sb, mode)
            torch.cuda.synchronize()
            e = max_err((got.reshape(-1),), (want.reshape(-1),))
            errs["table_sharded_scan"] = max(errs["table_sharded_scan"], e)
            out[mode] = int(got) if got.dim() == 0 else int((widen(got) != 0).sum())
            if e:
                raise AssertionError(f"row-sharded {label}, mode {mode}: kernel disagrees with "
                                     f"its plain twin (max_abs_err {e})")
        print(f"  row-sharded {label}: table {tuple(table.shape)} in {n_model} shards of "
              f"{st.rows_per} rows, B={w.shape[0]} W={w.shape[1]} "
              f"{str(w.dtype).replace('torch.', '')} state_bits={sb}; count / count_packed "
              f"{out['count']} / {out['count_packed']}, non-zero words planes / hotstate / raw "
              f"{out['planes']} / {out['hotstate']} / {out['raw']}; five modes max_abs_err=0 "
              f"({time.perf_counter() - t:.2f} s with the twins)")
        return out, st, w

    for seed, n_model in ((0, 1), (1, 3), (2, 8)):
        r = np.random.default_rng(seed)
        m = port.AhoCorasickSet(fuzz_keywords(r, "abcdef", 60, 8), engine="device", device=dev)
        pd_f = scan_batched.build_packed(m.compiled)
        text_f = "".join(r.choice(list("abcdefgh "), size=20_000 + 77 * seed))
        got = check_tp(f"fuzz seed {seed}", pd_f.table, m._classes(text_f), pd_f.halo,
                       pd_f.state_bits, n_model)[0]
        if got["count"] != m.count(text_f) or got["count"] <= 0:
            raise AssertionError(f"row-sharded fuzz seed {seed}: count {got['count']} != "
                                 f"the single-table count {m.count(text_f)}")
    tiny = port.AhoCorasickSet(["x", "y"], engine="device", device=dev, thresholder=NeverDense())
    pd_t = scan_batched.build_packed(tiny.compiled)
    if not pd_t.table.shape[0] < N_SHARDS:
        raise AssertionError("the tiny quotient table has as many rows as shards")
    got = check_tp("more shards than rows", pd_t.table, tiny._classes("xxyxy x!y" * 100),
                   pd_t.halo, pd_t.state_bits, N_SHARDS, chunk=64)[0]
    if got["count"] != 700:
        raise AssertionError(f"more shards than rows: count {got['count']} != 700")
    table10k = scan_batched.build_packed(big.compiled).table
    got, st10k, _ = check_tp("10k keywords x 32 Mi units", table10k, cls, pd.halo, pd.state_bits,
                             N_SHARDS)
    if got["count"] != count10k:
        raise AssertionError(f"row-sharded 10k table: count {got['count']} != the single-table "
                             f"count {count10k}")
    wwl_f = port.WholeWordLongestMatchSet(fuzz_keywords(np.random.default_rng(0), "abcdef", 60, 8),
                                          engine="device", device=dev)
    cls_f = wwl_f._classes("".join(np.random.default_rng(0).choice(list("abcdefgh ,"),
                                                                  size=20_000)))
    row_sc = wwl_f.dev.wwl_scan_host
    saved = scan_wwl._ROW_MAX_BYTES
    scan_wwl._ROW_MAX_BYTES = 0  # force the flat layout
    try:
        flat_sc = scan_wwl.build_wwl_scan(wwl_f.compiled)
    finally:
        scan_wwl._ROW_MAX_BYTES = saved
    if not row_sc.row_layout or flat_sc.row_layout:
        raise AssertionError("the whole-word-longest fuzz tables are not row and flat")
    raw_words = {}
    for label, sc_f in (("row", row_sc), ("flat", flat_sc)):
        tab = sc_f.table if sc_f.row_layout else sc_f.table.reshape(-1, sc_f.num_classes)
        raw_words[label] = check_tp(f"whole-word-longest table, {label} layout", tab, cls_f,
                                    sc_f.halo, sc_f.id_bits, 3)[0]["raw"]
    if raw_words["row"] != raw_words["flat"] or not raw_words["row"]:
        raise AssertionError(f"row and flat whole-word-longest raw planes differ: {raw_words}")
    flat1m_host, sb1m_host, halo1m_host = scan_batched.build_count_packed(c1m)
    table1m = flat1m_host.reshape(c1m.num_states, c1m.num_classes)
    got_tp1m, st1m, w1m = check_tp("1M keywords x 32 Mi units (count-packed table)", table1m,
                                   cls5, halo1m_host, sb1m_host, N_SHARDS)
    if got_tp1m["count_packed"] != count1m_32 or got_tp1m["hotstate"] != hot1m_32:
        raise AssertionError(f"row-sharded 1M table: count {got_tp1m['count_packed']} and "
                             f"{got_tp1m['hotstate']} hot positions != the single-table "
                             f"{count1m_32} and {hot1m_32}")

    # The probe kernels (B19) at the JAX probes' sizes, and the PFAC walk
    # (device_engine="pfac2") on fuzz, demo and the 10k dictionary at 1 Mi units.
    check_probe_kernels(dev, errs, max_err)
    t0 = time.perf_counter()
    print(f"  row edges: {check_row_edges(dev, errs)} cases, each == its twin "
          f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    print(f"  chain edges: {check_chain_edges(dev, errs)} cases, each == its twin "
          f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    print(f"  onehot edges: {check_onehot_edges(dev, errs)} cases, each == its twin "
          f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    print(f"  gather2d edges: {check_gather2d_edges(dev, errs)} cases, each == its twin "
          f"({time.perf_counter() - t0:.2f} s)")
    prng = np.random.default_rng(SEED + 20)  # its own: the main path's texts stay as they were
    fuzz_m = port.AhoCorasickSet(fuzz_keywords(prng, "abcdef", 60, 8), engine="device", device=dev)
    demo_m = port.AhoCorasickSet(DEMO, engine="device", device=dev)
    for label, m, t in (("fuzz", fuzz_m, "".join(prng.choice(list("abcdefgh "), size=BASE_UNITS))),
                        ("demo", demo_m, word_soup(DEMO, prng, BASE_UNITS)),
                        ("10k keywords", big, text[:BASE_UNITS])):
        n_walk = check_pfac_kernels(f"{label} x {BASE_UNITS} units", m, m._classes(t), dev, errs,
                                    max_err)
        if n_walk != m.count(t) or not n_walk:
            raise AssertionError(f"pfac {label}: the walk counts {n_walk}, the facade {m.count(t)}")
    t0 = time.perf_counter()
    print(f"  pfac edges: {check_pfac_edges(dev, errs)} cases, v2 planes and count == their "
          f"twins ({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    print(f"  pfac1 edges: {check_pfac1_edges(dev, errs)} cases, v1 planes == their twins "
          f"(and v2's on dictionaries) ({time.perf_counter() - t0:.2f} s)")

    # 4. The paths through the public classes, counters zeroed just before
    # each and read just after it.
    small = text[:BASE_UNITS]
    path_launches = {}
    path_seq = {}  # label: the units the path's sequential scans scanned

    def run_path(label, expected, fn, absent=()):
        """``expected``: kernels the path must launch; ``absent``: kernels
        it must not."""
        port.reset_launches()
        t = time.perf_counter()
        detail = fn()
        counts = dict(port.launches)
        seq = dict(build.seq_units)
        path_launches[label] = counts
        path_seq[label] = seq
        print(f"path {label} ({time.perf_counter() - t:.1f} s): {detail}; launches "
              f"{ {k: v for k, v in counts.items() if v} }"
              + (f"; sequential scan units {seq}" if any(seq.values()) else ""))
        missing = [k for k in expected if counts[k] < 1]
        missing += [f"no {k}" for k in absent if counts[k] > 0]
        if missing:
            raise AssertionError(f"path {label}: {missing} never launched (or launched when it "
                                 f"must not): {counts}, {seq}")

    def resolved_ok(label, m, full_text, gold_m, probe, keep=None):
        s, e, v = m.match_triples(full_text)
        if keep is not None:
            keep[label] = (s, e, v)
        if m.last_stats.engine != "device" or len(s) == 0:
            raise AssertionError(f"{label}: engine {m.last_stats.engine}, {len(s)} matches")
        if not (np.all(s < e) and np.all(e[1:] >= e[:-1]) and np.all(s[1:] >= e[:-1])
                and e[-1] <= len(full_text)):
            raise AssertionError(f"{label}: triples overlap or are out of order")
        got, want = m.match(probe), gold_m.match(probe)
        if got != want or not want:
            raise AssertionError(f"{label}: match != gold on {len(probe)} units "
                                 f"({len(got)} vs {len(want)})")
        return f"{len(s)} matches on {len(full_text)} units, {len(want)} == gold on {len(probe)}"

    def ac_path():
        n = big.count(text)
        starts, ends, _ = big.match_triples(text)
        if n != len(starts) or n <= 0:
            raise AssertionError(f"count {n} != {len(starts)} triples")
        if not (np.all(np.diff(ends) >= 0) and np.all(starts < ends) and ends[-1] <= len(text)):
            raise AssertionError("triples out of order or out of range")
        gold_set = port.AhoCorasickSet(keywords, engine="gold", device=dev)
        got, want = big.match(small), gold_set.match(small)
        if got != want or not want:
            raise AssertionError(f"match != gold on 1 Mi units ({len(got)} vs {len(want)})")
        values = [f"v{i}" for i in range(len(keywords))]
        folded = small[: len(small) // 2].upper() + small[len(small) // 2:]
        mp = port.AhoCorasickMap(keywords, values, case_sensitive=False, engine="device", device=dev)
        gold_map = port.AhoCorasickMap(keywords, values, case_sensitive=False, engine="gold", device=dev)
        got_map = mp.match(folded)
        if got_map != gold_map.match(folded) or len(got_map) != len(want):
            raise AssertionError("case-folding map != gold on 1 Mi units")
        calls = []
        big.match(small, lambda t, s, e: calls.append((s, e)) or False)
        if calls != want[:1]:
            raise AssertionError(f"listener False did not stop delivery: {len(calls)} calls")
        return (f"count={n} on {len(text)} units; 1 Mi-unit match == gold ({len(want)} matches); "
                f"map == gold")

    run_path("AhoCorasickSet/Map", ("packed_scan_count", "packed_scan_planes", "compact_planes"),
             ac_path)

    matchers = {}

    def kind_path(cls_name, *args, **kw):
        def drive():
            m = getattr(port, cls_name)(*args, engine="device", device=dev, **kw)
            g = getattr(port, cls_name)(*args, engine="gold", device=dev, **kw)
            matchers[cls_name] = m
            probe = small
            if not kw.get("case_sensitive", True):
                probe = small[: len(small) // 2].upper() + small[len(small) // 2:]
            return resolved_ok(cls_name, m, text, g, probe)
        run_path(cls_name, ("packed_scan_planes", "compact_planes"), drive)

    kind_path("LongestMatchSet", keywords)
    kind_path("WholeWordMatchSet", keywords)
    kind_path("ShortestMatchSet", keywords)
    kind_path("LongestMatchMap", keywords, [f"v{i}" for i in range(len(keywords))],
              case_sensitive=False)

    def shortest_artifacts():
        buf = io.BytesIO()
        matchers["ShortestMatchSet"].save(buf)
        buf.seek(0)
        loaded = port.load_matcher(buf, engine="device", device=dev)
        if loaded._ac_cache is None:
            raise AssertionError("the npz lost the shortest matcher's internal AC")
        gold_s = port.ShortestMatchSet(keywords, engine="gold", device=dev)
        want = gold_s.match(small)
        if loaded.match(small) != want or loaded.last_stats.engine != "device":
            raise AssertionError("npz-loaded shortest matcher != gold on 1 Mi units")
        got = restart.match(small)
        if got != want or restart.last_stats.engine != "device" or restart._ac is not None:
            raise AssertionError("restart-scan shortest matcher != gold on 1 Mi units")
        return f"npz round trip and restart scan == gold on {len(small)} units ({len(want)} matches)"

    run_path("ShortestMatchSet npz / from_compiled", ("packed_scan_planes", "compact_planes",
                                                      "shortest_states"), shortest_artifacts)
    # Whole-word-longest: each route, and the auto repair.  The scan routes
    # run the engine scan_walks_auto picks (the fused scan where
    # FUSED_DEFAULT and fused_applicable, else the plane and the sweep):
    # each path runs under the package's FUSED_DEFAULT, and the scan and
    # mixed routes once more under the other value, held to the same triples
    # and to gold.
    fused_default = scan_wwl.FUSED_DEFAULT
    sweep_route = ("wwl_scan_plane", "wwl_sweep_at")

    def wwl_kernels(m, fused=None):
        """The kernels the scan route of ``m`` launches under ``FUSED_DEFAULT``
        (the package's value unless ``fused`` says otherwise)."""
        sc = m.dev.wwl_scan if scan_wwl.scan_applicable(m.compiled) else m.dev.wwl_scan_mixed
        fused = scan_wwl.FUSED_DEFAULT if fused is None else fused
        if fused and scan_wwl.fused_applicable(sc, bucket_depth(m.compiled.max_depth)):
            return ("wwl_scan_fused",)
        return sweep_route

    def other_default_path(label, m, full_text, gold_m, probe):
        """The scan route of ``m`` under the other ``FUSED_DEFAULT``: the same
        triples as under the package's value, and ``match`` == gold."""
        scan_wwl.FUSED_DEFAULT = not fused_default
        try:
            s, e, v = m.match_triples(full_text)
            got, want = m.match(probe), gold_m.match(probe)
        finally:
            scan_wwl.FUSED_DEFAULT = fused_default
        ref = wwl_triples[label]
        if not all(np.array_equal(a, b) for a, b in zip((s, e, v), ref)):
            raise AssertionError(f"{label}: FUSED_DEFAULT={not fused_default} gives other "
                                 f"triples ({len(s)} vs {len(ref[0])})")
        if got != want or not want:
            raise AssertionError(f"{label}: FUSED_DEFAULT={not fused_default}: match != gold")
        return (f"FUSED_DEFAULT={not fused_default}: {len(s)} triples == those under "
                f"{fused_default} on {len(full_text)} units; match == gold on {len(probe)} "
                f"units ({len(want)} matches)")

    wwl_triples = {}
    wwl_gold = port.WholeWordLongestMatchSet(keywords, engine="gold", device=dev)
    if not scan_wwl.fused_applicable(big_wwl.dev.wwl_scan, bucket_depth(
            big_wwl.compiled.max_depth)):
        raise AssertionError("the fused scan does not apply to the 10k dictionary")
    run_path("WholeWordLongestMatchSet", wwl_kernels(big_wwl), lambda: resolved_ok(
        "scan route", big_wwl, text, wwl_gold, small, keep=wwl_triples))
    run_path(f"WholeWordLongestMatchSet, FUSED_DEFAULT={not fused_default}",
             wwl_kernels(big_wwl, not fused_default),
             lambda: other_default_path("scan route", big_wwl, text, wwl_gold, small))

    word_chars = chartables.default_word_chars().copy()
    word_chars[ord("'")] = True  # BASELINE configs #4 and #7: apostrophe is a word char
    phrases = [f"{a} {b}" for a, b in zip(keywords[:500], keywords[500:1000])]
    kws7 = keywords + phrases
    text7 = bench_word_soup(np.random.default_rng(SEED + 7), kws7, BASE_UNITS) * (
        TEXT_UNITS // BASE_UNITS)
    mixed = port.WholeWordLongestMatchSet(kws7, word_chars=word_chars, engine="device",
                                          device=dev)
    continued = []

    def mixed_path():
        if scan_wwl.scan_applicable(mixed.compiled) or not scan_wwl.mixed_scan_applicable(
                mixed.compiled):
            raise AssertionError("the phrase dictionary does not take the mixed route")
        real = scan_wwl.apply_crossing_fixes

        def counting(m, cls_p, d, arrays, idx, starts):
            continued.append(len(idx))
            return real(m, cls_p, d, arrays, idx, starts)

        scan_wwl.apply_crossing_fixes = counting
        try:
            gold_m = port.WholeWordLongestMatchSet(kws7, word_chars=word_chars, engine="gold",
                                                   device=dev)
            detail = resolved_ok("mixed route", mixed, text7, gold_m, text7[:BASE_UNITS],
                                 keep=wwl_triples)
        finally:
            scan_wwl.apply_crossing_fixes = real
        s, e, _ = wwl_triples["mixed route"]
        spans = int(sum(" " in text7[a:b] for a, b in zip(s[:20_000].tolist(), e[:20_000].tolist())))
        if not spans:
            raise AssertionError("no phrase matched across a separator")
        return (f"{detail}; host-continued lanes per call {continued}; "
                f"{spans} of the first 20,000 matches span a separator")

    run_path("WholeWordLongestMatchSet mixed (BASELINE #7 shape)", wwl_kernels(mixed), mixed_path)
    run_path(f"WholeWordLongestMatchSet mixed, FUSED_DEFAULT={not fused_default}",
             wwl_kernels(mixed, not fused_default),
             lambda: other_default_path("mixed route", mixed, text7, port.WholeWordLongestMatchSet(
                 kws7, word_chars=word_chars, engine="gold", device=dev), text7[:BASE_UNITS]))

    def unicode_map_path():
        rng4 = np.random.default_rng(SEED + 4)
        kws4 = english_like_keywords(rng4, 1000) + ["naïve", "can't", "übermäßig"]
        text4 = bench_word_soup(rng4, kws4, BASE_UNITS) + " can't naïve übermäßig can'tx"
        text4 = text4[: len(text4) // 2].upper() + text4[len(text4) // 2:]
        vals4 = [f"v{i}" for i in range(len(kws4))]
        args = (kws4, vals4, False)
        m = port.WholeWordLongestMatchMap(*args, word_chars=word_chars, engine="device",
                                          device=dev)
        g = port.WholeWordLongestMatchMap(*args, word_chars=word_chars, engine="gold",
                                          device=dev)
        got, want = m.match(text4), g.match(text4)
        if got != want or m.last_stats.engine != "device" or len(want) < len(text4) // 200:
            raise AssertionError(f"Unicode map != gold ({len(got)} vs {len(want)} matches)")
        special = sorted({v for _, _, v in want} & {vals4[-3], vals4[-2], vals4[-1]})
        if len(special) != 3:
            raise AssertionError(f"the Unicode keywords did not all match: {special}")
        return f"case-folded Unicode map == gold on {len(text4)} units ({len(want)} matches)"

    run_path("WholeWordLongestMatchMap Unicode (BASELINE #4 shape)", wwl_kernels(big_wwl),
             unicode_map_path)

    def walk_path():
        s, e, v = big_wwl._walk_triples(scan_wwl.compact_lanes(big_wwl.compiled, cls_w), len(cls_w))
        ref = wwl_triples["scan route"]
        if not (np.array_equal(s, ref[0]) and np.array_equal(e, ref[1])
                and np.array_equal(v, ref[2])):
            raise AssertionError(f"walk route != scan route ({len(s)} vs {len(ref[0])} matches)")
        return f"walk route == scan route on {len(text)} units ({len(s)} matches)"

    run_path("WholeWordLongestMatchSet walk route", ("wwl_walks_at",), walk_path)

    def repair_path():
        t = "aaaa the " * 3000
        out = []
        for name in ("AhoCorasickSet", "LongestMatchSet", "WholeWordMatchSet"):
            m = getattr(port, name)(DEEP, device=dev)
            got, want = m.match(t), getattr(port, name)(DEEP, engine="gold", device=dev).match(t)
            if got != want or m.last_stats.engine != "device":
                raise AssertionError(f"{name} auto on a deep dictionary: engine "
                                     f"{m.last_stats.engine}, {len(got)} vs {len(want)}")
            out.append(f"{name} {len(got)}")
        m = port.AhoCorasickSet(DEEP, device=dev)
        n = m.count(t)
        if n != 33000 or m.last_stats.engine != "device":
            raise AssertionError(f"deep dictionary count {n} != 33000 ({m.last_stats.engine})")
        return f"auto == gold, engine device, on {len(t)} units: " + ", ".join(out)

    run_path("auto on a dictionary that does not pack inline",
             ("packedcount_count", "packedcount_hotstate_plane"), repair_path)

    w0, w_len = ONE_M["window"]
    window1m = text1m[w0: w0 + w_len]

    def ac_1m_path():
        n = ac1m.count(text1m)
        if n != ONE_M["ac_count"] or ac1m.last_stats.engine != "device":
            raise AssertionError(f"1M count {n} != {ONE_M['ac_count']} "
                                 f"({ac1m.last_stats.engine})")
        kwset = set(kws1m)
        oracle = [(i, i + L) for i in range(len(window1m)) for L in range(3, 13)
                  if i + L <= len(window1m) and window1m[i: i + L] in kwset]
        got = ac1m.match(window1m)
        if len(got) != len(oracle) or sorted(got) != sorted(oracle) or not oracle:
            raise AssertionError(f"1M match != naive oracle ({len(got)} vs {len(oracle)})")
        return (f"count {n} == pinned on {len(text1m)} units; match == naive oracle on "
                f"{len(window1m)} units ({len(got)} matches)")

    run_path("AhoCorasickSet 1M keywords", ("packedcount_count", "packedcount_hotstate_plane"),
             ac_1m_path)
    huge_matchers = {}

    def longest_1m_path():
        t = time.perf_counter()
        lm = port.LongestMatchSet(kws1m, engine="device", device=dev)
        t = time.perf_counter() - t
        huge_matchers["LongestMatchSet"] = lm
        n = lm.count(text1m)
        if n != ONE_M["longest_count"] or lm.last_stats.engine != "device":
            raise AssertionError(f"1M longest count {n} != {ONE_M['longest_count']}")
        got = lm.match(window1m)
        want = [(a, b) for a, b, _ in gold.gold_longest(lm.compiled, window1m)]
        if got != want or not want:
            raise AssertionError(f"1M longest window != gold ({len(got)} vs {len(want)})")
        return (f"compile {t} s; count {n} == pinned on {len(text1m)} units; window == "
                f"gold_longest ({len(want)} matches)")

    run_path("LongestMatchSet 1M keywords", ("packedcount_hotstate_plane",), longest_1m_path)

    def deep_path():
        inner = ["a" * i + "b" for i in range(40)]  # Shortest's inner AC is deep too
        t = deep_text * (BASE_UNITS // len(deep_text) + 1)
        vals = [f"v{i}" for i in range(len(DEEP))]
        out = []
        for name, args in (("AhoCorasickMap", (DEEP, vals)), ("WholeWordMatchSet", (DEEP,)),
                           ("ShortestMatchSet", (inner,))):
            m = getattr(port, name)(*args, engine="device", device=dev)
            got = m.match(t)
            want = getattr(port, name)(*args, engine="gold", device=dev).match(t)
            if got != want or not want or m.last_stats.engine != "device":
                raise AssertionError(f"{name} on a deep dictionary != gold "
                                     f"({len(got)} vs {len(want)})")
            out.append(f"{name} {len(want)}")
        return f"== gold on {len(t)} units: " + ", ".join(out)

    run_path("deep dictionaries (hotstate)", ("packedcount_hotstate_plane", "compact_planes"),
             deep_path)

    def split_path():
        # The dispatcher takes split only when the emit counts do not fit
        # beside the state (about 2**26 states); force that branch.
        real = scan_batched.count_packable
        scan_batched.count_packable = lambda m: False
        try:
            out = []
            for name, kws, t in (
                    ("AhoCorasickSet", ["a" * i for i in range(1, 101)],
                     "a" * 300 + "b" + "a" * 150 + " aab" * 20_000),
                    ("LongestMatchSet", DEEP, deep_text),
                    ("WholeWordMatchSet", DEEP, deep_text)):
                m = getattr(port, name)(kws, engine="device", device=dev)
                g = getattr(port, name)(kws, engine="gold", device=dev)
                got, want = m.match(t), g.match(t)
                n = m.count(t)
                if got != want or n != len(want) or not want or m.last_stats.engine != "device":
                    raise AssertionError(f"{name} split layout != gold ({len(got)} vs {len(want)})")
                out.append(f"{name} {len(want)}")
        finally:
            scan_batched.count_packable = real
        return "count_packable forced False: == gold: " + ", ".join(out)

    run_path("split layout through the classes", ("split_count", "split_emit_planes"), split_path)
    # Streams: each kind's cursor over the 10k dictionary and 32 Mi units fed
    # in uneven pieces, on "auto" matchers so that small feeds take the
    # sequential-scan kernel and large ones the planes kernels.
    sizes = stream_pieces(SEED + 10, len(text))
    small_feeds = sum(k < stream_mod._STREAM_DEVICE_MIN for k in sizes)
    print(f"stream feeds: {len(sizes)} pieces of {min(sizes)}..{max(sizes)} units, "
          f"{small_feeds} below the {stream_mod._STREAM_DEVICE_MIN}-unit device threshold")
    if not 0 < small_feeds < len(sizes):
        raise AssertionError("the feed sizes do not fall on both sides of the threshold")
    stream_times = {}

    def feed_all(stream, pieces, start, last):
        """Feed ``pieces`` from text offset ``start``; flat (start, end) pairs."""
        out, i = [], start
        for k in pieces:
            out.extend(stream.feed(text[i: i + k], i + k >= last))
            i += k
        return out

    def stream_path(cls_name, make, ref, expected):
        def drive():
            m = make()
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = feed_all(m.stream(), sizes, 0, len(text))
            torch.cuda.synchronize()
            stream_times[cls_name] = time.perf_counter() - t
            want = np.stack([np.asarray(ref[0]), np.asarray(ref[1])], axis=1)
            if not np.array_equal(np.asarray(got, dtype=np.int64).reshape(-1, 2), want):
                raise AssertionError(f"{cls_name}: streamed output != match_triples "
                                     f"({len(got)} vs {len(want)} matches)")
            # A resume point saved mid-stream, through JSON, into a fresh
            # matcher's stream: the same output from there on.
            half = len(sizes) // 2
            cut = sum(sizes[:half])
            s1 = m.stream()
            first = feed_all(s1, sizes[:half], 0, len(text))
            state = json.loads(json.dumps(s1.state_dict()))
            s2 = make().stream()
            s2.load_state_dict(state)
            rest = feed_all(s2, sizes[half:], cut, len(text))
            if first + rest != got:
                raise AssertionError(f"{cls_name}: resumed stream != unbroken stream")
            return (f"{len(got)} matches over {len(sizes)} feeds == match_triples; resumed at "
                    f"unit {cut} (state keys {sorted(state)}) == unbroken; "
                    f"{stream_times[cls_name]} s ({2 * len(text) / stream_times[cls_name] / 1e9} "
                    f"GB/s) [{smi}]")
        run_path(f"{cls_name} stream", expected, drive)

    planes_stream = ("seq_states", "packed_scan_planes", "compact_planes")
    ac_ref = big.match_triples(text)
    stream_path("AhoCorasickSet", lambda: port.AhoCorasickSet(keywords, device=dev), ac_ref,
                planes_stream)
    kind_ref = {"AhoCorasickSet": ac_ref}
    for k in ("LongestMatchSet", "WholeWordMatchSet", "ShortestMatchSet"):
        kind_ref[k] = matchers[k].match_triples(text)
        stream_path(k, (lambda n: lambda: getattr(port, n)(keywords, device=dev))(k),
                    kind_ref[k], planes_stream)
    stream_path("WholeWordLongestMatchSet",
                lambda: port.WholeWordLongestMatchSet(keywords, device=dev),
                wwl_triples["scan route"], wwl_kernels(big_wwl))

    def stream_1m_path():
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = ac1m.match_stream(io.StringIO(text1m))
        t = time.perf_counter() - t
        if len(got) != ONE_M["ac_count"]:
            raise AssertionError(f"1M match_stream: {len(got)} matches != {ONE_M['ac_count']}")
        s, e, _ = ac1m.match_triples(text1m)
        if got != list(zip(s.tolist(), e.tolist())):
            raise AssertionError("1M match_stream != match_triples")
        return (f"match_stream {len(got)} matches == pinned == match_triples on {len(text1m)} "
                f"units in {t} s [{smi}]")

    run_path("AhoCorasickSet 1M keywords match_stream", ("packedcount_hotstate_plane",),
             stream_1m_path)

    # Row-compressed dictionary through the gold branch: one cursor feed over
    # the RowTable form of the sequential scan.
    wide_text32 = wide_base * (TEXT_UNITS // BASE_UNITS)
    gold_times = {}

    def rows_gold_path():
        dev_m = port.AhoCorasickSet(wide_ac_kws, engine="device", device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s, e, v = wide_gold.match_triples(wide_text32)
        gold_times["facade"] = time.perf_counter() - t
        if wide_gold.last_stats.engine != "gold" or wide_gold.last_stats.units != len(wide_text32):
            raise AssertionError(f"gold branch: {wide_gold.last_stats}")
        ds, de, _ = dev_m.match_triples(wide_text32)
        if not (np.array_equal(s, ds) and np.array_equal(e, de)) or len(s) < len(wide_text32) // 200:
            raise AssertionError(f"gold branch != device engine ({len(s)} vs {len(ds)} matches)")
        probe = wide_base[: 1 << 17]
        want = [(a, b) for a, b, _ in gold.gold_match(wide_gold.compiled, probe)]
        if wide_gold.match(probe) != want or not want:
            raise AssertionError("gold branch != the per-character gold loop")
        fuzz_text = "".join(rows_rng.choice(list("abcdefgh "), size=200_000))
        want = [(a, b) for a, b, _ in gold.gold_match(rows_m.compiled, fuzz_text)]
        if rows_m.match(fuzz_text) != want or rows_m.match_stream([fuzz_text[:999],
                                                                    fuzz_text[999:]]) != want:
            raise AssertionError("fuzz RowTable dictionary: gold branch or stream != gold loop")
        return (f"{len(s)} matches on {len(wide_text32)} units == device engine, in "
                f"{gold_times['facade']} s ({gold_times['facade'] * 1e9 / len(wide_text32)} ns/unit); "
                f"== gold loop on {len(probe)} units; fuzz RowTable == gold loop [{smi}]")

    run_path("row-compressed AhoCorasickSet, gold branch", ("seq_states",), rows_gold_path,
             absent=("seq_states_serial",))

    def rows_shortest_path():
        fuzz_text = "".join(rows_rng.choice(list("abcdefgh "), size=200_000))
        sm = port.ShortestMatchSet(rows_kws, engine="gold", device=dev, thresholder=NeverDense())
        want = [(a, b) for a, b, _ in gold.gold_match(sm.compiled, fuzz_text)]
        if not sm.compiled.is_row_compressed or sm.match(fuzz_text) != want or not want:
            raise AssertionError("row-compressed ShortestMatchSet: gold branch != gold loop")
        return f"{len(want)} matches on {len(fuzz_text)} units == the gold loop"

    run_path("row-compressed ShortestMatchSet, gold branch (restart table)",
             ("seq_states_serial",), rows_shortest_path, absent=("seq_states",))

    # A resume point of the pre-tail format ({"state", "off"}): the cursor
    # scans from the carried state until the tail determines it.
    legacy_off = 1 << 20
    legacy_state = int(scan_dfa.seq_states(
        *dense_tab, int32_classes(cls[:legacy_off]), 0, d_seq)[-1])

    def legacy_path():
        st = port.AhoCorasickSet(keywords, device=dev).stream()
        st.load_state_dict({"state": legacy_state, "off": legacy_off})
        got = feed_all(st, [3000, 1 << 20], legacy_off, legacy_off + 3000 + (1 << 20))
        s, e, _ = big.match_triples(text[: legacy_off + 3000 + (1 << 20)])
        keep = e > legacy_off
        want = np.stack([s[keep], e[keep]], axis=1)
        if not np.array_equal(np.asarray(got, dtype=np.int64).reshape(-1, 2), want):
            raise AssertionError(f"legacy resume: {len(got)} matches != {len(want)}")
        return (f"resumed from state {legacy_state} at unit {legacy_off}: {len(got)} matches == "
                f"match_triples past it")

    run_path("AhoCorasickSet stream, legacy resume", ("seq_states",), legacy_path,
             absent=("seq_states_serial",))

    # match(text, listener): False on the first match stops the scan.
    early = {}

    def early_stop_path():
        m = port.AhoCorasickSet(keywords, device=dev)
        m.match(small, lambda t, s, e: False)  # tables uploaded, kernels loaded
        calls = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        m.match(text, lambda t, s, e: calls.append((s, e)) or False)
        early["stop"] = time.perf_counter() - t
        units, delivered = m.last_stats.units, m.last_stats.matches
        if len(calls) != 1 or delivered != 1 or not 0 < units <= 2 * m._LISTENER_CHUNK_MIN:
            raise AssertionError(f"early stop: {len(calls)} calls, {units} units scanned")
        torch.cuda.synchronize()
        t = time.perf_counter()
        n_all = []
        m.match(text, lambda t, s, e: n_all.append(e) or True)
        early["full"] = time.perf_counter() - t
        if m.last_stats.units != len(text) or len(n_all) != len(ac_ref[0]) or \
                not np.array_equal(np.asarray(n_all), ac_ref[1]):
            raise AssertionError("chunked listener scan != match_triples")
        return (f"False on the first match: {units} of {len(text)} units scanned in "
                f"{early['stop']} s; a listener that never stops: {len(n_all)} matches in "
                f"{early['full']} s [{smi}]")

    run_path("match(text, listener) early stop", ("packed_scan_planes",), early_stop_path)

    def readable_path():
        values = [f"v{i}" for i in range(len(keywords))]
        mp = port.AhoCorasickMap(keywords, values, device=dev)
        want = [v for _, _, v in mp.match(small)]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "text.txt")
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(small)
            got = []
            with open(path, encoding="utf-8") as fh:
                mp.match_readable(fh, got.append)
            few = []
            with open(path, encoding="utf-8") as fh:
                mp.match_readable(fh, lambda v: few.append(v) or len(few) < 5)
        if got != want or not want or few != want[:5]:
            raise AssertionError(f"match_readable != match ({len(got)} vs {len(want)} values)")
        return f"{len(got)} values from a {len(small)}-unit file == match; False stops after 5"

    run_path("AhoCorasickMap match_readable", ("packed_scan_planes",), readable_path)

    # The data-parallel sharded scanner: eight shards on the one card (the
    # mesh names the device eight times), held against the single-device
    # matchers' output on the same text.
    mesh = [torch.device("cuda", 0)] * N_SHARDS
    sharded_times = {}
    dp_triples = {}  # the mesh form's triples, for the group form below

    def same_triples(label, got, want):
        for g, w in zip(got, want):
            if not np.array_equal(np.asarray(g), np.asarray(w)):
                raise AssertionError(f"{label}: sharded triples != the single-device matcher's "
                                     f"({len(got[0])} vs {len(want[0])} matches)")

    def timed(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sharded_times[label] = time.perf_counter() - t
        return out

    def sharded_ac_path():
        out = []
        for world in (N_SHARDS, 1, 3):
            sc = sharding.ShardedScanner(big, mesh[:world])
            n = timed(f"AhoCorasickSet count, {world} shards", lambda: sc.count(text))
            got = timed(f"AhoCorasickSet match_triples, {world} shards",
                        lambda: sc.match_triples(text))
            same_triples(f"AhoCorasickSet, {world} shards", got, ac_ref)
            dp_triples.setdefault("AhoCorasickSet", got)
            if n != len(ac_ref[0]) or sc._counter[2] != "packed" or sc._planes[1] != "packed":
                raise AssertionError(f"sharded count {n} != {len(ac_ref[0])} on {world} shards")
            out.append(f"{world} shards: count {n} == triples == single-device, cuts at "
                       f"{sc._shard_boundaries(len(cls), sc._planes[2])}")
        return "; ".join(out)

    run_path("ShardedScanner AhoCorasickSet", ("packed_scan_count", "packed_scan_planes",
                                               "compact_planes"), sharded_ac_path)

    def sharded_kind_path(cls_name, ref):
        def drive():
            sc = sharding.ShardedScanner(matchers[cls_name], mesh)
            got = timed(f"{cls_name} match_triples, {N_SHARDS} shards",
                        lambda: sc.match_triples(text))
            same_triples(cls_name, got, ref)
            dp_triples[cls_name] = got
            n = sc.count(text)
            if n != len(ref[0]):
                raise AssertionError(f"{cls_name}: sharded count {n} != {len(ref[0])}")
            inner = sc._inner if sc._inner is not None else sc
            return (f"{n} matches on {len(text)} units == single-device; cuts at "
                    f"{sc._shard_boundaries(len(cls), inner._planes[2])}")
        run_path(f"ShardedScanner {cls_name}", ("packed_scan_planes", "compact_planes"), drive)

    for k in ("LongestMatchSet", "WholeWordMatchSet", "ShortestMatchSet"):
        sharded_kind_path(k, kind_ref[k])
    sharded_kind_path("LongestMatchMap", matchers["LongestMatchMap"].match_triples(text))

    sweep_kernels = ("wwl_scan_plane", "wwl_sweep_all")

    def sharded_wwl(label, m, full_text, ref):
        sc = sharding.ShardedScanner(m, mesh)
        got = timed(f"{label} match_triples, {N_SHARDS} shards",
                    lambda: sc.match_triples(full_text))
        same_triples(label, got, ref)
        dp_triples.setdefault(label, got)
        return f"{len(got[0])} matches on {len(full_text)} units == single-device"

    run_path("ShardedScanner WholeWordLongestMatchSet", sweep_kernels, lambda: sharded_wwl(
        "WholeWordLongestMatchSet", big_wwl, text, wwl_triples["scan route"]))
    run_path("ShardedScanner WholeWordLongestMatchSet mixed", sweep_kernels, lambda: sharded_wwl(
        "WholeWordLongestMatchSet mixed", mixed, text7, wwl_triples["mixed route"]))

    def sharded_walk_path():
        # Neither scan table (forced): the per-start walk at every position.
        real = scan_wwl.scan_applicable, scan_wwl.mixed_scan_applicable
        scan_wwl.scan_applicable = scan_wwl.mixed_scan_applicable = lambda m: False
        try:
            return sharded_wwl("WholeWordLongestMatchSet walk branch", big_wwl, text,
                               wwl_triples["scan route"])
        finally:
            scan_wwl.scan_applicable, scan_wwl.mixed_scan_applicable = real

    run_path("ShardedScanner WholeWordLongestMatchSet walk branch", ("wwl_walks_at",),
             sharded_walk_path)

    def sharded_1m_path():
        sc = sharding.ShardedScanner(ac1m, mesh)
        n = sc.count(text1m)
        if n != ONE_M["ac_count"] or sc._counter[2] != "packedcount":
            raise AssertionError(f"sharded 1M count {n} != {ONE_M['ac_count']} "
                                 f"({sc._counter[2]})")
        same_triples("AhoCorasickSet 1M", sc.match_triples(text1m), ac1m.match_triples(text1m))
        if sc._planes[1] != "hotstate":
            raise AssertionError(f"sharded 1M planes took {sc._planes[1]}, not hotstate")
        nl = sharding.ShardedScanner(huge_matchers["LongestMatchSet"], mesh).count(text1m)
        if nl != ONE_M["longest_count"]:
            raise AssertionError(f"sharded 1M longest count {nl} != {ONE_M['longest_count']}")
        return (f"count {n} == pinned (packedcount), triples == single-device (hotstate), "
                f"Longest {nl} == pinned, on {len(text1m)} units, cuts at "
                f"{sc._shard_boundaries(len(text1m), sc._planes[2])}")

    run_path("ShardedScanner 1M keywords", ("packedcount_count", "packedcount_hotstate_plane"),
             sharded_1m_path)

    demo32 = demo_m._classes((demo_text * (TEXT_UNITS // len(demo_text) + 1))[:TEXT_UNITS])

    # The references, made before the path so that its counts hold only the
    # stitched scan: the serial walk, and the lane scan held to it far past
    # the lengths phase 3 holds it to the serial twin.
    arrival_cases = []
    for label, table, c, d in (
            ("demo dictionary", demo_tab, demo32, max(demo_m.compiled.max_depth, 1)),
            ("10k dictionary", dense_tab[0], cls[:TEXT_UNITS], d_seq)):
        c_d = int32_classes(c)
        want = timed(f"seq_states_serial, {label}, {len(c)} units",
                     lambda: scan_dfa.seq_states(table, None, c_d, 0).cpu().numpy())
        lanes = timed(f"seq_states (lane scan, d = {d}), {label}, {len(c)} units",
                      lambda: scan_dfa.seq_states(table, None, c_d, 0, d).cpu().numpy())
        if not np.array_equal(lanes, want):
            raise AssertionError(f"lane scan != seq_states_serial ({label})")
        print(f"  arrival reference {label}, table {tuple(table.shape)}, {len(c)} units: "
              f"the lane scan (d = {d}) == seq_states_serial")
        arrival_cases.append((label, table, c, want, d))

    # Each caller held to its stitch forms: the goto closures' arrival states
    # declare their depth (the synchronized kernels) ...
    def arrival_path():
        out = []
        for label, table, c, want, d in arrival_cases:
            got = timed(f"sharded_arrival_states, {label}, {len(c)} units, sync_depth {d}",
                        lambda: sharding.sharded_arrival_states(table, c, mesh, sync_depth=d))
            if not np.array_equal(got, want):
                raise AssertionError(f"sharded arrival states != seq_states_serial ({label})")
            out.append(f"{label}, table {tuple(table.shape)}, {len(c)} units: == "
                       f"seq_states_serial (last state {int(got[-1])})")
        return "; ".join(out)

    run_path("sharded_arrival_states", ("state_maps", "entry_fold", "rescan"), arrival_path,
             absent=("seq_states", "seq_states_serial", "state_maps_all", "rescan_serial"))

    # ... and the shortest restart table, which does not synchronize, takes
    # the forms for any table, as does a caller that declares no depth.
    restart_flat = int32_classes(short_cls)
    restart_want = scan_dfa.seq_states(restart_tab[0], None, restart_flat, 0)

    def restart_stitch_path():
        got = stitch.stitched_scan(restart_tab[0], restart_flat.reshape(N_SHARDS, -1))
        if not torch.equal(got.reshape(-1), restart_want):
            raise AssertionError("stitched_scan of the restart table != seq_states_serial")
        return (f"stitched_scan, 10k shortest restart table {tuple(restart_tab[0].shape)}, "
                f"{N_SHARDS} x {len(short_cls) // N_SHARDS} units == seq_states_serial")

    run_path("stitched_scan restart table", ("state_maps_all", "entry_fold", "rescan_serial"),
             restart_stitch_path, absent=("state_maps", "rescan"))

    def arrival_any_path():
        out = []
        for label, table, c, want, _ in (
                *arrival_cases, ("10k shortest restart table", restart_tab[0], short_cls,
                                 restart_want.cpu().numpy(), None)):
            got = timed(f"sharded_arrival_states, {label}, {len(c)} units, no sync_depth",
                        lambda: sharding.sharded_arrival_states(table, c, mesh))
            if not np.array_equal(got, want):
                raise AssertionError(f"sharded arrival states without a depth != "
                                     f"seq_states_serial ({label})")
            out.append(f"{label}, table {tuple(table.shape)}, {len(c)} units: == "
                       f"seq_states_serial")
        return "; ".join(out)

    run_path("sharded_arrival_states, no sync_depth",
             ("state_maps_all", "entry_fold", "rescan_serial"), arrival_any_path,
             absent=("seq_states", "seq_states_serial", "state_maps", "rescan"))

    def sharded_stream_path():
        def feed_arrays(st, pieces, start):
            parts, i = [], start
            for k in pieces:
                parts.append(st.feed(text[i: i + k], i + k >= len(text)))
                i += k
            return [np.concatenate([p[j] for p in parts]) for j in range(3)]

        sc = sharding.ShardedScanner(big, mesh)
        got = timed(f"ShardedStream AhoCorasickSet, {len(sizes)} feeds",
                    lambda: feed_arrays(sc.stream(), sizes, 0))
        same_triples("ShardedStream", got, ac_ref)
        dp_triples["stream"] = got
        half = len(sizes) // 2
        cut = sum(sizes[:half])
        s1 = sc.stream()
        first = feed_arrays(s1, sizes[:half], 0)
        state = json.loads(json.dumps(s1.state_dict()))
        s2 = sharding.ShardedScanner(port.AhoCorasickSet(keywords, engine="device", device=dev),
                                     mesh).stream()
        s2.load_state_dict(state)
        rest = feed_arrays(s2, sizes[half:], cut)
        same_triples("ShardedStream resumed", [np.concatenate(p) for p in zip(first, rest)], got)
        return (f"{len(got[0])} matches over {len(sizes)} feeds == match_triples; resumed at "
                f"unit {cut} in a fresh scanner == unbroken")

    run_path("ShardedStream AhoCorasickSet", ("packed_scan_planes",), sharded_stream_path)

    def graft_path():
        graft_entry.dryrun_multigpu(N_SHARDS)
        fn, example = graft_entry.entry()
        got = fn(*example)
        want = scan_block.packed_scan_planes_plain(*example, fn.halo, fn.state_bits)
        torch.cuda.synchronize()
        if got.device != example[1].device or max_err((got,), (want,)):
            raise AssertionError("graft_entry.entry(): fn(*example_args) != its plain twin")
        return (f"dryrun_multigpu({N_SHARDS}) passed; entry() planes {tuple(got.shape)} over "
                f"{tuple(example[1].shape)} windows, {int((widen(got) != 0).sum())} hot positions")

    run_path("graft_entry", ("packed_scan_count", "packed_scan_planes", "wwl_scan_plane",
                             "wwl_sweep_all", "state_maps", "entry_fold", "rescan",
                             "seq_states_serial", "table_sharded_scan"),
             graft_path, absent=("state_maps_all", "rescan_serial"))

    # The table-sharded scanner: the same mesh read as a model mesh, the
    # table's rows in eight separate allocations on the one card, held against
    # the single-device matchers' output on the same text.
    tp_kernel = ("table_sharded_scan",)
    tp_scanners = {}
    tp_triples = {}  # the mesh form's triples, for the group form below

    def row_shards(ts, mode):
        """The scanner's shards for ``mode``: (tables, distinct allocations)."""
        tables = ts._built[mode][0]
        return tables, len({t.data_ptr() for tab in tables for t in tab.shards})

    def tp_kind_path(label, m, full_text, ref, layout, mode, expected=tp_kernel):
        def drive():
            ts = sharding.TableShardedScanner(m, mesh)
            tp_scanners[label] = ts
            if ts.layout != layout:
                raise AssertionError(f"{label}: layout {ts.layout}, expected {layout}")
            got = timed(f"TableShardedScanner {label} match_triples, {N_SHARDS} row shards",
                        lambda: ts.match_triples(full_text))
            same_triples(f"TableShardedScanner {label}", got, ref)
            tp_triples[label] = got
            n = timed(f"TableShardedScanner {label} count, {N_SHARDS} row shards",
                      lambda: ts.count(full_text))
            if n != len(ref[0]) or n <= 0:
                raise AssertionError(f"{label}: table-sharded count {n} != {len(ref[0])}")
            inner = ts._inner if ts._inner is not None else ts
            tables, allocations = row_shards(inner, mode)
            if allocations != N_SHARDS or tables[0].n_model != N_SHARDS:
                raise AssertionError(f"{label}: {allocations} allocations for {N_SHARDS} shards")
            return (f"{n} matches on {len(full_text)} units == single-device; layout "
                    f"{ts.layout}, {N_SHARDS} shards of {tables[0].rows_per} rows x "
                    f"{tables[0].stride} classes, {allocations} allocations")
        run_path(f"TableShardedScanner {label}", expected, drive)

    tp_kind_path("AhoCorasickSet", big, text, ac_ref, "planes", "planes")
    tp_kind_path("LongestMatchSet", matchers["LongestMatchSet"], text,
                 kind_ref["LongestMatchSet"], "planes", "planes")
    tp_kind_path("WholeWordMatchSet", matchers["WholeWordMatchSet"], text,
                 kind_ref["WholeWordMatchSet"], "planes", "planes")
    tp_kind_path("ShortestMatchSet", matchers["ShortestMatchSet"], text,
                 kind_ref["ShortestMatchSet"], "shortest", "planes")
    # The raw plane stays on the card and is swept there.
    tp_wwl_kernels = tp_kernel + ("wwl_sweep_all",)
    tp_kind_path("WholeWordLongestMatchSet", big_wwl, text, wwl_triples["scan route"], "wwl",
                 "raw", tp_wwl_kernels)
    tp_kind_path("WholeWordLongestMatchSet mixed", mixed, text7, wwl_triples["mixed route"],
                 "wwl", "raw", tp_wwl_kernels)

    def tp_mesh2_path():
        out = []
        for shape in ((2, 4), (4, 2)):
            ts = sharding.TableShardedScanner(big, sharding.dp_tp_mesh(mesh, shape))
            got = timed(f"TableShardedScanner AhoCorasickSet match_triples, {shape} mesh",
                        lambda: ts.match_triples(text))
            same_triples(f"TableShardedScanner {shape}", got, ac_ref)
            n = ts.count(text)
            tables, allocations = row_shards(ts, "planes")
            if n != len(ac_ref[0]) or len(tables) != shape[0] or allocations != shape[1]:
                raise AssertionError(f"{shape} mesh: count {n}, {len(tables)} model groups, "
                                     f"{allocations} allocations")
            out.append(f"{shape}: count {n} == triples == single-device, {len(tables)} model "
                       f"groups x {shape[1]} row shards ({allocations} allocations shared)")
        table, halo, sb = tp_scanners["AhoCorasickSet"]._table, pd.halo, pd.state_bits
        n = timed(f"sharded_table_count, {N_SHARDS} row shards, upload included",
                  lambda: sharding.sharded_table_count(table, cls, halo, sb, mesh))
        if n != len(ac_ref[0]):
            raise AssertionError(f"sharded_table_count {n} != {len(ac_ref[0])}")
        return "; ".join(out) + f"; sharded_table_count {n} == count"

    run_path("TableShardedScanner data x model meshes, sharded_table_count", tp_kernel,
             tp_mesh2_path)

    def tp_1m_path():
        ts = sharding.TableShardedScanner(ac1m, mesh)
        tp_scanners["1M"] = ts
        if ts.layout != "hotstate":
            raise AssertionError(f"1M dictionary: layout {ts.layout}, expected hotstate")
        n = timed("TableShardedScanner 1M count, upload included", lambda: ts.count(text1m))
        if n != ONE_M["ac_count"]:
            raise AssertionError(f"table-sharded 1M count {n} != {ONE_M['ac_count']}")
        got = timed("TableShardedScanner 1M match_triples", lambda: ts.match_triples(text1m))
        same_triples("TableShardedScanner 1M", got, ac1m.match_triples(text1m))
        tables, allocations = row_shards(ts, "hotstate")
        nbytes = sum(t.nbytes for t in tables[0].shards)
        if allocations != N_SHARDS or ts._built["count_packed"][0] is not tables or \
                nbytes < c1m.num_states * c1m.num_classes * 4:
            raise AssertionError(f"1M dictionary: {allocations} allocations, {nbytes} B")
        lm = sharding.TableShardedScanner(huge_matchers["LongestMatchSet"], mesh)
        nl = lm.count(text1m)
        if nl != ONE_M["longest_count"] or lm.layout != "hotstate":
            raise AssertionError(f"table-sharded 1M longest count {nl} != "
                                 f"{ONE_M['longest_count']}")
        return (f"count {n} == pinned (count_packed mode), triples == the single-device "
                f"facade's (hotstate mode), Longest {nl} == pinned, on {len(text1m)} units; "
                f"{c1m.num_states} x {c1m.num_classes} table in {N_SHARDS} allocations of "
                f"{tables[0].rows_per} rows, {nbytes} B")

    run_path("TableShardedScanner 1M keywords", tp_kernel, tp_1m_path)

    def tp_stream_path():
        def feed_arrays(st, pieces):
            parts, i = [], 0
            for k in pieces:
                parts.append(st.feed(text[i: i + k], i + k >= len(text)))
                i += k
            return [np.concatenate([p[j] for p in parts]) for j in range(3)]

        ts = tp_scanners["AhoCorasickSet"]
        got = timed(f"TableShardedScanner stream AhoCorasickSet, {len(sizes)} feeds",
                    lambda: feed_arrays(ts.stream(), sizes))
        same_triples("TableShardedScanner stream", got, ac_ref)
        tp_triples["stream"] = got
        return f"{len(got[0])} matches over {len(sizes)} feeds == match_triples"

    run_path("TableShardedScanner stream AhoCorasickSet", tp_kernel, tp_stream_path)

    # The group form on the card: an NCCL process group of one rank in this
    # process, on cuda:0.  Its model axis has one rank, so the table-sharded
    # facades scan with table_sharded_scan's one launch (the step loop must
    # not launch), the data-parallel ones with their plans' kernels; each ==
    # the mesh form's triples above.  Then the step loop driven through
    # group_scan with NCCL's all_reduce: eager and as a CUDA graph.
    import torch.distributed as dist

    group_t0 = time.perf_counter()
    torch.cuda.set_device(0)
    group_dir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{group_dir}/store", rank=0,
                            world_size=1)
    try:
        world = dist.group.WORLD
        step_kernel = ("table_sharded_step", "table_sharded_classes")
        one_launch = ("table_sharded_scan",)

        def tp_group_path(label, m, full_text, expected=one_launch, form=world):
            def drive():
                ts = sharding.TableShardedScanner(m, group=form)
                got = timed(f"TableShardedScanner {label} match_triples, group= (NCCL, world 1)",
                            lambda: ts.match_triples(full_text))
                same_triples(f"TableShardedScanner {label}, group=", got, tp_triples[label])
                n = ts.count(full_text)
                inner = ts._inner if ts._inner is not None else ts
                tables = next(iter(inner._built.values()))[0]
                if n != len(got[0]) or len(tables) != 1 or tables[0].device != dev_index:
                    raise AssertionError(f"{label}, group=: count {n}, shards {len(tables)} on "
                                         f"{tables[0].device}")
                return (f"{n} matches on {len(full_text)} units == the mesh form's; layout "
                        f"{ts.layout}, the whole table one shard on {tables[0].device}")
            name = "WORLD" if form is world else f"dp_tp_groups() {form.shape}"
            run_path(f"TableShardedScanner {label} group={name}", expected, drive,
                     absent=step_kernel)

        dev_index = torch.device("cuda", torch.cuda.current_device())
        tp_group_path("AhoCorasickSet", big, text)
        tp_group_path("AhoCorasickSet", big, text, form=sharding.dp_tp_groups())
        for k in ("LongestMatchSet", "WholeWordMatchSet", "ShortestMatchSet"):
            tp_group_path(k, matchers[k], text)
        tp_group_path("WholeWordLongestMatchSet", big_wwl, text, one_launch + ("wwl_sweep_all",))
        tp_group_path("WholeWordLongestMatchSet mixed", mixed, text7,
                      one_launch + ("wwl_sweep_all",))

        def tp_group_rest_path():
            ts = sharding.TableShardedScanner(big, group=world)
            parts, i = [], 0
            st = ts.stream()
            for k in sizes:
                parts.append(st.feed(text[i: i + k], i + k >= len(text)))
                i += k
            same_triples("TableShardedScanner stream, group=",
                         [np.concatenate([p[j] for p in parts]) for j in range(3)],
                         tp_triples["stream"])
            table, halo, sb = tp_scanners["AhoCorasickSet"]._table, pd.halo, pd.state_bits
            n = timed("sharded_table_count, group= (NCCL, world 1)",
                      lambda: sharding.sharded_table_count(table, cls, halo, sb, group=world))
            n1m = timed("TableShardedScanner 1M count, group= (NCCL, world 1)",
                        lambda: sharding.TableShardedScanner(ac1m, group=world).count(text1m))
            if n != len(ac_ref[0]) or n1m != ONE_M["ac_count"]:
                raise AssertionError(f"group=: sharded_table_count {n}, 1M count {n1m}")
            return (f"stream over {len(sizes)} feeds == the mesh form's; sharded_table_count {n} "
                    f"== count; 1M count {n1m} == pinned (count_packed mode, hotstate layout)")

        run_path("TableShardedScanner stream, sharded_table_count, 1M count, group=", one_launch,
                 tp_group_rest_path, absent=step_kernel)

        def dp_group_path(label, m, full_text, expected):
            def drive():
                sc = sharding.ShardedScanner(m, group=world)
                got = timed(f"ShardedScanner {label} match_triples, group= (NCCL, world 1)",
                            lambda: sc.match_triples(full_text))
                same_triples(f"ShardedScanner {label}, group=", got, dp_triples[label])
                n = sc.count(full_text)
                if n != len(got[0]):
                    raise AssertionError(f"ShardedScanner {label}, group=: count {n}")
                out = f"{n} matches on {len(full_text)} units == the mesh form's"
                if label == "AhoCorasickSet":
                    parts, i = [], 0
                    st = sc.stream()
                    for k in sizes:
                        parts.append(st.feed(full_text[i: i + k], i + k >= len(full_text)))
                        i += k
                    same_triples("ShardedStream, group=",
                                 [np.concatenate([p[j] for p in parts]) for j in range(3)],
                                 dp_triples["stream"])
                    out += f"; stream over {len(sizes)} feeds == the mesh form's"
                return out
            run_path(f"ShardedScanner {label} group=", expected, drive)

        dp_group_path("AhoCorasickSet", big, text, ("packed_scan_count", "packed_scan_planes"))
        for k in ("LongestMatchSet", "WholeWordMatchSet", "ShortestMatchSet"):
            dp_group_path(k, matchers[k], text, ("packed_scan_planes",))
        dp_group_path("WholeWordLongestMatchSet", big_wwl, text, sweep_kernels)

        print(f"group-form facades (NCCL world 1, with its set-up): "
              f"{time.perf_counter() - group_t0} s")
        from ahocorasick_tpu_torch.bench import scan_variants

        t_loop = time.perf_counter()
        A10 = table10k.shape[1]
        w10 = scan_batched.classes_to_device(scan_batched.chunk_classes(cls, 512, pd.halo, A10),
                                             A10, dev)
        # The step loop's three main-path shapes, one rank holding the whole
        # table: the 10k planes and count, the 1M count-packed count.
        cells = scan_variants.step_cells(table10k, w10, pd.halo, pd.state_bits, table1m, w1m,
                                         halo1m_host, sb1m_host)
        mesh_of = {"10k planes": st10k, "10k count": st10k, "1M count_packed": st1m}
        # The step and its prep against their twins, launch by launch (not a path).
        twins = {label: step_loop_vs_twin(label, *cell, mesh_of[label], errs)
                 for label, cell in cells.items()}

        def reduce(bufs):
            dist.all_reduce(bufs[0].view(torch.int32), group=world)

        def as_words(x):
            return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF if x.dim() else x.reshape(1)

        loop_graphs = {}

        def graph_path():
            """group_scan with NCCL's all_reduce: eager, then with a
            StepGraphs (its first call of the key runs eagerly, its second
            captures and replays, here on other windows of the shape: each
            window's classes reversed), then replayed on the first windows
            again; each == the twin and table_sharded_scan."""
            done = []
            for label, (shard, w, halo, sb, mode) in cells.items():
                graphs = ktp.StepGraphs()
                other = w.flip(1).contiguous()  # every window's classes reversed
                runs = [ktp.group_scan([(0, shard)], x, halo, sb, mode, reduce, g)[0]
                        for x, g in ((w, None), (w, graphs), (other, graphs), (w, graphs))]
                mesh = [as_words(ktp.table_sharded_scan(mesh_of[label], x, halo, sb, mode))
                        for x in (w, other)]
                want = (twins[label], mesh[0], mesh[1], mesh[0])
                if len(graphs) != 1 or not torch.equal(twins[label], mesh[0]) or any(
                        not torch.equal(as_words(g), x) for g, x in zip(runs, want)):
                    raise AssertionError(f"group_scan {label}: the eager loop, the graph or its "
                                         f"replays != the twin or table_sharded_scan")
                if torch.equal(mesh[0], mesh[1]):
                    raise AssertionError(f"group_scan {label}: the two windows scan the same")
                loop_graphs[label] = graphs
                done.append(f"{label}: eager == graph == twin == table_sharded_scan, "
                            f"captured and replayed on other windows, replayed again ({halo} + "
                            f"{ktp.step_segments(w.shape[0], w.shape[1] - halo, halo, mode)[1]} "
                            f"steps)")
            return "; ".join(done)

        run_path("group_scan, NCCL world 1: eager and as a CUDA graph", step_kernel, graph_path)

        # The step's times: the K sweep (each K's step, captured all_reduce,
        # prep and loops), then, at step_segments' K, the step alone and with
        # its all_reduce, one lane's launch, the eager loop, the graph replay
        # and the mesh form's table_sharded_scan on the same windows.
        sweep = scan_variants.step_sweep(cells, world)["step_sweep"]
        print(f"step K sweep {json.dumps({'card': smi, **sweep})}")
        for label, rows in sweep.items():
            _, w_s, halo_s, _, mode_s = cells[label]
            best = min(rows.values(), key=lambda r: r["model_ms"])
            fastest = min(rows.values(), key=lambda r: r["replay_ms"])
            print(f"step K sweep, {label}: " + "; ".join(
                f"K={r['K']} {r['steps']} steps x ({r['step_ms']} + {r['all_reduce_ms']}) = "
                f"{r['model_ms']} ms, graph {r['replay_ms']} ms, eager {r['eager_ms']} ms"
                for r in rows.values()) + f"; least model: K={best['K']}, fastest replay: "
                f"K={fastest['K']}; step_segments: K="
                f"{ktp.step_segments(w_s.shape[0], w_s.shape[1] - halo_s, halo_s, mode_s)[0]} "
                f"[{smi}]")

        def step_times(label, shard, w, halo, sb, mode):
            B, W = w.shape
            C = W - halo
            K, L = ktp.step_segments(B, C, halo, mode)
            counting = mode in ("count", "count_packed")

            def buffers(lanes, body):
                out = (torch.zeros(lanes, dtype=torch.int64, device=dev) if counting
                       else torch.empty((1, body), dtype=torch.uint32, device=dev))
                return (torch.zeros(lanes, dtype=torch.uint32, device=dev), out,
                        torch.zeros(1, dtype=torch.int64, device=dev) if counting else None)

            classes = ktp.step_classes(w, halo, (K, L))
            words, out, total = buffers(B * K, B * C)
            t = halo + 1  # folds a body position and looks the next one up
            step = lambda: ktp.table_sharded_step(shard, 0, words, classes, t, halo, sb, mode,
                                                  (K, L), C, out, total)
            reduce_words = lambda: dist.all_reduce(words.view(torch.int32), group=world)
            # One lane of one window of halo + 4 classes: the launch's latency floor.
            c1 = ktp.step_classes(w[:1, : halo + 4].contiguous(), halo, (1, 4))
            words1, out1, total1 = buffers(1, 4)
            one = lambda: ktp.table_sharded_step(shard, 0, words1, c1, t, halo, sb, mode, (1, 4),
                                                 4, out1, total1)
            # The eager masked-index chain of the JAX body's gather at the
            # lanes' states and step-t classes.
            flat64 = shard.view(torch.int32).reshape(-1).to(torch.int64) & 0xFFFFFFFF
            s64 = (words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) & ((1 << sb) - 1)
            c64 = classes[t].view(ktp._signed(classes.dtype)).to(torch.int64) & 0xFFFF

            def library_chain():
                mine = s64 < shard.shape[0]
                return torch.where(mine, flat64[torch.where(mine, s64, 0) * shard.shape[1] + c64],
                                   0)

            graphs = loop_graphs[label]
            (graph, *_), = graphs._graphs.values()
            rec = {
                "step": cuda_ms(step, 200), "card": cuda_ms(step, 200, queued=True),
                "step_all_reduce": cuda_ms(lambda: (step(), reduce_words()), 200),
                "all_reduce_graph": sweep[label][f"K={K}"]["all_reduce_ms"],
                "floor": cuda_ms(one, 200, queued=True),
                "loop": cuda_ms(lambda: ktp.group_scan([(0, shard)], w, halo, sb, mode, reduce),
                                3),
                "graph_call": cuda_ms(lambda: ktp.group_scan([(0, shard)], w, halo, sb, mode,
                                                             reduce, graphs), 10),
                "replay": cuda_ms(graph.replay, 10),
                "mesh_scan": cuda_ms(lambda: ktp.table_sharded_scan(mesh_of[label], w, halo, sb,
                                                                    mode), 20),
                "plain": cuda_ms(lambda: ktp.table_sharded_step_plain(
                    shard, 0, words, classes, t, halo, sb, mode, (K, L), C, out, total), 3),
                "prep": cuda_ms(lambda: ktp.step_classes(w, halo, (K, L), classes), 20),
                "prep_card": cuda_ms(lambda: ktp.step_classes(w, halo, (K, L), classes), 20,
                                     queued=True),
                "prep_plain": cuda_ms(lambda: ktp.step_classes_plain(w, halo, (K, L)), 3),
                "library": cuda_ms(library_chain, 20),
                # one PyTorch call for the prep where the lanes tile the body
                # exactly: the windows' lane views, copied class-major
                "prep_library": (cuda_ms(lambda: w.unfold(1, halo + L, L).permute(2, 0, 1)
                                         .contiguous(), 20) if K * L == C else None),
                "lanes": B * K, "steps": halo + L, "K": K, "window_bytes": w.element_size(),
                "window_nbytes": w.numel() * w.element_size(),
                "class_nbytes": classes.numel() * classes.element_size()}
            print(f"time table_sharded_step, {label} ({B} x {W} windows, K={K}, {B * K} lanes, "
                  f"{halo + L} launches and all_reduces a call, NCCL world 1): step through the "
                  f"wrapper {rec['step']} ms, card time {rec['card']} ms, step + all_reduce "
                  f"{rec['step_all_reduce']} ms, captured all_reduce {rec['all_reduce_graph']} "
                  f"ms, one-lane step (latency floor) {rec['floor']} ms; the eager loop "
                  f"{rec['loop']} ms, the graph through group_scan {rec['graph_call']} ms, its "
                  f"bare replay {rec['replay']} ms, beside table_sharded_scan "
                  f"({mesh_of[label].n_model} shards, the mesh form) {rec['mesh_scan']} ms; "
                  f"plain twin {rec['plain']} ms, eager masked-index chain {rec['library']} ms; "
                  f"the prep table_sharded_classes {rec['prep']} ms through the wrapper, "
                  f"{rec['prep_card']} ms card time, twin {rec['prep_plain']} ms, the lane views "
                  f"copied class-major (one PyTorch call) {rec['prep_library']} ms [{smi}]")
            return rec

        step_rec = {{"10k planes": "planes", "10k count": "count",
                     "1M count_packed": "1M"}[label]: step_times(label, *cell)
                    for label, cell in cells.items()}
        del loop_graphs
        print(f"group_scan phases (NCCL world 1: step vs twin, the graph path, the K sweep, "
              f"step times): {time.perf_counter() - t_loop} s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(group_dir, ignore_errors=True)

    # Two and four ranks on the one card (NCCL refuses two ranks on one GPU:
    # gloo, which carries CUDA tensors for all_reduce and all_gather): the
    # 1-axis group form at world 2 and the 2-axis (2, 2) form at world 4, on
    # the kernel, == the mesh form.  The ranks load the table and classes
    # from a file and build nothing: the library is the one built above.
    def gloo_spawn():
        import torch.multiprocessing as mp

        spawn_dir = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
        try:
            return spawn_in(spawn_dir, mp)
        finally:
            shutil.rmtree(spawn_dir, ignore_errors=True)

    def spawn_in(spawn_dir, mp):
        data = os.path.join(spawn_dir, "table.npz")
        cls_g = cls[:BASE_UNITS]
        np.savez(data, table=table10k, cls=cls_g, halo=pd.halo, state_bits=pd.state_bits)
        out = []
        # The eager step loop's launches a rank, five modes: halo + L + 1 a
        # mode at step_segments' lanes over the rank's windows (all of them
        # at world 2, half at world 4's (2, 2)).
        B_g = scan_batched.chunk_classes(cls_g, 512, pd.halo, table10k.shape[1]).shape[0]
        want_steps = {world_size: sum(pd.halo + ktp.step_segments(
            -(-B_g // n_data), 512, pd.halo, mode)[1] + 1 for mode in ktp.MODES)
            for world_size, n_data in ((2, 1), (4, 2))}
        for world_size, layout in ((2, [dev_index] * 2),
                                   (4, sharding.dp_tp_mesh([dev_index] * 4, (2, 2)))):
            want = {mode: sharding._table_sharded_run(table10k, cls_g, pd.halo, pd.state_bits,
                                                      layout, 512, mode) for mode in ktp.MODES}
            rank_dir = os.path.join(spawn_dir, f"world{world_size}")
            os.makedirs(rank_dir)
            t = time.perf_counter()
            ctx = mp.spawn(gloo_rank, args=(world_size, os.path.join(rank_dir, "init"), data,
                                            rank_dir), nprocs=world_size, join=False)
            deadline = time.monotonic() + GLOO_JOIN_S
            try:
                while not ctx.join(timeout=5):
                    if time.monotonic() > deadline:
                        raise AssertionError(f"the {world_size} gloo ranks did not finish in "
                                             f"{GLOO_JOIN_S} s")
            finally:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                        proc.join(10)
            seconds = time.perf_counter() - t
            for r in range(world_size):
                with np.load(os.path.join(rank_dir, f"rank{r}.npz")) as z:
                    for mode, w in want.items():
                        w = np.asarray([w]) if isinstance(w, int) else w.view(torch.int32).cpu(
                            ).numpy()
                        if not np.array_equal(z[mode], w):
                            raise AssertionError(f"gloo world {world_size}, rank {r}, mode "
                                                 f"{mode}: != the mesh form")
                    steps, scans, preps = z["launches"]
                    if steps != want_steps[world_size] or scans or preps != len(ktp.MODES):
                        raise AssertionError(f"gloo world {world_size}, rank {r}: launches "
                                             f"table_sharded_step {steps} (want "
                                             f"{want_steps[world_size]}), table_sharded_scan "
                                             f"{scans}, table_sharded_classes {preps}")
            out.append(f"world {world_size} ({'1-axis' if world_size == 2 else '(2, 2)'}): "
                       f"every rank's five modes == the mesh form, {steps} step launches a rank "
                       f"(halo + L + 1 a mode), {preps} preps, "
                       f"{seconds} s with the spawn")
        return "; ".join(out)

    t = time.perf_counter()
    print(f"gloo ranks on the card, 10k table over {BASE_UNITS} units: {gloo_spawn()} "
          f"({time.perf_counter() - t} s) [{smi}]")
    print(f"group-form phases (NCCL world 1: facades, step vs twin, step times; the gloo "
          f"spawns): {time.perf_counter() - group_t0} s")

    def corpus_path():
        crng = np.random.default_rng(SEED + 11)
        docs = []
        for _ in range(CORPUS_DOCS):
            a = int(crng.integers(0, BASE_UNITS - 4096))
            docs.append(small[a: a + int(crng.integers(0, 4097))])
        docs += [text[: 1 << 18], ""]  # one document over the device threshold, one empty
        m = port.AhoCorasickSet(keywords, engine="device", device=dev)
        seen = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        results, stats = corpus.scan_corpus(m, docs, on_result=lambda i, ms: seen.append(i))
        sharded_times["scan_corpus"] = time.perf_counter() - t
        want = [m.match(d) for d in docs]
        if results != want or seen != list(range(len(docs))) or stats.retries or \
                stats.gold_fallbacks or stats.documents != len(docs) or \
                stats.units != sum(map(len, docs)) or \
                stats.matches != sum(map(len, want)) or stats.matches <= 0:
            raise AssertionError(f"scan_corpus != match per document: {stats}")
        # A failing matcher on the card gets its retries and then its own
        # error, not an answer from the gold engine on the host.
        calls = []

        def broken(doc, listener=None):
            calls.append(doc)
            raise RuntimeError("launch failed")

        m.match = broken
        try:
            corpus.scan_corpus(m, docs[:1], max_retries=2)
        except RuntimeError as e:
            if str(e) != "launch failed" or len(calls) != 3:
                raise AssertionError(f"scan_corpus on a failing card matcher: {e!r}, {calls}")
        else:
            raise AssertionError("scan_corpus answered from the host for a matcher on the card")
        del m.match
        return (f"{stats.documents} documents, {stats.units} units, {stats.matches} matches == "
                f"match per document, {stats.seconds} s ({stats.gbps} GB/s)")

    run_path("scan_corpus", ("packed_scan_planes",), corpus_path)

    # The benchmark entry points (the port's bench package): every kind of
    # the AC family through device_engine="batched2" (the stride-2 kernels on
    # the 10k dictionary's 152 MB table), the BASELINE.json suite, the
    # headline, the scaling record and a profiled run.
    bench_out = {}

    def batched2_path():
        out = []
        engines = port.models.matchers._PfacEngine
        for name in ("AhoCorasickSet", "LongestMatchSet", "WholeWordMatchSet", "ShortestMatchSet",
                     "LongestMatchMap"):
            args = (keywords, [f"v{i}" for i in range(len(keywords))]) if name.endswith("Map") \
                else (keywords,)
            want = getattr(port, name)(*args, engine="device", device=dev).match_triples(small)
            engines.device_engine = "batched2"
            try:
                m = getattr(port, name)(*args, engine="device", device=dev)
                got = m.match_triples(small)
                inner = m._ac if name.startswith("Shortest") else m
                which = (dispatch.planes_plan(inner.compiled, inner.dev, inner._force()).which,
                         dispatch.count_plan(inner.compiled, inner.dev, inner._force()).which)
                rec = bench_main.run_config(
                    f"batched2-{name}", kind=m.kind, is_map=m.is_map, keywords=keywords,
                    case_sensitive=True, text=small, reps=1, device=dev)
            finally:
                engines.device_engine = "rowdfa"
            for g, w in zip(got, want):
                if not np.array_equal(g, w):
                    raise AssertionError(f"{name} batched2 triples != the default engine's")
            if which != ("rowdfa2", "rowdfa2") or rec["matches"] != len(want[0]) or \
                    not len(want[0]):
                raise AssertionError(f"{name} batched2: plans {which}, record {rec}, "
                                     f"{len(want[0])} triples")
            print(json.dumps(rec))
            out.append(f"{name} {len(want[0])} (plans {which[0]}, {which[1]})")
        return (f"device_engine=batched2 == the default engine on {len(small)} units: "
                + ", ".join(out) + f"; the records above were measured on [{smi}]")

    run_path("device_engine=batched2, every AC-family kind", ("rowdfa2_count", "rowdfa2_planes",
                                                              "compact_planes"), batched2_path)

    # The probes' entry point (B19): every probe of the four JAX files' main
    # at their sizes, then the residency sweep.
    probe_out = {}

    def probes_path():
        probe_out.update(probes_main.main([]))
        fails = [k for k, v in probe_out["probe6"].items() if isinstance(v, Exception)]
        if fails != ["sublane take_along_axis (8,128)"]:
            raise AssertionError(f"probe6 formulations failing: {fails} (only the sublane "
                                 f"gather of a 32-column table should)")
        outs = [v[1] for mod in ("probe", "probe2") for v in probe_out[mod].values()]
        if any(o.numel() == 0 or o.device.type != "cuda" for o in outs):
            raise AssertionError("a probe returned no output on the card")
        sweep = probe_out["sweep"]
        # every sweep result against its twin, the 470 MB table's included
        for r in sweep:
            name = "row_chain" if r["placement"] == "row_chain" else "chain_gather"
            e = r["max_abs_err"] if r["max_abs_err"] >= 0 else 1
            if r["placement"] != "torch":
                errs[name] = max(errs[name], e)
            if e:
                raise AssertionError(f"residency sweep {r['entries']} entries, "
                                     f"{r['placement']}: max_abs_err {e} against the twin")
        biggest = max(r["entries"] for r in sweep)
        big_rows = [r["placement"] for r in sweep if r["entries"] == biggest]
        if "global" not in big_rows or "row_chain" not in big_rows:
            raise AssertionError(f"residency sweep: the {biggest}-entry table ran only {big_rows}")
        return (f"{sum(len(v) for k, v in probe_out.items() if k != 'sweep')} probe lines, "
                f"{len(sweep)} residency-sweep records over {len({r['entries'] for r in sweep})} "
                f"table sizes [{smi}]")

    run_path("probes (python -m ahocorasick_tpu_torch.probes)",
             ("chain_gather", "row_chain", "onehot_mma", "gather2d"), probes_path)

    # Every AC-family kind under device_engine="pfac2" (the PFAC walk) == the
    # default engine's triples; the references are made before the path, so
    # the packed planes kernel must not launch on it.
    pfac_kinds = ("AhoCorasickSet", "AhoCorasickMap", "LongestMatchSet", "LongestMatchMap",
                  "WholeWordMatchSet", "ShortestMatchSet")
    pfac_args = {name: ((keywords, [f"v{i}" for i in range(len(keywords))])
                        if name.endswith("Map") else (keywords,)) for name in pfac_kinds}
    pfac_refs = {name: getattr(port, name)(*pfac_args[name], engine="device", device=dev)
                 .match_triples(small) for name in pfac_kinds}

    def pfac2_path():
        out = []
        engines = port.models.matchers._PfacEngine
        engines.device_engine = "pfac2"
        try:
            for name in pfac_kinds:
                m = getattr(port, name)(*pfac_args[name], engine="device", device=dev)
                got = m.match_triples(small)
                want = pfac_refs[name]
                if any(not np.array_equal(g, w) for g, w in zip(got, want)) or not len(want[0]):
                    raise AssertionError(f"{name} under pfac2: {len(got[0])} triples != the "
                                         f"default engine's {len(want[0])}")
                if name == "AhoCorasickSet" and m.count(small) != len(want[0]):
                    raise AssertionError("AhoCorasickSet.count under pfac2 != its triples")
                out.append(f"{name} {len(want[0])}")
        finally:
            engines.device_engine = "rowdfa"
        if port.launches["packed_scan_planes"] or port.launches["packed_scan_count"]:
            raise AssertionError(f"the packed kernels launched under pfac2: {dict(port.launches)}")
        return (f"device_engine=pfac2 == the default engine on {len(small)} units: "
                + ", ".join(out))

    run_path("device_engine=pfac2, every AC-family kind", ("pfac2_planes",), pfac2_path)

    # The JAX package's conformance reference (tests/test_pfac2.py) on the
    # 10k dictionary at 32 Mi units: the v1 walk == the v2 walk, and the v2
    # count == the planes' popcount == the packed count.
    def pfac_conformance_path():
        c = big.compiled
        rt = big.dev.ranked
        d = bucket_depth(c.max_depth)
        cp = scan_batched.classes_to_device(scan_pfac2.pad_classes(cls, d, bucket=LANE_BUCKET),
                                            c.num_classes, dev)
        v2 = scan_pfac2.pfac2_bitplanes(rt.trie_next, rt.prefix, rt.match_threshold, cp, d,
                                        (d + 31) // 32, rt.prefix_k, c.num_classes, rt.dead_state)
        n2 = int(scan_pfac2.pfac2_count(rt.trie_next, rt.prefix, rt.match_threshold, cp, d,
                                        rt.prefix_k, c.num_classes, rt.dead_state))
        trie = big.dev.trie_next
        v1 = scan_pfac.pfac_bitplanes(trie, big.dev.is_match, cp, d, (d + 31) // 32,
                                      trie.shape[0] - 1)
        pop = int(scan_block._popcount32(widen(v2)).sum())
        same = torch.equal(v1.view(torch.int32), v2.view(torch.int32))
        if not same or not n2 == pop == count10k:
            raise AssertionError(f"PFAC conformance: v1 == v2 {same}, count {n2}, "
                                 f"popcount {pop}, packed count {count10k}")
        return f"v1 planes == v2 planes {tuple(v2.shape)}; count {n2} == popcount == packed count"

    run_path("PFAC conformance (v1 walk == v2 walk), 10k x 32 Mi units",
             ("pfac2_planes", "pfac2_count", "pfac1_planes"), pfac_conformance_path)

    def suite_path():
        picked = []
        real = bench.ac_kernel_rate

        def recording(m, *a, **k):
            rate = real(m, *a, **k)
            picked.append((m.compiled.num_states, rate[2], dispatch.planes_plan(
                m.compiled, m.dev).which))
            return rate

        bench.ac_kernel_rate = recording
        t = time.perf_counter()
        try:
            bench_main.baseline_suite(full=False, reps=2, seed=0, device=dev)
        finally:
            bench.ac_kernel_rate = real
        bench_out["suite_s"] = time.perf_counter() - t
        return (f"baseline_suite(full=False, reps=2, seed=0) in {bench_out['suite_s']} s; "
                f"AC-family configs (states, count kernel, planes kernel) in order: {picked}; "
                f"the records above were measured on [{smi}]")

    run_path("bench baseline_suite", ("packed_scan_count", "packed_scan_planes", "compact_planes",
                                      *wwl_kernels(big_wwl)), suite_path)

    def headline_path():
        res = headline.measure(dev)
        print(json.dumps(res["line"]))
        rng_h = np.random.default_rng(headline.SEED)
        kws_h = headline.make_dictionary(rng_h, headline.N_KEYWORDS)
        base_h = headline.make_text_classes(big, kws_h, rng_h, headline.BASE_UNITS)
        want = int(big._device_count(np.tile(base_h, TEXT_UNITS // headline.BASE_UNITS)))
        if kws_h != keywords or res["total"] != want or res["which"] != headline.HEADLINE_ENGINE:
            raise AssertionError(f"headline: total {res['total']} != {want} or engine "
                                 f"{res['which']}")
        bench_out["headline"] = res
        return (f"{res['line']}; {res['which']} count over {res['shape']} windows == the "
                f"facade's count ({want}); {res['seconds_per_scan'] * 1e3} ms per scan from "
                f"reps lo/hi {res['reps']} [{smi}]")

    run_path("bench.headline", ("packed_scan_count",), headline_path)

    def scaling_path():
        buf = io.StringIO()
        real_stdout, sys.stdout = sys.stdout, buf
        try:
            bench_main.scaling_bench(10_000, 1 << 20, 4, 0)
        finally:
            sys.stdout = real_stdout
        recs = [json.loads(line) for line in buf.getvalue().splitlines()]
        for r in recs:
            print(json.dumps(r))
        if [r["devices"] for r in recs] != [1] or recs[0]["efficiency_vs_1"] != 1.0:
            raise AssertionError(f"scaling_bench on one card: {recs}")
        return f"{len(recs)} record on {torch.cuda.device_count()} card: {recs[0]} [{smi}]"

    run_path("bench scaling_bench", ("packed_scan_count",), scaling_path)

    def profile_path():
        with tempfile.TemporaryDirectory() as tmp:
            bench_main.main(["--kind", "ac", "--keywords", "1000", "--units", str(1 << 20),
                             "--reps", "1", "--profile", tmp])
            files = [os.path.join(tmp, f) for f in os.listdir(tmp)]
            if len(files) != 1 or not os.path.getsize(files[0]):
                raise AssertionError(f"--profile wrote {files}")
            size = os.path.getsize(files[0])
            with open(files[0]) as fh:
                trace = json.load(fh)
        events = trace.get("traceEvents", [])
        device = sorted({e.get("name", "")[:60] for e in events
                         if e.get("cat") == "kernel"})
        launches_seen = sum("cudaLaunchKernel" in e.get("name", "") for e in events)
        return (f"--profile wrote one Chrome trace of {size} B, {len(events)} events; "
                f"{launches_seen} cudaLaunchKernel calls; device kernels in it: {device}")

    run_path("bench --profile", ("packed_scan_count",), profile_path)
    print("time sharded facades (host clock, one call each): "
          + "; ".join(f"{k} {v} s" for k, v in sharded_times.items()) + f" [{smi}]")
    counts = {k: sum(c[k] for c in path_launches.values()) for k in KERNELS}

    # 5. Times.
    w_full = windows(big, cls, 512)
    args = (pd.table, w_full, pd.halo, pd.state_bits)
    planes_full = scan_block.packed_scan_planes(*args)

    gbps = lambda ms: 2 * len(text) / (ms * 1e-3) / 1e9
    ms = {
        "packed_scan_count": (cuda_ms(lambda: scan_block.packed_scan_count(*args), 20),
                              cuda_ms(lambda: scan_block.packed_scan_count_plain(*args), 3)),
        "packed_scan_planes": (cuda_ms(lambda: scan_block.packed_scan_planes(*args), 20),
                               cuda_ms(lambda: scan_block.packed_scan_planes_plain(*args), 3)),
        "compact_planes": (cuda_ms(lambda: compact.compact_planes(planes_full), 20),
                           cuda_ms(lambda: compact.compact_planes_plain(planes_full), 5)),
    }
    for k, (t_kernel, t_plain) in ms.items():
        print(f"time {k} at {tuple(w_full.shape)} windows / {tuple(planes_full.shape)} planes: "
              f"kernel {t_kernel} ms ({gbps(t_kernel)} GB/s), plain twin {t_plain} ms "
              f"({gbps(t_plain)} GB/s) [{smi}]")
    # Speculate and repair at 64 Ki, 1 Mi and 32 Mi units, through the
    # wrappers at the rule's K: the shortest restart scan over the cached
    # restart rows (uint8 classes), and seq_states without sync_depth on the
    # dense 10k table, the 10k restart table and the wide RowTable; then the
    # repair lengths at 32 Mi.
    rdev = restart.dev
    short32 = restart._classes(text)
    c_twin = scan_batched.classes_to_device(short_cls, short_compiled.num_classes, dev)
    c_32 = scan_batched.classes_to_device(short32, short_compiled.num_classes, dev)
    spec_n = (1 << 16, 1 << 20, TEXT_UNITS)
    t_s = {n: cuda_ms(lambda n=n: scan_dfa.shortest_states(
        rdev.dfa_next, rdev.match_len, c_32[:n], rdev.restart_row_id), 5) for n in spec_n}
    t_s64 = t_s[1 << 16]
    t_p64 = cuda_ms(lambda: scan_dfa.shortest_states_plain(rdev.dfa_next, rdev.match_len, c_twin), 1)
    ms["shortest_states"] = (t_s64, t_p64)
    print("time shortest_states (speculate and repair): " + "; ".join(
        f"{t} ms on {n} units ({t * 1e6 / n} ns/unit, K = {scan_dfa.spec_chunk_len(n)})"
        for n, t in t_s.items()) + f"; plain twin {t_p64} ms on {len(short_cls)} units [{smi}]")

    q64 = int32_classes(cls[: 1 << 16])
    q32 = int32_classes(cls)
    q_short32 = int32_classes(short32)
    q_wide32 = int32_classes(wide_cls32)
    # The lane scan (sync_depth = d) at the timed shapes, each held against
    # its twin in phase 3.
    t_sync = {n: cuda_ms(lambda n=n: scan_dfa.seq_states(*dense_tab, q32[:n], 0, d_seq), 20)
              for n in (1 << 10, 1 << 12, 1 << 16, TEXT_UNITS)}
    t_sync_wide = cuda_ms(lambda: scan_dfa.seq_states(*wide_tab, q_wide32, 0, 1), 20)
    spec_cells = (("dense 10k table", dense_tab, q32),
                  ("10k shortest restart table", restart_tab, q_short32),
                  ("wide-alphabet RowTable", wide_tab, q_wide32))
    t_spec = {(label, n): cuda_ms(lambda tab=tab, q=q, n=n: scan_dfa.seq_states(*tab, q[:n], 0), 5)
              for label, tab, q in spec_cells for n in spec_n}
    t_q64 = t_spec["dense 10k table", 1 << 16]
    t_qp = cuda_ms(lambda: scan_dfa.seq_states_plain(*dense_tab, q64, 0, d_seq), 2)
    t_qps = cuda_ms(lambda: scan_dfa.seq_states_plain(*dense_tab, q64, 0), 1)
    ms["seq_states"] = (t_sync[1 << 16], t_qp)
    ms["seq_states_serial"] = (t_q64, t_qps)
    print("time seq_states, lane scan (d = " + str(d_seq) + "): dense 10k table " + "; ".join(
        f"{t} ms on {n} units ({t * 1e6 / n} ns/unit, L = {scan_dfa.sync_lane_len(n, d_seq)})"
        for n, t in t_sync.items())
          + f"; wide-alphabet RowTable (d = 1) {t_sync_wide} ms on {len(q_wide32)} units "
          f"({t_sync_wide * 1e6 / len(q_wide32)} ns/unit, L = "
          f"{scan_dfa.sync_lane_len(len(q_wide32), 1)}); plain twin {t_qp} ms on {len(q64)} "
          f"units [{smi}]")
    print("time seq_states, speculate and repair: " + "; ".join(
        f"{label} {t} ms on {n} units ({t * 1e6 / n} ns/unit, K = {scan_dfa.spec_chunk_len(n)})"
        for (label, n), t in t_spec.items())
          + f"; plain twin {t_qps} ms on {len(q64)} units [{smi}]")
    stats = []
    for label, tab, q in (("10k shortest_states", (rdev.dfa_next, rdev.restart_row_id), c_32),
                          *spec_cells):
        _, rep = scan_dfa.spec_states(*tab, q, 0)
        r = rep.to(torch.int64)
        K = scan_dfa.spec_chunk_len(len(q))
        lens = torch.clamp(len(q) - K * torch.arange(len(r), device=dev), max=K)
        hist = torch.bincount(torch.clamp(r, max=64)).tolist()
        stats.append(f"{label}: {len(r)} chunks of K = {K}, repair mean {float(r.float().mean())} "
                     f"max {int(r.max())}, {int((r > 0).sum())} repaired, "
                     f"{int(((r == lens) & (r > 0)).sum())} to their end; chunks by repair "
                     f"length 0..63, 64+: {hist}")
    print(f"spec repairs at {TEXT_UNITS} units: " + "; ".join(stats) + f" [{smi}]")
    print(f"time streams on {len(text)} units in {len(sizes)} uneven feeds: "
          + "; ".join(f"{k} {v} s ({2 * len(text) / v / 1e9} GB/s)"
                      for k, v in stream_times.items())
          + f"; gold branch, wide-alphabet RowTable, {gold_times['facade']} s "
          f"({gold_times['facade'] * 1e9 / len(text)} ns/unit); listener False on the first "
          f"match {early['stop']} s, listener that never stops {early['full']} s [{smi}]")

    wd10, st10, cls_p10, lanes10, d10 = wwl_inputs(big_wwl, cls_w, sc10.num_classes)
    pargs = (sc10.table, wd10, d10, sc10.id_bits, sc10.num_classes, False)
    plane10 = kwwl.wwl_scan_plane(*pargs)[0]
    skw = dict(d=d10, id_bits=sc10.id_bits, depth_bits=sc10.depth_bits, cross=False)
    sargs = (plane10, None, None, sc10.outrows, st10)
    walk_args = (*big_wwl.dev.wwl_walk,
                 scan_batched.classes_to_device(cls_p10, big_wwl.compiled.num_classes, dev),
                 st10, d10)
    walk_kw = dict(walk_tables=big_wwl.dev.wwl_walk_derived)  # as the matcher's route passes
    ms["wwl_scan_plane"] = (cuda_ms(lambda: kwwl.wwl_scan_plane(*pargs), 20),
                            cuda_ms(lambda: kwwl.wwl_scan_plane_plain(*pargs), 3))
    ms["wwl_sweep_at"] = (cuda_ms(lambda: kwwl.wwl_sweep_at(*sargs, **skw), 20),
                          cuda_ms(lambda: kwwl.wwl_sweep_at_plain(*sargs, **skw), 3))
    ms["wwl_walks_at"] = (cuda_ms(lambda: kwwl.wwl_walks_at(*walk_args, **walk_kw), 20),
                          cuda_ms(lambda: kwwl.wwl_walks_at_plain(*walk_args), 3))
    wf10 = scan_batched.classes_to_device(scan_wwl.chunk_classes_overlap(
        cls_p10, 512, d10, d10 + 1, sc10.num_classes), sc10.num_classes, dev)
    fargs = (sc10.table, sc10.outrows, wf10, st10)
    fkw = dict(halo=d10, id_bits=sc10.id_bits, depth_bits=sc10.depth_bits,
               num_classes=sc10.num_classes, d=d10, cross=False)
    ms["wwl_scan_fused"] = (cuda_ms(lambda: kwwl.wwl_scan_fused(*fargs, **fkw), 20),
                            cuda_ms(lambda: kwwl.wwl_scan_fused_plain(*fargs, **fkw), 2))
    for k in ("wwl_scan_plane", "wwl_sweep_at", "wwl_walks_at", "wwl_scan_fused"):
        t_kernel, t_plain = ms[k]
        shape = tuple((wf10 if k == "wwl_scan_fused" else wd10).shape)
        print(f"time {k} at {shape} windows, {st10.shape[0]} start slots "
              f"({len(lanes10)} lanes): kernel {t_kernel} ms ({gbps(t_kernel)} GB/s), plain twin "
              f"{t_plain} ms ({gbps(t_plain)} GB/s) [{smi}]")

    # The A/B that sets FUSED_DEFAULT (python -m ahocorasick_tpu_torch.probes.
    # probe_wwl_fused): the fused scan against the plane and the sweep, the
    # per-start walk beside them, at baseline-4 and at this run's 10k cell.
    ab_ms, ab_cases = {}, {}
    for config, make in (("baseline-4", lambda: probe_wwl_fused.baseline4(dev)),
                         ("10k", lambda: (big_wwl, cls_w))):
        ab_cases[config] = make()
        ab_info, ab_best = probe_wwl_fused.ab(*ab_cases[config])
        print(f"ab wwl {config}: " + json.dumps({**ab_info, **ab_best}) + f" [{smi}]")
        if ab_info["max_abs_err"] or ab_info["walk_max_abs_err"]:
            raise AssertionError(f"ab wwl {config}: the fused or the walk's outcomes differ from "
                                 f"the sweep's")
        ab_ms[config] = ab_best
    fused_wins = all(b["fused"]["device_ms"] < b["sweep"]["device_ms"] for b in ab_ms.values())
    print(f"ab wwl: the fused scan's card time is below the plane and the sweep's in "
          f"{'both cases' if fused_wins else 'not both cases'} ("
          + "; ".join(f"{c} {b['fused']['device_ms']} vs {b['sweep']['device_ms']} ms, walk "
                      f"{b['walk']['device_ms']} ms" for c, b in ab_ms.items())
          + f"): the rule gives FUSED_DEFAULT = {fused_wins}; the package has "
          f"{fused_default} [{smi}]")

    # The every-position sweep on one shard of the sharded WWL scan (4 Mi
    # positions and the 512-word right halo), and the stitch kernels at the
    # arrival-states path's per-shard shapes on the 10k table (C = 1).
    per_w = TEXT_UNITS // N_SHARDS
    all_args = (plane10[: per_w + 512].contiguous(), None, None, sc10.outrows, per_w)
    ms["wwl_sweep_all"] = (cuda_ms(lambda: kwwl.wwl_sweep_all(*all_args, **skw), 20),
                           cuda_ms(lambda: kwwl.wwl_sweep_all_plain(*all_args, **skw), 3))
    print(f"time wwl_sweep_all at {per_w} positions of a {all_args[0].shape[0]}-word plane: "
          f"kernel {ms['wwl_sweep_all'][0]} ms, plain twin {ms['wwl_sweep_all'][1]} ms [{smi}]")
    tab10 = dense_tab[0]
    K10 = ARRIVAL_UNITS_10K // N_SHARDS
    c10 = [int32_classes(cls[r * K10: (r + 1) * K10]).reshape(1, K10) for r in range(N_SHARDS)]
    sigma8 = torch.cat([kstitch.state_maps(tab10, c, d_seq) for c in c10])
    entry8 = kstitch.entry_fold(sigma8, 0)

    def timed_twin(k, kernel, plain, reps):
        """``ms[k]``: the kernel's and its twin's times at one shape, their
        outputs first held equal."""
        box = {}
        ms[k] = (cuda_ms(lambda: box.__setitem__("got", kernel()), reps),
                 cuda_ms(lambda: box.__setitem__("want", plain()), 1))
        e = max_err((box["got"],), (box["want"],))
        errs[k] = max(errs[k], e)
        if e:
            raise AssertionError(f"{k}: the timed call disagrees with its twin")

    # Both forms of the maps and the rescan at the arrival path's per-shard
    # shape (C = 1), where the first designs were timed.
    for k, depth in (("state_maps", d_seq), ("state_maps_all", None)):
        timed_twin(k, lambda: kstitch.state_maps(tab10, c10[0], depth),
                   lambda: kstitch.state_maps_plain(tab10, c10[0], depth), 20)
    timed_twin("entry_fold", lambda: kstitch.entry_fold(sigma8, 0),
               lambda: kstitch.entry_fold_plain(sigma8, 0), 20)
    for k, depth in (("rescan", d_seq), ("rescan_serial", None)):
        timed_twin(k, lambda: kstitch.rescan(tab10, c10[1], entry8[1:2], depth),
                   lambda: kstitch.rescan_plain(tab10, c10[1], entry8[1:2], depth), 20)
    # The card's time alone beside ms[k], which is through the wrapper.
    stitch_card = {
        "state_maps": cuda_ms(lambda: kstitch.state_maps(tab10, c10[0], d_seq), 20, True),
        "state_maps_all": cuda_ms(lambda: kstitch.state_maps(tab10, c10[0]), 20, True),
        "entry_fold": cuda_ms(lambda: kstitch.entry_fold(sigma8, 0), 20, True),
        "rescan": cuda_ms(lambda: kstitch.rescan(tab10, c10[1], entry8[1:2], d_seq), 20, True),
        "rescan_serial": cuda_ms(lambda: kstitch.rescan(tab10, c10[1], entry8[1:2]), 20, True)}
    for k, shape in (("state_maps", f"C=1 K={K10} S={tab10.shape[0]} d={d_seq}"),
                     ("state_maps_all", f"C=1 K={K10} S={tab10.shape[0]}"),
                     ("entry_fold", f"sigma {tuple(sigma8.shape)}"),
                     ("rescan", f"C=1 K={K10} d={d_seq}"), ("rescan_serial", f"C=1 K={K10}")):
        print(f"time {k}, 10k dense table {tuple(tab10.shape)}, {shape}: kernel {ms[k][0]} ms "
              f"(card time, the calls queued: {stitch_card[k]} ms), plain twin {ms[k][1]} ms "
              f"[{smi}]")
    # The forms for any table on the 10k restart table at the same shape, and
    # each table's meet positions there, held to the twin.
    restart_c = int32_classes(short_cls[:K10]).reshape(1, K10)
    restart_entry = torch.zeros(1, dtype=torch.int32, device=dev)
    print(f"time state_maps_all / rescan_serial, 10k shortest restart table "
          f"{tuple(restart_tab[0].shape)}, C=1 K={K10}: "
          f"{cuda_ms(lambda: kstitch.state_maps(restart_tab[0], restart_c), 20)} / "
          f"{cuda_ms(lambda: kstitch.rescan(restart_tab[0], restart_c, restart_entry), 20)} ms "
          f"[{smi}]")
    meet_line = {}
    meet_lookups = None
    for label, table, c in (
            ("10k closure", tab10, c10[0]), ("10k shortest restart table", restart_tab[0],
                                             restart_c),
            ("demo dictionary", demo_tab,
             int32_classes(demo32[: N_SHARDS * K10]).reshape(N_SHARDS, K10))):
        sig, meet = kstitch.meet_maps(table, c)
        e = max_err((sig, meet), kstitch.meet_maps_plain(table, c))
        errs["state_maps_all"] = max(errs["state_maps_all"], e)
        if e:
            raise AssertionError(f"meet positions, {label}: the kernel disagrees with its twin")
        mm = meet.to(torch.int64)
        if meet_lookups is None:  # the timed call's: R, then each lane until it met
            meet_lookups = c.shape[1] + int(torch.clamp(mm[:, 1:] + 1, max=c.shape[1]).sum())
        meet_line[label] = {"C": c.shape[0], "K": c.shape[1], "S": table.shape[0],
                            "mean": float(mm.double().mean()), "largest": int(mm.max()),
                            "never_met": int((mm == c.shape[1]).sum()), "lanes": mm.numel()}
    print(f"meet positions (state_maps_all: the first position at which a lane's state equals "
          f"its chunk's run from the root, K where it never does): {json.dumps(meet_line)} "
          f"[{smi}]")

    # The stitched scan beside the one sequential scan at the same N: a small
    # automaton (the demo dictionary) on 32 Mi units, the 10k table and the
    # 10k restart table (which does not synchronize); the synchronized forms
    # where a depth is declared and the forms for any table at every shape.
    demo_flat = int32_classes(demo32)
    for label, table, flat, d, shapes in (
            ("demo dictionary", demo_tab, demo_flat, d_demo,
             ((N_SHARDS, TEXT_UNITS // N_SHARDS), (4096, TEXT_UNITS // 4096))),
            ("10k dictionary", tab10, int32_classes(cls[:ARRIVAL_UNITS_10K]), d_seq,
             ((N_SHARDS, K10), (64, ARRIVAL_UNITS_10K // 64),
              (1024, ARRIVAL_UNITS_10K // 1024))),
            ("10k dictionary", tab10, int32_classes(cls[:TEXT_UNITS]), d_seq,
             ((N_SHARDS, TEXT_UNITS // N_SHARDS), (4096, TEXT_UNITS // 4096))),
            ("10k shortest restart table", restart_tab[0], restart_flat, None,
             ((N_SHARDS, restart_flat.shape[0] // N_SHARDS),))):
        t_seq = cuda_ms(lambda: scan_dfa.seq_states(table, None, flat, 0), 3)
        t_lane = cuda_ms(lambda: scan_dfa.seq_states(table, None, flat, 0, d), 5) if d else None
        ref = scan_dfa.seq_states(table, None, flat, 0, d)
        for chunks, K in shapes:
            c = flat.reshape(chunks, K)
            for depth in (d, None) if d else (None,):
                sig = kstitch.state_maps(table, c, depth)
                ent = kstitch.entry_fold(sig, 0)
                whole = stitch.stitched_scan(table, c, 0, depth)
                if not torch.equal(whole.reshape(-1), ref):
                    raise AssertionError(f"stitched_scan {label} C={chunks} sync_depth={depth} "
                                         f"!= the sequential scan")
                parts = (cuda_ms(lambda: kstitch.state_maps(table, c, depth), 3),
                         cuda_ms(lambda: kstitch.entry_fold(sig, 0), 3),
                         cuda_ms(lambda: kstitch.rescan(table, c, ent, depth), 3))
                t_all = cuda_ms(lambda: stitch.stitched_scan(table, c, 0, depth), 3)
                names = ("state_maps", "rescan") if depth else ("state_maps_all", "rescan_serial")
                print(f"time stitched_scan, {label}, table {tuple(table.shape)}, "
                      f"N={flat.shape[0]} C={chunks} K={K} sync_depth={depth}: {t_all} ms "
                      f"({names[0]} {parts[0]}, entry_fold {parts[1]}, {names[1]} {parts[2]}) "
                      f"against seq_states_serial {t_seq} ms = {t_seq / t_all} x"
                      + (f", seq_states (lane scan, d = {d}) {t_lane} ms" if d else "")
                      + f" [{smi}]")

    # The huge-dictionary kernels on the 1M dictionary, BASELINE #5's text.
    flat1m, sb1m, halo1m = ac1m.dev.count_packed_dfa
    A1m = c1m.num_classes
    w5 = scan_batched.classes_to_device(
        scan_batched.chunk_classes(cls5, 512, halo1m, A1m), A1m, dev)
    cargs = (flat1m, w5, halo1m, sb1m, A1m)
    dfa1m, emit1m, halo_s = ac1m.dev.split_dfa
    w5s = w5 if halo_s == halo1m else scan_batched.classes_to_device(
        scan_batched.chunk_classes(cls5, 512, halo_s, A1m), A1m, dev)
    sargs1m = (dfa1m, emit1m, w5s, halo_s, A1m, emit1m.shape[1])
    ms["packedcount_count"] = (cuda_ms(lambda: khuge.packedcount_count(*cargs), 20),
                               cuda_ms(lambda: khuge.packedcount_count_plain(*cargs), 3))
    ms["packedcount_hotstate_plane"] = (
        cuda_ms(lambda: khuge.packedcount_hotstate_plane(*cargs), 20),
        cuda_ms(lambda: khuge.packedcount_hotstate_plane_plain(*cargs), 3))
    ms["split_count"] = (cuda_ms(lambda: khuge.split_count(*sargs1m), 20),
                         cuda_ms(lambda: khuge.split_count_plain(*sargs1m), 3))
    ms["split_emit_planes"] = (cuda_ms(lambda: khuge.split_emit_planes(*sargs1m), 20),
                               cuda_ms(lambda: khuge.split_emit_planes_plain(*sargs1m), 3))
    for k in ("packedcount_count", "packedcount_hotstate_plane", "split_count",
              "split_emit_planes"):
        t_kernel, t_plain = ms[k]
        print(f"time {k} at {tuple(w5.shape)} windows, 1M dictionary ({flat1m.nbytes} B "
              f"count-packed, {dfa1m.nbytes + emit1m.nbytes} B split): kernel {t_kernel} ms "
              f"({gbps(t_kernel)} GB/s), plain twin {t_plain} ms ({gbps(t_plain)} GB/s) [{smi}]")

    # The kernels redesigned for this card, held against their twins at the
    # timed shapes, then the A/B of their designs (bench/scan_variants.py).
    kc = int(scan_block.packed_scan_count(*args))
    pc = int(scan_block.packed_scan_count_plain(*args))
    e_hot = max_err((khuge.packedcount_hotstate_plane(*cargs),),
                    (khuge.packedcount_hotstate_plane_plain(*cargs),))
    kpc = int(khuge.packedcount_count(*cargs))
    ppc = int(khuge.packedcount_count_plain(*cargs))
    e_split = max_err((khuge.split_emit_planes(*sargs1m),),
                      (khuge.split_emit_planes_plain(*sargs1m),))
    ksc = int(khuge.split_count(*sargs1m))
    psc = int(khuge.split_count_plain(*sargs1m))
    torch.cuda.synchronize()
    errs["packed_scan_count"] = max(errs["packed_scan_count"], abs(kc - pc))
    errs["packedcount_hotstate_plane"] = max(errs["packedcount_hotstate_plane"], e_hot)
    errs["packedcount_count"] = max(errs["packedcount_count"], abs(kpc - ppc))
    errs["split_emit_planes"] = max(errs["split_emit_planes"], e_split)
    errs["split_count"] = max(errs["split_count"], abs(ksc - psc))
    k_count = scan_block.segments(w_full.shape[0], w_full.shape[1] - pd.halo, pd.halo,
                                  scan_block.COUNT_MAX_LANES)[0]
    k_hot, k_pc, k_split, k_sc = (
        scan_block.segments(w.shape[0], w.shape[1] - h, h, cap)[0]
        for w, h, cap in ((w5, halo1m, khuge.HOTSTATE_MAX_LANES),
                          (w5, halo1m, khuge.PACKEDCOUNT_MAX_LANES),
                          (w5s, halo_s, khuge.SPLIT_PLANES_MAX_LANES),
                          (w5s, halo_s, khuge.SPLIT_COUNT_MAX_LANES)))
    print(f"  timed shapes: packed_scan_count at {tuple(w_full.shape)}, K={k_count}: kernel={kc} "
          f"twin={pc}; packedcount_hotstate_plane at {tuple(w5.shape)}, K={k_hot}: "
          f"max_abs_err={e_hot}; packedcount_count, K={k_pc}: kernel={kpc} twin={ppc}; "
          f"split_emit_planes at {tuple(w5s.shape)}, P={sargs1m[-1]}, K={k_split}: "
          f"max_abs_err={e_split}; split_count, K={k_sc}: kernel={ksc} twin={psc}")
    if kc != pc or e_hot or kpc != ppc or e_split or ksc != psc:
        raise AssertionError("a redesigned kernel disagrees with its twin at its timed shape")
    variants_lib = scan_variants.library()
    ab = scan_variants.run(args, cargs, sargs1m, variants_lib)
    print(f"ab scan_variants {json.dumps({'card': smi, **ab})}")
    ab = scan_variants.rowdfa2_ab(rowdfa_ms["10k keywords x 32 Mi units"]["args"], variants_lib)
    print(f"ab rowdfa2 {json.dumps({'card': smi, **ab})}")
    ab = scan_variants.seq_ab({"10k dense": (*dense_tab, q32, d_seq),
                               "wide RowTable": (*wide_tab, q_wide32, 1)}, variants_lib)
    print(f"ab seq {json.dumps({'card': smi, **ab})}")
    # Speculate and repair against the one-thread walks, every run held bit
    # for bit against them up to 32 Mi units (timed up to 1 Mi).
    ab = scan_variants.spec_ab({
        "10k shortest_states": (rdev.dfa_next, rdev.restart_row_id, c_32, rdev.match_len),
        "10k restart table": (*restart_tab, q_short32, None),
        "10k dense": (*dense_tab, q32, None),
        "wide RowTable": (*wide_tab, q_wide32, None)}, variants_lib)
    print(f"ab spec {json.dumps({'card': smi, **ab})}")
    # The stitch's forms for any table against its first designs (and the
    # synchronized forms on the goto closures), each launch held bit for bit
    # against the first design.
    ab = scan_variants.meet_ab({
        "10k restart table": (restart_tab[0], q_short32, None),
        "10k closure": (dense_tab[0], q32, d_seq),
        "demo dictionary": (demo_tab, demo_flat, d_demo)}, variants_lib)
    print(f"ab meet {json.dumps({'card': smi, **ab})}")
    # The fold's first design against speculate and repair, each launch held
    # bit for bit against the first design: the demo dictionary's sigma at C
    # = 4,096 (its 32 Mi units), the 10k table's at the arrival path's 8
    # chunks, and random maps (every guess wrong); with the latency floors.
    fold_cells = {
        "demo C=4096": kstitch.state_maps(demo_tab, demo_flat.reshape(4096, -1), d_demo),
        "10k C=8": sigma8,
        "random 4096 x 1024": scan_variants.random_sigma(4096, 1024, dev, SEED)}
    ab_fold = scan_variants.fold_ab(fold_cells, variants_lib)
    print(f"ab entry_fold {json.dumps({'card': smi, **ab_fold})}")
    # The latency chains' floors (the timed call's shape), which the ranking
    # below takes where they lie above the bytes and operations bound.
    latency_floor = {"entry_fold": ab_fold["fold_floor_ms"]["10k C=8"]["floor_ms"],
                     # one lane's launch of the step kernel, card time
                     "table_sharded_step": step_rec["planes"]["floor"]}
    for label, fl in ab_fold["fold_floor_ms"].items():
        t_fold = ab_fold["fold_ms"][label]
        print(f"latency floor entry_fold, {label}: a launch {fl['launch_ms']} ms + a sigma load "
              f"{fl['sigma_load_ns']} ns x (per {ab_fold['fold_repairs'][label]['per']} + the "
              f"longest repair {ab_fold['fold_repairs'][label]['repair_max']}) = "
              f"{fl['floor_ms']} ms; kernel {t_fold['spec']} ms = {t_fold['spec'] / fl['floor_ms']}"
              f" x; first design {t_fold['first']} ms [{smi}]")
    ab = scan_variants.tp_ab((st10k, w_full, pd.halo, pd.state_bits), variants_lib)
    print(f"ab table_sharded {json.dumps({'card': smi, **ab})}")
    ab = scan_variants.sweep_ab({
        "at 10k starts": (*sargs, st10.shape[0], d10, sc10.id_bits, sc10.depth_bits, False),
        "all 4 Mi": (*all_args[:4], None, per_w, d10, sc10.id_bits, sc10.depth_bits, False)},
        variants_lib)
    print(f"ab sweep {json.dumps({'card': smi, **ab})}")
    # The whole-word-longest walks' designs at baseline-4 and the 10k cell:
    # the fused scan's first design and its K, the walk's first design and
    # its prefix placements, each launch held bit for bit against the twin.
    t_ab = time.perf_counter()
    wwl_ab_cells = {c: scan_variants.wwl_cells(*mc) for c, mc in ab_cases.items()}
    ab = scan_variants.wwl_fused_ab({c: v[0] for c, v in wwl_ab_cells.items()}, variants_lib)
    print(f"ab wwl_fused {json.dumps({'card': smi, **ab})}")
    ab = scan_variants.wwl_walk_ab({c: v[1] for c, v in wwl_ab_cells.items()}, variants_lib)
    print(f"ab wwl_walk {json.dumps({'card': smi, **ab})}")
    for c, rec in ab["wwl_walk_ms"].items():
        ld = rec["loads"]
        print(f"wwl walk loads, {c}, {rec['slots']} start slots, d={rec['d']}: first design "
              f"{ld['first']['loads']} trie loads, a walk mean {ld['first']['mean']} max "
              f"{ld['first']['max']}; package (one k={ld['prefix_k']} prefix load, then the trie) "
              f"{ld['package']['loads']}, a walk mean {ld['package']['mean']} max "
              f"{ld['package']['max']}, {ld['died_in_prefix']} walks decided by the prefix; rate "
              + ", ".join(f"{k} {v} G loads/s" for k, v in rec["g_loads_per_s"].items())
              + f" [{smi}]")
    print(f"  the WWL walks' A/Bs took {time.perf_counter() - t_ab} s")
    # The plane the sweep at the 10k starts reads: the 32-byte sectors its
    # walks touch (words w .. w + k_die of each walk in [0, L)).
    outs10 = kwwl.wwl_sweep_at(*sargs, **skw)
    die = outs10[0].to(torch.int64)
    w64 = st10.to(torch.int64)
    walks = (w64 >= 0) & (w64 < plane10.shape[0] - (d10 + 1))
    first, last = w64[walks] // 8, die[walks] // 8
    touched = torch.zeros(plane10.shape[0] // 8 + 1, dtype=torch.bool, device=dev)
    for step in range(-(-(d10 + 1) // 8) + 1):
        touched[torch.minimum(first + step, last)] = True
    sectors = int(touched.sum())
    sweep_bytes = sectors * 32 + st10.nbytes + sum(t.nbytes for t in outs10)
    print(f"sweep plane sectors: the {int(walks.sum())} walks at the 10k cell's {st10.shape[0]} "
          f"start slots touch {sectors} of the plane's {plane10.shape[0] // 8} 32-byte sectors "
          f"({sectors * 32} B of {plane10.nbytes} B); with the starts and the outcomes "
          f"{sweep_bytes} B, {sweep_bytes / PEAK_BYTES_PER_S * 1e3} ms at "
          f"{PEAK_BYTES_PER_S / 1e12} TB/s; the sweep took {ms['wwl_sweep_at'][0]} ms [{smi}]")

    # The row-sharded scan beside the single-table kernels on the same
    # windows: the 10k table (every mode; the payload is an emit mask, so
    # count_packed and hotstate read it as a number), then the 1M table.
    tp_ms = {mode: cuda_ms((lambda md: lambda: ktp.table_sharded_scan(
        st10k, w_full, pd.halo, pd.state_bits, md))(mode), 20) for mode in ktp.MODES}
    tp_plain = {mode: cuda_ms((lambda md: lambda: ktp.table_sharded_scan_plain(
        st10k, w_full, pd.halo, pd.state_bits, md))(mode), 1) for mode in ("count", "planes")}
    ms["table_sharded_scan"] = (tp_ms["planes"], tp_plain["planes"])
    ms["table_sharded_step"] = (step_rec["planes"]["step"], step_rec["planes"]["plain"])
    ms["table_sharded_classes"] = (step_rec["planes"]["prep"], step_rec["planes"]["prep_plain"])
    print(f"time table_sharded_scan at {tuple(w_full.shape)} windows, 10k table "
          f"{tuple(table10k.shape)} in {N_SHARDS} shards of {st10k.rows_per} rows: "
          + ", ".join(f"{k} {v} ms ({gbps(v)} GB/s)" for k, v in tp_ms.items())
          + f"; plain twin count {tp_plain['count']} ms, planes {tp_plain['planes']} ms; beside "
          f"packed_scan_count {ms['packed_scan_count'][0]} ms and packed_scan_planes "
          f"{ms['packed_scan_planes'][0]} ms in this run [{smi}]")
    tp1m_ms = {mode: cuda_ms((lambda md: lambda: ktp.table_sharded_scan(
        st1m, w1m, halo1m_host, sb1m_host, md))(mode), 20) for mode in ("count_packed", "hotstate")}
    print(f"time table_sharded_scan at {tuple(w1m.shape)} windows, 1M table "
          f"{tuple(table1m.shape)} ({table1m.nbytes} B) in {N_SHARDS} shards of {st1m.rows_per} "
          f"rows: " + ", ".join(f"{k} {v} ms ({gbps(v)} GB/s)" for k, v in tp1m_ms.items())
          + f"; beside packedcount_count {ms['packedcount_count'][0]} ms and "
          f"packedcount_hotstate_plane {ms['packedcount_hotstate_plane'][0]} ms in this run "
          f"[{smi}]")

    def host_s(fn, reps):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return out

    pfac_big = port.AhoCorasickSet.from_compiled(big.compiled, engine="device", device=dev)
    pfac_big.device_engine = "pfac2"
    facade = [("AhoCorasickSet count", lambda: big.count(text)),
              ("AhoCorasickSet match_triples", lambda: big.match_triples(text)),
              ("AhoCorasickSet match_triples, device_engine=pfac2",
               lambda: pfac_big.match_triples(text))]
    facade += [(f"{k} match_triples", (lambda m: lambda: m.match_triples(text))(matchers[k]))
               for k in ("LongestMatchSet", "WholeWordMatchSet", "ShortestMatchSet")]
    facade += [("WholeWordLongestMatchSet match_triples", lambda: big_wwl.match_triples(text)),
               ("WholeWordLongestMatchSet mixed match_triples", lambda: mixed.match_triples(text7))]
    lm1m = huge_matchers["LongestMatchSet"]
    facade += [("1M AhoCorasickSet count", lambda: ac1m.count(text5)),
               ("1M AhoCorasickSet match_triples", lambda: ac1m.match_triples(text5)),
               ("1M LongestMatchSet match_triples", lambda: lm1m.match_triples(text5))]
    sc8 = sharding.ShardedScanner(big, mesh)
    planes8 = sharding.make_sharded_planes(big, mesh)[0]
    facade += [(f"ShardedScanner AhoCorasickSet count, {N_SHARDS} shards", lambda: sc8.count(text)),
               (f"ShardedScanner AhoCorasickSet match_triples, {N_SHARDS} shards",
                lambda: sc8.match_triples(text)),
               (f"make_sharded_planes fn(cls), {N_SHARDS} shards", lambda: planes8(cls))]
    ts10, ts1m = tp_scanners["AhoCorasickSet"], tp_scanners["1M"]
    facade += [(f"TableShardedScanner AhoCorasickSet count, {N_SHARDS} row shards",
                lambda: ts10.count(text)),
               (f"TableShardedScanner AhoCorasickSet match_triples, {N_SHARDS} row shards",
                lambda: ts10.match_triples(text)),
               (f"TableShardedScanner 1M AhoCorasickSet count, {N_SHARDS} row shards",
                lambda: ts1m.count(text5)),
               (f"TableShardedScanner 1M AhoCorasickSet match_triples, {N_SHARDS} row shards",
                lambda: ts1m.match_triples(text5))]
    for label, fn in facade:
        runs = host_s(fn, 3)
        med = sorted(runs)[1]
        print(f"time facade {label} on {len(text)} units: median {med} s "
              f"({2 * len(text) / med / 1e9} GB/s); runs {runs} [{smi}]")

    # Where the facade's time goes: its stages one by one, each synced.
    stages = {}

    def stage(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[label] = time.perf_counter() - t
        return out

    c = stage("classes (UTF-16 encode + charmap)", lambda: big._classes(text))
    w = stage("windows (chunk_classes)", lambda: scan_batched.chunk_classes(
        c, 512, pd.halo, big.compiled.num_classes))
    wd = stage("upload", lambda: torch.from_numpy(w).to(dev))
    stage("count kernel + scalar download", lambda: int(scan_block.packed_scan_count(
        pd.table, wd, pd.halo, pd.state_bits)))
    bits = stage("planes kernel", lambda: scan_block.packed_scan_planes(
        pd.table, wd, pd.halo, pd.state_bits))
    sp = stage("compaction kernel (compact_planes) + download",
               lambda: scan_batched.planes_to_sparse(bits, len(c)))
    stage("extraction (ac_matches_batched, compaction included)",
          lambda: scan_batched.ac_matches_batched(big.compiled, c, bits))
    print(f"stages on {len(text)} units ({'sparse' if sp else 'dense'} download, "
          f"{len(sp[0]) if sp else 0} hot positions): "
          + "; ".join(f"{k} {v} s" for k, v in stages.items()) + f" [{smi}]")

    # The sharded count's stages: the narrow 1-D upload and windows cut on
    # the device, beside the facade's host windows above.
    stages = {}
    c = stage("classes (UTF-16 encode + charmap)", lambda: big._classes(text))
    prepare8, _, _ = sharding.make_sharded_counter(big, mesh)
    shards8 = stage(f"pad + narrow upload of {N_SHARDS} shards", lambda: prepare8(c))
    ordered = [shards8[r] for r in range(N_SHARDS)]
    wins = stage("halos + windows on the device", lambda: [
        sharding._windows_on_device(
            sharding._cat([sharding._left_halo(ordered, r, pd.halo), ordered[r]]), 512, pd.halo)
        for r in range(N_SHARDS)])
    parts = stage(f"count kernels ({N_SHARDS} launches)", lambda: [
        scan_block.packed_scan_count(pd.table, w8, pd.halo, pd.state_bits) for w8 in wins])
    n8 = stage("reduce (scalar downloads + sum)", lambda: sum(int(t) for t in parts))
    if n8 != len(ac_ref[0]):
        raise AssertionError(f"staged sharded count {n8} != {len(ac_ref[0])}")
    # B17's bound: the sum of the bounds of the count kernels one call launches.
    b17 = sum(max((w8.nbytes + 8) / PEAK_BYTES_PER_S, 4 * w8.numel() / PEAK_OPS_PER_S)
              for w8 in wins) * 1e3
    print(f"bound B17, the sharded count ({N_SHARDS} packed_scan_count launches on windows "
          f"{[tuple(w8.shape) for w8 in wins]}): {b17} ms [{smi}]")
    print(f"sharded count stages on {len(text)} units, {N_SHARDS} shards of "
          f"{ordered[0].shape[0]} units: "
          + "; ".join(f"{k} {v} s" for k, v in stages.items()) + f" [{smi}]")

    # The table-sharded AC match's stages on the 10k dictionary (host windows,
    # one upload, the row-sharded kernel), then the whole-word-longest
    # table-sharded path, whose die sweep runs on the card over the raw plane.
    stages = {}
    c = stage("classes (UTF-16 encode + charmap)", lambda: big._classes(text))
    w = stage("windows (chunk_classes)", lambda: scan_batched.chunk_classes(
        c, 512, pd.halo, table10k.shape[1]))
    wd = stage("upload", lambda: scan_batched.classes_to_device(w, table10k.shape[1], dev))
    stage("count kernel + scalar download", lambda: int(ktp.table_sharded_scan(
        st10k, wd, pd.halo, pd.state_bits, "count")))
    bits = stage("planes kernel", lambda: ktp.table_sharded_scan(
        st10k, wd, pd.halo, pd.state_bits, "planes"))
    stage("extraction (ac_matches_batched: compaction, download, native extract)",
          lambda: scan_batched.ac_matches_batched(big.compiled, c, bits))
    print(f"table-sharded stages on {len(text)} units, {N_SHARDS} row shards: "
          + "; ".join(f"{k} {v} s" for k, v in stages.items()) + f" [{smi}]")
    stages = {}
    tsw = tp_scanners["WholeWordLongestMatchSet"]
    c = stage("classes", lambda: big_wwl._classes(text))
    cls_pw = np.pad(c, (0, tsw._wwl.halo + 1))
    raw = stage("raw scan (windows, upload, kernel)", lambda: tsw._scan(cls_pw, "raw")[0])
    outs_d = stage("die sweep on the card (walks_from_raw)", lambda: scan_wwl.walks_from_raw(
        tsw._wwl, *tsw._sweep_tables(raw.device), raw, cls_pw, len(c)))
    outs = stage("download of the outcomes", lambda: [x.cpu().numpy() for x in outs_d])
    ws_w = stage("word_starts", lambda: word_starts(
        np.asarray(big_wwl.compiled.class_is_word)[c]))
    stage("follow_chain", lambda: follow_chain(*outs[:5], ws_w, len(c)))
    print(f"table-sharded wwl stages on {len(text)} units, {N_SHARDS} row shards: "
          + "; ".join(f"{k} {v} s" for k, v in stages.items()) + f" [{smi}]")

    # The whole-word-longest facade's stages: the scan route on the 10k
    # dictionary, then the mixed route's host continuations.
    stages = {}
    c = stage("classes", lambda: big_wwl._classes(text))
    cls_p, starts, lanes, ws, d = stage("compact_lanes", lambda: scan_wwl.compact_lanes(
        big_wwl.compiled, c))
    if fused_default:  # the engine scan_walks_auto picks
        w = stage("windows (chunk_classes_overlap)", lambda: scan_wwl.chunk_classes_overlap(
            cls_p, 512, d, d + 1, sc10.num_classes))
    else:
        w = stage("windows (chunk_classes)", lambda: scan_batched.chunk_classes(
            cls_p, 512, d, sc10.num_classes))
    wd, st = stage("upload (windows + starts)", lambda: (
        scan_batched.classes_to_device(w, sc10.num_classes, dev), torch.from_numpy(starts).to(dev)))
    if fused_default:
        outs = stage("fused kernel (its first call on these starts checks their order)",
                     lambda: kwwl.wwl_scan_fused(sc10.table, sc10.outrows, wd, st, halo=d,
                                                 id_bits=sc10.id_bits,
                                                 depth_bits=sc10.depth_bits,
                                                 num_classes=sc10.num_classes, d=d,
                                                 cross=False))
    else:
        plane = stage("plane kernel", lambda: kwwl.wwl_scan_plane(
            sc10.table, wd, d, sc10.id_bits, sc10.num_classes, False))
        outs = stage("sweep kernel", lambda: kwwl.wwl_sweep_at(
            plane[0], None, None, sc10.outrows, st, d=d, id_bits=sc10.id_bits,
            depth_bits=sc10.depth_bits, cross=False))
    arrays = stage("download of lane outcomes", lambda: [
        x[: len(lanes)].cpu().numpy() for x in outs])
    def scatter():
        pos = [np.zeros(len(c), dtype=x.dtype) for x in arrays]
        for full, x in zip(pos, arrays):
            full[lanes] = x
        return pos

    pos = stage("scatter to position arrays", scatter)
    trip = stage("follow_chain (native, int64 copies included)", lambda: follow_chain(
        *pos, ws, len(c)))
    stage("triples list -> arrays", lambda: np.asarray(trip, dtype=np.int64))
    c7 = mixed._classes(text7)
    cls_p7, starts7, lanes7, _, d7 = scan_wwl.compact_lanes(mixed.compiled, c7)
    outs7 = scan_wwl.scan_walks_auto(mixed.dev.wwl_scan_mixed, cls_p7, starts7, d7, True)
    arrays7 = [x[: len(lanes7)].cpu().numpy() for x in outs7[:5]]
    cont7 = np.nonzero(outs7[5][: len(lanes7)].cpu().numpy())[0]
    stage("host continuations (mixed)", lambda: scan_wwl.apply_crossing_fixes(
        mixed.compiled, cls_p7, d7, arrays7, cont7, lanes7[cont7]))
    print(f"wwl stages on {len(text)} units ({len(lanes)} lanes; mixed: {len(lanes7)} lanes, "
          f"{len(cont7)} continued on the host): "
          + "; ".join(f"{k} {v} s" for k, v in stages.items()) + f" [{smi}]")

    # Where a stream's time goes: the AC and Longest streams again, with the
    # cursor's stages timed (each call synchronized, so the total is above
    # the untimed run's).
    def timed_stream(cls_name):
        totals = {}
        targets = [(stream_mod.StreamScanner, "_classes", "classes"),
                   (stream_mod._CandidateSource, "candidates", "candidates"),
                   (stream_mod._SeqScan, "states", "sequential scan (upload, kernel, download)"),
                   (stream_mod, "expand_state_emits", "emit expansion"),
                   (scan_batched, "chunk_classes", "windows"),
                   (scan_batched, "ac_matches_batched",
                    "compaction, download and native extraction")]
        saved = []
        for obj, attr, label in targets:
            real = getattr(obj, attr)

            def wrap(*a, _real=real, _label=label, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _real(*a, **k)
                torch.cuda.synchronize()
                totals[_label] = totals.get(_label, 0.0) + time.perf_counter() - t
                return out

            saved.append((obj, attr, real))
            setattr(obj, attr, wrap)
        try:
            m = getattr(port, cls_name)(keywords, device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            n_out = len(feed_all(m.stream(), sizes, 0, len(text)))
            total = time.perf_counter() - t
        finally:
            for obj, attr, real in saved:
                setattr(obj, attr, real)
        inside = totals.pop("candidates")
        rest = total - inside - totals["classes"]
        print(f"stream stages {cls_name} on {len(text)} units in {len(sizes)} feeds "
              f"({n_out} matches): total {total} s; "
              + "; ".join(f"{k} {v} s" for k, v in totals.items())
              + f"; other work inside candidates (upload, planes kernel, tail filter) "
              f"{inside - sum(v for k, v in totals.items() if k != 'classes')} s; outside it "
              f"(text slices, tuple lists, the pending queue) {rest} s [{smi}]")

    timed_stream("AhoCorasickSet")
    timed_stream("LongestMatchSet")

    # The row-compressed gold branch (one cursor feed over the RowTable form
    # of the lane scan), stage by stage, beside the facade's median.
    stages = {}
    gold_runs = host_s(lambda: wide_gold.match_triples(wide_text32), 3)
    c = stage("classes", lambda: wide_gold._classes(wide_text32))
    cd = stage("upload (int32 classes)", lambda: int32_classes(c))
    st = stage("lane scan kernel", lambda: scan_dfa.seq_states(*wide_tab, cd, 0, 1))
    sh = stage("download of states", lambda: st.cpu().numpy())
    trip = stage("expand_state_emits", lambda: stream_mod.expand_state_emits(
        wide_gold.compiled, sh, 0))
    stage("triples: tuple list, then arrays", lambda: np.asarray(
        list(zip(*(x.tolist() for x in trip))), dtype=np.int64))
    print(f"gold branch stages on {len(wide_text32)} units, wide-alphabet RowTable "
          f"({len(trip[0])} matches): facade match_triples median {sorted(gold_runs)[1]} s "
          f"(runs {gold_runs}); " + "; ".join(f"{k} {v} s" for k, v in stages.items())
          + f" [{smi}]")

    # The 1M dictionary's match path, stage by stage (hotstate layout).
    stages = {}
    scan_batched.host_emit_planes(c1m)  # built once per matcher, then cached
    c = stage("classes", lambda: ac1m._classes(text5))
    w = stage("windows (chunk_classes)", lambda: scan_batched.chunk_classes(
        c, 512, halo1m, A1m))
    wd = stage("upload", lambda: scan_batched.classes_to_device(w, A1m, dev))
    stage("count kernel + scalar download", lambda: int(khuge.packedcount_count(
        flat1m, wd, halo1m, sb1m, A1m)))
    bits = stage("hotstate kernel", lambda: khuge.packedcount_hotstate_plane(
        flat1m, wd, halo1m, sb1m, A1m))
    sp = stage("compaction kernel + download (sparse, or dense when over n // 4 hot)",
               lambda: scan_batched.planes_to_sparse(bits, len(c)) or scan_batched.to_host(bits))
    smask = np.uint32((1 << sb1m) - 1)

    def decode():
        planes_tab = scan_batched.host_emit_planes(c1m)
        if isinstance(sp, tuple):
            idx, packed = sp
            return idx, planes_tab[(packed[:, 0] & smask).astype(np.int64)]
        v = sp[0, : len(c)]
        idx = np.nonzero(v)[0].astype(np.int64)
        return idx, planes_tab[(v[idx] & smask).astype(np.int64)]

    idx, masks = stage("host decode (state -> emit planes)", decode)
    starts, ends = stage("native extract", lambda: native_lib.extract_resolve_sparse(
        idx, masks, len(c), c1m.max_depth, "all"))
    print(f"huge stages on {len(text5)} units, 1M dictionary ({'sparse' if isinstance(sp, tuple) else 'dense'} "
          f"download, {len(idx)} hot positions, {len(starts)} matches): "
          + "; ".join(f"{k} {v} s" for k, v in stages.items()) + f" [{smi}]")

    # The "auto" thresholds: engine="gold" against engine="device" per input
    # size: the device's first count and first match_triples (a fresh matcher
    # over the same compiled automaton: table build and upload included) and
    # warm counts; and for streams, one feed through the sequential-scan
    # kernel against the planes kernel (core/stream._CandidateSource, warm).
    # Break-even: the smallest size from which the device is never slower in
    # the sweep.  The 1M dictionary's first calls (a 470 MB table build) are
    # timed at three sizes, up to 1 Mi units.
    sweep_sizes = [1 << k for k in range(8, 19)]
    sweep_texts = [(f"{len(kws_r)} keywords", port.AhoCorasickSet(kws_r, engine="device", device=dev),
                    bench_word_soup(np.random.default_rng(SEED + 13), kws_r, sweep_sizes[-1]))
                   for kws_r in suite_dicts.values()]
    sweep_texts += [("10k keywords", big, text[: sweep_sizes[-1]]),
                    ("1M keywords", ac1m, text5[: 1 << 20])]
    first_1m = (sweep_sizes[0], 1 << 18, 1 << 20)

    def once(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def break_even(rows, fast, slow):
        ok = [r[fast] is not None and r[fast] <= r[slow] for r in rows]
        for i in range(len(rows)):
            if all(ok[i:]):
                return rows[i]["n"]
        return None

    sweep = {}
    for label, m, t_sweep in sweep_texts:
        gold_m = port.AhoCorasickSet.from_compiled(m.compiled, engine="gold", device=dev)
        src_seq = stream_mod._CandidateSource(m.compiled, dev, m.dev, "gold")
        src_dev = stream_mod._CandidateSource(m.compiled, dev, m.dev, "device")
        cls_sweep = m._classes(t_sweep)
        rows = []
        for n in sweep_sizes + ([1 << 19, 1 << 20] if m is ac1m else []):
            t_n, c_n = t_sweep[:n], cls_sweep[:n]
            first = first_match = None
            if m is not ac1m or n in first_1m:
                fresh = port.AhoCorasickSet.from_compiled(m.compiled, engine="device", device=dev)
                first = once(lambda: fresh.count(t_n))
                fresh = port.AhoCorasickSet.from_compiled(m.compiled, engine="device", device=dev)
                first_match = once(lambda: fresh.match_triples(t_n))
            m.count(t_n)
            src_seq.candidates(c_n, 0)
            src_dev.candidates(c_n, 0)
            m.match_triples(t_n)
            rows.append({
                "n": n, "gold": min(once(lambda: gold_m.count(t_n)) for _ in range(2)),
                "gold_match": once(lambda: gold_m.match_triples(t_n)),
                "first": first, "first_match": first_match,
                "warm": min(once(lambda: m.count(t_n)) for _ in range(3)),
                "warm_match": min(once(lambda: m.match_triples(t_n)) for _ in range(2)),
                "seq": min(once(lambda: src_seq.candidates(c_n, 0)) for _ in range(3)),
                "planes": min(once(lambda: src_dev.candidates(c_n, 0)) for _ in range(3))})
            if m.last_stats.engine != "device" or gold_m.last_stats.engine != "gold":
                raise AssertionError(f"threshold sweep {label}: engines {m.last_stats.engine}, "
                                     f"{gold_m.last_stats.engine}")
        firsts = [r for r in rows if r["first"] is not None]
        sweep[label] = {"rows": rows, "warm": break_even(rows, "warm", "gold"),
                        "warm_match": break_even(rows, "warm_match", "gold_match"),
                        "first": break_even(firsts, "first", "gold"),
                        "first_match": break_even(firsts, "first_match", "gold_match"),
                        "stream": break_even(rows, "planes", "seq"),
                        "plan": dispatch.count_plan(m.compiled, m.dev).which}
        for r in rows:
            firsts = ("not measured" if r["first"] is None else
                      f"{r['first'] * 1e3} ms, match_triples {r['first_match'] * 1e3} ms")
            print(f"sweep {label}, {r['n']} units: gold count {r['gold'] * 1e3} ms, "
                  f"match_triples {r['gold_match'] * 1e3} ms; device first call count {firsts}; "
                  f"device warm count {r['warm'] * 1e3} ms, match_triples "
                  f"{r['warm_match'] * 1e3} ms; stream feed: "
                  f"sequential scan "
                  f"{r['seq'] * 1e3} ms, planes kernel {r['planes'] * 1e3} ms [{smi}]")
        sw = sweep[label]
        print(f"sweep {label} ({m.compiled.num_states} states, count plan {sw['plan']}): "
              f"break-even warm {sw['warm']} units (count) and {sw['warm_match']} units "
              f"(match_triples), first call {sw['first']} units (count) and "
              f"{sw['first_match']} units (match_triples, planes plan "
              f"{dispatch.planes_plan(m.compiled, m.dev).which}), stream "
              f"feed {sw['stream']} units; _AUTO_DEVICE_MIN_UNITS "
              f"{port.models.matchers._AUTO_DEVICE_MIN_UNITS}, _STREAM_DEVICE_MIN "
              f"{stream_mod._STREAM_DEVICE_MIN} [{smi}]")

    def timed_pair(name, kernel, plain, reps, plain_reps):
        """(kernel ms, twin ms) at a timing shape, the kernel's result first
        held against the twin's there (its error joins ``errs``)."""
        e = max_err((kernel(),), (plain(),))
        errs[name] = max(errs[name], e)
        if e:
            raise AssertionError(f"{name} at its timing shape: max_abs_err {e} against the twin")
        return cuda_ms(kernel, reps), cuda_ms(plain, plain_reps)

    # The probe kernels: chain_gather and row_chain at the residency sweep's
    # shape on the 10k dictionary's table size (one load per step, global),
    # onehot_mma at probe.py's P4, gather2d at probe3.py's 2-D gather; each
    # beside its twin and the same chain as eager torch indexing (the library
    # yardstick, which the port never calls).
    probe_library = {}
    gen = torch.Generator(device=dev).manual_seed(probes_main.SEED)
    n_ref, steps = probes_main.SWEEP_SIZES[3], probes_main.SWEEP_STEPS
    tab_ref = probes_main.cycle_table(n_ref, dev, gen)
    start_ref = torch.randint(0, n_ref, (probes_main.SWEEP_CHAINS,), generator=gen, device=dev,
                              dtype=torch.int32)
    rows_ref = n_ref // probes_main.ROW_WORDS
    row_ref = torch.zeros((rows_ref, probes_main.ROW_WORDS), dtype=torch.int32, device=dev)
    row_ref[:, 0] = probes_main.cycle_table(rows_ref, dev, gen)
    row_start = start_ref % rows_ref

    def torch_chain():
        s = start_ref.long()
        for _ in range(steps):
            s = tab_ref[s].long()
        return s

    def torch_rows():
        s = row_start.long()
        for _ in range(steps):
            s = row_ref[s].max(dim=1).values.long() % rows_ref
        return s

    ms["chain_gather"] = timed_pair(
        "chain_gather",
        lambda: kprobe.chain_gather(tab_ref, start_ref, steps, "load", placement="global"),
        lambda: kprobe.chain_gather_plain(tab_ref, start_ref, steps, "load"), 20, 1)
    probe_library["chain_gather"] = cuda_ms(torch_chain, 2)
    ms["row_chain"] = timed_pair(
        "row_chain", lambda: kprobe.row_chain(row_ref, row_start, steps, "max", rows_ref),
        lambda: kprobe.row_chain_plain(row_ref, row_start, steps, "max", rows_ref), 20, 1)
    probe_library["row_chain"] = cuda_ms(torch_rows, 2)
    # The row read's first design against the group sizes at widths 28 (this
    # table) and 128 (probe.py's 4,096 x 128), each launch held bit for bit
    # against the first design, and each one's latency floor: reps x the step
    # latency of 32 chains on the idle card x the waves its chains need.
    ab_rows = scan_variants.row_ab(scan_variants.row_cells(dev), variants_lib)
    print(f"ab row_chain {json.dumps({'card': smi, **ab_rows})}")
    # and the first design against the rule's group at every residency-sweep
    # size (rows of 28 words, 512 B to 470 MB)
    ab = scan_variants.row_ab(scan_variants.row_cells(dev, sizes=probes_main.SWEEP_SIZES),
                              variants_lib, every_group=False)
    print(f"ab row_chain sweep {json.dumps({'card': smi, **ab})}")
    slower = [c for c, t in ab["row_ms"].items()
              if t[f"G={kprobe.row_group(probes_main.ROW_WORDS)}"] > t["first"]]
    print(f"ab row_chain sweep: the rule's group is slower than the first design at "
          f"{slower or 'no size'} [{smi}]")
    # chain_gather's floor the same way: 32 chains of the timed table, a
    # thread each, so one wave for its 65,536 chains.
    lat_ms = [scan_variants._card_ms(
        lambda r=r: kprobe.chain_gather(tab_ref, start_ref[:32], r, "load", placement="global"),
        3, dev) for r in (steps, 2 * steps)]
    gather_floor = (lat_ms[1] - lat_ms[0]) * -(-start_ref.numel() // scan_variants.CARD_THREADS)
    row_label = f"{rows_ref} x {probes_main.ROW_WORDS}"
    row_group = kprobe.row_group(probes_main.ROW_WORDS)
    latency_floor.update({"chain_gather": gather_floor,
                          "row_chain": ab_rows["row_floor_ms"][row_label][f"G={row_group}"]})
    print(f"latency floor chain_gather: {steps} steps x {(lat_ms[1] - lat_ms[0]) / steps * 1e3} "
          f"us a step (32 chains) x 1 wave = {gather_floor} ms; kernel {ms['chain_gather'][0]} "
          f"ms = {ms['chain_gather'][0] / gather_floor} x its floor [{smi}]")
    # The chain's arms in global memory (bench/scan_variants.chain_ab): (a)
    # the same loads at independent addresses, the card's random-request
    # ceiling on this table, whose time is the chain's throughput floor; (b)
    # the chains in flight; (c) __ldcg, the L1 carve-out; (d) 2 and 4 chains
    # a thread; (e) one block an SM.
    ab_chain = scan_variants.chain_ab(scan_variants.chain_cell(dev), variants_lib)
    print(f"ab chain_gather {json.dumps({'card': smi, **ab_chain})}")
    throughput_floor = {"chain_gather": ab_chain["throughput_floor_ms"]}
    kind = "throughput" if throughput_floor["chain_gather"] > gather_floor else "latency"
    print(f"throughput floor chain_gather: {start_ref.numel() * steps} lookups / "
          f"{ab_chain['independent_rate'] / 1e9} G lookups/s (arm (a)) = "
          f"{throughput_floor['chain_gather']} ms, beside its latency floor {gather_floor} ms: "
          f"bound by {kind}; kernel {ms['chain_gather'][0]} ms = "
          f"{ms['chain_gather'][0] / max(gather_floor, throughput_floor['chain_gather'])} x the "
          f"larger; arms faster than the kernel by more than the spread of one design "
          f"({ab_chain['chain_spread_ms']} ms): {ab_chain['chain_beats'] or 'none'} [{smi}]")
    print("chains in flight chain_gather: " + "; ".join(
        f"{n} chains {v['ms']} ms, {v['rate'] / 1e9} G lookups/s"
        for n, v in ab_chain["chain_curve"].items()) + f" [{smi}]")
    print(f"latency floor row_chain, {row_label}, G = {row_group} (the rule): "
          f"{latency_floor['row_chain']} ms ({ab_rows['row_step_us'][row_label][f'G={row_group}']}"
          f" us a step); kernel {ms['row_chain'][0]} ms = "
          f"{ms['row_chain'][0] / latency_floor['row_chain']} x its floor; first design "
          f"{ab_rows['row_ms'][row_label]['first']} ms, its floor "
          f"{ab_rows['row_floor_ms'][row_label]['first']} ms [{smi}]")
    rs = np.random.RandomState(SEED)
    tab4 = torch.from_numpy(rs.randint(0, 2048, (2048, 128)).astype(np.float32)).to(dev)
    tab4_h = kprobe.onehot_table(tab4)
    idx4 = torch.from_numpy(rs.randint(0, 2048, (1024, 128), np.int32)).to(dev)

    def torch_onehot(half):
        i = idx4.long()
        tab4_t = tab4_h.t()
        for _ in range(128):
            oh = torch.nn.functional.one_hot(i[:, 0], 2048)
            g = oh.half() @ tab4_t if half else oh.to(torch.float32) @ tab4
            i = (i + g.long()) & 2047
        return i

    ms["onehot_mma"] = timed_pair("onehot_mma", lambda: kprobe.onehot_mma(tab4_h, idx4, 128),
                                  lambda: kprobe.onehot_mma_plain(tab4_h, idx4, 128), 20, 2)
    # the library yardstick: the fp16 one-hot product a step (the product the
    # kernel computes); the fp32 one beside it
    onehot_fp32_ms = cuda_ms(lambda: torch_onehot(False), 2)
    probe_library["onehot_mma"] = cuda_ms(lambda: torch_onehot(True), 2)
    print(f"time library onehot_mma: fp16 one-hot chain {probe_library['onehot_mma']} ms, fp32 "
          f"{onehot_fp32_ms} ms [{smi}]")
    tab8 = torch.from_numpy(rs.randint(0, 1024, (8, 128), np.int32)).to(dev)
    idx8 = torch.from_numpy(rs.randint(0, 1024, (512, 128), np.int32)).to(dev)

    def torch_gather2d():
        x, t = idx8.long(), tab8.long()
        for r in range(1024):
            blk = x.reshape(-1, 8, 128)
            lane = blk & 127
            x = (x + t[(torch.gather(blk, 2, lane) >> 7) & 7, lane].reshape(-1, 128) + r) & 1023
        return x.sum()

    ms["gather2d"] = timed_pair(
        "gather2d",
        lambda: kprobe.gather2d(tab8, idx8, 1024, "gather2d_all", mask=1023, sum_out=True),
        lambda: kprobe.gather2d_plain(tab8, idx8, 1024, "gather2d_all", mask=1023, sum_out=True),
        20, 2)
    probe_library["gather2d"] = cuda_ms(torch_gather2d, 2)
    # gather2d's latency floor, as row_chain's: 1,024 steps x the step of one
    # warp on the idle card (the same call on the first 8 rows, each warp
    # alone on an SM: (time at 2,048 steps - time at 1,024) / 1,024, so that
    # the launch cancels) x the waves its 512 warps need (one); beside it
    # the loaded step, the timed call over its steps.
    g2_ms = [scan_variants._card_ms(
        lambda r=r: kprobe.gather2d(tab8, idx8[:8], r, "gather2d_all", mask=1023, sum_out=True),
        5, dev) for r in (1024, 2048)]
    g2_step = (g2_ms[1] - g2_ms[0]) / 1024
    g2_waves = -(-32 * idx8.shape[0] // scan_variants.CARD_THREADS)
    latency_floor["gather2d"] = 1024 * g2_step * g2_waves
    print(f"latency floor gather2d, 512 x 128 indices, gather2d_all: 1024 steps x "
          f"{g2_step * 1e3} us a step (one warp a row, idle) x {g2_waves} wave = "
          f"{latency_floor['gather2d']} ms; loaded step {ms['gather2d'][0] / 1024 * 1e3} us; "
          f"kernel {ms['gather2d'][0]} ms = {ms['gather2d'][0] / latency_floor['gather2d']} x "
          f"its floor [{smi}]")
    for k, shape in (("chain_gather", f"{n_ref} entries, {start_ref.numel()} chains x {steps}"),
                     ("row_chain", f"{rows_ref} x {probes_main.ROW_WORDS} rows, "
                                   f"{row_start.numel()} chains x {steps}"),
                     ("onehot_mma", "T=2048, B=1024, 128 columns, 128 steps"),
                     ("gather2d", "(8, 128) table, 512 x 128 indices, 1,024 steps")):
        print(f"time {k} at {shape}: kernel {ms[k][0]} ms, plain twin {ms[k][1]} ms, eager "
              f"torch {probe_library[k]} ms [{smi}]")

    # The PFAC walk at the facade's 32 Mi units of the 10k dictionary, and the
    # (lane, depth) steps this text makes it take before the dead state.
    comp10 = big.compiled
    rt10 = big.dev.ranked
    d10p = bucket_depth(comp10.max_depth)
    P10 = (d10p + 31) // 32
    cp10 = scan_batched.classes_to_device(scan_pfac2.pad_classes(cls, d10p, bucket=LANE_BUCKET),
                                          comp10.num_classes, dev)
    n10 = cp10.numel() - d10p
    trie10 = big.dev.trie_next
    a2 = (rt10.trie_next, rt10.prefix, rt10.match_threshold, cp10, d10p)
    a1 = (trie10, big.dev.is_match, cp10, d10p, P10)
    ms["pfac2_planes"] = timed_pair(
        "pfac2_planes",
        lambda: kpfac.pfac2_planes(*a2, P10, rt10.prefix_k, comp10.num_classes, rt10.dead_state),
        lambda: kpfac.pfac2_planes_plain(*a2, P10, rt10.prefix_k, comp10.num_classes), 20, 2)
    ms["pfac2_count"] = timed_pair(
        "pfac2_count",
        lambda: kpfac.pfac2_count(*a2, rt10.prefix_k, comp10.num_classes, rt10.dead_state),
        lambda: kpfac.pfac2_count_plain(*a2, rt10.prefix_k, comp10.num_classes), 20, 2)
    ms["pfac1_planes"] = timed_pair(
        "pfac1_planes", lambda: kpfac.pfac1_planes(*a1, trie10.shape[0] - 1),
        lambda: kpfac.pfac1_planes_plain(*a1), 20, 2)
    c64 = cp10.long()

    def walked(st, table, first, dead):
        """Table loads each lane makes from depth ``first`` until the dead
        state (int32[n10])."""
        flat, stride = table.view(torch.int32).long().reshape(-1), table.shape[1]
        loads = torch.zeros(n10, dtype=torch.int32, device=dev)
        for kk in range(first, d10p):
            alive = st != dead
            loads += alive
            st = torch.where(alive, flat[st * stride + c64[kk: kk + n10]], st)
        return loads

    gram = kpfac._gram_index(cp10, n10, rt10.prefix_k, comp10.num_classes)
    first2 = rt10.prefix.view(torch.int32).long()[gram] & ((1 << kpfac.STATE_BITS) - 1)
    lane2 = 1 + walked(first2, rt10.trie_next, rt10.prefix_k, rt10.dead_state)  # the prefix too
    steps2 = int(lane2.sum())
    first1 = trie10.long()[0][c64[:n10]]
    lane1 = 1 + walked(first1, trie10, 1, trie10.shape[0] - 1)  # the root too
    steps1 = int(lane1.sum())
    for k in ("pfac2_planes", "pfac2_count", "pfac1_planes"):
        print(f"time {k}, 10k dictionary, {n10} lanes, depth {d10p}: kernel {ms[k][0]} ms "
              f"({gbps(ms[k][0])} GB/s), plain twin {ms[k][1]} ms; table loads: v2 {steps2} "
              f"(prefix included), v1 {steps1} [{smi}]")
    # The v2 walk's loads a lane (the prefix load and the trie loads) and the
    # rate each mode reached, to set beside the residency sweep's dependent
    # chain rate at an L2-resident table ("sweep" lines).
    w32 = lane2[: n10 // 32 * 32].reshape(-1, 32)
    print(f"pfac walk loads, 10k dictionary, {n10} lanes: {steps2} loads, a lane mean "
          f"{steps2 / n10} max {int(lane2.max())}; a warp of 32 consecutive starts: the longest "
          f"walk's loads mean {float(w32.max(dim=1).values.double().mean())}; trie loads "
          f"{steps2 - n10}; rate " + ", ".join(
              f"{k} {steps2 / (ms[k][0] * 1e-3) / 1e9} G loads/s"
              for k in ("pfac2_planes", "pfac2_count")) + f" [{smi}]")
    # The v1 walk's loads in its redesign (the trie loads past the staged
    # levels, and those that build the staged tables in each block) against
    # the first design's (every transition, the root's included), and each
    # design's warp efficiency: the walks' work over 32 x the sum of each
    # warp's largest lane (a lane a start: its loads; the redesign: a loop
    # pass a load past the staged levels and one to end).
    plan1 = kpfac.v1_plan(trie10, cp10, d10p)
    stride1 = trie10.shape[1]
    past1 = (lane1 - (2 if plan1.two_level else 0)).clamp(min=0)
    build1 = plan1.grid * (stride1 + stride1 * stride1) if plan1.two_level else 0
    loads1 = int(past1.sum()) + build1
    print(f"pfac1 walk loads, 10k dictionary, {n10} lanes, depth {d10p}: first design {steps1} "
          f"table loads, warp efficiency {v1_warp_efficiency(lane1)}; redesign (two-level "
          f"table {plan1.two_level}, {plan1.grid} blocks) {loads1} trie loads "
          f"({int(past1.sum())} past the staged levels, {build1} building them), "
          f"{int((past1 == 0).sum())} walks within the staged levels, warp efficiency {v1_warp_efficiency(past1 + 1)}; kernel "
          f"{loads1 / (ms['pfac1_planes'][0] * 1e-3) / 1e9} G trie loads/s [{smi}]")
    # The walk's designs in one process: the first design (planes, count, the
    # count without its atomic add), the package's, the prefix read with
    # __ldg, no refills (scan_variants.pfac_ab).
    ab = scan_variants.pfac_ab((rt10, cp10, d10p, comp10.num_classes), variants_lib,
                               grid=False)
    print(f"ab pfac {json.dumps({'card': smi, **ab})}")

    # The least time the card could take for each kernel's timed call: the
    # bytes it must move (each streamed input read once, each output written
    # once, at this run's sizes) over the memory rate, or its operations over
    # the 32-bit rate, whichever is larger.  The transition tables are left
    # out of the bytes: how much of a table a scan touches depends on the
    # text, so the bound is a floor.
    def nbytes(*xs):
        total = 0
        for x in xs:
            for leaf in x if isinstance(x, (tuple, list)) else (x,):
                if isinstance(leaf, torch.Tensor):
                    total += leaf.nbytes
        return total

    chars10, chars_w, chars5 = w_full.numel(), wd10.numel(), w5.numel()
    row10 = rowdfa_ms["10k keywords x 32 Mi units"]
    w_row = row10["args"][1]
    for k in ("rowdfa2_count", "rowdfa2_planes"):
        ms[k] = (row10[k], row10[k + " twin"])
    hot_out = compact.compact_planes(planes_full)
    n64 = len(short_cls)
    work = {  # name: (bytes, operations)
        "packed_scan_count": (nbytes(w_full) + 8, 4 * chars10),
        "packed_scan_planes": (nbytes(w_full, planes_full), 4 * chars10),
        "compact_planes": (nbytes(planes_full, hot_out[1], hot_out[2]) + 8, planes_full.numel()),
        "shortest_states": (nbytes(c_twin) + 4 * n64, 4 * n64),
        "wwl_scan_plane": (nbytes(wd10, kwwl.wwl_scan_plane(*pargs)), 4 * chars_w),
        # the 32-byte plane sectors its walks touch, the starts and the
        # outcomes ("sweep plane sectors"; one plane word a live lane gives
        # the old yardstick, printed below)
        "wwl_sweep_at": (sweep_bytes, 6 * len(lanes10)),
        "wwl_walks_at": (nbytes(walk_args[-3], st10, kwwl.wwl_walks_at(*walk_args, **walk_kw)),
                         6 * len(lanes10)),
        # the overlap windows and the starts in, 17 B of outcomes per slot out;
        # a lookup, a depth, a difference and a compare per class
        "wwl_scan_fused": (nbytes(wf10, st10, kwwl.wwl_scan_fused(*fargs, **fkw)),
                           4 * wf10.numel()),
        "packedcount_count": (nbytes(w5) + 8, 4 * chars5),
        "packedcount_hotstate_plane": (nbytes(w5, khuge.packedcount_hotstate_plane(*cargs)),
                                       4 * chars5),
        "split_count": (nbytes(w5s) + 8, 6 * chars5),
        "split_emit_planes": (nbytes(w5s, khuge.split_emit_planes(*sargs1m)), 6 * chars5),
        # classes in, states out; a lookup and an index per unit
        "seq_states": (8 * len(q64), 2 * len(q64)),
        "seq_states_serial": (8 * len(q64), 2 * len(q64)),
        # the plane once, four int32 and one bool plane out
        "wwl_sweep_all": (4 * (per_w + d10 + 1)
                          + nbytes(kwwl.wwl_sweep_all(*all_args, **skw)), 6 * per_w),
        # the synchronized maps: the first t = min(K, d + 1) classes and at
        # most d of the tail in, sigma out; S * t lookups and a d-long tail
        "state_maps": (4 * (min(K10, d_seq + 1) + d_seq) + 4 * tab10.shape[0],
                       tab10.shape[0] * min(K10, d_seq + 1) + d_seq),
        # classes in, sigma out; the lookups this run's data needs: the
        # reference run, then each lane until it met it (the first design's
        # yardstick, C * K * S lookups, printed below)
        "state_maps_all": (nbytes(c10[0]) + 4 * tab10.shape[0], meet_lookups),
        # a chain of C dependent loads: latency, not bytes
        "entry_fold": (8 * sigma8.shape[0], sigma8.shape[0]),
        # classes and the entry state in, states out; a lookup and an index a unit
        "rescan": (8 * K10 + 4, 2 * K10),
        "rescan_serial": (8 * K10 + 4, 2 * K10),
        # the planes mode: windows in, one word per body position out, and the
        # shard pointers; a division and a pointer load more than the packed scan
        "table_sharded_scan": (nbytes(w_full, planes_full) + 8 * N_SHARDS, 6 * chars10),
        # one launch of the step loop, planes, at the 10k cell: a lane's word
        # in, its class, its word out, one table word and one plane word out;
        # a mask, a compare, an index and a shift or two a lane
        "table_sharded_step": (step_rec["planes"]["lanes"]
                               * (16 + step_rec["planes"]["window_bytes"]),
                               8 * step_rec["planes"]["lanes"]),
        # the step loop's prep at the 10k planes: the windows in, the
        # class-major classes out; an index and a compare a class
        "table_sharded_classes": (step_rec["planes"]["window_nbytes"]
                                  + step_rec["planes"]["class_nbytes"],
                                  2 * step_rec["planes"]["steps"] * step_rec["planes"]["lanes"]),
        # windows in (a count out, or 4 B per body position), one lookup per
        # pair but the same shifts and popcounts per position
        "rowdfa2_count": (nbytes(w_row) + 8, 4 * w_row.numel()),
        "rowdfa2_planes": (nbytes(w_row) + 4 * w_row.shape[0] * (w_row.shape[1] - row10["args"][2]),
                           4 * w_row.numel()),
        # the chains in and out; a clamp and a load per step: a latency chain
        "chain_gather": (2 * start_ref.nbytes, 2 * start_ref.numel() * steps),
        # a 28-word max and a modulo per chain and step: a latency chain
        "row_chain": (2 * row_start.nbytes, (probes_main.ROW_WORDS + 2) * row_start.numel() * steps),
        # the dense one-hot product per step, on the fp16 tensor cores
        "onehot_mma": (nbytes(tab4_h) + 2 * nbytes(idx4),
                       2 * idx4.shape[0] * tab4.shape[0] * tab4.shape[1] * 128,
                       PEAK_FP16_TENSOR_PER_S),
        "gather2d": (nbytes(tab8, idx8) + 4, 6 * idx8.numel() * 1024),
        # classes in, planes (or a count) out; a load and a compare per step
        # this text makes before the dead state
        "pfac2_planes": (nbytes(cp10) + 4 * P10 * n10, 2 * steps2),
        "pfac2_count": (nbytes(cp10) + 8, 3 * steps2),
        "pfac1_planes": (nbytes(cp10) + 4 * P10 * n10, 2 * steps1),
    }
    sweep_words = nbytes(st10, kwwl.wwl_sweep_at(*sargs, **skw)) + 4 * len(lanes10)
    first_maps = K10 * tab10.shape[0] / PEAK_OPS_PER_S * 1e3
    print(f"bound state_maps_all, the first design's C*K*S lookups (the yardstick before the "
          f"meet): {K10 * tab10.shape[0]} operations / {PEAK_OPS_PER_S / 1e12} T/s = "
          f"{first_maps} ms; kernel {ms['state_maps_all'][0]} ms = "
          f"{ms['state_maps_all'][0] / first_maps} x [{smi}]")
    print(f"bound wwl_sweep_at, one plane word a live lane (the yardstick before the "
          f"touched sectors): {sweep_words} B / 3.35 TB/s = "
          f"{sweep_words / PEAK_BYTES_PER_S * 1e3} ms [{smi}]")
    bounds = {}
    for k, (b, ops, *peak) in work.items():
        peak = peak[0] if peak else PEAK_OPS_PER_S
        t_bytes, t_ops = b / PEAK_BYTES_PER_S * 1e3, ops / peak * 1e3
        bounds[k] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        print(f"bound {k}: {b} B / 3.35 TB/s = {t_bytes} ms, {ops} operations / "
              f"{peak / 1e12} T/s = {t_ops} ms; kernel {ms[k][0]} ms = "
              f"{ms[k][0] / bounds[k][0]} x its bound [{smi}]")
    # One PyTorch call chain that computes the compaction (P = 1): nonzero,
    # then a gather.  Timed here as the yardstick; the port never calls it.
    plane0 = planes_full.view(torch.int32)[0]

    def library_compact():
        idx = torch.nonzero(plane0).squeeze(1)
        return idx, plane0[idx]

    library = dict.fromkeys(KERNELS)
    library.update(probe_library)
    library["compact_planes"] = cuda_ms(library_compact, 20)
    library["table_sharded_step"] = step_rec["planes"]["library"]
    library["table_sharded_classes"] = step_rec["planes"]["prep_library"]
    print(f"time library compact (torch.nonzero + gather, P = 1, {plane0.numel()} positions): "
          f"{library['compact_planes']} ms [{smi}]")

    # Where the main path loses most to the bounds: launches x (ms - bound).
    # The sequential scans' launches scan from 1 unit to 32 Mi, so their gaps
    # are taken over the units they scanned: each one's time as a cost a
    # launch plus a cost a unit, fitted to the lane scan's 1 Ki and 32 Mi
    # timings and to speculate and repair's 64 Ki and 32 Mi on the 10k
    # restart table, each less the bytes bound of its units.
    seq_u = {k: sum(c[k] for c in path_seq.values()) for k in build.seq_units}
    per_unit_sync = (t_sync[TEXT_UNITS] - t_sync[1 << 10]) / (TEXT_UNITS - (1 << 10))
    fixed_sync = t_sync[1 << 10] - (1 << 10) * per_unit_sync
    t_r64, t_r32 = (t_spec["10k shortest restart table", n] for n in (1 << 16, TEXT_UNITS))
    per_unit_spec = (t_r32 - t_r64) / (TEXT_UNITS - (1 << 16))
    fixed_spec = t_r64 - (1 << 16) * per_unit_spec
    seq_time = {"seq_states": counts["seq_states"] * fixed_sync
                + seq_u["seq_states"] * per_unit_sync,
                "seq_states_serial": counts["seq_states_serial"] * fixed_spec
                + seq_u["seq_states_serial"] * per_unit_spec}
    seq_bound = {k: 8 * u / PEAK_BYTES_PER_S * 1e3 for k, u in seq_u.items()}
    yardstick = {k: max(bounds[k][0], latency_floor.get(k, 0.0), throughput_floor.get(k, 0.0))
                 for k in KERNELS}
    gaps = {k: counts[k] * (ms[k][0] - yardstick[k]) for k in KERNELS}
    gaps.update({k: seq_time[k] - seq_bound[k] for k in seq_time})
    print(f"sequential scans on the paths: {counts['seq_states']} lane scans over "
          f"{seq_u['seq_states']} units, modelled {seq_time['seq_states']} ms = "
          f"{counts['seq_states']} x {fixed_sync} ms + {seq_u['seq_states']} x {per_unit_sync} "
          f"ms, bound {seq_bound['seq_states']} ms; {counts['seq_states_serial']} speculate-and-"
          f"repair scans over {seq_u['seq_states_serial']} units, modelled "
          f"{seq_time['seq_states_serial']} ms = {counts['seq_states_serial']} x {fixed_spec} ms "
          f"+ {seq_u['seq_states_serial']} x {per_unit_spec} ms, bound "
          f"{seq_bound['seq_states_serial']} ms [{smi}]")
    gap = sorted(((g, k) for k, g in gaps.items()), reverse=True)
    print("launches x gap to bound (ms; the sequential scans over their units; the latency "
          f"chains {sorted(latency_floor)} to their latency floors, chain_gather to the larger "
          f"of its latency and throughput floors): " + "; ".join(
        f"{k} {counts[k]} x ({ms[k][0]} - {yardstick[k]}) = {g}" if k not in seq_time else
        f"{k} {seq_u[k]} units: {seq_time[k]} - {seq_bound[k]} = {g}" for g, k in gap)
          + f" [{smi}]")
    print(f"chip_smoke: {time.perf_counter() - t_start} s from the build to here [{smi}]")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
         "launches": counts[k], "max_abs_err": errs[k],
         "ms": ms[k][0], "plain_ms": ms[k][1], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": library[k]}
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
