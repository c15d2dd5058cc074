"""Host-side emission extraction: device planes/states -> match triples — the
port of ``ahocorasick_tpu/ops/emit.py``.

``resolve_end_planes`` serves the ``"planes"`` and ``"hotstate"`` layouts
over the port's compaction (``ops/scan_batched.planes_to_sparse`` /
``hotstate_sparse``); ``walk_values``, ``sort_by_end_start`` and
``states_to_shortest_matches`` are the JAX module's numpy helpers, and so
are the START-indexed ``bitplanes_to_matches`` / ``ac_matches`` of the
``device_engine="pfac2"`` cross-check walk (``ops/scan_pfac2.py``), whose
planes come back to the host whole, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ahocorasick_tpu_torch.core.compiler import CompiledMatcher
from ahocorasick_tpu_torch.native import lib as native_lib
from ahocorasick_tpu_torch.ops import scan_batched
from ahocorasick_tpu_torch.resolve.queue import resolve_longest, resolve_shortest


def bitplanes_to_matches(bits: np.ndarray, max_depth: int) -> Tuple[np.ndarray, np.ndarray]:
    """uint32[P, N] START-indexed planes -> (starts, lengths) int64 arrays,
    unsorted."""
    bits = np.asarray(bits)
    planes, n = bits.shape
    starts_all = []
    lens_all = []
    hot = np.nonzero(bits.any(axis=0))[0]
    if len(hot):
        sub = np.ascontiguousarray(bits[:, hot].T)  # (H, P)
        # Expand to (H, P*32) bit bools, little-endian within each word.
        b8 = sub.view(np.uint8).reshape(len(hot), planes * 4)
        expanded = np.unpackbits(b8, axis=1, bitorder="little")  # (H, P*32)
        rows, ks = np.nonzero(expanded)
        starts_all.append(hot[rows])
        lens_all.append(ks + 1)
    if not starts_all:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    starts = np.concatenate(starts_all).astype(np.int64)
    lens = np.concatenate(lens_all).astype(np.int64)
    keep = lens <= max_depth
    return starts[keep], lens[keep]


def walk_values(
    m: CompiledMatcher, cls: np.ndarray, starts: np.ndarray, lens: np.ndarray
) -> np.ndarray:
    """Recover value ids for (start, len) matches by re-walking the trie."""
    if len(starts) == 0:
        return np.zeros(0, dtype=np.int64)
    trie = m.trie_next
    max_len = int(lens.max())
    states = np.zeros(len(starts), dtype=np.int64)
    vals = np.full(len(starts), -1, dtype=np.int64)
    for k in range(max_len):
        active = lens > k
        idx = starts[active] + k
        states[active] = trie[states[active], cls[idx]]
        done = lens == k + 1
        vals[done] = m.own_val[states[done]]
    return vals


def sort_by_end_start(starts: np.ndarray, lens: np.ndarray):
    """Order matches as the sequential reference emits them.

    All matches ending at a position are reported longest-first
    (``AhoCorasickSet.java:522-535``), i.e. start ascending at equal end;
    across positions ends ascend.
    """
    ends = starts + lens
    order = np.lexsort((starts, ends))
    return starts[order], ends[order], order


def ac_matches(m: CompiledMatcher, cls: np.ndarray, bits: np.ndarray):
    """(starts, ends, vals) in reference emission order for the AC kinds,
    from START-indexed planes."""
    starts, lens = bitplanes_to_matches(bits, m.max_depth)
    starts, ends, order = sort_by_end_start(starts, lens)
    lens = ends - starts
    if m.values is not None:
        vals = walk_values(m, cls, starts, lens)
    else:
        vals = np.full(len(starts), -1, dtype=np.int64)
    return starts, ends, vals


def states_to_shortest_matches(m: CompiledMatcher, states: np.ndarray):
    """Arrival states -> shortest-match triples (already end-ascending)."""
    states = np.asarray(states)
    ml = m.match_len[states]
    pos = np.nonzero(ml > 0)[0]
    ends = pos + 1
    starts = ends - ml[pos]
    vals = m.match_val[states[pos]].astype(np.int64)
    return starts.astype(np.int64), ends.astype(np.int64), vals


def resolve_end_planes(m: CompiledMatcher, cls: np.ndarray, bits, mode: str,
                       layout: str = "planes"):
    """``(starts, ends, vals)`` of the leftmost-longest (``mode="longest"``)
    or leftmost-shortest (``"shortest"``) matches from ``bits`` (a device
    tensor from a planes kernel, or a host array): END-indexed emit planes
    (``layout="planes"``) or the packed (state, count) plane of the hotstate
    kernel (``"hotstate"``).

    With the native library, extraction and the greedy resolve are fused in
    C over the compacted hot positions (only they are downloaded), or over
    the dense planes when compaction does not pay; values are then re-walked
    over just the accepted spans.  Without it, all candidates are extracted
    and resolved in numpy."""
    n = len(cls)
    if native_lib.available():
        if layout == "hotstate":
            sp = scan_batched.hotstate_sparse(m, bits, n)
        else:
            sp = scan_batched.planes_to_sparse(bits, n)
        if sp is not None:
            starts, ends = native_lib.extract_resolve_sparse(sp[0], sp[1], n, m.max_depth, mode)
        else:
            starts, ends = native_lib.extract_resolve(
                scan_batched.to_host(bits), n, m.max_depth, mode)
        return starts, ends, scan_batched._ac_vals(m, cls, starts, ends)
    trip = scan_batched.ac_matches_batched(m, cls, bits, layout=layout)
    return (resolve_longest if mode == "longest" else resolve_shortest)(*trip)
