"""Packed-table builders, window layout, hot-position compaction and match
extraction for the batched-halo DFA scan — the port of
``ahocorasick_tpu/ops/scan_batched.py`` without its JAX scan loops (those
became the kernels of ``kernels/scan_block.py`` and
``kernels/scan_batched.py``).

The table-building functions are numpy, the port's own copies of that
module's; they must stay byte-identical to it
(``tests/test_torch_tables.py``, ``tests/test_torch_huge.py``).  The scan is
d-synchronizing: a window that starts at the root and consumes
``halo = max_depth`` classes of left context reaches the sequential
automaton's state, so B windows scan in parallel lanes.  Table entries pack
``next_state | emit_mask << state_bits``, where bit ``L-1`` of ``emit_mask``
means "a keyword of length L ends here" (the state's whole suffix-chain emit
set).

Huge dictionaries, whose state bits plus max depth exceed 32, have three
layouts of their own: count-packed (``next | emit_count << state_bits``,
``build_count_packed``) for counts; hotstate (the same table, the whole
packed word kept where a keyword ends, decoded on the host by
``hotstate_sparse``) for matches; and split (the bare next-state table plus
per-state emit planes) when even the emit count does not fit beside the
state.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ahocorasick_tpu_torch.core.compiler import CompiledMatcher, RowTable
from ahocorasick_tpu_torch.kernels import compact
from ahocorasick_tpu_torch.native import lib as native_lib

PAD_CLASS = 0


class PackedDfa(NamedTuple):
    table: object  # uint32[S_eff, A] numpy (builder) or torch tensor (device)
    emit_mask: Optional[np.ndarray]  # uint32[S, P] emit planes when split, else None
    state_bits: int  # 32 when not packed inline
    halo: int


def effective_rows(m: CompiledMatcher) -> int:
    """Scan-state count: distinct goto-closure rows for row-compressed
    matchers (the quotient DFA, see ``build_packed``), else trie states."""
    if m.is_row_compressed and isinstance(m.dfa_next, RowTable):
        return m.dfa_next.rows.shape[0]
    return m.num_states


def inline_packable(m: CompiledMatcher) -> bool:
    """Packed-inline layout applies: scan-state bits + emit bits fit 32."""
    d = max(m.max_depth, 1)
    s_eff = effective_rows(m)
    return max(int(s_eff - 1).bit_length(), 1) + d <= 32


def quotient_packable(m: CompiledMatcher) -> bool:
    """A row-compressed matcher whose quotient DFA packs inline."""
    return (
        m.is_row_compressed
        and isinstance(m.dfa_next, RowTable)
        and inline_packable(m)
    )


def _state_emit_planes(m: CompiledMatcher) -> np.ndarray:
    """Per-state emit planes uint32[S, P]: bit L-1 (plane (L-1)//32) set iff
    a keyword of length L ends at this state (own + suffix chain)."""
    S = m.num_states
    d = max(m.max_depth, 1)
    P = (d + 31) // 32
    planes = np.zeros((S, P), dtype=np.uint32)
    if m.emit_count is not None:
        counts = m.emit_count[:S].astype(np.int64)
        pos = np.nonzero(counts)[0]
        if len(pos):
            reps = counts[pos]
            total = int(reps.sum())
            offs = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(reps) - reps, reps
            )
            eidx = np.repeat(m.emit_start[pos].astype(np.int64), reps) + offs
            st_rep = np.repeat(pos, reps)
            bit = m.emit_len[eidx].astype(np.int64) - 1
            np.bitwise_or.at(
                planes, (st_rep, bit >> 5), np.uint32(1) << (bit & 31).astype(np.uint32)
            )
    return planes


def build_packed(m: CompiledMatcher) -> PackedDfa:
    """Packed scan table.  Dense matchers: ``next | emit << state_bits`` over
    trie states.  Row-compressed matchers: the same layout over the quotient
    DFA whose states are the distinct goto-closure rows (``row_id`` is a DFA
    homomorphism, and the emit mask of ``rows[r, c]`` depends only on
    ``(r, c)``), so the quotient scan emits the sequential automaton's masks.
    Dictionaries whose masks do not fit beside the state (split layout)
    return the bare next-state table plus per-state emit planes."""
    d = max(m.max_depth, 1)
    # The deepest state (a complete longest keyword) has depth d, so
    # convergence needs d characters of history.
    halo = d
    planes = _state_emit_planes(m)

    if m.is_row_compressed:
        rt = m.dfa_next
        if not isinstance(rt, RowTable):
            raise ValueError(f"kind {m.kind!r} has no goto-closure table")
        R = rt.rows.shape[0]
        rid_bits = max(int(R - 1).bit_length(), 1)
        if rid_bits + d > 32:
            raise ValueError(
                "row-compressed dictionary has no packed device layout "
                f"({R} rows, max depth {d})"
            )
        # Compiler invariant: the root's row is row 0 (the scan starts at 0).
        if int(rt.row_id[0]) != 0:
            raise ValueError("row-compressed table does not map the root to row 0")
        packed = rt.row_id[rt.rows].astype(np.uint32) | (
            planes[:, 0][rt.rows] << np.uint32(rid_bits)
        )
        return PackedDfa(packed, None, rid_bits, halo)

    S = m.num_states
    state_bits = max(int(S - 1).bit_length(), 1)
    if state_bits + d <= 32:
        packed = m.dfa_next.astype(np.uint32) | (
            planes[:, 0][m.dfa_next] << np.uint32(state_bits)
        )
        return PackedDfa(packed, None, state_bits, halo)
    return PackedDfa(m.dfa_next.astype(np.uint32), planes, 32, halo)


def count_packable(m: CompiledMatcher) -> bool:
    """Count-packed layout applies: state bits + emit-count bits fit 32.

    Counting needs only how many keywords end at each position, and the
    per-state emit count (the suffix-chain length) is small, so
    ``next | count << state_bits`` keeps one lookup per character where the
    per-length mask does not fit beside the state."""
    if m.is_row_compressed or m.emit_count is None or m.dfa_next is None:
        return False
    state_bits = max(int(m.num_states - 1).bit_length(), 1)
    cap = 32 - state_bits
    if cap <= 0:
        return False
    return int(m.emit_count[: m.num_states].max(initial=0)) < (1 << cap)


def build_count_packed(m: CompiledMatcher):
    """``(uint32[S*A] flat, state_bits, halo)``: ``next | emit_count(next)
    << state_bits``."""
    if not count_packable(m):
        raise ValueError("dictionary's emit counts do not fit beside the state")
    S, A = m.num_states, m.num_classes
    state_bits = max(int(S - 1).bit_length(), 1)
    counts = m.emit_count[:S].astype(np.uint32)
    packed = m.dfa_next.astype(np.uint32) | (
        counts[m.dfa_next] << np.uint32(state_bits)
    )
    return packed.reshape(S * A), state_bits, max(m.max_depth, 1)


def hotstate_layout(m: CompiledMatcher) -> bool:
    """Huge-dictionary match layout: packed-inline overflows but the
    count-packed table fits.  The scan keeps the packed (state, count) word
    at each position where a keyword ends, and the host recovers the emit
    masks from the state id (``hotstate_sparse``)."""
    return (
        m.dfa_next is not None
        and not m.is_row_compressed
        and not inline_packable(m)
        and count_packable(m)
    )


_HOST_EMIT_PLANES: "OrderedDict[int, tuple]" = OrderedDict()


def host_emit_planes(m: CompiledMatcher) -> np.ndarray:
    """Cached host copy of the per-state emit planes (LRU of 4 matchers).

    Entries hold a weak reference to the matcher: a huge dictionary's planes
    are tens of MB, and a strong reference would pin the matcher's tables
    after its callers drop it; an entry evicts itself when its matcher is
    collected."""
    key = id(m)
    ent = _HOST_EMIT_PLANES.get(key)
    if ent is not None and ent[0]() is m:
        _HOST_EMIT_PLANES.move_to_end(key)
        return ent[1]
    planes = _state_emit_planes(m)

    def _evict(_ref, _key=key):
        _HOST_EMIT_PLANES.pop(_key, None)

    _HOST_EMIT_PLANES[key] = (weakref.ref(m, _evict), planes)
    if len(_HOST_EMIT_PLANES) > 4:
        _HOST_EMIT_PLANES.popitem(last=False)
    return planes


def hotstate_sparse(m: CompiledMatcher, bits, n: int):
    """Hotstate plane ``uint32[1, N]`` -> ``(idx, masks[k, P])``, the
    contract of ``planes_to_sparse``, so the sparse extraction and the native
    extract-and-resolve serve both layouts.  The hot words are compacted
    (or, when that does not pay, found in the dense download), and each
    word's state indexes the host emit planes."""
    S = m.num_states
    smask = np.uint32((1 << max(int(S - 1).bit_length(), 1)) - 1)
    planes_tab = host_emit_planes(m)
    sp = planes_to_sparse(bits, n)
    if sp is not None:
        idx, packed = sp
        states = (packed[:, 0] & smask).astype(np.int64)
        return idx, planes_tab[states]
    v = to_host(bits)[0, :n]
    idx = np.nonzero(v)[0].astype(np.int64)
    states = (v[idx] & smask).astype(np.int64)
    return idx, planes_tab[states]


def class_dtype(num_classes: int):
    """Narrowest dtype holding class ids in [0, num_classes): uint8 / uint16
    (classes index BMP units, so they are always < 65536)."""
    return np.uint8 if num_classes <= 256 else np.uint16


def classes_to_device(arr: np.ndarray, num_classes: int, device) -> torch.Tensor:
    """Class ids (any shape) uploaded in the narrow dtype of ``class_dtype``:
    uint8, or uint16 through an int16 view (same bits)."""
    arr = np.ascontiguousarray(arr, dtype=class_dtype(num_classes))
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).to(device).view(torch.uint16)
    return torch.from_numpy(arr).to(device)


def chunk_classes(
    cls: np.ndarray, chunk: int, halo: int, num_classes: Optional[int] = None
) -> np.ndarray:
    """(B, halo + chunk) windows: chunk i covers [i*chunk, (i+1)*chunk) with a
    left halo (PAD_CLASS beyond the text; the halo re-synchronizes lanes).

    ``num_classes`` selects the narrow dtype (``class_dtype``); None keeps
    int32.  Windows are strided views of one padded copy, materialized once."""
    n = len(cls)
    B = -(-max(n, 1) // chunk)
    dt = np.int32 if num_classes is None else class_dtype(num_classes)
    p = np.pad(np.asarray(cls).astype(dt, copy=False), (halo, B * chunk - n),
               constant_values=PAD_CLASS)
    # left halo of chunk i = p[i*chunk : i*chunk + halo]; body follows it.
    view = np.lib.stride_tricks.as_strided(
        p, shape=(B, halo + chunk), strides=(chunk * p.itemsize, p.itemsize),
        writeable=False)
    return view.copy()


# --------------------------------------------------- hot-position compaction

_SPARSE_MIN_UNITS = 1 << 16
# Compaction pays for itself by shrinking the device->host download; on the
# CPU the "download" is free and dense extraction wins.  Tests flip this to
# pin the sparse path on the CPU suite.
_SPARSE_ON_CPU = False


def planes_to_sparse(bits, n: int):
    """END-planes ``uint32[P, N]`` -> host ``(idx, masks)`` for the positions
    with any emit bit: ascending ``idx`` (int64) below ``n`` and hot-major
    ``masks`` (uint32[k, P]).  None when a dense download is the better deal
    (small inputs, numpy input, CPU tensors, or more than ``n // 4`` hot
    positions).  CUDA planes go through the compaction kernel, CPU planes
    through its plain twin (``kernels/compact.py``); only the hot entries
    are downloaded."""
    if not isinstance(bits, torch.Tensor) or n < _SPARSE_MIN_UNITS:
        return None
    if not _SPARSE_ON_CPU and bits.device.type == "cpu":
        return None
    out = compact.compact_planes(bits, limit=n // 4)
    if out is None:
        return None
    _, idx, masks = out
    idx = idx.cpu().numpy()
    masks = masks.view(torch.int32).cpu().numpy().view(np.uint32)
    # Padded window lanes trail the text; idx ascends, so idx < n is a
    # prefix and slicing keeps views instead of copying.
    keep = int(np.searchsorted(idx, n))
    return idx[:keep], masks[:keep]


def to_host(bits) -> np.ndarray:
    """Device or host planes -> numpy uint32."""
    if isinstance(bits, torch.Tensor):
        return bits.view(torch.int32).cpu().numpy().view(np.uint32)
    return np.asarray(bits)


# ------------------------------------------------------------- extraction


def sparse_planes_to_matches(idx: np.ndarray, masks: np.ndarray, max_depth: int):
    """(hot positions, hot-major masks) -> (starts, lens), unsorted segments
    in the same per-length grouping as ``end_planes_to_matches``."""
    if not len(idx):
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    planes = masks.shape[1]
    starts_l, seg_lens, seg_counts = [], [], []
    for p in range(planes):
        w = masks[:, p]
        if not w.any():
            continue
        for b in range(32):
            L = 32 * p + b + 1
            if L > max_depth:
                break
            rows = np.nonzero(w & np.uint32(1 << b))[0]
            if len(rows):
                starts_l.append(idx[rows] + 1 - L)
                seg_lens.append(L)
                seg_counts.append(len(rows))
    if not starts_l:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    lens = np.repeat(np.asarray(seg_lens, dtype=np.int64), seg_counts)
    return np.concatenate(starts_l), lens


def end_planes_to_matches(bits: np.ndarray, n: int, max_depth: int):
    """END-indexed planes -> (starts, lens): bit L-1 at position j = match of
    length L ending at j+1 (start j+1-L), one masked ``nonzero`` per length
    over the hot positions only."""
    bits = np.asarray(bits)[:, :n]
    hot = np.nonzero(bits.any(axis=0))[0]
    return sparse_planes_to_matches(hot.astype(np.int64), bits[:, hot].T, max_depth)


def ac_matches_batched(m: CompiledMatcher, cls: np.ndarray, bits,
                       layout: str = "planes"):
    """(starts, ends, vals) in reference emission order.

    ``layout`` says how to read ``bits``: ``"planes"``, END-indexed emit
    planes; ``"hotstate"``, the packed (state, count) plane of
    ``packedcount_hotstate_plane``, decoded by ``hotstate_sparse``.  ``bits``
    may be a device tensor straight from the kernel (hot positions are
    compacted on the device and only they are downloaded) or a host array.
    Extraction runs through the native C extractor when it is available: it
    walks the bit words end-ascending, longest-first, so its output is
    already in the reference emission order."""
    from ahocorasick_tpu_torch.ops import emit as emit_mod

    native_ok = native_lib.available()
    n = len(cls)
    if layout == "hotstate":
        idx, masks = hotstate_sparse(m, bits, n)
        if native_ok:
            starts, ends = native_lib.extract_resolve_sparse(idx, masks, n, m.max_depth, "all")
            return starts, ends, _ac_vals(m, cls, starts, ends)
        starts, lens = sparse_planes_to_matches(idx, masks, m.max_depth)
    elif (sp := planes_to_sparse(bits, n)) is not None:
        if native_ok:
            starts, ends = native_lib.extract_resolve_sparse(
                sp[0], sp[1], n, m.max_depth, "all")
            return starts, ends, _ac_vals(m, cls, starts, ends)
        starts, lens = sparse_planes_to_matches(sp[0], sp[1], m.max_depth)
    else:
        host = to_host(bits)
        if native_ok:
            starts, ends = native_lib.extract_resolve(host, n, m.max_depth, "all")
            return starts, ends, _ac_vals(m, cls, starts, ends)
        starts, lens = end_planes_to_matches(host, n, m.max_depth)
    starts, ends, _ = emit_mod.sort_by_end_start(starts, lens)
    return starts, ends, _ac_vals(m, cls, starts, ends)


def _ac_vals(m: CompiledMatcher, cls: np.ndarray, starts, ends):
    from ahocorasick_tpu_torch.ops import emit as emit_mod

    if m.values is not None:
        return emit_mod.walk_values(m, cls, starts, ends - starts)
    return np.full(len(starts), -1, dtype=np.int64)
