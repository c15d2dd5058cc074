"""Whole-word-longest walk outcomes: the Hopper kernels and their plain
PyTorch twins.

Five kernels (``csrc/wwl_scan.cu``, ``csrc/wwl_walk.cu``):

* ``wwl_scan_plane(table, windows, halo, id_bits, num_classes, quotient)``
  scans ``chunk_classes`` windows over the packed
  ``id | depth << id_bits | word << (id_bits + depth_bits) [| cross << ...]``
  table and returns the packed entry at every body position, ``uint32[B*C]``
  in flat text order, and for quotient tables the flat entry index
  ``s * num_classes + c`` that produced it (``int32[B*C]``, else None); it
  runs ``scan_block.segments`` lanes per window, and so does its twin;
* ``wwl_sweep_at(plane, entry, rows_flat, outrows, starts, ...)`` runs the
  die sweep ``k_die(w) = min{k >= 0 : depth[w + k] <= k}`` at each start and
  applies the outcome rules to the pre-die state's ``outrows`` row;
* ``wwl_sweep_all(plane, entry, rows_flat, outrows, n_keep, ...)`` is that
  sweep at every position ``0 .. n_keep - 1``, which the sharded scanner runs
  on each shard;
* ``wwl_walks_at(trie_next, own_len, own_val, fail_len, fail_off, fail_val,
  class_is_word, cls_padded, starts, max_depth)`` walks the trie from each
  start for at most ``max_depth + 1`` steps (dead = ``trie_next.shape[0] -
  1``) and applies the same rules; on the card it reads two tables derived
  from these (``WalkTables``: a k-gram prefix table and one outcome row a
  state);
* ``wwl_scan_fused(table, outrows, windows, starts, ...)`` finds each walk's
  die position inside the scan of ``chunk_classes_overlap`` windows (no
  plane: each lane counts its next starts' deaths over a tile of entries in
  registers and writes a record a start, which a second launch resolves)
  and applies the same rules; its twin follows the JAX kernel's ring of ``d
  + 1`` slots instead, over the same lanes (``fused_segments``).

Together they replace the JAX package's ``ops/scan_wwl.py`` ``wwl_scan_walks``
(with ``_wwl_core``), ``wwl_scan_walks_all``, ``wwl_walks_at`` /
``wwl_walks`` and ``wwl_scan_walks_fused``.  The outputs are
the JAX contract: ``(die_pos, has, m_start, m_end, m_val)``, int32 with
``has`` bool, plus ``cont`` (bool) from the sweep when ``cross``.  A start at
or past ``L = B*C - (d + 1)`` reads a zero sweep word (``k_die = 0``, a
non-word die, the root's outcome), as the JAX engine's zero-padded plane
does; class reads outside ``cls_padded`` are the pad class 0.

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.kernels.scan_block import _segment_lanes, _to_uint32, _widen, segments

_CLASS_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def _same_device(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on several devices: {[str(t.device) for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_classes(name: str, t: torch.Tensor, dims: int) -> None:
    if t.dtype not in _CLASS_BYTES or t.dim() != dims:
        raise TypeError(
            f"{name} must be uint8, uint16 or int32 with {dims} dims, got {t.dtype}{tuple(t.shape)}")


def _check_int32(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32 or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise TypeError(f"{name} must be int32{list(shape) if shape else ''}, "
                        f"got {t.dtype}{tuple(t.shape)}")


def _index(t: torch.Tensor) -> torch.Tensor:
    """Class ids or table words as int64 (unsigned reading)."""
    return t.to(torch.int64) if t.dtype == torch.int32 else _widen(t)


def _outcomes(own, ownv, fl, fo, fv, die_pos, die_word):
    """Walk-outcome rules (``WholeWordLongestMatchSet.java:65-94``) over the
    pre-die state's outcome values and the die char's wordness, int64 in."""
    has_own = (own > 0) & ~die_word
    has_fail = (fl > 0) & (die_word | (own == 0))
    end = torch.where(has_own, die_pos, die_pos - fo)
    length = torch.where(has_own, own, fl)
    val = torch.where(has_own, ownv, fv)
    i32 = lambda x: x.to(torch.int32)
    return i32(die_pos), has_own | has_fail, i32(end - length), i32(end), i32(val)


def _check_aligned(outrows: torch.Tensor) -> None:
    """The kernels read an outrows row as one 16-byte and one 4-byte load."""
    if outrows.data_ptr() % 16:
        raise ValueError("outrows must start on a 16-byte boundary")


def _empty_outcomes(w: int, dev, cross: bool):
    """``(die_pos, has, m_start, m_end, m_val[, cont])`` of ``w`` slots, rows
    of two allocations (one int32, one bool)."""
    ints = torch.empty((4, w), dtype=torch.int32, device=dev)
    bools = torch.empty((2 if cross else 1, w), dtype=torch.bool, device=dev)
    outs = (ints[0], bools[0], ints[1], ints[2], ints[3])
    return outs + (bools[1],) if cross else outs


# ------------------------------------------------------------ scan plane (B11)


def _check_plane_args(table, windows, halo, id_bits, num_classes):
    if table.dtype != torch.uint32 or table.dim() not in (1, 2):
        raise TypeError(f"table must be uint32[S, Ap] or [S*A], got {table.dtype}{tuple(table.shape)}")
    _check_classes("windows", windows, 2)
    _same_device(table, windows)
    B, W = windows.shape
    if B < 1 or not 0 <= halo < W:
        raise ValueError(f"need B >= 1 and 0 <= halo < W; got B={B}, W={W}, halo={halo}")
    if not 1 <= id_bits <= 30 or num_classes < 1:
        raise ValueError(f"bad id_bits={id_bits} or num_classes={num_classes}")
    stride = table.shape[1] if table.dim() == 2 else num_classes
    if stride < num_classes:
        raise ValueError(f"table rows of {stride} entries hold fewer than {num_classes} classes")
    return B, W, stride


def wwl_scan_plane(table: torch.Tensor, windows: torch.Tensor, halo: int, id_bits: int,
                   num_classes: int, quotient: bool):
    """``(plane uint32[B*C], entry int32[B*C] or None)``: the packed entry
    at every body position, and for quotient tables the flat entry index
    ``s * num_classes + c`` that produced it."""
    B, W, stride = _check_plane_args(table, windows, halo, id_bits, num_classes)
    if windows.device.type == "cpu":
        return wwl_scan_plane_plain(table, windows, halo, id_bits, num_classes, quotient)
    dev = windows.device
    plane = torch.empty(B * (W - halo), dtype=torch.uint32, device=dev)
    entry = torch.empty(B * (W - halo), dtype=torch.int32, device=dev) if quotient else None
    build.call("wwl_scan_plane", table.data_ptr(), windows.data_ptr(),
               _CLASS_BYTES[windows.dtype], B, W, halo, stride, num_classes, id_bits,
               *segments(B, W - halo, halo), plane.data_ptr(),
               entry.data_ptr() if quotient else None, dev.index, _stream(dev))
    launches["wwl_scan_plane"] += 1
    return plane, entry


def wwl_scan_plane_plain(table, windows, halo, id_bits, num_classes, quotient):
    """The plain twin: the kernel's lanes (``segments``: K per window, each
    warmed over the ``halo`` classes before its segment), a Python loop over
    their columns with one batched gather over the lanes per column."""
    B, W = windows.shape
    C = W - halo
    K, L = segments(B, C, halo)
    lanes = _segment_lanes(windows, halo, K, L)
    stride = table.shape[1] if table.dim() == 2 else num_classes
    tf = _widen(table.reshape(-1))
    idmask = (1 << id_bits) - 1
    s = torch.zeros(B * K, dtype=torch.int64, device=windows.device)
    for t in range(halo):
        s = tf[s * stride + _index(lanes[:, t])] & idmask
    plane = torch.empty((B * K, L), dtype=torch.int64, device=windows.device)
    entry = torch.empty((B * K, L), dtype=torch.int64, device=windows.device) if quotient else None
    for t in range(halo, halo + L):
        c = _index(lanes[:, t])
        v = tf[s * stride + c]
        plane[:, t - halo] = v
        if quotient:
            entry[:, t - halo] = s * num_classes + c
        s = v & idmask

    def flat(x):  # the last segment's columns past C are padding
        return x.reshape(B, K * L)[:, :C].reshape(-1)

    plane = _to_uint32(flat(plane))
    return plane, flat(entry).to(torch.int32) if quotient else None


# ------------------------------------------------------------- die sweep (B11)


def _check_sweep_args(plane, entry, rows_flat, outrows, d, id_bits, depth_bits, cross):
    if plane.dtype != torch.uint32 or plane.dim() != 1:
        raise TypeError(f"plane must be uint32[N], got {plane.dtype}{tuple(plane.shape)}")
    if (entry is None) != (rows_flat is None):
        raise ValueError("quotient sweeps need both the entry plane and rows_flat")
    if entry is not None:
        _check_int32("entry", entry, plane.shape)
        _check_int32("rows_flat", rows_flat, None)
    _check_int32("outrows", outrows, None)
    if outrows.dim() != 2 or outrows.shape[1] != 8:
        raise TypeError(f"outrows must be int32[S, 8], got {tuple(outrows.shape)}")
    if d < 0 or not 1 <= id_bits <= 30 or not 1 <= depth_bits or id_bits + depth_bits + 1 + cross > 32:
        raise ValueError(f"bad d={d}, id_bits={id_bits}, depth_bits={depth_bits}")


def wwl_sweep_at(plane: torch.Tensor, entry: Optional[torch.Tensor],
                 rows_flat: Optional[torch.Tensor], outrows: torch.Tensor,
                 starts: torch.Tensor, *, d: int, id_bits: int, depth_bits: int, cross: bool):
    """Walk outcomes at ``starts`` from a ``wwl_scan_plane`` plane; quotient
    tables pass its ``entry`` plane and ``rows_flat`` (both or neither)."""
    _check_sweep_args(plane, entry, rows_flat, outrows, d, id_bits, depth_bits, cross)
    _check_int32("starts", starts, None)
    if starts.dim() != 1:
        raise TypeError(f"starts must be int32[W], got {tuple(starts.shape)}")
    dev = _same_device(*[t for t in (plane, entry, rows_flat, outrows, starts) if t is not None])
    if dev.type == "cpu":
        return wwl_sweep_at_plain(plane, entry, rows_flat, outrows, starts, d=d, id_bits=id_bits,
                                  depth_bits=depth_bits, cross=cross)
    _check_aligned(outrows)
    W = starts.shape[0]
    outs = _empty_outcomes(W, dev, cross)
    if W == 0:
        return outs
    ptr = lambda t: None if t is None else t.data_ptr()
    build.call("wwl_sweep_at", plane.data_ptr(), ptr(entry), ptr(rows_flat), outrows.data_ptr(),
               starts.data_ptr(), W, plane.shape[0] - (d + 1), d, id_bits, depth_bits,
               int(cross), *(t.data_ptr() for t in outs[:5]), ptr(outs[5] if cross else None),
               dev.index, _stream(dev))
    launches["wwl_sweep_at"] += 1
    return outs


def wwl_sweep_at_plain(plane, entry, rows_flat, outrows, starts, *, d, id_bits, depth_bits,
                       cross):
    """The plain twin: the d + 1 sweep steps vectorized over the starts."""
    p = _widen(plane)
    live = plane.shape[0] - (d + 1)
    w = starts.to(torch.int64)
    valid = (w >= 0) & (w < live)
    wc = torch.where(valid, w, 0)
    idmask, dmask = (1 << id_bits) - 1, (1 << depth_bits) - 1
    kd = torch.full_like(w, -1)
    dw = torch.zeros_like(w)
    cx = torch.zeros_like(w)
    for k in range(d + 1):
        v = p[wc + k]
        newly = (kd < 0) & (((v >> id_bits) & dmask) <= k)
        kd = torch.where(newly, k, kd)
        dw = torch.where(newly, (v >> (id_bits + depth_bits)) & 1, dw)
        if cross and k > 0:  # the k == 0 die entry never crosses
            cx = torch.where(newly, (v >> (id_bits + depth_bits + 1)) & 1, cx)
    zero = torch.zeros_like(w)
    kd, dw, cx = (torch.where(valid, x, zero) for x in (kd, dw, cx))
    pre = (wc + kd - 1).clamp(min=0)
    if entry is None:
        prev = p[pre] & idmask
    else:
        prev = rows_flat.to(torch.int64)[entry.to(torch.int64)[pre]]
    s_last = torch.where(kd > 0, prev, 0)
    o = outrows.to(torch.int64)[s_last]
    outs = _outcomes(o[:, 0], o[:, 1], o[:, 2], o[:, 3], o[:, 4], w + kd, dw.bool())
    return outs + (cx.bool(),) if cross else outs


# ------------------------------------------------- every-position sweep (B12)


def wwl_sweep_all(plane: torch.Tensor, entry: Optional[torch.Tensor],
                  rows_flat: Optional[torch.Tensor], outrows: torch.Tensor, n_keep: int, *,
                  d: int, id_bits: int, depth_bits: int, cross: bool):
    """Walk outcomes at every position ``0 .. n_keep - 1`` of a
    ``wwl_scan_plane`` plane (the thread's own index is its start, so no
    starts array is read).  ``n_keep`` may not pass ``len(plane) - (d + 1)``:
    every walk then reads ``d + 1`` real plane words."""
    _check_sweep_args(plane, entry, rows_flat, outrows, d, id_bits, depth_bits, cross)
    n_keep = int(n_keep)
    live = plane.shape[0] - (d + 1)
    if not 0 <= n_keep <= max(live, 0):
        raise ValueError(f"n_keep={n_keep} outside [0, {live}]: the plane of {plane.shape[0]} "
                         f"words must extend d + 1 = {d + 1} past the last start")
    dev = _same_device(*[t for t in (plane, entry, rows_flat, outrows) if t is not None])
    if dev.type == "cpu":
        return wwl_sweep_all_plain(plane, entry, rows_flat, outrows, n_keep, d=d,
                                   id_bits=id_bits, depth_bits=depth_bits, cross=cross)
    _check_aligned(outrows)
    outs = _empty_outcomes(n_keep, dev, cross)
    if n_keep == 0:
        return outs
    ptr = lambda t: None if t is None else t.data_ptr()
    build.call("wwl_sweep_all", plane.data_ptr(), ptr(entry), ptr(rows_flat), outrows.data_ptr(),
               n_keep, live, d, id_bits, depth_bits, int(cross),
               *(t.data_ptr() for t in outs[:5]), ptr(outs[5] if cross else None),
               dev.index, _stream(dev))
    launches["wwl_sweep_all"] += 1
    return outs


def wwl_sweep_all_plain(plane, entry, rows_flat, outrows, n_keep, *, d, id_bits, depth_bits,
                        cross):
    """The plain twin: ``wwl_sweep_at_plain`` over ``arange(n_keep)``."""
    starts = torch.arange(n_keep, dtype=torch.int32, device=plane.device)
    return wwl_sweep_at_plain(plane, entry, rows_flat, outrows, starts, d=d, id_bits=id_bits,
                              depth_bits=depth_bits, cross=cross)


# ------------------------------------------------------ per-start walk (B13)

# The per-start walk's derived tables (csrc/wwl_walk.cu).
WALK_MAX_K = 3  # kMaxK
WALK_STATE_BITS = 28  # kStateBits: a prefix entry's state field
WALK_DIED = 1 << 31  # kDied: a prefix entry's flag, the walk died within the k-gram
WALK_MAX_PREFIX_ENTRIES = 1 << 20  # the largest k-gram table (4 MB), as ops/scan_pfac2's


class WalkTables(NamedTuple):
    """The per-start walk's derived tables (``ops/scan_wwl.build_walk_tables``):
    ``prefix`` uint32[A^k] over the trie's padded classes A (the state after
    a k-gram, or ``WALK_DIED | step << WALK_STATE_BITS | the state before the
    step`` where the walk died within it), its ``prefix_k``, and ``rows``
    int32[S, 8], each state's outcome row (own_len, own_val, fail_len,
    fail_off, fail_val, 0, 0, 0)."""

    prefix: torch.Tensor
    prefix_k: int
    rows: torch.Tensor


def walk_prefix_k(stride: int, max_depth: int) -> int:
    """The k-gram length: the largest k <= ``WALK_MAX_K`` and <= ``max_depth +
    1`` (a walk takes ``max_depth + 1`` steps) whose ``stride^k`` entries stay
    within ``WALK_MAX_PREFIX_ENTRIES``; at least 1."""
    k = 1
    while (k < min(WALK_MAX_K, max_depth + 1)
           and stride ** (k + 1) <= WALK_MAX_PREFIX_ENTRIES):
        k += 1
    return k


# Tables derived by the wrapper itself, where the caller hands none:
# (id of trie_next, the outcome arrays' ids, k) -> (a weak reference to
# trie_next, the arrays' version counters then, the tables).  An entry leaves
# with its trie_next.
_DERIVED: dict = {}


def _derived_tables(trie_next, own_len, own_val, fail_len, fail_off, fail_val,
                    max_depth) -> WalkTables:
    from ahocorasick_tpu_torch.ops import scan_wwl as ops_wwl

    arrays = (trie_next, own_len, own_val, fail_len, fail_off, fail_val)
    k = walk_prefix_k(trie_next.shape[1], max_depth)
    key = (*(id(t) for t in arrays), k)
    versions = tuple(t._version for t in arrays)
    seen = _DERIVED.get(key)
    if seen is not None and seen[0]() is trie_next and seen[1] == versions:
        return seen[2]
    tables = ops_wwl.build_walk_tables(*arrays, max_depth)
    _DERIVED[key] = (weakref.ref(trie_next, lambda _ref: _DERIVED.pop(key, None)), versions,
                     tables)
    return tables


def wwl_walks_at(trie_next: torch.Tensor, own_len: torch.Tensor, own_val: torch.Tensor,
                 fail_len: torch.Tensor, fail_off: torch.Tensor, fail_val: torch.Tensor,
                 class_is_word: torch.Tensor, cls_padded: torch.Tensor, starts: torch.Tensor,
                 max_depth: int, *, walk_tables: Optional[WalkTables] = None):
    """Walk outcomes for the given start positions (the JAX ``wwl_walks_at``
    contract); ``cls_padded`` extends ``max_depth + 1`` units past every
    start (reads beyond it are the pad class 0).  On the card the kernel
    reads the derived tables ``walk_tables`` (``ops/scan_wwl
    .build_walk_tables`` of these arrays), derived here and cached a
    ``trie_next`` where none are handed in; it raises where the states do not
    fit a prefix entry's ``WALK_STATE_BITS``."""
    if trie_next.dtype != torch.int32 or trie_next.dim() != 2:
        raise TypeError(f"trie_next must be int32[S, A], got {trie_next.dtype}{tuple(trie_next.shape)}")
    S, A = trie_next.shape
    for name, t in (("own_len", own_len), ("own_val", own_val), ("fail_len", fail_len),
                    ("fail_off", fail_off), ("fail_val", fail_val)):
        _check_int32(name, t, (S,))
    if class_is_word.dtype != torch.bool or tuple(class_is_word.shape) != (A,):
        raise TypeError(f"class_is_word must be bool[{A}], got "
                        f"{class_is_word.dtype}{tuple(class_is_word.shape)}")
    _check_classes("cls_padded", cls_padded, 1)
    _check_int32("starts", starts, None)
    if starts.dim() != 1 or max_depth < 0:
        raise ValueError(f"need int32[W] starts and max_depth >= 0, got "
                         f"{tuple(starts.shape)}, {max_depth}")
    tables = (trie_next, own_len, own_val, fail_len, fail_off, fail_val, class_is_word)
    dev = _same_device(*tables, cls_padded, starts)
    if dev.type == "cpu":
        return wwl_walks_at_plain(*tables, cls_padded, starts, max_depth)
    W = starts.shape[0]
    outs = _empty_outcomes(W, dev, False)
    if W == 0:
        return outs
    wt = (walk_tables if walk_tables is not None
          else _derived_tables(*tables[:6], max_depth))
    _check_walk_tables(wt, S, A, max_depth, dev)
    build.call("wwl_walks_at", trie_next.data_ptr(), wt.prefix.data_ptr(), wt.rows.data_ptr(),
               class_is_word.data_ptr(), S, A, wt.prefix_k, cls_padded.data_ptr(),
               _CLASS_BYTES[cls_padded.dtype], cls_padded.shape[0], starts.data_ptr(), W,
               max_depth, *(t.data_ptr() for t in outs), dev.index, _stream(dev))
    launches["wwl_walks_at"] += 1
    return outs


def _check_walk_tables(wt: WalkTables, S: int, A: int, max_depth: int, dev) -> None:
    if S > 1 << WALK_STATE_BITS:
        raise ValueError(f"{S} states do not fit the walk's {WALK_STATE_BITS}-bit prefix entries")
    if not 1 <= wt.prefix_k <= min(WALK_MAX_K, max_depth + 1):
        raise ValueError(f"prefix_k {wt.prefix_k} outside [1, min({WALK_MAX_K}, max_depth + 1 "
                         f"= {max_depth + 1})]")
    if (wt.prefix.dtype != torch.uint32 or wt.prefix.dim() != 1
            or wt.prefix.numel() != A ** wt.prefix_k):
        raise TypeError(f"prefix must be uint32[{A}^{wt.prefix_k}], got "
                        f"{wt.prefix.dtype}{tuple(wt.prefix.shape)}")
    _check_int32("rows", wt.rows, (S, 8))
    if wt.prefix.device != dev or wt.rows.device != dev:
        raise ValueError(f"walk tables on {wt.prefix.device}, classes on {dev}")
    if not (wt.prefix.is_contiguous() and wt.rows.is_contiguous()):
        raise ValueError("walk tables must be contiguous")
    _check_aligned(wt.rows)


def wwl_walks_at_plain(trie_next, own_len, own_val, fail_len, fail_off, fail_val,
                       class_is_word, cls_padded, starts, max_depth):
    """The plain twin: the ``max_depth + 1`` steps vectorized over the starts."""
    A = trie_next.shape[1]
    dead = trie_next.shape[0] - 1
    tf = trie_next.reshape(-1).to(torch.int64)
    cls_at = _class_reader(cls_padded)
    w = starts.to(torch.int64)
    state = torch.zeros_like(w)
    kd = torch.full_like(w, -1)
    s_last = torch.zeros_like(w)
    for k in range(max_depth + 1):
        nxt = tf[state * A + cls_at(w + k)]
        newly = (kd < 0) & (nxt == dead)
        kd = torch.where(newly, k, kd)
        s_last = torch.where(newly, state, s_last)
        state = nxt
    die_pos = w + kd
    die_word = class_is_word[cls_at(die_pos)]
    g = lambda t: t.to(torch.int64)[s_last]
    return _outcomes(g(own_len), g(own_val), g(fail_len), g(fail_off), g(fail_val), die_pos,
                     die_word)


def _class_reader(cls_padded):
    """``cls_at(i)``: the classes at int64 positions i, the pad class 0
    outside ``cls_padded``."""
    M = cls_padded.shape[0]
    c_ext = torch.cat([_index(cls_padded), torch.zeros(1, dtype=torch.int64, device=cls_padded.device)])
    return lambda i: c_ext[torch.where((i >= 0) & (i < M), i, M)]


def wwl_walks_prefix(trie_next, class_is_word, cls_padded, starts, max_depth,
                     walk_tables: WalkTables):
    """The kernel's decomposition in plain PyTorch: one prefix lookup a
    start (the walk's death within the k-gram, or its state after it), then
    the trie steps ``k .. max_depth`` of the walks that go on, and the
    outcome from the pre-die state's row of ``walk_tables.rows``.  Equal to
    ``wwl_walks_at_plain`` of the tables ``walk_tables`` was derived from."""
    A = trie_next.shape[1]
    dead = trie_next.shape[0] - 1
    k = walk_tables.prefix_k
    cls_at = _class_reader(cls_padded)
    w = starts.to(torch.int64)
    gram = torch.zeros_like(w)
    for j in range(k):
        gram = gram * A + cls_at(w + j)
    e = _widen(walk_tables.prefix)[gram]
    died = (e & WALK_DIED) != 0
    mask = (1 << WALK_STATE_BITS) - 1
    kd = torch.where(died, (e >> WALK_STATE_BITS) & 3, -1)
    s_last = torch.where(died, e & mask, 0)
    state = torch.where(died, dead, e & mask)
    tf = trie_next.reshape(-1).to(torch.int64)
    for step in range(k, max_depth + 1):
        go = (kd < 0) & (state != dead)
        nxt = tf[torch.where(go, state, 0) * A + cls_at(w + step)]
        newly = go & (nxt == dead)
        kd = torch.where(newly, step, kd)
        s_last = torch.where(newly, state, s_last)
        state = torch.where(go, nxt, state)
    die_pos = w + kd
    die_word = class_is_word[cls_at(die_pos)]
    r = walk_tables.rows.to(torch.int64)[s_last]
    return _outcomes(r[:, 0], r[:, 1], r[:, 2], r[:, 3], r[:, 4], die_pos, die_word)


# ------------------------------------------------------------ fused scan (B1)


def _kd_bits(d: int) -> int:
    return max(int(d).bit_length(), 1)


def _check_fused_args(table, outrows, windows, starts, halo, id_bits, depth_bits, num_classes,
                      d, cross, quotient):
    if quotient:
        raise ValueError("the fused scan takes dense tables only: a quotient table's pre-die "
                         "state needs the flat entry index (use the plane and the sweep)")
    B, W, stride = _check_plane_args(table, windows, halo, id_bits, num_classes)
    if d < 0 or W - halo - (d + 1) < 1:
        raise ValueError(f"windows of {W} classes hold no body past halo={halo} and d + 1 = "
                         f"{d + 1} classes of right overlap")
    if B * (W - halo) >= 1 << 31:
        raise ValueError(f"{B} windows hold 2**31 positions or more (positions are int32)")
    if (depth_bits < 1 or id_bits + depth_bits + 1 + cross > 32
            or 1 + _kd_bits(d) + (2 if cross else 1) + id_bits > 32):
        raise ValueError(f"the fused record does not fit 32 bits: d={d}, id_bits={id_bits}, "
                         f"depth_bits={depth_bits}, cross={cross}")
    _check_int32("outrows", outrows, None)
    if outrows.dim() != 2 or outrows.shape[1] != 8 or outrows.shape[0] < 1 << id_bits:
        raise TypeError(f"outrows must be int32[S, 8] with S >= 2**id_bits, got "
                        f"{tuple(outrows.shape)}")
    _check_int32("starts", starts, None)
    if starts.dim() != 1:
        raise TypeError(f"starts must be int32[W], got {tuple(starts.shape)}")
    _same_device(table, outrows, windows, starts)
    return B, W, stride


# The fused scan splits windows while its lanes stay at most this many, up
# to FUSED_MAX_K lanes a window (scan_block.segments: segments of at least
# four halos and 32 steps).  Its lanes are chains of dependent lookups with no
# store tile, so it takes the count kernel's view that lanes in flight help
# until the caches bind, not the planes kernels' cap.
FUSED_MAX_LANES = 1 << 20
FUSED_MAX_K = 8


def fused_segments(num_windows: int, body: int, halo: int) -> tuple:
    """``(K, L)`` of the fused scan over ``num_windows`` windows of ``body``
    positions: ``scan_block.segments`` under ``FUSED_MAX_LANES`` and
    ``FUSED_MAX_K``; K = 1 where ``halo = 0``.  Its twin takes the same."""
    return segments(num_windows, body, halo, FUSED_MAX_LANES, FUSED_MAX_K)


def fused_lane_slots(starts: torch.Tensor, num_windows: int, body: int, d: int, K: int,
                     L: int, lane_slots: int) -> torch.Tensor:
    """``int64[num_windows * K + 1]``: entry g is the first of the slots
    ``[0, lane_slots)`` whose start lies at or past lane g's first position
    (live past the last lane), the slot range ``[J(g), J(g + 1))`` that the
    fused kernel's lane g takes; ``J(0)`` slots below 0 and the slots from
    ``J(num_windows * K)`` (starts at or past live) take the zero sweep
    word.  One pass a slot, as a prepass would make it: each slot's lane
    from arithmetic on its start (window ``w // C``, lane ``(w - b*C) //
    L``), and each lane's first slot where a new lane's run begins; a lane
    without starts takes the next lane's."""
    lanes = num_windows * K
    live = num_windows * body - (d + 1)
    w = starts[:lane_slots].to(torch.int64)
    b = torch.div(w.clamp(0, max(live - 1, 0)), body, rounding_mode="floor")
    key = b * K + torch.div(w.clamp(min=0) - b * body, L, rounding_mode="floor")
    key = torch.where(w < 0, -1, torch.where(w >= live, lanes, key))
    first = torch.full((lanes + 2,), lane_slots, dtype=torch.int64, device=starts.device)
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    first.scatter_reduce_(0, (key + 1)[new], torch.nonzero(new).reshape(-1), "amin")
    # A lane without starts begins where the next lane with starts does.
    first = torch.flip(torch.cummin(torch.flip(first, [0]), 0).values, [0])
    return first[1:]


# Starts found sorted: id -> (a weak reference, the version counter then, the
# slots the lanes take).  A tensor is read again only once it changed, so
# repeated calls on the same starts (the timing loops) do not wait on the card
# for the check; an entry leaves with its tensor.
_SORTED: dict = {}


def lane_slots(starts: torch.Tensor) -> int:
    """The slots of sorted ``starts`` that the fused kernel's lanes take:
    all but a trailing run of equal starts after its first slot (the padded
    slots of ``compact_lanes``), whose outcome the rest of the run copies.
    Raises on starts that are not sorted ascending."""
    key = id(starts)
    seen = _SORTED.get(key)
    if seen is not None and seen[0]() is starts and seen[1] == starts._version:
        return seen[2]
    n = starts.shape[0]
    slots = n
    if n > 1:
        down = (starts[1:] < starts[:-1]).any()
        step = torch.nonzero(starts[1:] != starts[:-1])
        last = step[-1, 0] + 1 if step.shape[0] else torch.zeros((), dtype=torch.int64,
                                                                  device=starts.device)
        bad, run = torch.stack([down.to(torch.int64), last.to(torch.int64)]).tolist()
        if bad:
            raise ValueError("starts must be sorted ascending")
        slots = run + 1
    _SORTED[key] = (weakref.ref(starts, lambda _ref: _SORTED.pop(key, None)), starts._version,
                    slots)
    return slots


def wwl_scan_fused(table: torch.Tensor, outrows: torch.Tensor, windows: torch.Tensor,
                   starts: torch.Tensor, *, halo: int, id_bits: int, depth_bits: int,
                   num_classes: int, d: int, cross: bool, quotient: bool = False):
    """Walk outcomes at the sorted ``starts`` from one scan of
    ``chunk_classes_overlap`` windows (``halo + C + d + 1`` classes a row) of
    a dense table, with no plane: ``(die_pos, has, m_start, m_end, m_val)``,
    each ``[W]``, plus ``cont`` with ``cross``, the values ``wwl_sweep_at``
    gives for the same starts over the plane of the same text.  Raises on a
    quotient table and on starts that are not sorted ascending."""
    B, W, stride = _check_fused_args(table, outrows, windows, starts, halo, id_bits, depth_bits,
                                     num_classes, d, cross, quotient)
    slots = lane_slots(starts)
    n = starts.shape[0]
    dev = windows.device
    if dev.type == "cpu":
        return wwl_scan_fused_plain(table, outrows, windows, starts, halo=halo, id_bits=id_bits,
                                    depth_bits=depth_bits, num_classes=num_classes, d=d,
                                    cross=cross)
    _check_aligned(outrows)
    outs = _empty_outcomes(n, dev, cross)
    if n == 0:
        return outs
    meta = torch.empty(slots, dtype=torch.int32, device=dev)  # a record a start
    build.call("wwl_scan_fused", table.data_ptr(), windows.data_ptr(),
               _CLASS_BYTES[windows.dtype], B, W, halo, stride, d, id_bits, depth_bits,
               int(cross), *fused_segments(B, W - halo - (d + 1), halo), starts.data_ptr(), n,
               slots, outrows.data_ptr(), meta.data_ptr(), *(t.data_ptr() for t in outs[:5]),
               outs[5].data_ptr() if cross else None, dev.index, _stream(dev))
    launches["wwl_scan_fused"] += 1
    return outs


def wwl_scan_fused_plain(table, outrows, windows, starts, *, halo, id_bits, depth_bits,
                         num_classes, d, cross):
    """The plain twin, by the JAX kernel's algorithm, not the kernel's: every
    lane (``fused_segments``, each warmed over the ``halo`` classes before its
    segment and reading ``d + 1`` classes past it) carries a ring of ``d +
    1`` records over its columns (slot ``t mod (d+1)`` tracks the walk
    started at body step t; at each step every live slot tests ``depth <=
    age``; the slot of age d is complete and emits ``k | word << kd_bits [|
    cross << (kd_bits + 1)] | s_pre << (kd_bits + nflag)``), then the records
    are taken at the starts (zero outside ``[0, B*C - (d+1))``, as the
    sweep's zero word) and resolved by the outcome rules.  int64
    throughout."""
    B, W = windows.shape
    C = W - halo - (d + 1)
    K, L = fused_segments(B, C, halo)
    lanes = _segment_lanes(windows, halo, K, L, d + 1)
    dev = windows.device
    stride = table.shape[1] if table.dim() == 2 else num_classes
    tf = _widen(table.reshape(-1))
    idmask, dmask = (1 << id_bits) - 1, (1 << depth_bits) - 1
    kd_bits = _kd_bits(d)
    nflag = 2 if cross else 1
    s = torch.zeros(B * K, dtype=torch.int64, device=dev)
    for t in range(halo):
        s = tf[s * stride + _index(lanes[:, t])] & idmask
    slots = torch.arange(d + 1, dtype=torch.int64, device=dev)
    ring = torch.ones((B * K, d + 1), dtype=torch.int64, device=dev)  # died, k = 0
    meta = torch.empty((B * K, L), dtype=torch.int64, device=dev)
    for t in range(L + d + 1):
        v = tf[s * stride + _index(lanes[:, halo + t])]
        depth = (v >> id_bits) & dmask
        word = (v >> (id_bits + depth_bits)) & 1
        age = (t - slots) % (d + 1)
        ring = torch.where(age == 0, 0, ring)  # a fresh walk starts in slot t mod (d+1)
        newly = ((ring & 1) == 0) & (depth[:, None] <= age)
        rec = 1 | (age << 1) | (word[:, None] << (1 + kd_bits))
        if cross:  # age 0 cannot cross
            cx = (v >> (id_bits + depth_bits + 1)) & 1
            rec = rec | (torch.where(age > 0, cx[:, None], 0) << (2 + kd_bits))
        rec = rec | (s[:, None] << (1 + kd_bits + nflag))
        ring = torch.where(newly, rec, ring)
        if d <= t < d + L:  # the slot of age d holds the walk from body step t - d
            meta[:, t - d] = ring[:, (t - d) % (d + 1)] >> 1
        s = v & idmask
    meta = meta.reshape(B, K * L)[:, :C].reshape(-1)  # the last lane's columns past C: padding
    w = starts.to(torch.int64)
    valid = (w >= 0) & (w < B * C - (d + 1))
    mg = torch.where(valid, meta[torch.where(valid, w, 0)], 0)
    kd = mg & ((1 << kd_bits) - 1)
    s_last = torch.where(kd > 0, (mg >> (kd_bits + nflag)) & idmask, 0)
    o = outrows.to(torch.int64)[s_last]
    outs = _outcomes(o[:, 0], o[:, 1], o[:, 2], o[:, 3], o[:, 4], w + kd,
                     ((mg >> kd_bits) & 1).bool())
    return outs + (((mg >> (kd_bits + 1)) & 1).bool(),) if cross else outs
