"""Whole-word-longest walk outcomes: the Hopper kernels and their plain
PyTorch twins.

Three kernels (``csrc/wwl_scan.cu``, ``csrc/wwl_walk.cu``):

* ``wwl_scan_plane(table, windows, halo, id_bits, num_classes, quotient)``
  scans ``chunk_classes`` windows over the packed
  ``id | depth << id_bits | word << (id_bits + depth_bits) [| cross << ...]``
  table and returns the packed entry at every body position, ``uint32[B*C]``
  in flat text order, and for quotient tables the flat entry index
  ``s * num_classes + c`` that produced it (``int32[B*C]``, else None);
* ``wwl_sweep_at(plane, entry, rows_flat, outrows, starts, ...)`` runs the
  die sweep ``k_die(w) = min{k >= 0 : depth[w + k] <= k}`` at each start and
  applies the outcome rules to the pre-die state's ``outrows`` row;
* ``wwl_walks_at(trie_next, own_len, own_val, fail_len, fail_off, fail_val,
  class_is_word, cls_padded, starts, max_depth)`` walks the trie from each
  start for at most ``max_depth + 1`` steps (dead = ``trie_next.shape[0] -
  1``) and applies the same rules.

Together they replace the JAX package's ``ops/scan_wwl.py`` ``wwl_scan_walks``
(with ``_wwl_core``) and ``wwl_walks_at`` / ``wwl_walks``.  The outputs are
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

from typing import Optional

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.kernels.scan_block import _widen

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


def _to_uint32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> uint32 (same bits, through int32)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32).view(torch.uint32)


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


def _empty_outcomes(w: int, dev, cross: bool):
    i32 = lambda: torch.empty(w, dtype=torch.int32, device=dev)
    outs = (i32(), torch.empty(w, dtype=torch.bool, device=dev), i32(), i32(), i32())
    return outs + (torch.empty(w, dtype=torch.bool, device=dev),) if cross else outs


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
               plane.data_ptr(), entry.data_ptr() if quotient else None, dev.index, _stream(dev))
    launches["wwl_scan_plane"] += 1
    return plane, entry


def wwl_scan_plane_plain(table, windows, halo, id_bits, num_classes, quotient):
    """The plain twin: a Python loop over the window columns, one batched
    gather over the B lanes per column."""
    B, W = windows.shape
    stride = table.shape[1] if table.dim() == 2 else num_classes
    tf = _widen(table.reshape(-1))
    idmask = (1 << id_bits) - 1
    s = torch.zeros(B, dtype=torch.int64, device=windows.device)
    for t in range(halo):
        s = tf[s * stride + _index(windows[:, t])] & idmask
    plane = torch.empty((B, W - halo), dtype=torch.int64, device=windows.device)
    entry = torch.empty((B, W - halo), dtype=torch.int64, device=windows.device) if quotient else None
    for t in range(halo, W):
        c = _index(windows[:, t])
        v = tf[s * stride + c]
        plane[:, t - halo] = v
        if quotient:
            entry[:, t - halo] = s * num_classes + c
        s = v & idmask
    plane = _to_uint32(plane.reshape(-1))
    return plane, entry.reshape(-1).to(torch.int32) if quotient else None


# ------------------------------------------------------------- die sweep (B11)


def wwl_sweep_at(plane: torch.Tensor, entry: Optional[torch.Tensor],
                 rows_flat: Optional[torch.Tensor], outrows: torch.Tensor,
                 starts: torch.Tensor, *, d: int, id_bits: int, depth_bits: int, cross: bool):
    """Walk outcomes at ``starts`` from a ``wwl_scan_plane`` plane; quotient
    tables pass its ``entry`` plane and ``rows_flat`` (both or neither)."""
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
    _check_int32("starts", starts, None)
    if starts.dim() != 1:
        raise TypeError(f"starts must be int32[W], got {tuple(starts.shape)}")
    dev = _same_device(*[t for t in (plane, entry, rows_flat, outrows, starts) if t is not None])
    if d < 0 or not 1 <= id_bits <= 30 or not 1 <= depth_bits or id_bits + depth_bits + 1 + cross > 32:
        raise ValueError(f"bad d={d}, id_bits={id_bits}, depth_bits={depth_bits}")
    if dev.type == "cpu":
        return wwl_sweep_at_plain(plane, entry, rows_flat, outrows, starts, d=d, id_bits=id_bits,
                                  depth_bits=depth_bits, cross=cross)
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


# ------------------------------------------------------ per-start walk (B13)


def wwl_walks_at(trie_next: torch.Tensor, own_len: torch.Tensor, own_val: torch.Tensor,
                 fail_len: torch.Tensor, fail_off: torch.Tensor, fail_val: torch.Tensor,
                 class_is_word: torch.Tensor, cls_padded: torch.Tensor, starts: torch.Tensor,
                 max_depth: int):
    """Walk outcomes for the given start positions (the JAX ``wwl_walks_at``
    contract); ``cls_padded`` extends ``max_depth + 1`` units past every
    start (reads beyond it are the pad class 0)."""
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
    build.call("wwl_walks_at", *(t.data_ptr() for t in tables), S, A, cls_padded.data_ptr(),
               _CLASS_BYTES[cls_padded.dtype], cls_padded.shape[0], starts.data_ptr(), W,
               max_depth, *(t.data_ptr() for t in outs), dev.index, _stream(dev))
    launches["wwl_walks_at"] += 1
    return outs


def wwl_walks_at_plain(trie_next, own_len, own_val, fail_len, fail_off, fail_val,
                       class_is_word, cls_padded, starts, max_depth):
    """The plain twin: the ``max_depth + 1`` steps vectorized over the starts."""
    A = trie_next.shape[1]
    dead = trie_next.shape[0] - 1
    tf = trie_next.reshape(-1).to(torch.int64)
    M = cls_padded.shape[0]
    c_ext = torch.cat([_index(cls_padded), torch.zeros(1, dtype=torch.int64, device=cls_padded.device)])

    def cls_at(i):  # reads outside cls_padded are the pad class 0 (c_ext[M])
        return c_ext[torch.where((i >= 0) & (i < M), i, M)]

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
