"""ctypes bindings for the native host compiler (``src/ac_native.cpp``), the
port's copy of ``ahocorasick_tpu/native/lib.py`` over its own build of its
own copy of the source (``native/build.py``).

Every entry point has a pure-Python fallback at its call site; importing
this module never raises on a missing toolchain — check ``available()``.
Set ``AHOCORASICK_TPU_NO_NATIVE=1`` to disable the native path entirely.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("AHOCORASICK_TPU_NO_NATIVE"):
        _lib = False
        return _lib
    try:
        from ahocorasick_tpu_torch.native.build import build

        path = build()
        lib = ctypes.CDLL(path)
    except Exception:
        _lib = False
        return _lib

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    lib.ac_build.restype = ctypes.c_void_p
    lib.ac_build.argtypes = [u16p, i64p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_int]
    lib.ac_num_states.restype = ctypes.c_int64
    lib.ac_num_states.argtypes = [ctypes.c_void_p]
    lib.ac_num_classes.restype = ctypes.c_int32
    lib.ac_num_classes.argtypes = [ctypes.c_void_p]
    lib.ac_get_build_meta.restype = None
    lib.ac_get_build_meta.argtypes = [ctypes.c_void_p, i32p, u8p]
    lib.ac_finalize.restype = ctypes.c_int64
    lib.ac_finalize.argtypes = [ctypes.c_void_p] + [i32p] * 10 + [ctypes.c_int]
    lib.ac_get_emits.restype = None
    lib.ac_get_emits.argtypes = [ctypes.c_void_p, i32p, i32p]
    lib.ac_free.restype = None
    lib.ac_free.argtypes = [ctypes.c_void_p]
    lib.ac_fill_wwl.restype = None
    lib.ac_fill_wwl.argtypes = [ctypes.c_void_p, u8p, i32p, i32p, i32p]
    lib.ac_follow_chain.restype = ctypes.c_int64
    lib.ac_follow_chain.argtypes = [i64p, u8p, i64p, i64p, i64p, i64p,
                                    ctypes.c_int64, ctypes.c_int64,
                                    i64p, i64p, i64p]
    lib.ac_resolve_longest.restype = ctypes.c_int64
    lib.ac_resolve_longest.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                       i64p, i64p, i64p]
    lib.ac_resolve_shortest.restype = ctypes.c_int64
    lib.ac_resolve_shortest.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                        i64p, i64p, i64p]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.ac_extract_resolve.restype = ctypes.c_int64
    lib.ac_extract_resolve.argtypes = [u32p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int, i64p, i64p]
    lib.ac_extract_resolve_sparse.restype = ctypes.c_int64
    lib.ac_extract_resolve_sparse.argtypes = [i64p, u32p, ctypes.c_int64,
                                              ctypes.c_int64, ctypes.c_int64,
                                              ctypes.c_int, i64p, i64p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not False


def _ptr(arr: Optional[np.ndarray], ctype):
    if arr is None:
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


_KIND_CODE = {"ac": 0, "longest": 1, "shortest": 2, "whole_word": 3,
              "whole_word_longest": 4}
# ac_extract_resolve modes (ac_native.cpp): "all" streams every candidate
# unresolved, already in the reference emission order.
_MODE_CODE = {"longest": 0, "shortest": 1, "all": 2}


def compile_tables(units: np.ndarray, offsets: np.ndarray, kind: str,
                   with_values: bool,
                   word_chars: Optional[np.ndarray] = None) -> dict:
    """Run the native compiler; returns a dict of numpy arrays.

    ``units``: uint16 concatenated folded keyword units; ``offsets``:
    int64[n+1].  Output arrays are byte-identical to the Python compiler's
    (parity-tested in tests/test_torch_host.py).  Large tables are written by
    the native code directly into huge-page-backed numpy buffers — one
    first-touch per page (see utils/alloc.py for why that matters).
    """
    from ahocorasick_tpu_torch.utils.alloc import big_empty

    lib = _load()
    assert lib, "native library unavailable"
    units = np.ascontiguousarray(units, dtype=np.uint16)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    build_closure = True
    if kind == "whole_word_longest":
        # Word-uniformity over the folded keyword units decides whether the
        # goto-closure DFA (the scan engine's table) is built at all —
        # mixed keywords disable the engine, so skip the dense S*A fill
        # entirely (same ww_uniform gate as the Python compiler).
        assert word_chars is not None
        wb = np.asarray(word_chars, dtype=bool)[units]
        cs_ = np.concatenate([[0], np.cumsum(wb)])
        seg = cs_[offsets[1:]] - cs_[offsets[:-1]]
        build_closure = bool(np.all((seg == 0) | (seg == np.diff(offsets))))
    h = lib.ac_build(
        _ptr(units, ctypes.c_uint16),
        _ptr(offsets, ctypes.c_int64),
        ctypes.c_int64(n), _KIND_CODE[kind], int(with_values),
    )
    if not h:
        raise MemoryError("ac_build failed")
    try:
        S = lib.ac_num_states(h)
        A = lib.ac_num_classes(h)
        has_emit = kind in ("ac", "longest", "whole_word")
        out = {
            "num_states": int(S),
            "num_classes": int(A),
            "class_of_unit": np.empty(65536, dtype=np.int32),
            "trie_next": big_empty((S + 1, A), np.int32),
            "dfa_next": big_empty((S, A), np.int32) if build_closure else None,
            "fail": big_empty(S, np.int32) if build_closure else None,
            "own_len": big_empty(S + 1, np.int32),
            "own_val": big_empty(S + 1, np.int32),
            "match_len": big_empty(S + 1, np.int32),
            "match_val": big_empty(S + 1, np.int32),
            "depth": big_empty(S + 1, np.int32),
            "emit_start": big_empty(S + 1, np.int32) if has_emit else None,
            "emit_count": big_empty(S + 1, np.int32) if has_emit else None,
            "accepted": np.empty(max(n, 1), dtype=np.uint8),
        }
        i32 = ctypes.c_int32
        lib.ac_get_build_meta(h, _ptr(out["class_of_unit"], i32),
                              _ptr(out["accepted"], ctypes.c_uint8))
        out["accepted"] = out["accepted"][:n]
        E = lib.ac_finalize(
            h, _ptr(out["trie_next"], i32), _ptr(out["dfa_next"], i32),
            _ptr(out["fail"], i32), _ptr(out["own_len"], i32),
            _ptr(out["own_val"], i32), _ptr(out["match_len"], i32),
            _ptr(out["match_val"], i32), _ptr(out["depth"], i32),
            _ptr(out["emit_start"], i32), _ptr(out["emit_count"], i32),
            ctypes.c_int(int(build_closure)),
        )
        if has_emit:
            out["emit_len"] = big_empty(max(E, 1), np.int32)
            out["emit_val"] = big_empty(max(E, 1), np.int32)
            lib.ac_get_emits(h, _ptr(out["emit_len"], i32),
                             _ptr(out["emit_val"], i32))
        else:
            out["emit_len"] = out["emit_val"] = None
            out["emit_start"] = out["emit_count"] = None
        if kind == "whole_word_longest":
            # Carried fail matches (parent-order pass over the native trie;
            # wordness per folded unit supplied by the caller).
            assert word_chars is not None
            wu = np.ascontiguousarray(word_chars, dtype=np.uint8)
            out["fail_len"] = big_empty(S + 1, np.int32)
            out["fail_off"] = big_empty(S + 1, np.int32)
            out["fail_val"] = big_empty(S + 1, np.int32)
            lib.ac_fill_wwl(h, _ptr(wu, ctypes.c_uint8),
                            _ptr(out["fail_len"], i32),
                            _ptr(out["fail_off"], i32),
                            _ptr(out["fail_val"], i32))
        return out
    finally:
        lib.ac_free(h)


def follow_chain(die_pos, has, m_start, m_end, m_val, ws, n) -> List[Tuple[int, int, int]]:
    """Native restart-chain follower (see ``resolve/wholeword.py``)."""
    lib = _load()
    assert lib, "native library unavailable"
    die_pos = np.ascontiguousarray(die_pos, dtype=np.int64)
    has8 = np.ascontiguousarray(has, dtype=np.uint8)
    m_start = np.ascontiguousarray(m_start, dtype=np.int64)
    m_end = np.ascontiguousarray(m_end, dtype=np.int64)
    m_val = np.ascontiguousarray(m_val, dtype=np.int64)
    ws = np.ascontiguousarray(ws, dtype=np.int64)
    cap = max(int(has8.sum()), 1)
    out_s = np.empty(cap, dtype=np.int64)
    out_e = np.empty(cap, dtype=np.int64)
    out_v = np.empty(cap, dtype=np.int64)
    i64 = ctypes.c_int64
    k = lib.ac_follow_chain(
        _ptr(die_pos, i64), _ptr(has8, ctypes.c_uint8), _ptr(m_start, i64),
        _ptr(m_end, i64), _ptr(m_val, i64), _ptr(ws, i64),
        ctypes.c_int64(len(ws)), ctypes.c_int64(int(n)),
        _ptr(out_s, i64), _ptr(out_e, i64), _ptr(out_v, i64),
    )
    return list(zip(out_s[:k].tolist(), out_e[:k].tolist(), out_v[:k].tolist()))


def resolve_longest(starts, ends, vals):
    """Native leftmost-longest resolver (exact SetMatchQueue semantics);
    mirror of resolve/queue.py::resolve_longest, which is the parity oracle."""
    lib = _load()
    assert lib, "native library unavailable"
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    n = len(starts)
    out_s = np.empty(max(n, 1), dtype=np.int64)
    out_e = np.empty(max(n, 1), dtype=np.int64)
    out_v = np.empty(max(n, 1), dtype=np.int64)
    i64 = ctypes.c_int64
    k = lib.ac_resolve_longest(
        _ptr(starts, i64), _ptr(ends, i64), _ptr(vals, i64),
        ctypes.c_int64(n), _ptr(out_s, i64), _ptr(out_e, i64),
        _ptr(out_v, i64),
    )
    return out_s[:k], out_e[:k], out_v[:k]


def resolve_shortest(starts, ends, vals):
    """Native leftmost-shortest (min-end) resolver; mirror of
    resolve/queue.py::resolve_shortest_py, which is the parity oracle."""
    lib = _load()
    assert lib, "native library unavailable"
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    n = len(starts)
    out_s = np.empty(max(n, 1), dtype=np.int64)
    out_e = np.empty(max(n, 1), dtype=np.int64)
    out_v = np.empty(max(n, 1), dtype=np.int64)
    i64 = ctypes.c_int64
    k = lib.ac_resolve_shortest(
        _ptr(starts, i64), _ptr(ends, i64), _ptr(vals, i64),
        ctypes.c_int64(n), _ptr(out_s, i64), _ptr(out_e, i64),
        _ptr(out_v, i64),
    )
    return out_s[:k], out_e[:k], out_v[:k]


def extract_resolve_sparse(idx: np.ndarray, masks: np.ndarray, n: int,
                           max_depth: int, mode: str):
    """Sparse fused extraction + greedy resolve over (position, masks) pairs
    from device-side plane compaction.  ``idx`` ascending hot positions,
    ``masks`` hot-major uint32[n_hot, planes]; returns accepted (s, e)."""
    lib = _load()
    assert lib, "native library unavailable"
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    masks = np.ascontiguousarray(masks, dtype=np.uint32)
    n_hot, planes = masks.shape
    assert len(idx) == n_hot
    if mode == "all":  # unresolved: capacity = total candidate popcount
        cap = int(np.bitwise_count(masks).sum()) + 1
    else:
        cap = min(n, n_hot * planes * 32) + 1
    out_s = np.empty(cap, dtype=np.int64)
    out_e = np.empty(cap, dtype=np.int64)
    i64 = ctypes.c_int64
    k = lib.ac_extract_resolve_sparse(
        _ptr(idx, i64), _ptr(masks, ctypes.c_uint32), i64(n_hot), i64(planes),
        i64(max_depth), ctypes.c_int(_MODE_CODE[mode]),
        _ptr(out_s, i64), _ptr(out_e, i64),
    )
    return out_s[:k], out_e[:k]


def extract_resolve(bits: np.ndarray, n: int, max_depth: int, mode: str):
    """Fused END-indexed bitplane extraction + greedy resolve (see
    ``ac_extract_resolve`` in ac_native.cpp).  Returns accepted (starts,
    ends); values are re-walked by the caller over just those spans."""
    lib = _load()
    assert lib, "native library unavailable"
    bits = np.ascontiguousarray(bits, dtype=np.uint32)
    planes, stride = bits.shape
    assert n <= stride
    if mode == "all":  # unresolved: capacity = total candidate popcount
        cap = int(np.bitwise_count(bits[:, :n]).sum()) + 1
    else:
        cap = n + 1
    out_s = np.empty(cap, dtype=np.int64)
    out_e = np.empty(cap, dtype=np.int64)
    i64 = ctypes.c_int64
    k = lib.ac_extract_resolve(
        _ptr(bits, ctypes.c_uint32), i64(planes), i64(stride), i64(n),
        i64(max_depth), ctypes.c_int(_MODE_CODE[mode]),
        _ptr(out_s, i64), _ptr(out_e, i64),
    )
    return out_s[:k], out_e[:k]
