"""Whole-word-longest walk engine — the port of ``ahocorasick_tpu/ops/scan_wwl.py``.

The reference's ``WholeWordLongestMatchSet.match`` restarts its trie walk
where the previous walk died, a sequential chain.  The device computes, for
every walk start the chain can consume (position 0 and each word start), the
whole outcome of "a walk starting here": where it dies and the one match it
emits (own match, or the carried fail match).  The chain then reduces to
following those outcomes on the host (``resolve.wholeword.follow_chain``).

Outcome rules (``WholeWordLongestMatchSet.java:65-94``): a walk dies at the
first char with no trie edge; a non-word die char emits the own match if
any, else the carried fail match; a word die char emits only the fail match;
the end of input behaves as a non-word die char, because the pad class 0 is
a non-word dead end.

Two device engines, each a pair of kernels in ``kernels/scan_wwl.py``:

* the scan (``wwl_scan_walks``): one packed DFA lookup per char whose entry
  is ``id | depth << id_bits | word << (id_bits + depth_bits)`` (plus a
  crossing bit for the truncated closure of separator-spanning
  dictionaries), then a die sweep per start,
  ``k_die(w) = min{k >= 0 : depth[w + k] <= k}``;
* the per-start trie walk (``wwl_walks_at``), for dictionaries that neither
  scan table packs.

The numpy table-building functions are the port's own copies of that
module's; they stay byte-identical to it
(``tests/test_torch_wwl.py``).  The JAX module's fused ring variant is not
ported (it lost the v5e A/B, ``FUSED_DEFAULT = False``), nor are its v5e
gather tricks (``_plane_take``, the meta-word packing): a GPU thread reads
``plane[w + k]`` directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ahocorasick_tpu_torch.core.compiler import WHOLE_WORD_LONGEST, RowTable
from ahocorasick_tpu_torch.utils.lanes import LANE_BUCKET, bucket_depth
from ahocorasick_tpu_torch.kernels import scan_wwl as kernels
from ahocorasick_tpu_torch.ops import scan_batched
from ahocorasick_tpu_torch.ops.scan_dfa import pad_classes

# Window body length of the scan (the JAX engine's 512).
_CHUNK = 512

# Row-layout gate of the JAX builder, kept so that the tables and
# ``device_table_bytes()`` agree with it.
_ROW_MAX_BYTES = 16 << 20
_ROW_MAX_CLASSES = 512


class WwlScan(NamedTuple):
    """Tables of the scan engine: numpy from the builders, tensors on the
    device (``convert.wwl_scan_from_numpy``)."""

    table: object  # uint32 packed entries: [Sp, Ap] row layout, or flat [S_eff * A]
    rows_flat: Optional[object]  # int32[R * A] concrete targets (quotient only)
    outrows: object  # int32[Sp2, 8]: own_len, own_val, fail_len, fail_off, fail_val
    id_bits: int
    depth_bits: int
    halo: int
    num_classes: int
    row_layout: bool
    quotient: bool
    has_cross: bool = False  # truncated closure: crossing-edge bit packed


# ------------------------------------------------------------- applicability


def word_uniform_trie(m) -> bool:
    """Every trie path is uniformly word chars or uniformly non-word chars
    (the trimmed keywords, and the all-separator keywords the Java trim
    keeps).  Each state's incoming-edge wordness (one parent each) must
    match all its outgoing edges; the root is neutral."""
    if m.class_is_word is None:
        return False
    word = np.asarray(m.class_is_word, dtype=bool)
    if word.all() or not word.any():
        return True
    dead = m.num_states
    t = m.trie_next
    rows, row_id = (t.rows, t.row_id) if isinstance(t, RowTable) else (t, None)
    live = rows != dead
    has_w = (live & word[None, :]).any(axis=1)
    has_n = (live & ~word[None, :]).any(axis=1)
    col_w = np.zeros(m.num_states + 1, dtype=bool)
    col_n = np.zeros(m.num_states + 1, dtype=bool)
    tw = rows[:, word]
    col_w[tw[tw != dead]] = True
    tn = rows[:, ~word]
    col_n[tn[tn != dead]] = True
    if row_id is not None:
        has_w, has_n = has_w[row_id], has_n[row_id]
    has_w = has_w[: m.num_states + 1]
    has_n = has_n[: m.num_states + 1]
    return not bool(((col_w & has_n) | (col_n & has_w)).any())


def _depth_bits(m) -> int:
    return max(max(m.max_depth, 1).bit_length(), 1)


def scan_applicable(m) -> bool:
    """The scan engine applies: a goto-closure DFA (older artifacts have
    none), class 0 non-word (the engines pad with it), the packed entry fits
    32 bits, and the trie is word-uniform."""
    if m.kind != WHOLE_WORD_LONGEST or m.dfa_next is None:
        return False
    if m.class_is_word is None or bool(m.class_is_word[0]):
        return False
    rows = m.dfa_next.rows.shape[0] if isinstance(m.dfa_next, RowTable) else m.num_states
    id_bits = max(int(rows - 1).bit_length(), 1)
    if id_bits + _depth_bits(m) + 1 > 32:
        return False
    return word_uniform_trie(m)


def mixed_scan_applicable(m) -> bool:
    """The scan engine applies through the truncated closure: dictionaries
    ``scan_applicable`` rejects (separator-spanning keywords such as
    "New York", or closure-less artifacts) whose entry, crossing bit
    included, fits 32 bits over the trie's states."""
    if m.kind != WHOLE_WORD_LONGEST or m.class_is_word is None:
        return False
    if bool(m.class_is_word[0]) or scan_applicable(m):
        return False
    id_bits = max(int(m.num_states - 1).bit_length(), 1)
    return id_bits + _depth_bits(m) + 2 <= 32


# ---------------------------------------------------------- truncated closure


def _trie_edges(m):
    """``(parents, classes, children)`` of every trie edge, from the dense or
    ``RowTable`` goto table."""
    S = m.num_states
    dead = S
    t = m.trie_next
    if isinstance(t, RowTable):
        trows, trid = t.rows, t.row_id[:S]
        live = trows != dead
        cnt_r = live.sum(axis=1)
        r_nz_r, r_nz_c = np.nonzero(live)
        r_nz_t = trows[r_nz_r, r_nz_c]
        row_start = np.concatenate([[0], np.cumsum(cnt_r)])
        cnts = cnt_r[trid]
        ps = np.repeat(np.arange(S, dtype=np.int64), cnts)
        total = int(cnts.sum())
        offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(cnts) - cnts, cnts)
        flat = row_start[trid[ps]] + offs
        cs = r_nz_c[flat]
        ch = r_nz_t[flat].astype(np.int64)
    else:
        ps, cs = np.nonzero(t[:S] != dead)
        ch = t[ps, cs].astype(np.int64)
    return ps, cs, ch


def _edges_by_level(depth, ch):
    """Edge indices stably sorted by child depth, and the sorted depths."""
    edge_depth = np.asarray(depth)[ch]
    order = np.argsort(edge_depth, kind="stable")
    return order, edge_depth[order]


def _level_slice(order, ed_sorted, level):
    a = np.searchsorted(ed_sorted, level, "left")
    b = np.searchsorted(ed_sorted, level, "right")
    return order[a:b]


def _uniform_states(m, ps, cs, ch, level_order=None):
    """``bool[S]``: the state's root path is word-uniform (the root is), and
    the path wordness of each state."""
    S = m.num_states
    word = np.asarray(m.class_is_word, dtype=bool)
    depth = np.asarray(m.depth[:S])
    uniform = np.zeros(S, dtype=bool)
    uniform[0] = True
    word_of = np.zeros(S, dtype=bool)
    order, ed_sorted = level_order if level_order is not None else _edges_by_level(depth, ch)
    max_d = int(depth.max()) if S > 1 else 0
    for level in range(1, max_d + 1):
        sel = _level_slice(order, ed_sorted, level)
        if not len(sel):
            continue
        p, c, n = ps[sel], cs[sel], ch[sel]
        w = word[c]
        if level == 1:
            uniform[n] = True
        else:
            uniform[n] = uniform[p] & (word_of[p] == w)
        word_of[n] = w
    return uniform, word_of


def _truncated_closure_dense(m):
    """Dense goto closure of the word-uniform sub-trie with crossing marks:
    ``(dfa int32[S, A], cross bool[S, A], uniform bool[S])``, built level by
    level.  At level L the parents' own edges complete the depth-(L-1) rows,
    then ``fail[n] = dfa[fail[p], c]`` and ``dfa[n] = dfa[fail[n]]``.
    Crossing marks are own-edge properties and never inherit."""
    S, A = m.num_states, m.num_classes
    depth = np.asarray(m.depth[:S])
    ps, cs, ch = _trie_edges(m)
    lvl = _edges_by_level(depth, ch)
    uniform, _ = _uniform_states(m, ps, cs, ch, lvl)

    dfa = np.zeros((S, A), dtype=np.int32)
    cross = np.zeros((S, A), dtype=bool)
    fail = np.zeros(S, dtype=np.int64)
    order, ed_sorted = lvl
    keep = uniform[ps][order]  # edges from uniform parents; sortedness kept
    order, ed_sorted = order[keep], ed_sorted[keep]
    is_cross = ~uniform[ch]
    max_d = int(ed_sorted[-1]) if len(ed_sorted) else 0
    for level in range(1, max_d + 1):
        sel = _level_slice(order, ed_sorted, level)
        if not len(sel):
            continue
        p, c, n = ps[sel], cs[sel], ch[sel]
        cx = is_cross[sel]
        dfa[p[~cx], c[~cx]] = n[~cx]
        cross[p[cx], c[cx]] = True
        pu, cu, nu = p[~cx], c[~cx], n[~cx]
        if len(nu):
            fail[nu] = 0 if level == 1 else dfa[fail[pu], cu]
            dfa[nu] = dfa[fail[nu]]
    return dfa, cross, uniform


def _truncated_closure(m):
    """Hash-consed goto closure of the word-uniform sub-trie with crossing
    marks (the row-compressed form of ``_truncated_closure_dense``): rows
    are keyed by (fail row, own uniform edges, own crossing columns), since
    states sharing a closure row may cross differently.

    Returns ``(rows int32[R, A], cross bool[R, A], row_id int32[S],
    uniform bool[S])``; the root's row is row 0."""
    S, A = m.num_states, m.num_classes
    depth = np.asarray(m.depth[:S])
    ps, cs, ch = _trie_edges(m)
    uniform, _ = _uniform_states(m, ps, cs, ch)

    ov: list = [None] * S  # uniform-child overrides {class: child}
    cx: list = [None] * S  # crossing columns
    parent = np.zeros(S, dtype=np.int64)
    pcls = np.zeros(S, dtype=np.int64)
    parent[ch] = ps
    pcls[ch] = cs
    for p, c, n in zip(ps.tolist(), cs.tolist(), ch.tolist()):
        if not uniform[p]:
            continue
        if uniform[n]:
            if ov[p] is None:
                ov[p] = {}
            ov[p][c] = n
        else:
            if cx[p] is None:
                cx[p] = []
            cx[p].append(c)

    rows = np.zeros((min(max(S, 2), 1024), A), dtype=np.int32)
    crows = np.zeros_like(rows, dtype=bool)
    row_id = np.zeros(S, dtype=np.int32)
    for c, n in (ov[0] or {}).items():
        rows[0, c] = n
    for c in cx[0] or ():
        crows[0, c] = True
    n_rows = 1
    row_of_key: dict = {}
    fail = np.zeros(S, dtype=np.int32)

    uni = np.nonzero(uniform)[0]
    uni = uni[np.argsort(depth[uni], kind="stable")]
    for s in uni.tolist():
        if s == 0:
            continue
        f = 0 if depth[s] == 1 else int(rows[row_id[fail[parent[s]]], pcls[s]])
        fail[s] = f
        key = (int(row_id[f]), tuple(sorted((ov[s] or {}).items())), tuple(sorted(cx[s] or ())))
        rid = row_of_key.get(key)
        if rid is None:
            if n_rows == len(rows):
                rows = np.concatenate([rows, np.zeros_like(rows)])
                crows = np.concatenate([crows, np.zeros_like(crows)])
            row = rows[key[0]].copy()
            if ov[s]:
                row[list(ov[s].keys())] = list(ov[s].values())
            rows[n_rows] = row
            if cx[s]:
                crows[n_rows, cx[s]] = True
            rid = row_of_key[key] = n_rows
            n_rows += 1
        row_id[s] = rid
    return rows[:n_rows].copy(), crows[:n_rows].copy(), row_id, uniform


# ------------------------------------------------------------------ builders


def _pack_entries(m, nxt, ids, id_bits, depth_bits, cross=None) -> np.ndarray:
    """``ids[nxt] | depth[nxt] << id_bits | word[c] << (id_bits + depth_bits)
    [| cross << (id_bits + depth_bits + 1)]`` over a ``[rows, A]`` target
    table ``nxt`` of concrete states."""
    depth = np.asarray(m.depth[: m.num_states], dtype=np.uint32)
    word = np.asarray(m.class_is_word, dtype=np.uint32)
    packed = (nxt if ids is None else ids[nxt]).astype(np.uint32)
    packed |= depth[nxt] << np.uint32(id_bits)
    packed |= (word << np.uint32(id_bits + depth_bits))[None, :]
    if cross is not None:
        packed |= cross.astype(np.uint32) << np.uint32(id_bits + depth_bits + 1)
    return packed


def build_wwl_scan(m) -> WwlScan:
    """Host tables of the scan engine over the compiled goto closure (dense)
    or its quotient rows (row-compressed)."""
    if not scan_applicable(m):
        raise ValueError("the whole-word-longest scan engine does not apply to this dictionary")
    d = max(m.max_depth, 1)
    depth_bits = _depth_bits(m)
    if isinstance(m.dfa_next, RowTable):
        rt = m.dfa_next
        id_bits = max(int(rt.rows.shape[0] - 1).bit_length(), 1)
        if int(rt.row_id[0]) != 0:
            raise ValueError("row-compressed table does not map the root to row 0")
        packed = _pack_entries(m, rt.rows, rt.row_id, id_bits, depth_bits)
        rows_flat = np.ascontiguousarray(rt.rows.reshape(-1).astype(np.int32))
    else:
        id_bits = max(int(m.num_states - 1).bit_length(), 1)
        packed = _pack_entries(m, m.dfa_next, None, id_bits, depth_bits)
        rows_flat = None
    return _pack_wwl_scan(m, packed, rows_flat, id_bits, depth_bits, d, rows_flat is not None,
                          has_cross=False)


def build_wwl_scan_mixed(m) -> WwlScan:
    """Host tables of the scan engine over the truncated closure
    (``_truncated_closure*``), with the crossing bit packed above the word
    bit so that the sweep flags walks that leave the uniform sub-trie."""
    if not mixed_scan_applicable(m):
        raise ValueError("the truncated-closure scan does not apply to this dictionary")
    d = max(m.max_depth, 1)
    depth_bits = _depth_bits(m)
    if m.is_row_compressed:
        rows, cross, row_id, _ = _truncated_closure(m)
        id_bits = max(int(rows.shape[0] - 1).bit_length(), 1)
        if id_bits + depth_bits + 2 > 32:
            raise ValueError(
                f"truncated quotient closure does not pack ({rows.shape[0]} rows, max depth {d})")
        packed = _pack_entries(m, rows, row_id, id_bits, depth_bits, cross)
        rows_flat = np.ascontiguousarray(rows.reshape(-1).astype(np.int32))
    else:
        nxt, cross, _ = _truncated_closure_dense(m)
        id_bits = max(int(m.num_states - 1).bit_length(), 1)
        packed = _pack_entries(m, nxt, None, id_bits, depth_bits, cross)
        rows_flat = None
    return _pack_wwl_scan(m, packed, rows_flat, id_bits, depth_bits, d, rows_flat is not None,
                          has_cross=True)


def _pack_wwl_scan(m, packed, rows_flat, id_bits, depth_bits, d, quotient, has_cross):
    """Row layout (``[Sp, Ap]``, zero-padded) when it fits the JAX builder's
    gate, else the flat ``[S_eff * A]`` table; and the outcome rows."""
    S, A = m.num_states, m.num_classes
    Ap = max(8, 1 << (A - 1).bit_length())
    Sr = packed.shape[0]
    Sp = -(-Sr // 8) * 8
    row_layout = Ap <= _ROW_MAX_CLASSES and Sp * Ap * 4 <= _ROW_MAX_BYTES
    if row_layout:
        table = np.zeros((Sp, Ap), dtype=np.uint32)
        table[:Sr, :A] = packed
    else:
        table = np.ascontiguousarray(packed.reshape(-1))
    Sp2 = 8
    while Sp2 < S + 1:
        Sp2 *= 2
    outrows = np.zeros((Sp2, 8), dtype=np.int32)
    for col, arr in enumerate((m.own_len, m.own_val, m.fail_len, m.fail_off, m.fail_val)):
        outrows[: S + 1, col] = arr
    return WwlScan(table, rows_flat, outrows, id_bits, depth_bits, d, A, row_layout, quotient,
                   has_cross)


# --------------------------------------------------------------- walk lanes


def compact_lanes(m, cls: np.ndarray, text_start: bool = True):
    """``(cls_p, starts, lanes, ws, d)``: the padded classes, the walk starts
    the chain can consume (position 0 when ``text_start``, then every word
    start) padded with ``len(cls)`` to a quarter-octave bucket, the unpadded
    lanes, the word starts and the bucketed walk depth ``d``.

    ``text_start`` says ``cls[0]`` is the true beginning of the text, so a
    word char there starts a word."""
    d = bucket_depth(m.max_depth)
    cls_p = pad_classes(cls, d + 1, bucket=LANE_BUCKET)
    is_word = np.asarray(m.class_is_word)[cls]
    if len(is_word):
        prev = np.concatenate([[not text_start], is_word[:-1]])
        ws = np.nonzero(is_word & ~prev)[0].astype(np.int64)
    else:
        ws = np.zeros(0, dtype=np.int64)
    lanes = ws
    if text_start and (len(ws) == 0 or ws[0] != 0) and len(cls):
        lanes = np.concatenate([np.zeros(1, dtype=np.int64), ws])
    # Quarter-octave buckets {1, 1.25, 1.5, 1.75} x 2^k, as the JAX engine.
    Wp = 256
    while Wp < max(len(lanes), 1):
        Wp *= 2
    if Wp > 256:
        for frac in (5, 6, 7):
            if Wp // 8 * frac >= len(lanes):
                Wp = Wp // 8 * frac
                break
    starts = np.full(Wp, len(cls), dtype=np.int32)
    starts[: len(lanes)] = lanes
    return cls_p, starts, lanes, ws, d


def chain_lanes(ws: np.ndarray, n: int) -> np.ndarray:
    """The positions the restart chain can consume: 0, then every word start."""
    if n and (len(ws) == 0 or ws[0] != 0):
        return np.concatenate([np.zeros(1, dtype=np.int64), ws])
    return ws


def host_walks_at(m, cls_p: np.ndarray, starts: np.ndarray, d: int):
    """Full-trie walk outcomes for the given starts, in host numpy (dense or
    ``RowTable`` ``[s, c]`` indexing): the continuation of the walks whose
    truncated-trie die char hit a crossing edge.  ``cls_p`` extends at least
    ``d + 1`` units past every start."""
    S = m.num_states
    t = m.trie_next
    word = np.asarray(m.class_is_word, dtype=bool)
    starts = np.asarray(starts, dtype=np.int64)
    W = len(starts)
    states = np.zeros(W, dtype=np.int64)
    k_die = np.full(W, -1, dtype=np.int32)
    s_last = np.zeros(W, dtype=np.int64)
    dwv = np.zeros(W, dtype=bool)
    for k in range(d + 1):
        chars = cls_p[starts + k]
        nxt = np.asarray(t[states, chars], dtype=np.int64)
        newly = (k_die < 0) & (nxt == S)
        if newly.any():
            k_die[newly] = k
            s_last[newly] = states[newly]
            dwv[newly] = word[chars[newly]]
        states = nxt
    if (k_die < 0).any():
        raise ValueError(f"a walk outlived {d + 1} steps: d is below the trie depth")
    die_pos = (starts + k_die).astype(np.int32)
    own, fl = m.own_len[s_last], m.fail_len[s_last]
    has_own = (own > 0) & ~dwv
    has_fail = (fl > 0) & (dwv | (own == 0))
    end = np.where(has_own, die_pos, die_pos - m.fail_off[s_last])
    length = np.where(has_own, own, fl)
    val = np.where(has_own, m.own_val[s_last], m.fail_val[s_last])
    return (die_pos, has_own | has_fail, (end - length).astype(np.int32),
            end.astype(np.int32), val.astype(np.int32))


def apply_crossing_fixes(m, cls_p: np.ndarray, d: int, arrays, idx, starts) -> None:
    """Overwrite the outcomes at slots ``idx`` of the mutable quintet
    ``arrays`` (die, has, m_start, m_end, m_val) with full-trie host walks
    from ``starts``."""
    if not len(idx):
        return
    for arr, fix in zip(arrays, host_walks_at(m, cls_p, starts, d)):
        arr[idx] = fix


# ------------------------------------------------------------ device engines


def wwl_scan_walks(table, rows_flat, outrows, windows, starts, *, halo: int, id_bits: int,
                   depth_bits: int, num_classes: int, d: int, row_layout: bool, quotient: bool,
                   cross: bool = False):
    """Walk outcomes at ``starts`` from one packed DFA scan over the
    ``chunk_classes`` windows: ``(die_pos, has, m_start, m_end, m_val)``,
    each ``[W]`` (int32; ``has`` bool), plus ``cont`` (bool: the die char hit
    a crossing edge, so the walk continues past the truncated trie) with
    ``cross``.  The JAX ``wwl_scan_walks`` contract; ``row_layout`` must
    agree with the table's rank."""
    if row_layout != (table.dim() == 2):
        raise ValueError(f"row_layout={row_layout} but the table has shape {tuple(table.shape)}")
    plane, entry = kernels.wwl_scan_plane(table, windows, halo, id_bits, num_classes, quotient)
    return kernels.wwl_sweep_at(plane, entry, rows_flat if quotient else None, outrows, starts,
                                d=d, id_bits=id_bits, depth_bits=depth_bits, cross=cross)


def scan_walks(sc: WwlScan, cls_p: np.ndarray, starts: np.ndarray, d: int, device):
    """The scan engine for the given starts: windows of ``cls_p`` with a
    ``d``-unit halo uploaded narrow, then ``wwl_scan_walks``."""
    w = scan_batched.chunk_classes(cls_p, _CHUNK, d, sc.num_classes)
    return wwl_scan_walks(
        sc.table, sc.rows_flat, sc.outrows,
        scan_batched.classes_to_device(w, sc.num_classes, device),
        torch.from_numpy(np.ascontiguousarray(starts, dtype=np.int32)).to(device),
        halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits, num_classes=sc.num_classes,
        d=d, row_layout=sc.row_layout, quotient=sc.quotient, cross=sc.has_cross)


wwl_walks_at = kernels.wwl_walks_at


def wwl_walks(trie_next, own_len, own_val, fail_len, fail_off, fail_val, class_is_word,
              cls_padded, max_depth: int):
    """Walk outcomes at every position ``0 .. len(cls_padded) - max_depth - 2``
    (the JAX ``wwl_walks`` contract): ``wwl_walks_at`` over all of them."""
    n = cls_padded.shape[0] - max_depth - 1
    starts = torch.arange(max(n, 0), dtype=torch.int32, device=cls_padded.device)
    return kernels.wwl_walks_at(trie_next, own_len, own_val, fail_len, fail_off, fail_val,
                                class_is_word, cls_padded, starts, max_depth)


# ------------------------------------------------- outcomes for chain lanes


def scan_lane_outcomes(m, sc: WwlScan, compact, device):
    """The scan route over ``sc`` for the lanes of ``compact``
    (``compact_lanes``): host arrays ``[die, has, m_start, m_end, m_val]``,
    one entry per lane.  With crossing bits, the flagged walks are re-run on
    the host over the full trie."""
    cls_p, starts, lanes, _ws, d = compact
    outs = scan_walks(sc, cls_p, starts, d, device)
    arrays = [x[: len(lanes)].cpu().numpy() for x in outs[:5]]
    if sc.has_cross:
        cont = np.nonzero(outs[5][: len(lanes)].cpu().numpy())[0]
        apply_crossing_fixes(m, cls_p, d, arrays, cont, lanes[cont])
    return arrays


def walk_lane_outcomes(m, walk_tables, compact, device):
    """The per-start trie walk route (any dense dictionary) for the lanes of
    ``compact``, over ``_DeviceTables.wwl_walk``; arrays as above."""
    cls_p, starts, lanes, _ws, d = compact
    cls_d = scan_batched.classes_to_device(cls_p, m.num_classes, device)
    starts_d = torch.from_numpy(starts).to(device)
    outs = wwl_walks_at(*walk_tables, cls_d, starts_d, d)
    return [x[: len(lanes)].cpu().numpy() for x in outs]


def lane_outcomes(m, dev, compact):
    """Walk outcomes for the lanes of ``compact`` by the first route that
    applies: the scan over the goto closure (word-uniform dictionaries,
    dense or quotient rows), the scan over the truncated closure
    (separator-spanning ones), else the per-start trie walk.  ``dev`` is the
    matcher's ``_DeviceTables``."""
    if scan_applicable(m):
        return scan_lane_outcomes(m, dev.wwl_scan, compact, dev.device)
    if mixed_scan_applicable(m):
        return scan_lane_outcomes(m, dev.wwl_scan_mixed, compact, dev.device)
    return walk_lane_outcomes(m, dev.wwl_walk, compact, dev.device)
