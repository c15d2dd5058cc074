"""Host-side matcher compiler: keywords -> dense numpy automaton tables.

This is the port's copy of ``ahocorasick_tpu/core/compiler.py``: the
table-compiled replacement for the reference's eight per-matcher
construction pipelines (canonical copy: ``AhoCorasickSet.java:20-191``).
Where the reference builds a pointer-linked trie with per-node hashmap/range
storage and walks fail links at match time, we compile everything down to a
handful of dense ``int32`` arrays once, so every engine (CUDA kernel, plain
PyTorch twin, gold model) is a pure gather program over static shapes:

* ``charmap``   — UTF-16 unit -> compact alphabet class (case folding and
  word-character classification baked in; moral heir of the reference's
  ``Character.toLowerCase`` calls and ``WordCharacters`` tables).
* ``trie_next`` — goto function over trie edges only, with an absorbing DEAD
  state.  This powers the *failureless* parallel scan: on the device we do not
  translate fail links into the hot loop at all — every position walks its
  own trie path in parallel, so fail transitions (whose only purpose is to
  let a *sequential* scanner avoid restarting) are unnecessary there.
* ``dfa_next``  — full goto-closure delta: S x A next-state table with fail
  links compiled away.  The reference itself proves this move is sound: its
  RangeNode gap-filling pass (``AhoCorasickSet.java:142-190``) precomputes
  exactly these closures for dense nodes.
* emit tables   — per-state flattened match lists reproducing the
  ``output()`` suffix-chain order (``AhoCorasickSet.java:522-535``).

Variant semantics (prefix pruning for shortest-match, whole-word fail
matches, per-state depth for leftmost-longest) are compile-time transforms
producing the same table schema, so the device engines stay variant-agnostic.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ahocorasick_tpu_torch.utils import chartables

DEADCLASS_OTHER = 0  # non-keyword char, non-word
DEADCLASS_WORD = 1  # non-keyword char, word (only meaningful with word_chars)

AC = "ac"
LONGEST = "longest"
SHORTEST = "shortest"
WHOLE_WORD = "whole_word"
WHOLE_WORD_LONGEST = "whole_word_longest"

KINDS = (AC, LONGEST, SHORTEST, WHOLE_WORD, WHOLE_WORD_LONGEST)

# Dense-table budget in int32 entries per table (2 GB).  Dictionaries whose
# (states + 1) x classes footprint exceeds this keep the row-deduplicated
# representation (``RowTable``) instead of materializing dense arrays.  The
# reference's full-alphabet case (testFullNode: 64Ki single-char keywords,
# SetTest.java:73-79) is the motivating extreme: S = A = 64Ki would need two
# 16 GB tables dense, but has only TWO distinct transition rows.
_DENSE_LIMIT = 1 << 29


class RowTable:
    """Row-deduplicated 2-D transition table, logically ``table[s, c]``.

    The moral heir of the reference's ``RangeNode`` memory policy
    (``AhoCorasickSet.java:417-495``): per-state transition rows are
    hash-consed during construction — a state with no own trie edges shares
    its fail state's goto-closure row outright — so wide-alphabet
    dictionaries stay linear in *distinct* rows instead of quadratic in
    states x classes.  Supports the host-side access patterns of the gold
    engines, streaming cursors and value re-walk (scalar and fancy
    ``[s, c]`` indexing, ``[s]`` row fetch); device engines scan the packed
    QUOTIENT DFA over the distinct rows (``ops/scan_batched.build_packed``).
    """

    __slots__ = ("rows", "row_id")

    def __init__(self, rows: np.ndarray, row_id: np.ndarray) -> None:
        self.rows = rows  # int32[R, A] distinct rows
        self.row_id = row_id  # int32[S] state -> row

    @property
    def shape(self):
        return (len(self.row_id), self.rows.shape[1])

    @property
    def dtype(self):
        return self.rows.dtype

    @property
    def nbytes(self) -> int:
        return self.rows.nbytes + self.row_id.nbytes

    def __getitem__(self, key):
        if isinstance(key, tuple):
            s, c = key
            return self.rows[self.row_id[s], c]
        return self.rows[self.row_id[key]]

    def materialize(self) -> np.ndarray:
        return self.rows[self.row_id]


@dataclasses.dataclass(frozen=True)
class CompiledMatcher:
    """Immutable compiled automaton.

    State ids: ``0`` is the trie root; ``num_states`` is the absorbing DEAD
    state (so gather targets stay in-bounds).  ``dfa_next`` has no DEAD state:
    it is a total function (fail links compiled away).
    """

    kind: str
    case_sensitive: bool
    num_states: int  # S: trie states including root; DEAD == num_states
    num_classes: int  # A
    charmap: np.ndarray  # int32[65536] -> class in [0, A)
    class_is_word: Optional[np.ndarray]  # bool[A] (whole-word kinds only)
    trie_next: np.ndarray  # int32[S+1, A]; missing edge -> DEAD
    dfa_next: Optional[np.ndarray]  # int32[S, A] full closure (ac/longest/shortest)
    fail: Optional[np.ndarray]  # int32[S] fail links (ac/longest/shortest)
    own_len: np.ndarray  # int32[S+1] own-match length (0 = none)
    own_val: np.ndarray  # int32[S+1] own-match value id (-1 = none)
    match_len: np.ndarray  # int32[S+1] own-or-inherited (Java node.matchLength)
    match_val: np.ndarray  # int32[S+1]
    depth: np.ndarray  # int32[S+1] node depth (root=0)
    emit_start: Optional[np.ndarray]  # int32[S+1] into emit_len/emit_val
    emit_count: Optional[np.ndarray]  # int32[S+1]
    emit_len: Optional[np.ndarray]  # int32[E] match lengths, Java output() order
    emit_val: Optional[np.ndarray]  # int32[E] value ids
    fail_len: Optional[np.ndarray]  # int32[S+1] whole_word_longest fail match
    fail_off: Optional[np.ndarray]  # int32[S+1]
    fail_val: Optional[np.ndarray]  # int32[S+1]
    word_chars: Optional[np.ndarray]  # bool[65536] raw word-char table
    values: Optional[list]  # host-side value objects (maps) or None (sets)
    max_depth: int  # longest keyword length in UTF-16 units

    @property
    def dead_state(self) -> int:
        return self.num_states

    def memory_bytes(self) -> int:
        total = 0
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (np.ndarray, RowTable)):
                total += v.nbytes
        return total

    @property
    def is_row_compressed(self) -> bool:
        """True when the transition tables kept the row-deduplicated form
        (wide-alphabet dictionaries over the dense budget); device engines
        scan the packed quotient DFA over the distinct rows where the kind
        allows it (see ``models.matchers._device_capable``), else the
        vectorized host path."""
        return isinstance(self.trie_next, RowTable)


class _Trie:
    """Append-only host trie used during compilation."""

    __slots__ = ("children", "own_len", "own_val", "depth", "parent", "parent_char")

    def __init__(self) -> None:
        self.children: List[dict] = [{}]  # node -> {folded char unit -> child id}
        self.own_len: List[int] = [0]
        self.own_val: List[int] = [-1]
        self.depth: List[int] = [0]
        self.parent: List[int] = [0]
        self.parent_char: List[int] = [0]

    def add_child(self, node: int, unit: int) -> int:
        kids = self.children[node]
        child = kids.get(unit)
        if child is None:
            child = len(self.children)
            kids[unit] = child
            self.children.append({})
            self.own_len.append(0)
            self.own_val.append(-1)
            self.depth.append(self.depth[node] + 1)
            self.parent.append(node)
            self.parent_char.append(unit)
        return child

    def __len__(self) -> int:
        return len(self.children)


def _fold_units(keyword: str, case_sensitive: bool) -> np.ndarray:
    units = chartables.to_utf16_units(keyword)
    if not case_sensitive:
        units = chartables.lower_table()[units]
    return units


def _dense_fits_estimate(keywords: Sequence[str], case_sensitive: bool) -> bool:
    """Upper-bound the dense-table footprint without building the trie.

    States are bounded by total keyword units + 1, classes by distinct
    folded units + 2; both overestimate (shared prefixes dedup states), so a
    True here guarantees the dense tables fit ``_DENSE_LIMIT``.
    """
    joined = "".join(k for k in keywords if k)
    units = chartables.to_utf16_units(joined)
    if not case_sensitive:
        units = chartables.lower_table()[units]
    s_bound = len(units) + 2
    a_bound = len(np.unique(units)) + 2
    return s_bound * a_bound <= _DENSE_LIMIT


def _iter_pairs(keywords: Iterable[str], values: Optional[Iterable]):
    if values is None:
        for kw in keywords:
            yield kw, None
    else:
        for kw, val in zip(keywords, values):
            yield kw, val


def compile_matcher(
    keywords: Iterable[str],
    kind: str,
    case_sensitive: bool,
    values: Optional[Iterable] = None,
    word_chars: Optional[np.ndarray] = None,
    backend: str = "auto",
    thresholder=None,
) -> CompiledMatcher:
    """Compile a keyword list into dense automaton tables.

    ``values``: optional per-keyword payloads (map variants).  ``word_chars``:
    bool[65536] for whole-word kinds (defaults to the reference's default
    word-character set).  ``backend``: ``"auto"`` uses the native (C++)
    compiler when available for the fail-link kinds, ``"python"``/``"native"``
    force one; outputs are byte-identical either way (parity-tested).
    ``thresholder``: dense-vs-row-compressed table policy
    (``utils.thresholds.Thresholder``; see that module for the SPI mapping).
    ``None`` = the default entry budget.  A custom policy compiles through
    the Python path (the native compiler only builds dense tables).
    """
    if kind not in KINDS:
        raise ValueError(f"unknown matcher kind {kind!r}")
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if thresholder is not None:
        if backend == "native":
            raise ValueError(
                "backend='native' always builds dense tables and cannot "
                "honor a custom thresholder; use backend='auto' or 'python'"
            )
        backend = "python"
    whole_word = kind in (WHOLE_WORD, WHOLE_WORD_LONGEST)
    if whole_word and word_chars is None:
        word_chars = chartables.default_word_chars()
    if backend != "python":
        try:
            from ahocorasick_tpu_torch.native import lib as native_lib

            native_ok = native_lib.available()
        except Exception:
            native_ok = False
        if native_ok:
            # The native compiler materializes dense S x A tables; route
            # wide-alphabet dictionaries (testFullNode-style) to the Python
            # path, which keeps the row-deduplicated representation.
            kws_list = list(keywords)
            vals_list = list(values) if values is not None else None
            if backend == "native" or _dense_fits_estimate(kws_list, case_sensitive):
                return _compile_native(kws_list, kind, case_sensitive,
                                       vals_list,
                                       word_chars if whole_word else None)
            keywords, values = kws_list, vals_list
        elif backend == "native":
            raise RuntimeError("native compiler backend unavailable")
    if not whole_word:
        word_chars = None

    trie = _Trie()
    value_list: Optional[list] = [] if values is not None else None
    max_depth = 0
    # WHOLE_WORD_LONGEST: the goto-closure DFA (scan engine) is only built
    # when every keyword is word-uniform — mixed keywords ("New York")
    # disable the scan engine anyway, and the closure would only bloat
    # compile time and artifacts (ops/scan_wwl.word_uniform_trie).
    ww_uniform = True

    for keyword, val in _iter_pairs(keywords, values):
        if keyword is None:
            continue
        if whole_word:
            # Reference trims non-word chars off the ends, then (plain
            # whole-word only) rejects keywords containing interior non-word
            # characters (WholeWordMatchSet.java:146-153).
            keyword = chartables.trim_word(keyword, word_chars)
            if kind == WHOLE_WORD:
                raw_units = chartables.to_utf16_units(keyword)
                if not np.all(word_chars[raw_units]):
                    raise ValueError(f"{keyword} contains non-word characters.")
            if len(keyword) == 0:
                continue
        elif len(keyword) == 0:
            continue

        units = _fold_units(keyword, case_sensitive)
        if kind == WHOLE_WORD_LONGEST and len(units):
            w = word_chars[units]
            if w.any() and not w.all():
                ww_uniform = False
        node = 0
        skipped = False
        for unit in units:
            node = trie.add_child(node, int(unit))
            if kind == SHORTEST and trie.own_len[node] != 0:
                # A shorter keyword already terminates here; this keyword can
                # never match (ShortestMatchSet.java:23-42).  Order-dependent
                # by design, reproduced exactly.
                skipped = True
                break
        if skipped:
            continue
        trie.own_len[node] = len(units)
        if value_list is not None:
            trie.own_val[node] = len(value_list)
            value_list.append(val)
        max_depth = max(max_depth, len(units))

    return _finalize(
        trie, kind, case_sensitive, value_list, word_chars, max_depth,
        thresholder=thresholder, ww_uniform=ww_uniform,
    )


def shortest_survivors(
    keywords: Iterable[str],
    case_sensitive: bool,
    values: Optional[Iterable] = None,
):
    """Keywords surviving ShortestMatchSet's insert-time prefix skip, with
    their values, in input order.

    Reproduces the OUTER loop (``ShortestMatchSet.java:23-42``): a keyword is
    skipped when a (proper or full) prefix of it is already a match — in
    particular an exact duplicate is skipped, so (unlike the AC map's
    overwrite rule) the FIRST value wins.  The surviving set is what the
    candidates-then-resolve device path scans: occurrences of later-pruned
    keywords can never win the min-end greedy resolve (every such keyword has
    a strictly-earlier-ending candidate inside it with the same-or-later
    start), so insert-time skips are the only filtering that affects values.
    """
    trie = _Trie()
    kws: list = []
    vals: list = [] if values is not None else None
    for keyword, val in _iter_pairs(keywords, values):
        if not keyword:
            continue
        units = _fold_units(keyword, case_sensitive)
        node = 0
        skipped = False
        for unit in units:
            node = trie.add_child(node, int(unit))
            if trie.own_len[node] != 0:
                skipped = True
                break
        if skipped:
            continue
        trie.own_len[node] = len(units)
        kws.append(keyword)
        if vals is not None:
            vals.append(val)
    return kws, vals


def _compile_native(
    keywords: Iterable[str],
    kind: str,
    case_sensitive: bool,
    values: Optional[Iterable],
    word_chars: Optional[np.ndarray] = None,
) -> CompiledMatcher:
    """Native (C++) compile path: pack keywords, run ac_native, assemble.

    Byte-identical outputs to the Python path (tests/test_torch_host.py); the
    difference is host compile speed on large dictionaries.  Keywords are
    materialized here (the Python path streams them) — acceptable because
    the native path exists precisely for big in-memory dictionaries.

    Whole-word kinds: keywords are trimmed/validated here (the reference
    constructor semantics, WholeWordMatchSet.java:146-153), the native
    alphabet reserves the two catch-all wordness classes, and wordness /
    fail-carry tables are filled from ``word_chars``.
    """
    from ahocorasick_tpu_torch.native import lib as native_lib

    if values is None:
        kws = [k for k in keywords if k is not None]
        vals: Optional[list] = None
    else:
        pairs = [(k, v) for k, v in zip(keywords, values) if k is not None]
        kws = [k for k, _ in pairs]
        vals = [v for _, v in pairs]

    whole_word = kind in (WHOLE_WORD, WHOLE_WORD_LONGEST)
    if whole_word:
        assert word_chars is not None
        trimmed = []
        for k in kws:
            k = chartables.trim_word(k, word_chars)
            if kind == WHOLE_WORD and len(k):
                raw_units = chartables.to_utf16_units(k)
                if not np.all(word_chars[raw_units]):
                    raise ValueError(f"{k} contains non-word characters.")
            trimmed.append(k)  # empties stay: native skips, value unconsumed
        kws = trimmed

    joined = "".join(kws)
    units_all = chartables.to_utf16_units(joined).astype(np.uint16)
    lens = np.fromiter(map(len, kws), dtype=np.int64, count=len(kws))
    if int(lens.sum()) != len(units_all):  # non-BMP chars present
        lens = np.fromiter(
            (len(chartables.to_utf16_units(k)) for k in kws),
            dtype=np.int64,
            count=len(kws),
        )
    offsets = np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(lens)])
    if not case_sensitive:
        units_all = chartables.lower_table()[units_all]

    wu = None
    if whole_word:
        wu = np.asarray(word_chars, dtype=np.uint8)
    t = native_lib.compile_tables(units_all, offsets, kind,
                                  values is not None, word_chars=wu)
    # (Mixed-wordness WWL dictionaries come back with dfa_next/fail = None:
    # compile_tables gates the closure build on word-uniformity, matching
    # the Python path's ww_uniform.)

    accepted = t["accepted"].astype(bool)
    value_list = None
    if vals is not None:
        value_list = [v for v, a in zip(vals, accepted) if a]
    max_depth = int(lens[accepted].max()) if accepted.any() else 0

    lower = chartables.lower_table()
    eff = np.arange(65536, dtype=np.int64) if case_sensitive else lower.astype(np.int64)
    cu = t["class_of_unit"]
    class_is_word = None
    if whole_word:
        # Non-edge units split by wordness into the two reserved catch-all
        # classes (0: other non-word, 1: other word); edge classes take the
        # wordness of their (folded) unit — exactly _build_alphabet.
        wc = np.asarray(word_chars, dtype=bool)
        cu = np.where(cu == 0, wc.astype(np.int32), cu)
        A = t["num_classes"]
        class_is_word = np.zeros(A, dtype=bool)
        class_is_word[1] = True
        edge = t["class_of_unit"] >= 2
        class_is_word[t["class_of_unit"][edge]] = wc[edge]
    charmap = cu[eff]

    return CompiledMatcher(
        kind=kind,
        case_sensitive=case_sensitive,
        num_states=t["num_states"],
        num_classes=t["num_classes"],
        charmap=charmap,
        class_is_word=class_is_word,
        trie_next=t["trie_next"],
        dfa_next=t["dfa_next"],
        fail=t["fail"],
        own_len=t["own_len"],
        own_val=t["own_val"],
        match_len=t["match_len"],
        match_val=t["match_val"],
        depth=t["depth"],
        emit_start=t["emit_start"],
        emit_count=t["emit_count"],
        emit_len=t["emit_len"],
        emit_val=t["emit_val"],
        fail_len=t.get("fail_len"),
        fail_off=t.get("fail_off"),
        fail_val=t.get("fail_val"),
        word_chars=np.asarray(word_chars, dtype=bool) if whole_word else None,
        values=value_list,
        max_depth=max_depth,
    )


def _build_alphabet(trie: _Trie, case_sensitive: bool, word_chars: Optional[np.ndarray]):
    """Assign compact alphabet classes and the 65536-entry charmap."""
    lower = chartables.lower_table()
    edge_chars = sorted({c for kids in trie.children for c in kids})
    have_word = word_chars is not None

    if have_word:
        # Wordness in the reference is evaluated on the *folded* haystack char
        # in case-insensitive mode (WholeWordMatchSet.java:96,101), so it is a
        # function of the folded unit and can be baked into the class id.
        base = 2  # class 0: other non-word, class 1: other word
    else:
        base = 1  # class 0: any non-keyword char

    class_of = {c: base + i for i, c in enumerate(edge_chars)}
    num_classes = base + len(edge_chars)

    eff = np.arange(65536, dtype=np.int64) if case_sensitive else lower.astype(np.int64)
    # Class per *folded* unit, then compose with the folding map.
    folded_class = np.zeros(65536, dtype=np.int32)
    if have_word:
        folded_class[:] = np.where(word_chars, DEADCLASS_WORD, DEADCLASS_OTHER)
    for c, cls in class_of.items():
        folded_class[c] = cls
    charmap = folded_class[eff]

    class_is_word = None
    if have_word:
        class_is_word = np.zeros(num_classes, dtype=bool)
        class_is_word[DEADCLASS_WORD] = True
        for c, cls in class_of.items():
            class_is_word[cls] = bool(word_chars[c])
    return charmap, num_classes, class_of, class_is_word


def _bfs_order(trie: _Trie) -> List[int]:
    order = [0]
    head = 0
    while head < len(order):
        node = order[head]
        head += 1
        order.extend(trie.children[node].values())
    return order


def _finalize(
    trie: _Trie,
    kind: str,
    case_sensitive: bool,
    value_list: Optional[list],
    word_chars: Optional[np.ndarray],
    max_depth: int,
    thresholder=None,
    ww_uniform: bool = True,
) -> CompiledMatcher:
    S = len(trie)
    charmap, A, class_of, class_is_word = _build_alphabet(trie, case_sensitive, word_chars)
    DEAD = S
    # Dense-vs-RowTable layout: the Thresholder SPI decides (whole automaton
    # as the one "node" — see utils/thresholds.py), under the hard entry cap
    # that keeps the testFullNode extreme from materializing 16 GB tables.
    if thresholder is None:
        from ahocorasick_tpu_torch.utils.thresholds import DenseTableBudget

        thresholder = DenseTableBudget(_DENSE_LIMIT)
    n_edges = sum(len(kids) for kids in trie.children)
    dense = (S + 1) * A <= _DENSE_LIMIT and bool(
        thresholder.is_over_threshold(n_edges, 0, (S + 1) * A)
    )

    # Trie edges in class space, one override dict per node.  Rows are
    # hash-consed below: nodes sharing edge sets (e.g. all leaves) share
    # storage, so memory is O(distinct rows x A), not O(S x A).
    overrides = [
        {class_of[c]: ch for c, ch in kids.items()} for kids in trie.children
    ]

    own_len = np.asarray(trie.own_len + [0], dtype=np.int32)
    own_val = np.asarray(trie.own_val + [-1], dtype=np.int32)
    depth = np.asarray(trie.depth + [0], dtype=np.int32)
    match_len = own_len.copy()
    match_val = own_val.copy()

    order = _bfs_order(trie)
    parent = np.asarray(trie.parent, dtype=np.int32)
    parent_cls = np.asarray(
        [class_of[c] if n else 0 for n, c in enumerate(trie.parent_char)], dtype=np.int32
    )

    fail = None
    dfa_next = None
    emit_start = emit_count = emit_len_arr = emit_val_arr = None
    fail_len = fail_off = fail_val = None

    build_closure = kind in (AC, LONGEST, SHORTEST, WHOLE_WORD) or (
        kind == WHOLE_WORD_LONGEST and ww_uniform
    )
    if build_closure:
        # WHOLE_WORD also gets fail links / closure / emit tables: its device
        # engine scans the dictionary as a plain AC automaton and filters
        # candidates by word boundaries, which is exactly equivalent for
        # pure-word-char keywords (matches are maximal word runs).  The gold
        # engine still walks the failureless trie (the reference semantics,
        # WholeWordMatchSet.java:47-132).
        # WHOLE_WORD_LONGEST gets the closure (but no emit tables) for the
        # scan-based walk engine (ops/scan_wwl.wwl_scan_walks): when the trie
        # is pure-word-char, the arrival-state DEPTH of the goto-closure DFA
        # decides every walk's die position in one batched scan.
        fail = np.zeros(S, dtype=np.int32)

        # Hash-consed goto-closure rows: a node's row is its fail state's row
        # with the node's own trie edges written over it, so the cons key is
        # (fail row id, edge overrides).  Nodes without own edges share their
        # fail state's row outright — the testFullNode extreme collapses to 2
        # distinct rows.
        dfa_rows = np.zeros((min(S, 1024), A), dtype=np.int32)
        dfa_row_id = np.zeros(S, dtype=np.int32)
        # Root: missing transitions loop to root (the reference root returns
        # itself via defaultTransition, AhoCorasickSet.java:505-507).
        for c, child in overrides[0].items():
            dfa_rows[0, c] = child
        n_rows = 1
        row_of_key: dict = {}

        # Level-synchronous BFS: fail links + goto closure + variant passes.
        by_level: dict = {}
        for node in order[1:]:
            by_level.setdefault(trie.depth[node], []).append(node)

        for level in sorted(by_level):
            nodes = np.asarray(by_level[level], dtype=np.int32)
            if level == 1:
                fail[nodes] = 0
            else:
                fail[nodes] = dfa_rows[
                    dfa_row_id[fail[parent[nodes]]], parent_cls[nodes]
                ]
            if kind == SHORTEST:
                # Reproduce ShortestMatchSet.java:95-110: inherit the first
                # match down the fail chain, then prune any matching node to a
                # leaf whose transitions all restart at the root.
                for node in nodes.tolist():
                    if level > 1 and match_len[node] == 0:
                        f = fail[node]
                        while f != 0 and match_len[f] == 0:
                            f = fail[f]
                        match_len[node] = match_len[f]
                        match_val[node] = match_val[f]
                    if level > 1 and match_len[node] != 0:
                        overrides[node] = {}
                        fail[node] = 0
            for node in nodes.tolist():
                ov = overrides[node]
                key = (int(dfa_row_id[fail[node]]), tuple(sorted(ov.items())))
                rid = row_of_key.get(key)
                if rid is None:
                    if n_rows == len(dfa_rows):
                        dfa_rows = np.concatenate(
                            [dfa_rows, np.zeros_like(dfa_rows)], axis=0
                        )
                    row = dfa_rows[key[0]].copy()
                    if ov:
                        row[list(ov.keys())] = list(ov.values())
                    dfa_rows[n_rows] = row
                    rid = row_of_key[key] = n_rows
                    n_rows += 1
                dfa_row_id[node] = rid

        if dense:
            dfa_next = dfa_rows[dfa_row_id]
        else:
            dfa_next = RowTable(dfa_rows[:n_rows].copy(), dfa_row_id)

    if kind in (AC, LONGEST, WHOLE_WORD):
        # Suffix-chain emit lists in exact Java output() order: own match
        # first, then strictly shorter suffix matches (descending length),
        # via the first-match-ancestor links (AhoCorasickSet.java:110-121).
        fm = np.full(S + 1, -1, dtype=np.int32)  # first match node at-or-above via fails
        for node in order:
            if node == 0:
                fm[0] = -1
                continue
            fm[node] = node if own_len[node] > 0 else fm[fail[node]]

        # L(t) for match node t: [(own t)] + L(fm(fail(t))).
        seg_start: dict = {}
        seg_list_len: List[int] = []
        seg_list_val: List[int] = []

        def build_L(t: int) -> tuple:
            if t in seg_start:
                return seg_start[t]
            nxt = fm[fail[t]]
            if nxt == -1:
                start = len(seg_list_len)
                seg_list_len.append(int(own_len[t]))
                seg_list_val.append(int(own_val[t]))
                res = (start, 1)
            else:
                sub_start, sub_count = build_L(int(nxt))
                start = len(seg_list_len)
                seg_list_len.append(int(own_len[t]))
                seg_list_val.append(int(own_val[t]))
                seg_list_len.extend(seg_list_len[sub_start : sub_start + sub_count])
                seg_list_val.extend(seg_list_val[sub_start : sub_start + sub_count])
                res = (start, 1 + sub_count)
            seg_start[t] = res
            return res

        emit_start = np.zeros(S + 1, dtype=np.int32)
        emit_count = np.zeros(S + 1, dtype=np.int32)
        for node in order:
            anchor = fm[node]
            if anchor != -1:
                st, ct = build_L(int(anchor))
                emit_start[node] = st
                emit_count[node] = ct
        emit_len_arr = np.asarray(seg_list_len or [0], dtype=np.int32)
        emit_val_arr = np.asarray(seg_list_val or [-1], dtype=np.int32)

        # Mirror Java's post-inheritance node.matchLength/value for parity
        # introspection (AhoCorasickSet.java:114-121).
        for node in order:
            if own_len[node] == 0 and fm[node] != -1:
                match_len[node] = own_len[fm[node]]
                match_val[node] = own_val[fm[node]]

    if kind == WHOLE_WORD_LONGEST:
        # Carried fail matches (WholeWordLongestMatchSet.java:224-247): the
        # last completed word-boundary match above this node.
        fail_len = np.zeros(S + 1, dtype=np.int32)
        fail_off = np.zeros(S + 1, dtype=np.int32)
        fail_val = np.full(S + 1, -1, dtype=np.int32)
        assert class_is_word is not None
        for node in order[1:]:
            p = parent[node]
            edge_is_word = bool(class_is_word[parent_cls[node]])
            if own_len[p] != 0 and not edge_is_word:
                fail_len[node] = own_len[p]
                fail_off[node] = 1
                fail_val[node] = own_val[p]
            else:
                fail_len[node] = fail_len[p]
                fail_off[node] = fail_off[p] + 1
                fail_val[node] = fail_val[p]

    # Trie goto table (failureless scan + value re-walk), hash-consed the
    # same way: base row all-DEAD, per-node edge overrides.  Built after the
    # variant passes so shortest-match pruning (cleared rows) is reflected,
    # matching the reference's cleared children (ShortestMatchSet.java:104-110).
    trie_rows = np.full((min(S + 1, 1024), A), DEAD, dtype=np.int32)
    trie_row_id = np.zeros(S + 1, dtype=np.int32)
    n_trows = 1  # row 0: the all-DEAD row (leaves and the DEAD state)
    trow_of_key: dict = {(): 0}
    for node in range(S):
        ov = overrides[node]
        key = tuple(sorted(ov.items()))
        rid = trow_of_key.get(key)
        if rid is None:
            if n_trows == len(trie_rows):
                trie_rows = np.concatenate(
                    [trie_rows, np.full_like(trie_rows, DEAD)], axis=0
                )
            row = np.full(A, DEAD, dtype=np.int32)
            row[list(ov.keys())] = list(ov.values())
            trie_rows[n_trows] = row
            rid = trow_of_key[key] = n_trows
            n_trows += 1
        trie_row_id[node] = rid
    trie_row_id[S] = 0  # DEAD state: no transitions

    if dense:
        trie_next = trie_rows[trie_row_id]
    else:
        trie_next = RowTable(trie_rows[:n_trows].copy(), trie_row_id)

    return CompiledMatcher(
        kind=kind,
        case_sensitive=case_sensitive,
        num_states=S,
        num_classes=A,
        charmap=charmap,
        class_is_word=class_is_word,
        trie_next=trie_next,
        dfa_next=dfa_next,
        fail=fail,
        own_len=own_len,
        own_val=own_val,
        match_len=match_len,
        match_val=match_val,
        depth=depth,
        emit_start=emit_start,
        emit_count=emit_count,
        emit_len=emit_len_arr,
        emit_val=emit_val_arr,
        fail_len=fail_len,
        fail_off=fail_off,
        fail_val=fail_val,
        word_chars=word_chars,
        values=value_list,
        max_depth=max_depth,
    )
