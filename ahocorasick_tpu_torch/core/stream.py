"""Streaming scan over unbounded inputs — the reference's Readable mode (the
port of ``ahocorasick_tpu/core/stream.py``).

Every cursor scans on an explicit ``torch.device`` handed down from the
matcher: large feeds take the planes kernels and the whole-word-longest walk
kernels of batch mode, small feeds the sequential-scan kernel
(``kernels/scan_dfa.seq_states``), and on the CPU their plain twins.  The JAX
module's scan-bucket padding, its cache of jitted runners and its
power-of-two lane bucketing exist to reuse compiled executables and have no
counterpart here.

The reference's stream mode (``AhoCorasickMap.match(Readable, ...)``,
``AhoCorasickMap.java:208-275``) carries exactly one node pointer across
buffer refills.  Here each matcher kind gets a *cursor* that carries the
minimal exact cross-chunk state:

* AC / Longest / Shortest — the DFA state (the goto closure makes the
  transition function total, so chunk entry state fully determines all
  subsequent behavior).  Longest additionally carries the pending
  ``MatchQueue`` and flushes only candidates that can no longer be displaced
  (end <= chunk_end - max_depth; cf. the ``idx - level`` purge invariant,
  ``LongestMatchSet.java:227``).
* Whole-word kinds — a tail of the last ``max_depth + 1`` units plus (for
  whole-word-longest) the restart-chain cursor; undecided walks are replayed
  against the next buffer.  Decisions taken at position ``i`` depend only on
  ``text[..i]``, so replay is exact.

Intentional divergence from the reference, documented per SURVEY.md §4: the
reference's ``ShortestMatchMap`` stream mode double-reports a match pending
exactly at a buffer boundary (``ShortestMatchMap.java:241-249,280-288``);
String mode is the semantic spec, so this implementation reports it once.
Stream output here equals String-mode output with global offsets for every
kind and every chunking (conformance-tested).

Positions are reported globally.  The reference's ``ReadableMatchListener``
only ever sees values (no positions); the maps' ``match_readable`` adapter
reproduces that exact surface, while ``match_stream`` also exposes global
``(start, end)`` — a strict extension.
"""

from __future__ import annotations

import weakref
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ahocorasick_tpu_torch.core.compiler import (
    AC,
    LONGEST,
    SHORTEST,
    WHOLE_WORD,
    WHOLE_WORD_LONGEST,
    CompiledMatcher,
    RowTable,
)
from ahocorasick_tpu_torch.kernels import scan_dfa as kernels
from ahocorasick_tpu_torch.ops import dispatch, scan_batched, scan_wwl
from ahocorasick_tpu_torch.resolve.queue import MatchQueue, resolve_shortest
from ahocorasick_tpu_torch.utils import chartables

Match = Tuple[int, int, int]


def default_chunk_units(max_depth: int) -> int:
    """The reference's buffer-size rule (``AhoCorasickMap.java:53``).

    Device-capable ``StreamScanner``s raise this default to the device
    threshold (output is chunking-invariant, so the rule's observable
    surface — exactness at any buffer size — is preserved; 4096-unit
    reads would keep every feed on the sequential path)."""
    return 2 * max_depth if max_depth > 2048 else 4096


def _read_chunks(source, chunk_units: int):
    """Normalize a Readable into an iterator of non-empty strings.

    Accepts file-like objects (``read(n) -> str``) or any iterable of
    string chunks.
    """
    if hasattr(source, "read"):
        while True:
            piece = source.read(chunk_units)
            if not piece:
                return
            yield piece
    else:
        for piece in source:
            if piece:
                yield piece


# id(CompiledMatcher) -> (weakref, restart table); see _restart_table.
_RESTART_TABLES: dict = {}


def seq_tensors(table, device: torch.device):
    """``(table, row_id)`` tensors of a host transition table on ``device``
    for ``kernels.seq_states``: a dense ``int32[S, A]`` array with ``row_id``
    None, or a ``RowTable`` as its distinct rows and its state -> row map."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    if isinstance(table, RowTable):
        return up(table.rows), up(table.row_id)
    return up(table), None


class _SeqScan:
    """Sequential DFA runner on one device: the table is uploaded at the
    first scan (or handed over already uploaded, ``tensors``).
    ``sync_depth``: the depth d at which the table synchronizes (a goto
    closure: the lane scan of ``kernels.seq_states``), or None for a table
    that does not (the shortest restart table: the serial walk)."""

    def __init__(self, table, device: torch.device, tensors=None, sync_depth=None):
        self._table = table
        self.device = torch.device(device)
        self._tensors = tensors
        self.sync_depth = sync_depth

    def states(self, cls: np.ndarray, s0: int) -> Tuple[np.ndarray, int]:
        """Arrival states for ``cls`` starting from ``s0``; returns carry."""
        n = len(cls)
        if n == 0:
            return np.zeros(0, dtype=np.int32), s0
        if self._tensors is None:
            self._tensors = seq_tensors(self._table, self.device)
        table, row_id = self._tensors
        cls_d = torch.from_numpy(np.ascontiguousarray(cls, dtype=np.int32)).to(self.device)
        states = kernels.seq_states(table, row_id, cls_d, s0, self.sync_depth).cpu().numpy()
        return states, int(states[-1])


def expand_state_emits(
    m: CompiledMatcher, states: np.ndarray, global_off: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized suffix-chain expansion of per-position arrival states.

    Returns (starts, ends, vals) in the sequential reference's emission
    order: end ascending; at equal end, the Java ``output()`` chain order
    (own/longest first — ``AhoCorasickSet.java:522-535``).
    """
    counts = m.emit_count[states]
    pos = np.nonzero(counts)[0]
    if len(pos) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    reps = counts[pos].astype(np.int64)
    total = int(reps.sum())
    ends = np.repeat(pos + global_off + 1, reps)
    # Per-emission index into the flat emit tables.
    offsets = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(reps) - reps, reps)
    eidx = np.repeat(m.emit_start[states[pos]].astype(np.int64), reps) + offsets
    lens = m.emit_len[eidx].astype(np.int64)
    vals = m.emit_val[eidx].astype(np.int64)
    return ends - lens, ends, vals


# Feed sizes at/above this ride the parallel planes kernels; below it the
# sequential scan.  chip_smoke.py's threshold sweep timed one feed both ways
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, two runs): the planes
# path is never slower from 4 Ki units on the 100-, 1,000-, 10k- and
# 1M-keyword dictionaries (from 1-2 Ki on some), so one constant serves every
# dictionary.  (The JAX package's is 16 Ki, from TPU costs.)
_STREAM_DEVICE_MIN = 1 << 12
# Read size of a device-capable scanner given no chunk_units: the JAX
# package's, so that both packages chunk a stream alike.
_STREAM_READ_UNITS = 1 << 14
_STREAM_CHUNK = 512  # batched-engine chunk length (matchers._BATCH_CHUNK)


class _CandidateSource:
    """All AC occurrences within a feed, tail-warmup exact, engine-switched.

    The automaton is d-synchronizing (``ops/scan_batched`` module doc): the
    state at any position is a function of the last ``d`` consumed units.
    Carrying the last ``d`` *classes* (the tail) therefore replaces carrying
    the state id, and lets every feed ride the same parallel planes kernels
    as batch mode (whichever layout ``ops/dispatch.planes_plan`` picks) — the
    warmup for the feed's first lane is the real tail instead of PAD, and
    candidates ending in the tail region (already delivered last feed) are
    dropped.  Small feeds use the sequential-scan kernel over tail+feed from
    the root, which is exact by the same argument, and for the same reason
    take its lane form (``sync_depth`` = the halo).  (Reference invariant source: ``AhoCorasickMap.java:208-275``
    carries one node across buffer refills.)
    """

    def __init__(self, m: CompiledMatcher, device, dev=None, engine: str = "auto"):
        self.m = m
        self.device = torch.device(device)
        self.halo = max(m.max_depth, 1)
        self.engine = engine
        self._tables = dev  # the matcher's table cache, whatever the engine
        self._dev = dev if engine != "gold" else None
        self._plan = None
        self._seq = None

    def seq_scan(self) -> _SeqScan:
        """The sequential runner over the goto closure, on the matcher's
        cached upload of it when there is one: the lane scan, since the goto
        closure synchronizes at the halo."""
        if self._seq is None:
            tensors = self._tables.seq_tables if self._tables is not None else None
            self._seq = _SeqScan(self.m.dfa_next, self.device, tensors, self.halo)
        return self._seq

    def _device_ok(self) -> bool:
        if self._dev is None or self.m.dfa_next is None:
            return False
        if self.m.is_row_compressed:
            return scan_batched.quotient_packable(self.m)
        return True

    def _use_device(self, n: int) -> bool:
        if not self._device_ok():
            return False
        return self.engine == "device" or n >= _STREAM_DEVICE_MIN

    def candidates(self, buf: np.ndarray, keep_after: int):
        """(starts, ends, vals) of matches in ``buf`` (local coords) with
        ``end > keep_after``, sorted by (end asc, start asc) — the
        reference's emission order (end asc; at equal end, the ``output()``
        suffix-chain order, ``AhoCorasickSet.java:522-535``)."""
        if len(buf) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        if self._use_device(len(buf)):
            if self._plan is None:
                self._plan = dispatch.planes_plan(self.m, self._dev)
            plan = self._plan
            nc = self.m.num_classes
            windows = scan_batched.chunk_classes(buf, _STREAM_CHUNK, plan.halo, nc)
            bits = plan.fn(plan.tables,
                           scan_batched.classes_to_device(windows, nc, self.device))
            layout = "hotstate" if plan.which == "hotstate" else "planes"
            starts, ends, vals = scan_batched.ac_matches_batched(
                self.m, buf, bits, layout=layout
            )
        else:
            states, _ = self.seq_scan().states(buf, 0)
            starts, ends, vals = expand_state_emits(self.m, states, 0)
        if keep_after > 0:
            keep = ends > keep_after
            starts, ends, vals = starts[keep], ends[keep], vals[keep]
        return starts, ends, vals


class _DfaCursor:
    """Streaming cursor for the AC / Longest / Shortest kinds.

    Cross-feed state is the class tail (last ``max_depth`` units) plus the
    global offset; see ``_CandidateSource`` for why that is exact.  Resume
    points saved by pre-tail builds ({"state", "off"}) still load: the
    cursor runs the sequential state-carry scan until ``max_depth`` units
    have been consumed, at which point the tail fully determines the state
    (d-synchronization) and it converges back to the engine path.
    """

    def __init__(self, m: CompiledMatcher, device, dev=None, engine: str = "auto"):
        self.m = m
        self.src = _CandidateSource(m, device, dev, engine)
        self.tail = np.zeros(0, dtype=np.int32)
        self.off = 0  # global index of the next unit
        self._legacy_state: Optional[int] = None
        self._since_legacy = 0

    def _advance(self, buf: np.ndarray, n_new: int) -> None:
        self.off += n_new
        keep = min(len(buf), self.src.halo)
        self.tail = np.asarray(buf[len(buf) - keep:], dtype=np.int32)

    def _feed_candidates_global(self, cls: np.ndarray):
        """New matches this feed as GLOBAL (starts, ends, vals), advancing
        the cursor; legacy-resumed cursors take the state-carry path until
        the tail is fully determined."""
        if self._legacy_state is not None:
            states, self._legacy_state = self.src.seq_scan().states(
                cls, self._legacy_state)
            starts, ends, vals = expand_state_emits(self.m, states, self.off)
            self.off += len(cls)
            self.tail = np.concatenate([self.tail, cls])[-self.src.halo:]
            self._since_legacy += len(cls)
            if self._since_legacy >= self.src.halo:
                self._legacy_state = None  # tail now determines the state
            return starts, ends, vals
        buf = np.concatenate([self.tail, cls]) if len(self.tail) else cls
        off0 = self.off - len(self.tail)
        starts, ends, vals = self.src.candidates(buf, self.off - off0)
        self._advance(buf, len(cls))
        return starts + off0, ends + off0, vals

    def feed(self, cls: np.ndarray, is_final: bool) -> List[Match]:
        raise NotImplementedError

    def state_dict(self) -> dict:
        """JSON-safe resume point.  The reference's cross-chunk invariant is
        one node pointer (``AhoCorasickMap.java:208-275``); here it is the
        class tail that determines that node (d-synchronization)."""
        if self._legacy_state is not None:
            return {"state": int(self._legacy_state), "off": int(self.off)}
        return {"tail": self.tail.tolist(), "off": int(self.off)}

    def load_state_dict(self, d: dict) -> None:
        self.off = int(d["off"])
        if "tail" in d:
            self.tail = np.asarray(d["tail"], dtype=np.int32)
            self._legacy_state = None
        else:  # pre-tail format: a DFA state id
            self._legacy_state = int(d["state"])
            self.tail = np.zeros(0, dtype=np.int32)
            self._since_legacy = 0


class _AcCursor(_DfaCursor):
    def feed(self, cls: np.ndarray, is_final: bool) -> List[Match]:
        starts, ends, vals = self._feed_candidates_global(cls)
        return list(zip(starts.tolist(), ends.tolist(), vals.tolist()))

    def feed_arrays(self, cls: np.ndarray, is_final: bool):
        """Array-triple variant of ``feed``: skips building millions of
        Python tuples on match-dense chunks (the listener fast path)."""
        return self._feed_candidates_global(cls)


class _ShortestCursor:
    """Shortest streaming: sequential restart-baked scan with a lazy upgrade
    to AC-over-survivors candidates + the incremental min-end greedy.

    The cursor starts in SEQ mode — the restart-at-root DFA scan, which
    needs only the shortest matcher's own tables (that automaton is NOT
    d-synchronizing, so this mode carries the state id).  When a feed
    crosses the device threshold AND an AC source is available
    (``ShortestMatchSet._ac``, passed lazily as a supplier so small streams
    never pay the second compile), it upgrades to CAND mode: the internal
    AC automaton scans with tail-halo warmup and candidates resolve with
    the cursor ``p`` = last accepted end (equivalence argued on
    ``resolve.queue.resolve_shortest``).  The upgrade is exact because SEQ
    mode tracks exactly (p, class tail) alongside the state, and a legacy
    resume point ({"state", "off"}) simply pins the cursor to SEQ mode.
    """

    def __init__(self, m: CompiledMatcher, device, dev=None, engine: str = "auto",
                 ac=None):
        self.m_outer = m
        self.device = torch.device(device)
        self.engine = engine
        # ``ac``: None | (ac_compiled, ac_dev, cls_map) | zero-arg supplier.
        self._ac = ac
        self.off = 0
        self.p = 0  # restart cursor: matches may not start before it
        self.tail = np.zeros(0, dtype=np.int32)  # shortest class space
        self._halo = max(m.max_depth, 1)
        # SEQ-mode state (active while _cand is None).
        self.state = 0
        self._seq = None
        # Units still needed before the tail fully determines the state
        # (nonzero only after a legacy {state, off} resume; counts down as
        # units are consumed — the tail itself accumulates regardless).
        self._tail_missing = 0
        # Pre-round-3 dicts carry no restart cursor p; without it the
        # CAND-mode overlap guard is unsound, so such resumes stay SEQ.
        self._p_known = True
        # CAND-mode machinery (built on upgrade).
        self._cand: Optional[_CandidateSource] = None
        self._cls_map = None

    @staticmethod
    def _restart_table(m: CompiledMatcher):
        # Restart-at-root baked into the table: match-state rows equal the
        # root's (the compile-time pruning makes deep match states leaves;
        # level-1 match states are handled by the same substitution).
        # Memoized per matcher (weak-keyed): call sites that build a fresh
        # cursor per match (row-compressed shortest match_triples) would
        # otherwise copy and patch the table on every call.
        cached = _RESTART_TABLES.get(id(m))
        if cached is not None and cached[0]() is m:
            return cached[1]
        is_match = m.match_len[: m.num_states] > 0
        if isinstance(m.dfa_next, RowTable):
            table = RowTable(
                m.dfa_next.rows,
                np.where(is_match, m.dfa_next.row_id[0], m.dfa_next.row_id),
            )
        else:
            eff = m.dfa_next.copy()
            eff[is_match] = m.dfa_next[0]
            table = eff
        key = id(m)

        def _evict(_ref, _key=key):
            _RESTART_TABLES.pop(_key, None)

        _RESTART_TABLES[key] = (weakref.ref(m, _evict), table)
        return table

    def _maybe_upgrade(self, n: int) -> None:
        if (self._cand is not None or self._tail_missing > 0
                or not self._p_known or self._ac is None):
            return
        if self.engine == "gold":
            return
        if not (self.engine == "device" or n >= _STREAM_DEVICE_MIN):
            return
        ac = self._ac() if callable(self._ac) else self._ac
        if ac is None:
            self._ac = None  # no AC source; stay SEQ but keep the tail
            return
        ac_m, ac_dev, cls_map = ac
        self._cand = _CandidateSource(ac_m, self.device, ac_dev, self.engine)
        self._cls_map = cls_map
        if self._cls_map is not None and len(self.tail):
            self.tail = self._cls_map[self.tail]

    def feed(self, cls: np.ndarray, is_final: bool) -> List[Match]:
        self._maybe_upgrade(len(cls))
        if self._cand is None:
            m = self.m_outer
            if self._seq is None:
                self._seq = _SeqScan(self._restart_table(m), self.device)
            states, self.state = self._seq.states(cls, self.state)
            ml = m.match_len[states]
            pos = np.nonzero(ml > 0)[0]
            ends = pos + self.off + 1
            starts = ends - ml[pos]
            vals = m.match_val[states[pos]].astype(np.int64)
            self.off += len(cls)
            if len(ends):
                self.p = int(ends[-1])
                self._p_known = True  # a real accepted end refreshed p
            self.tail = np.concatenate([self.tail, cls])[-self._halo:]
            self._tail_missing = max(self._tail_missing - len(cls), 0)
            return list(zip(starts.tolist(), ends.tolist(), vals.tolist()))

        if self._cls_map is not None:
            cls = self._cls_map[cls]
        buf = np.concatenate([self.tail, cls]) if len(self.tail) else cls
        off0 = self.off - len(self.tail)
        starts, ends, vals = self._cand.candidates(buf, self.off - off0)
        # Filter to start >= p, then the (native-backed) min-end greedy —
        # identical to advancing the cursor from p (resolve_shortest's
        # internal cursor starts at 0 and every remaining candidate starts
        # at/after p; same form as resolve_shortest_sharded).  CAND mode
        # only runs on big feeds, where adversarial inputs make the
        # per-candidate Python loop the bottleneck.
        starts = starts + off0
        ends = ends + off0
        keep_m = starts >= self.p
        rs, re_, rv = resolve_shortest(starts[keep_m], ends[keep_m],
                                       vals[keep_m])
        if len(re_):
            self.p = int(re_[-1])
            self._p_known = True
        self.off += len(cls)
        keep = min(len(buf), self._halo)
        self.tail = np.asarray(buf[len(buf) - keep:], dtype=np.int32)
        return list(zip(rs.tolist(), re_.tolist(), rv.tolist()))

    def state_dict(self) -> dict:
        # A legacy-pinned cursor (loaded without "p") must not launder an
        # UNKNOWN restart cursor into a trusted one on re-save: omit "p"
        # until a real accepted end refreshes it, so re-loaded dicts stay
        # pinned to SEQ mode (the _maybe_upgrade guard).
        if self._cand is None:
            d = {"state": int(self.state), "off": int(self.off)}
            if self._p_known:
                d["p"] = int(self.p)
            if self._tail_missing <= 0:
                d["tail"] = self.tail.tolist()
            return d
        d = {"tail": self.tail.tolist(), "off": int(self.off),
             "p": int(self.p)}
        if self._cls_map is not None:
            d["ac_space"] = True  # tail classes are in the AC charmap
        return d

    def load_state_dict(self, d: dict) -> None:
        self.off = int(d["off"])
        self.p = int(d.get("p", 0))
        # Pre-round-3 dicts carry no restart cursor p; the CAND-mode overlap
        # guard is unsound without it, so pin such resumes to SEQ mode
        # (enforces the _p_known invariant _maybe_upgrade relies on).
        self._p_known = "p" in d
        if "state" in d:
            self.state = int(d["state"])
            self._cand = None
            if "tail" in d:
                self.tail = np.asarray(d["tail"], dtype=np.int32)
                self._tail_missing = 0
            else:  # pre-round-3 resume point: tail unknown until it refills
                self.tail = np.zeros(0, dtype=np.int32)
                self._tail_missing = self._halo
            return
        # CAND-format dict: tail + p are mode-independent state.
        self.tail = np.asarray(d["tail"], dtype=np.int32)
        self._tail_missing = 0
        ac = self._ac() if callable(self._ac) else self._ac
        if ac is not None:
            ac_m, ac_dev, cls_map = ac
            if bool(d.get("ac_space")) != (cls_map is not None):
                # The saved tail's class space (outer vs remapped internal
                # AC) must match this build's, else the warmup states after
                # resume would silently diverge — same hazard the no-AC
                # branch below rejects.
                raise ValueError(
                    "resume point's tail class space does not match this "
                    "matcher's internal-AC charmap; resume with a matcher "
                    "built like the one that saved it"
                )
            self._cand = _CandidateSource(ac_m, self.device, ac_dev, self.engine)
            self._cls_map = cls_map
            return
        # No AC source (from_compiled artifact): resume exactly in SEQ
        # mode.  Since p is the LAST accepted end, no match ended after p,
        # so the restart-scan state at `off` equals a pure goto-closure
        # walk from the root over the text since max(p, off - halo) —
        # which the tail covers (d-synchronization on the match-free
        # stretch; see the class docstring).
        if d.get("ac_space"):
            raise ValueError(
                "resume point was saved with a class-remapped internal AC "
                "automaton; this matcher (no keyword source) cannot "
                "interpret its tail — resume with a keyword-constructed "
                "matcher instead"
            )
        self._cand = None
        take = min(len(self.tail), max(self.off - self.p, 0))
        s = 0
        dfa = self.m_outer.dfa_next
        for c in self.tail[len(self.tail) - take:].tolist():
            s = int(dfa[s, c])
        self.state = s


class _LongestCursor(_DfaCursor):
    def __init__(self, m: CompiledMatcher, device, dev=None, engine: str = "auto"):
        super().__init__(m, device, dev, engine)
        self.queue = MatchQueue()

    def feed(self, cls: np.ndarray, is_final: bool) -> List[Match]:
        starts, ends, vals = self._feed_candidates_global(cls)
        for s, e, v in zip(starts.tolist(), ends.tolist(), vals.tolist()):
            self.queue.push(s, e, v)
        if is_final:
            return self.queue.drain()
        # Future candidates end after self.off and have length <= max_depth,
        # so they start at/after self.off - max_depth + 1: anything queued
        # ending before that can never be displaced.
        return self.queue.flush(self.off - self.m.max_depth)

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["queue"] = self.queue.drain()
        for s, e, v in d["queue"]:
            self.queue.push(s, e, v)
        return d

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        self.queue = MatchQueue()
        for s, e, v in d["queue"]:
            self.queue.push(int(s), int(e), int(v))


class _WwCursor:
    """Streaming cursor for the plain WHOLE_WORD kind, riding the batch
    engines: AC candidates + vectorized boundary filter per feed.

    Equivalence with the reference's restart walk is the batch path's
    (pure-word-char keywords match whole words iff flanked by non-word
    chars or text edges, ``WholeWordMatchSet.java:47-132``); streaming
    adds exactly one new case — a candidate ending at the feed's last
    unit cannot check its RIGHT boundary until the next unit arrives, so
    it is held pending and delivered first next feed (its end precedes
    every new candidate's, preserving emission order).  The tail carries
    ``max_depth + 1`` classes: pending candidates start as far back as
    ``off - max_depth``, and their LEFT boundary check needs the unit
    before that.
    """

    def __init__(self, m: CompiledMatcher, device, dev=None, engine: str = "auto"):
        self.m = m
        self.src = _CandidateSource(m, device, dev, engine)
        self.keep = max(m.max_depth, 1) + 1  # tail length (see docstring)
        self.tail = np.zeros(0, dtype=np.int32)
        self.off = 0
        self.pending: List[Match] = []  # candidates with end == off

    def feed(self, cls: np.ndarray, is_final: bool) -> List[Match]:
        m = self.m
        buf = np.concatenate([self.tail, cls]) if len(self.tail) else cls
        off0 = self.off - len(self.tail)
        w = np.asarray(m.class_is_word)[buf] if len(buf) else np.zeros(0, bool)
        out: List[Match] = []

        def left_ok(s: int) -> bool:
            return s == 0 or not w[s - 1 - off0]

        # Pending candidates end exactly at self.off; buf[len(tail)] is the
        # first new unit (their right-boundary witness).
        for s, e, v in self.pending:
            if not left_ok(s):
                continue
            if len(cls) == 0:
                if is_final:
                    out.append((s, e, v))
                continue
            if not w[e - off0]:
                out.append((s, e, v))
        self.pending = [] if (len(cls) or is_final) else self.pending

        if len(cls):
            starts, ends, vals = self.src.candidates(buf, self.off - off0)
            # Vectorized boundary filter (same predicate as the batch path;
            # a per-candidate Python loop dominated the feed cost).
            sl = starts.astype(np.int64)  # local coords
            el = ends.astype(np.int64)
            sg = sl + off0
            lok = (sg == 0) | ~w[np.maximum(sl - 1, 0)]
            at_edge = el == len(buf)
            rok = ~at_edge & ~w[np.minimum(el, len(buf) - 1)]
            deliver = lok & (rok | (at_edge & is_final))
            out.extend(zip((sl[deliver] + off0).tolist(),
                           (el[deliver] + off0).tolist(),
                           vals[deliver].tolist()))
            if not is_final:
                hold = lok & at_edge
                self.pending.extend(zip((sl[hold] + off0).tolist(),
                                        (el[hold] + off0).tolist(),
                                        vals[hold].tolist()))
        self.off += len(cls)
        k = min(len(buf), self.keep)
        self.tail = np.asarray(buf[len(buf) - k:], dtype=np.int32)
        return out

    def state_dict(self) -> dict:
        return {"tail": self.tail.tolist(), "off": int(self.off),
                "pending": [list(p) for p in self.pending]}

    def load_state_dict(self, d: dict) -> None:
        self.off = int(d["off"])
        if "tail_off" in d:  # pre-round-3 _WordCursor format
            self.tail = np.asarray(d["tail"], dtype=np.int32)[-self.keep:]
            # Recover boundary-pending candidates: those ending at off lie
            # within the tail (length max_depth+1), so a from-root scan of
            # the tail finds them exactly (d-synchronization).
            self.pending = []
            if len(self.tail):
                starts, ends, vals = self.src.candidates(
                    self.tail, len(self.tail) - 1)
                off0 = self.off - len(self.tail)
                self.pending = [
                    (int(s) + off0, int(e) + off0, int(v))
                    for s, e, v in zip(starts, ends, vals)
                ]
            return
        self.tail = np.asarray(d["tail"], dtype=np.int32)
        self.pending = [tuple(p) for p in d.get("pending", [])]


class _WwlCursor:
    """Streaming cursor for WHOLE_WORD_LONGEST riding the device walks.

    Per feed: compute walk outcomes for every word start in tail+feed with
    the batch path's kernels, by the batch path's route
    (``ops/scan_wwl.lane_outcomes``, same outcome rules), then follow the sequential restart
    chain on the host exactly as the batch ``follow_chain`` does.  A walk
    whose die position lands in the padding (it would read units that
    have not arrived) is UNDECIDED: the chain stops before it and the walk
    replays next feed — its start lies within the carried ``max_depth+1``
    tail, the same bound the tail-replay cursor used.  Emission happens
    only for decided walks and the chain cursor (``resume``) only advances
    past them, so replays can never double-deliver.
    """

    def __init__(self, m: CompiledMatcher, dev, engine: str = "auto"):
        self.m = m
        self.dev = dev  # the matcher's table cache; it names the device
        self.keep = max(m.max_depth, 1) + 1
        self.tail = np.zeros(0, dtype=np.int32)
        self.off = 0
        self.resume = 0  # global: next walk starts at/after this position

    def feed(self, cls: np.ndarray, is_final: bool) -> List[Match]:
        m = self.m
        buf = np.concatenate([self.tail, cls]) if len(self.tail) else cls
        off0 = self.off - len(self.tail)
        n_buf = len(buf)
        out: List[Match] = []
        if n_buf == 0:
            return out
        # The ONE production lane setup (ops.scan_wwl.compact_lanes); the
        # reference's INITIAL walk starts at position 0 whatever its
        # wordness, so include lane 0 only at true stream start.
        compact = scan_wwl.compact_lanes(m, buf, text_start=off0 == 0)
        lanes = compact[2]
        if len(lanes) == 0:
            self._advance(buf, len(cls))
            return out
        # The scan routes are exact mid-stream too: every queried walk start
        # is an in-buffer word start whose word run begins in-buffer, so the
        # root-started scan's depth plane equals the sequential one at all
        # gathered positions; crossing walks re-run on the host, and a die
        # position in the padded region falls to the undecided check below
        # like every other walk's.
        die, has, ms, me, mv = scan_wwl.lane_outcomes(m, self.dev, compact)
        W = len(lanes)

        # Precompute each walk's successor slot (first word start after its
        # die position) so the chain loop is pure integer hopping — a
        # per-step searchsorted dominated the feed cost.
        nxt = np.searchsorted(lanes, die, side="right")
        r_loc = max(self.resume - off0, 0)
        idx = int(np.searchsorted(lanes, r_loc, side="left"))
        while idx < W:
            p = int(die[idx])
            if p >= n_buf and not is_final:
                break  # undecided: reads units that have not arrived
            if has[idx]:
                out.append((int(ms[idx]) + off0, int(me[idx]) + off0,
                            int(mv[idx])))
            self.resume = off0 + p + 1
            idx = int(nxt[idx])
        self._advance(buf, len(cls))
        return out

    def _advance(self, buf: np.ndarray, n_new: int) -> None:
        self.off += n_new
        k = min(len(buf), self.keep)
        self.tail = np.asarray(buf[len(buf) - k:], dtype=np.int32)

    def state_dict(self) -> dict:
        return {"tail": self.tail.tolist(), "off": int(self.off),
                "resume": int(self.resume), "wwl_dev": True}

    def load_state_dict(self, d: dict) -> None:
        self.off = int(d["off"])
        self.resume = int(d.get("resume", 0))
        self.tail = np.asarray(d["tail"], dtype=np.int32)[-self.keep:]


class _WordCursor:
    """Streaming cursor for the whole-word kinds (tail-replay design)."""

    def __init__(self, m: CompiledMatcher):
        self.m = m
        self.d = max(m.max_depth, 1)
        self.tail = np.zeros(0, dtype=np.int32)  # last <= d+1 classes
        self.tail_off = 0  # global index of tail[0]
        self.off = 0  # global index of the next incoming unit
        # Whole-word-longest restart chain cursor: next walk starts at the
        # first genuine word start at/after this global position.
        self.resume = 0

    # -- per-walk gold models (decision point = the index that ends them) -- #

    def _walk_ww(self, cls: np.ndarray, i0: int, is_final: bool):
        """Returns ('pending',) or ('done', decision_idx, match_or_None)."""
        m = self.m
        trie, is_word = m.trie_next, m.class_is_word
        DEAD = m.dead_state
        n = len(cls)
        s = 0
        i = i0
        while i < n:
            nxt = int(trie[s, cls[i]])
            if nxt == DEAD:
                if not is_word[cls[i]]:
                    if m.own_len[s] != 0:
                        return "done", i, (i - int(m.own_len[s]), i, int(m.own_val[s]))
                    return "done", i, None
                return "done", i, None  # dies mid-word: word cannot match
            s = nxt
            i += 1
        if is_final:
            if m.own_len[s] != 0:
                return "done", i, (i - int(m.own_len[s]), i, int(m.own_val[s]))
            return "done", i, None
        return ("pending",)

    def _walk_wwl(self, cls: np.ndarray, i0: int, is_final: bool):
        m = self.m
        trie, is_word = m.trie_next, m.class_is_word
        DEAD = m.dead_state
        n = len(cls)
        s = 0
        i = i0
        while i < n:
            nxt = int(trie[s, cls[i]])
            if nxt == DEAD:
                if not is_word[cls[i]]:
                    if m.own_len[s] != 0:
                        return "done", i, (i - int(m.own_len[s]), i, int(m.own_val[s]))
                    if m.fail_len[s] != 0:
                        fme = i - int(m.fail_off[s])
                        return "done", i, (fme - int(m.fail_len[s]), fme, int(m.fail_val[s]))
                    return "done", i, None
                # Dead end on a word char: only the carried fail match
                # reports (WholeWordLongestMatchSet.java:82-94).
                if m.fail_len[s] != 0:
                    fme = i - int(m.fail_off[s])
                    return "done", i, (fme - int(m.fail_len[s]), fme, int(m.fail_val[s]))
                return "done", i, None
            s = nxt
            i += 1
        if is_final:
            if m.own_len[s] != 0:
                return "done", i, (i - int(m.own_len[s]), i, int(m.own_val[s]))
            if m.fail_len[s] != 0:
                fme = i - int(m.fail_off[s])
                return "done", i, (fme - int(m.fail_len[s]), fme, int(m.fail_val[s]))
            return "done", i, None
        return ("pending",)

    def _word_starts(self, cls: np.ndarray) -> np.ndarray:
        """Walk-start positions in buffer-local indices.

        Word starts, plus — at TRUE stream start — index 0 unconditionally:
        the reference's initial walk begins at position 0 whatever its
        wordness (only mid-stream RESTARTS skip to word starts,
        ``WholeWordLongestMatchSet.java:91-99``), which is observable for
        keywords that begin with non-word characters (a trimmed-to-nothing
        keyword like ``" "`` survives insertion per the trim quirk and must
        match at position 0; the batch path's ``follow_chain`` starts its
        chain at 0 the same way).  Mid-buffer index 0 (tail_off > 0) is
        never a start: its wordness predecessor lives in the tail context,
        and every undecided walk starts at/after ``tail_off + 1`` (tail
        length is d+1 while live walks span at most d units).
        """
        if len(cls) == 0:
            return np.zeros(0, dtype=np.int64)
        is_word = self.m.class_is_word[cls]
        prev = np.concatenate([[True], is_word[:-1]])
        starts = np.nonzero(is_word & ~prev)[0]
        if self.tail_off == 0 and (len(starts) == 0 or starts[0] != 0):
            starts = np.concatenate([np.zeros(1, dtype=starts.dtype), starts])
        return starts

    def feed(self, cls: np.ndarray, is_final: bool) -> List[Match]:
        m = self.m
        buf = np.concatenate([self.tail, cls]) if len(self.tail) else cls
        buf_off = self.tail_off
        prev_end = self.off  # decisions before this were already delivered
        n = len(buf)
        walk = self._walk_ww if m.kind == WHOLE_WORD else self._walk_wwl
        chain = m.kind == WHOLE_WORD_LONGEST
        out: List[Match] = []

        ws_local = self._word_starts(buf)
        for j in range(len(ws_local)):
            i0 = int(ws_local[j])
            g0 = buf_off + i0
            if chain and g0 < self.resume:
                continue
            res = walk(buf, i0, is_final)
            if res[0] == "pending":
                # Walk undecided at buffer end; replay it next chunk (its
                # start lies within the carried tail by the depth bound).
                # Plain whole-word walks are per-word independent, so later
                # word starts still run now; the longest kind's restart
                # chain is sequential, so it must stop here.
                if chain:
                    break
                continue
            _, dec, match = res
            if match is not None and buf_off + dec >= prev_end:
                out.append((match[0] + buf_off, match[1] + buf_off, match[2]))
            if chain:
                # Resume after the word containing the die position: the
                # first word start strictly greater than it
                # (WholeWordLongestMatchSet.java:91-99).
                self.resume = buf_off + dec + 1

        self.off += len(cls)
        keep = min(n, self.d + 1)
        self.tail = buf[n - keep :]
        self.tail_off = buf_off + (n - keep)
        return out

    def state_dict(self) -> dict:
        return {
            "tail": self.tail.tolist(),
            "tail_off": int(self.tail_off),
            "off": int(self.off),
            "resume": int(self.resume),
        }

    def load_state_dict(self, d: dict) -> None:
        self.tail = np.asarray(d["tail"], dtype=np.int32)
        self.off = int(d["off"])
        # Device-cursor formats (_WwCursor: {tail, off, pending};
        # _WwlCursor: {tail, off, resume}) carry no tail_off — derive it —
        # and pending-at-edge matches need no conversion: those walks are
        # still undecided in tail-replay terms (their die unit has not
        # arrived), so the replay from the tail re-finds them exactly.
        self.tail_off = int(d.get("tail_off", self.off - len(self.tail)))
        self.resume = int(d.get("resume", 0))


def make_cursor(m: CompiledMatcher, device, dev=None, engine: str = "auto", ac=None):
    """``device``: the ``torch.device`` every scan of the cursor runs on (the
    matcher's; there is no default).  ``dev``: the matcher's device table
    cache (``models.matchers._DeviceTables``, on ``device``) — enables the
    parallel planes and walk kernels for large feeds.  ``ac``: SHORTEST only
    — ``(ac_compiled, ac_dev, cls_map)`` for the internal AC automaton over
    insert survivors, or a zero-argument supplier of it."""
    device = torch.device(device)
    if dev is not None and torch.device(dev.device) != device:
        raise ValueError(f"table cache on {dev.device}, cursor on {device}")
    if m.kind == AC:
        return _AcCursor(m, device, dev, engine)
    if m.kind == LONGEST:
        return _LongestCursor(m, device, dev, engine)
    if m.kind == SHORTEST:
        return _ShortestCursor(m, device, dev, engine, ac=ac)
    if m.kind in (WHOLE_WORD, WHOLE_WORD_LONGEST):
        # The device cursors win on the card; on the CPU the per-feed twins
        # cost more than the host tail-replay walk, so "auto" keeps the host
        # cursor there (explicit engine="device" forces the device cursors —
        # how the CPU test suite pins their conformance).
        want_device = engine == "device" or (
            engine != "gold" and device.type == "cuda"
        )
        if (want_device and m.kind == WHOLE_WORD and m.dfa_next is not None):
            return _WwCursor(m, device, dev, engine)
        if want_device and m.kind == WHOLE_WORD_LONGEST and dev is not None:
            # Row-compressed: only the scan routes apply (the per-start walk
            # needs dense trie tables) — uniform (quotient) or mixed
            # truncated-closure.
            if (not m.is_row_compressed or scan_wwl.scan_applicable(m)
                    or scan_wwl.mixed_scan_applicable(m)):
                return _WwlCursor(m, dev, engine)
    return _WordCursor(m)


class StreamScanner:
    """Push- or pull-based streaming façade over a compiled matcher."""

    def __init__(self, m: CompiledMatcher, chunk_units: Optional[int] = None,
                 *, device, dev=None, engine: str = "auto", ac=None):
        self.m = m
        default = default_chunk_units(max(m.max_depth, 1))
        if chunk_units is None and dev is not None and engine != "gold":
            # The reference's 4096-unit buffer rule predates the device
            # engines: device-capable scanners default to device-sized reads
            # (the caller can still pass any chunk_units explicitly).
            default = max(default, _STREAM_READ_UNITS)
        self.chunk_units = chunk_units or default
        self.cursor = make_cursor(m, device, dev, engine, ac)

    def _classes(self, text: str) -> np.ndarray:
        return self.m.charmap[chartables.to_utf16_units(text)]

    def scan(self, source) -> "Iterable[Match]":
        """Yield global (start, end, value_id) triples as they finalize."""
        it = _read_chunks(source, self.chunk_units)
        piece = next(it, None)
        fed = False
        while piece is not None:
            nxt = next(it, None)
            cls = self._classes(piece)
            fed = True
            for match in self.cursor.feed(cls, is_final=nxt is None):
                yield match
            piece = nxt
        if not fed:
            # Empty source: still run the end-of-input path once, so a
            # RESUMED cursor (pending queue / final-word walk) finalizes
            # even when nothing new arrives.
            for match in self.cursor.feed(np.zeros(0, dtype=np.int32), is_final=True):
                yield match

    # Resumable scans: persist/restore the cursor between processes.
    def state_dict(self) -> dict:
        return self.cursor.state_dict()

    def load_state_dict(self, d: dict) -> None:
        self.cursor.load_state_dict(d)

    def feed(self, text: str, is_final: bool) -> "List[Match]":
        """Push-mode: feed one text chunk, get finalized global triples."""
        return self.cursor.feed(self._classes(text), is_final)

    def feed_arrays(self, text: str, is_final: bool):
        """Push-mode returning (starts, ends, vals) int arrays.

        Cursors with a native array path (AC) skip the per-match tuple
        build; the resolved kinds (far fewer finalized matches per chunk)
        convert their list."""
        cls = self._classes(text)
        fa = getattr(self.cursor, "feed_arrays", None)
        if fa is not None:
            return fa(cls, is_final)
        trips = self.cursor.feed(cls, is_final)
        if not trips:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z.copy()
        a = np.asarray(trips, dtype=np.int64)
        return a[:, 0], a[:, 1], a[:, 2]
