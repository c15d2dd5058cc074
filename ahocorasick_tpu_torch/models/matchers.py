"""Public matcher classes of the PyTorch/CUDA port (the port of
``ahocorasick_tpu/models/matchers.py``): all-matches, leftmost-longest,
whole-word, leftmost-shortest and whole-word-longest, each as a set and as
a map.

Reporting conventions are the reference's: ``end`` is one past the last
matched UTF-16 unit, a listener returning ``False`` stops the run (texts
over ``_LISTENER_CHUNK`` units are scanned chunk by chunk through the stream
cursor, so the rest is never scanned), and matches come in the sequential
automaton's emission order.  With no listener, ``match`` returns
``(start, end)`` tuples (sets) or ``(start, end, value)`` (maps).
``match_stream``, ``stream()`` and the maps' ``match_readable`` scan
unbounded inputs through the cursors of ``core/stream.py``, on the
matcher's device.

Engines: ``"device"`` runs the kernels on the matcher's torch device (their
plain PyTorch twins when that device is the CPU); ``"gold"`` runs the
sequential host model; ``"auto"`` picks gold below ``_AUTO_DEVICE_MIN_UNITS``.
``device=None`` means CUDA, and the constructor raises when CUDA is
unavailable.  The AC, longest, whole-word and shortest kinds' device path
is an END-indexed planes kernel, then hot-position compaction and a host
resolve per kind: the packed scan for dictionaries whose emit masks pack
inline beside the state, and for every other dense dictionary the
huge-dictionary layouts of ``ops/dispatch.py`` (the hotstate plane, decoded
on the host, or the split planes; ``AhoCorasickSet.count`` sums emit counts
on the count-packed table).  Shortest matchers loaded without their
internal AC automaton take the sequential restart scan.
Whole-word-longest computes per-start walk outcomes on the device
(``ops/scan_wwl.py``) and follows the restart chain on the host.  Only
row-compressed (wide-alphabet) dictionaries that no ported kernel can take
(see ``_no_device_path``) answer through gold under ``"auto"``, and raise
under ``"device"``; ``_device_capable`` answers as the JAX package's does.
For row-compressed AC, longest and shortest dictionaries gold is one cursor
feed over the sequential-scan kernel, not the per-character loop.

The compiler, gold model, artifact format, native extractor, resolvers and
value re-walk are the port's own copies of the JAX package's host code, under
the same module names.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.convert import _bucket_up
from ahocorasick_tpu_torch.core import artifact, gold, stream
from ahocorasick_tpu_torch.core.compiler import (
    AC,
    LONGEST,
    SHORTEST,
    WHOLE_WORD,
    WHOLE_WORD_LONGEST,
    CompiledMatcher,
    compile_matcher,
    shortest_survivors,
)
from ahocorasick_tpu_torch.kernels.scan_dfa import restart_row_id
from ahocorasick_tpu_torch.ops import (
    dispatch,
    emit,
    scan_batched,
    scan_dfa,
    scan_pfac2,
    scan_rowdfa,
    scan_wwl,
)
from ahocorasick_tpu_torch.resolve.queue import resolve_longest, resolve_shortest
from ahocorasick_tpu_torch.resolve.wholeword import boundary_filter, follow_chain
from ahocorasick_tpu_torch.utils import chartables
from ahocorasick_tpu_torch.utils.lanes import LANE_BUCKET, bucket_depth
from ahocorasick_tpu_torch.utils.stats import ScanStats, timed

# Input size (UTF-16 units) from which "auto" takes the device: one constant
# for every dictionary, set from warm calls.  chip_smoke.py's threshold sweep
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md) timed engine="gold" against a
# device matcher on 2**8 to 2**20 units over 100-, 1,000-, 10k- and
# 1M-keyword dictionaries: warm calls are never slower from 0.5-2 Ki units on
# all four.  A matcher's first device call also builds and uploads its table
# (break-even there 2 Ki units for 100 keywords, 32 Ki for 10k, 1 Mi for 1M),
# a cost paid once and not again, so the threshold does not charge it to
# every call.  The JAX package's thresholds are TPU costs and are not used.
_AUTO_DEVICE_MIN_UNITS = 1 << 11

# Window body length: B = N / C lanes each scan C steps after the halo.
_BATCH_CHUNK = 512

# device_engine="pfac2": the START-indexed PFAC walk instead of a planes plan.
_PFAC_WALK = "pfac_walk"


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to scan with the "
            "plain PyTorch twins of the kernels")
    return dev


def _no_device_path(compiled: CompiledMatcher, kind: str) -> Optional[str]:
    """Why this compiled matcher has no device path in the port, or None.

    Dense dictionaries always have one: AC, longest and whole-word take the
    packed scan, or the count-packed / hotstate / split layouts when the
    emit masks do not fit beside the state; whole-word-longest the
    per-start walk.  Row-compressed ones: AC, longest and whole-word when
    their quotient DFA packs inline; whole-word-longest when a scan table
    applies.  Shortest answers None: it delegates to its internal AC
    matcher, which ``ShortestMatchSet._pick_engine`` consults itself."""
    if kind == SHORTEST or not compiled.is_row_compressed:
        return None
    if kind == WHOLE_WORD_LONGEST:
        if scan_wwl.scan_applicable(compiled) or scan_wwl.mixed_scan_applicable(compiled):
            return None
    elif kind in (AC, LONGEST, WHOLE_WORD) and scan_batched.quotient_packable(compiled):
        return None
    return (f"dictionary is too wide for this kind's device path (kind {kind!r}, "
            f"{compiled.num_states} states x {compiled.num_classes} classes, "
            f"max depth {compiled.max_depth})")


def _device_capable(compiled: CompiledMatcher, kind: str) -> bool:
    """Does this compiled matcher have a device path in the port?"""
    return _no_device_path(compiled, kind) is None


def _require_device_path(compiled: CompiledMatcher, kind: str) -> None:
    """Raise for ``engine="device"`` on a dictionary with no device path."""
    reason = _no_device_path(compiled, kind)
    if reason is not None:
        raise ValueError(f"{reason}; use engine='auto' or 'gold'")


class _DeviceTables:
    """Lazy per-matcher cache of the device tables (torch tensors on the
    matcher's device).  State rows and class columns are padded to the
    power-of-two buckets of the JAX package, so table bytes match it
    exactly."""

    def __init__(self, m: CompiledMatcher, device: torch.device):
        self._m = m
        self.device = device
        self._cache = {}
        self._host = {}  # numpy tables kept beside their device copies
        self._sp = _bucket_up(m.num_states + 1)
        self._ap = _bucket_up(m.num_classes)

    @property
    def packed_dfa(self) -> scan_batched.PackedDfa:
        """Packed goto-closure DFA (quotient rows for row-compressed
        matchers) for the packed-scan kernels."""
        if "packed_dfa" not in self._cache:
            pd = scan_batched.build_packed(self._m)
            self._cache["packed_dfa"] = convert.packed_from_numpy(
                pd.table, pd.state_bits, pd.halo, self._m.num_classes, self.device)
        return self._cache["packed_dfa"]

    @property
    def row_dfa(self) -> scan_rowdfa.RowDfa:
        """The stride-2 row table ``uint32[S*A, A+1]`` (quotient rows for
        row-compressed matchers) for the stride-2 kernels."""
        if "row_dfa" not in self._cache:
            rd = scan_rowdfa.build_rowdfa(self._m)
            self._cache["row_dfa"] = rd._replace(
                table=convert._uint32_tensor(rd.table, self.device))
        return self._cache["row_dfa"]

    @property
    def ranked(self) -> scan_pfac2.RankedTables:
        """Ranked tables of the ``device_engine="pfac2"`` walk, as the JAX
        package pads them: ``trie_next`` uint32[S_pad, A_pad] filled with
        ``dead_state``, and the k-gram ``prefix`` table."""
        if "ranked" not in self._cache:
            rt = scan_pfac2.build_ranked(self._m)
            trie = np.full((self._sp, self._ap), rt.dead_state, dtype=np.uint32)
            trie[: rt.num_states, : self._m.num_classes] = rt.trie_next
            self._cache["ranked"] = rt._replace(
                trie_next=convert._uint32_tensor(trie, self.device),
                prefix=convert._uint32_tensor(rt.prefix, self.device))
        return self._cache["ranked"]

    @property
    def count_packed_dfa(self) -> Tuple[torch.Tensor, int, int]:
        """``(table_flat, state_bits, halo)``: the flat, unpadded
        ``next | emit_count << state_bits`` table of a huge dictionary, for
        its count and hotstate kernels."""
        if "count_packed_dfa" not in self._cache:
            self._cache["count_packed_dfa"] = convert.count_packed_from_numpy(
                *scan_batched.build_count_packed(self._m), self.device)
        return self._cache["count_packed_dfa"]

    @property
    def split_dfa(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """``(dfa_flat, emit_tab, halo)``: the flat, unpadded next-state
        table and the per-state emit planes ``uint32[S, P]`` of a dictionary
        whose emit counts do not fit beside the state either."""
        if "split_dfa" not in self._cache:
            pd = scan_batched.build_packed(self._m)
            if pd.emit_mask is None:
                raise ValueError("dictionary packs inline; it has no split layout")
            self._cache["split_dfa"] = convert.split_from_numpy(
                pd.table.reshape(-1), pd.emit_mask, pd.halo, self.device)
        return self._cache["split_dfa"]

    @property
    def dfa_next(self) -> torch.Tensor:
        """Goto-closure DFA ``int32[S_pad, A_pad]``, zero-filled padding
        (the shortest restart scan's table)."""
        if "dfa_next" not in self._cache:
            m = self._m
            t = np.zeros((self._sp, self._ap), dtype=np.int32)
            t[: m.num_states, : m.num_classes] = m.dfa_next
            self._cache["dfa_next"] = torch.from_numpy(t).to(self.device)
        return self._cache["dfa_next"]

    @property
    def seq_tables(self):
        """``(table, row_id)`` for the sequential-scan kernel over the goto
        closure: the padded ``dfa_next`` and None, or a row-compressed
        table's distinct rows and its state -> row map."""
        if "seq_tables" not in self._cache:
            if self._m.is_row_compressed:
                self._cache["seq_tables"] = stream.seq_tensors(self._m.dfa_next, self.device)
            else:
                self._cache["seq_tables"] = (self.dfa_next, None)
        return self._cache["seq_tables"]

    def _wwl_host(self, name: str, build) -> scan_wwl.WwlScan:
        """The numpy ``WwlScan`` of ``build``, built once and kept in
        ``_host``; nothing is uploaded."""
        if name not in self._host:
            self._host[name] = build(self._m)
        return self._host[name]

    def _wwl_tables(self, name: str, build) -> scan_wwl.WwlScan:
        """The tensors on the device of the one build of ``_wwl_host``."""
        if name not in self._cache:
            self._cache[name] = convert.wwl_scan_from_numpy(
                self._wwl_host(name, build), self.device)
        return self._cache[name]

    @property
    def wwl_scan(self) -> scan_wwl.WwlScan:
        """Whole-word-longest scan tables over the goto closure (or its
        quotient rows), for word-uniform dictionaries."""
        return self._wwl_tables("wwl_scan", scan_wwl.build_wwl_scan)

    @property
    def wwl_scan_host(self) -> scan_wwl.WwlScan:
        """Host (numpy) build of ``wwl_scan``: the table-sharded scanner cuts
        its table into row shards itself and uploads none of it whole
        (``TableShardedScanner``)."""
        return self._wwl_host("wwl_scan", scan_wwl.build_wwl_scan)

    @property
    def wwl_scan_mixed(self) -> scan_wwl.WwlScan:
        """Whole-word-longest scan tables over the truncated closure, with
        crossing bits, for separator-spanning dictionaries."""
        return self._wwl_tables("wwl_scan_mixed", scan_wwl.build_wwl_scan_mixed)

    @property
    def wwl_scan_mixed_host(self) -> scan_wwl.WwlScan:
        """Host (numpy) build of ``wwl_scan_mixed``."""
        return self._wwl_host("wwl_scan_mixed", scan_wwl.build_wwl_scan_mixed)

    @property
    def trie_next(self) -> torch.Tensor:
        """The pure trie int32[S_pad, A_pad] with the dead state re-anchored
        to ``S_pad - 1``, an absorbing row (the JAX package's padding): the
        table of the per-start walks and of the v1 PFAC walk."""
        if "trie_next" not in self._cache:
            m = self._m
            dead = self._sp - 1
            trie = np.full((self._sp, self._ap), dead, dtype=np.int32)
            trie[: m.num_states + 1, : m.num_classes] = np.where(
                m.trie_next == m.num_states, dead, m.trie_next)
            self._cache["trie_next"] = torch.from_numpy(trie).to(self.device)
        return self._cache["trie_next"]

    @property
    def is_match(self) -> torch.Tensor:
        """bool[S_pad]: the state ends a keyword (``own_len > 0``)."""
        if "is_match" not in self._cache:
            out = np.zeros(self._sp, dtype=bool)
            out[: len(self._m.own_len)] = self._m.own_len > 0
            self._cache["is_match"] = torch.from_numpy(out).to(self.device)
        return self._cache["is_match"]

    @property
    def wwl_walk(self) -> Tuple[torch.Tensor, ...]:
        """The per-start walk's tables, padded as the JAX package pads them:
        ``(trie_next, own_len, own_val, fail_len, fail_off, fail_val,
        class_is_word)``.  ``trie_next`` is the property above; the outcome
        arrays are int32[S_pad], the ``_val`` ones padded with -1;
        ``class_is_word`` is bool[A_pad]."""
        if "wwl_walk" not in self._cache:
            m = self._m
            arrays = []
            for name in ("own_len", "own_val", "fail_len", "fail_off", "fail_val"):
                arr = getattr(m, name)
                out = np.full(self._sp, -1 if name.endswith("_val") else 0, dtype=arr.dtype)
                out[: len(arr)] = arr
                arrays.append(out)
            word = np.zeros(self._ap, dtype=bool)
            word[: m.num_classes] = m.class_is_word
            arrays.append(word)
            self._cache["wwl_walk"] = (self.trie_next, *(torch.from_numpy(a).to(self.device)
                                                         for a in arrays))
        return self._cache["wwl_walk"]

    @property
    def match_len(self) -> torch.Tensor:
        """Shortest-match length per state ``int32[S_pad]``, 0-padded."""
        if "match_len" not in self._cache:
            arr = np.zeros(self._sp, dtype=np.int32)
            arr[: len(self._m.match_len)] = self._m.match_len
            self._cache["match_len"] = torch.from_numpy(arr).to(self.device)
        return self._cache["match_len"]

    @property
    def restart_row_id(self) -> torch.Tensor:
        """``int32[S_pad]``: the restart scan's row of each state over the
        padded ``dfa_next`` (0 for a match state, else the state's own), the
        map ``kernels.scan_dfa.shortest_states`` takes."""
        if "restart_row_id" not in self._cache:
            self._cache["restart_row_id"] = restart_row_id(self.match_len)
        return self._cache["restart_row_id"]

    def device_bytes(self) -> int:
        """Bytes of the device tables built so far."""
        total = 0
        seen = set()  # seq_tables shares the padded dfa_next
        for entry in self._cache.values():
            for leaf in entry if isinstance(entry, tuple) else (entry,):
                if isinstance(leaf, torch.Tensor) and id(leaf) not in seen:
                    seen.add(id(leaf))
                    total += leaf.nbytes
        return total


class _Matcher:
    kind: str = AC
    is_map: bool = False

    def __init__(
        self,
        keywords: Iterable[str],
        case_sensitive: bool = True,
        *,
        values: Optional[Iterable] = None,
        word_chars: Optional[np.ndarray] = None,
        engine: str = "auto",
        device=None,
        thresholder=None,
    ) -> None:
        if engine not in ("auto", "device", "gold"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.device = _resolve_device(device)
        self.compiled = compile_matcher(
            keywords,
            self.kind,
            case_sensitive,
            values=values if self.is_map else None,
            word_chars=word_chars,
            thresholder=thresholder,
        )
        if engine == "device":
            _require_device_path(self.compiled, self.kind)
        self.dev = _DeviceTables(self.compiled, self.device)

    # ------------------------------------------------------------------ #

    def _classes(self, text: str) -> np.ndarray:
        units = chartables.to_utf16_units(text)
        return self.compiled.charmap[units]

    def _pick_engine(self, n_units: int) -> str:
        if not _device_capable(self.compiled, self.kind):
            return "gold"
        if self.engine != "auto":
            return self.engine
        return "device" if n_units >= _AUTO_DEVICE_MIN_UNITS else "gold"

    def match_triples(self, text: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All matches as (starts, ends, value_ids) numpy arrays, in the
        reference's emission order."""
        return self._match_triples_impl(text, self._classes(text))

    def _match_triples_impl(self, text: str, cls: np.ndarray):
        engine = self._pick_engine(len(cls))
        self.last_stats = ScanStats(units=len(cls), engine=engine, kind=self.kind)
        if len(cls) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        with timed(self.last_stats):
            if engine == "gold":
                if self.compiled.is_row_compressed and self.kind in (AC, LONGEST, SHORTEST):
                    # Row-compressed dictionaries skip the per-char Python
                    # gold loop: one cursor feed (the sequential-scan kernel
                    # over the two-level table, then numpy emit expansion) is
                    # exact for any text (core/stream.py).
                    trip = stream.make_cursor(
                        self.compiled, self.device, self.dev, "gold").feed(cls, is_final=True)
                else:
                    trip = gold.gold_match(self.compiled, text)
                if not trip:
                    z = np.zeros(0, dtype=np.int64)
                    out = z, z, z.copy()
                else:
                    a = np.asarray(trip, dtype=np.int64)
                    out = a[:, 0], a[:, 1], a[:, 2]
            else:
                out = self._device_triples(cls)
        self.last_stats.matches = int(len(out[0]))
        return out

    def _device_triples(self, cls: np.ndarray):
        raise NotImplementedError

    def count(self, text: str) -> int:
        starts, _, _ = self.match_triples(text)
        return int(len(starts))

    def device_table_bytes(self) -> int:
        """Device bytes of the tables uploaded so far (0 before the first
        device scan).  Shortest matchers include their internal AC
        automaton's once it is built."""
        total = self.dev.device_bytes()
        inner = self.__dict__.get("_ac_cache")
        if inner is not None:
            total += inner.device_table_bytes()
        return total

    def host_table_bytes(self) -> int:
        """Host bytes of the compiled form(s): shortest matchers add their
        internal AC automaton's once it is built."""
        total = self.compiled.memory_bytes()
        inner = self.__dict__.get("_ac_cache")
        if inner is not None:
            total += inner.host_table_bytes()
        return total

    def _deliver(self, text: str, listener, starts, ends, vals):
        values = self.compiled.values
        sl = np.asarray(starts).tolist()
        el = np.asarray(ends).tolist()
        if self.is_map:
            vl = np.asarray(vals).tolist()
            for s, e, v in zip(sl, el, vl):
                if listener(text, s, e, values[v]) is False:
                    return
        else:
            for s, e in zip(sl, el):
                if listener(text, s, e) is False:
                    return

    # Listener-mode scans of haystacks longer than this are chunked through
    # the stream cursor so a False return stops the scan after the current
    # chunk — the reference breaks its scan loop on False
    # (AhoCorasickSet.java:223-225).  Chunks grow geometrically from
    # _LISTENER_CHUNK_MIN so a listener that stops on the first match scans
    # KiBs, not MiBs, while full scans reach the big chunk within 3 feeds.
    _LISTENER_CHUNK = 1 << 20
    _LISTENER_CHUNK_MIN = 1 << 14

    def match(self, haystack: str, listener: Optional[Callable] = None):
        """Reference ``match``: deliver to a listener, or return the list."""
        if listener is not None:
            if self._listener_chunkable(haystack):
                return self._match_chunked(haystack, listener)
            starts, ends, vals = self.match_triples(haystack)
            self._deliver(haystack, listener, starts, ends, vals)
            return None
        starts, ends, vals = self.match_triples(haystack)
        sl = np.asarray(starts).tolist()
        el = np.asarray(ends).tolist()
        if self.is_map:
            values = self.compiled.values
            vl = np.asarray(vals).tolist()
            return [(s, e, values[v]) for s, e, v in zip(sl, el, vl)]
        return list(zip(sl, el))

    def _listener_chunkable(self, haystack: str) -> bool:
        # Every kind's stream cursor rides the device kernels, so chunked
        # delivery costs nothing and a False listener saves the unscanned
        # suffix.  Dictionaries without a device path pick "gold" here and
        # keep the full-scan path.  The gate is in UTF-16 UNITS: astral code
        # points count twice, so texts near the threshold measure their exact
        # unit length.
        n = len(haystack)
        if 2 * n <= self._LISTENER_CHUNK:
            return False  # cannot reach the gate even if all astral
        if n <= self._LISTENER_CHUNK:
            n = len(chartables.to_utf16_units(haystack))
        return n > self._LISTENER_CHUNK and self._pick_engine(n) == "device"

    def _match_chunked(self, haystack: str, listener) -> None:
        """Chunk-at-a-time listener delivery; stops reading on False.

        Delivery order is identical to the full-scan path: each kind's
        stream cursor finalizes matches in the batch emission order, and
        chunk outputs are consecutive."""
        scanner = self._stream_scanner(self._LISTENER_CHUNK)
        values = self.compiled.values
        n = len(haystack)
        self.last_stats = ScanStats(units=0, engine="device", kind=self.kind)
        delivered = 0
        with timed(self.last_stats):
            i = 0
            chunk = min(self._LISTENER_CHUNK_MIN, self._LISTENER_CHUNK)
            while i < n:
                piece = haystack[i : i + chunk]
                i += len(piece)
                chunk = min(chunk * 4, self._LISTENER_CHUNK)
                starts, ends, vals = scanner.feed_arrays(piece, is_final=i >= n)
                # Cursor offsets are UTF-16 units (ScanStats contract);
                # code-point slicing only drives the chunk loop.
                self.last_stats.units = scanner.cursor.off
                sl = np.asarray(starts).tolist()
                el = np.asarray(ends).tolist()
                if self.is_map:
                    vl = np.asarray(vals).tolist()
                    for s, e, v in zip(sl, el, vl):
                        delivered += 1
                        if listener(haystack, s, e, values[v]) is False:
                            self.last_stats.matches = delivered
                            return None
                else:
                    for s, e in zip(sl, el):
                        delivered += 1
                        if listener(haystack, s, e) is False:
                            self.last_stats.matches = delivered
                            return None
        self.last_stats.matches = delivered
        return None

    # ------------------------------ streaming ------------------------------ #

    def match_stream(self, source, listener: Optional[Callable] = None, *, chunk_units=None):
        """Scan an unbounded stream (file-like ``read(n)`` or str iterable).

        Output equals String-mode ``match`` with global UTF-16 offsets, for
        any chunking (see ``core/stream.py``).  With a listener
        (``(start, end[, value]) -> bool``), matches are delivered as they
        finalize and a ``False`` return stops reading; otherwise the full
        list is returned."""
        scanner = self._stream_scanner(chunk_units)
        values = self.compiled.values
        if listener is None:
            if self.is_map:
                return [(s, e, values[v]) for s, e, v in scanner.scan(source)]
            return [(s, e) for s, e, _ in scanner.scan(source)]
        for s, e, v in scanner.scan(source):
            res = listener(s, e, values[v]) if self.is_map else listener(s, e)
            if res is False:
                break
        return None

    def stream(self, chunk_units=None):
        """A push-mode scanner: ``feed(text, is_final)`` returns finalized
        global matches — ``(start, end)`` for sets, ``(start, end, value)``
        for maps; ``state_dict()``/``load_state_dict()`` persist the cursor
        across processes (resumable scans)."""
        return _MatcherStream(self._stream_scanner(chunk_units), self.is_map)

    def _stream_scanner(self, chunk_units):
        """Streaming scanner wired to this matcher's device and device
        tables, so large feeds take the same kernels as batch mode
        (exactness: ``core/stream._CandidateSource``)."""
        return stream.StreamScanner(self.compiled, chunk_units, device=self.device,
                                    dev=self.dev, engine=self.engine, ac=self._stream_ac())

    def _stream_ac(self):
        return None

    def match_readable(self, source, listener: Callable, *, chunk_units=None):
        """Reference ``StringMap.match(Readable, ReadableMatchListener)``:
        the listener receives values only (``StringMap.java:6``,
        ``ReadableMatchListener.java:4-9``); ``False`` stops the run."""
        if not self.is_map:
            raise TypeError("match_readable is a map-matcher API (values-only)")
        scanner = self._stream_scanner(chunk_units)
        values = self.compiled.values
        for _, _, v in scanner.scan(source):
            if listener(values[v]) is False:
                break
        return None

    # ----------------------------- persistence ----------------------------- #

    def save(self, path) -> None:
        """Persist the compiled automaton (``core/artifact.py`` npz, which
        either package loads)."""
        artifact.save(self.compiled, path)

    @classmethod
    def from_compiled(cls, compiled: CompiledMatcher, engine: str = "auto",
                      device=None):
        """Wrap an existing or loaded ``CompiledMatcher`` without recompiling."""
        if engine not in ("auto", "device", "gold"):
            raise ValueError(f"unknown engine {engine!r}")
        if compiled.kind != cls.kind or (compiled.values is not None) != cls.is_map:
            raise ValueError(
                f"artifact is kind={compiled.kind!r} "
                f"{'map' if compiled.values is not None else 'set'}; "
                f"expected {cls.kind!r} {'map' if cls.is_map else 'set'}"
            )
        if engine == "device":
            _require_device_path(compiled, cls.kind)
        if engine == "device" and cls.kind == SHORTEST and compiled.is_row_compressed:
            # _device_capable answers True for SHORTEST by delegating to the
            # internal AC automaton, which an artifact without it cannot
            # rebuild (no keyword source); only the host path remains.
            raise ValueError(
                "row-compressed shortest artifact has no device path (no "
                "keyword source for the internal AC automaton); use "
                "engine='auto' or 'gold'"
            )
        self = cls.__new__(cls)
        self.engine = engine
        self.device = _resolve_device(device)
        self.compiled = compiled
        self.dev = _DeviceTables(compiled, self.device)
        return self


class _PfacEngine(_Matcher):
    """All-candidates scan: END-indexed emit planes (or the hotstate plane of
    a huge dictionary) from the kernel ``ops/dispatch.planes_plan`` picks,
    hot positions compacted on the device, native extraction.

    ``device_engine`` keeps the JAX package's cross-check knob: ``"rowdfa"``
    (the default) and ``"batched"`` take the picked engine (the packed-scan
    kernels for a dictionary that packs inline), ``"batched2"`` the stride-2
    kernels wherever their table fits (``ops/scan_rowdfa.fits``), for counts
    and planes alike (the dispatcher's ``force``; the benchmark harness
    times the picked count kernel under ``"pfac2"``).  ``"pfac2"`` takes the
    failureless trie walk over ranked tables (``ops/scan_pfac2.py``): its
    START-indexed planes are extracted on the host (``emit.ac_matches``),
    ``_end_planes`` answers None, Longest and Shortest resolve its
    candidates, and ``AhoCorasickSet.count`` counts its triples, each as the
    JAX package's branch does.  Every name gives the same output; any other
    value raises at scan time."""

    device_engine = "rowdfa"
    # name -> the dispatcher's ``force``, or _PFAC_WALK: no planes plan at all
    _DEVICE_ENGINES = {"rowdfa": None, "batched": None, "batched2": "rowdfa2",
                       "pfac2": _PFAC_WALK}

    def _engine(self):
        """``device_engine``'s entry of ``_DEVICE_ENGINES``."""
        if self.device_engine not in self._DEVICE_ENGINES:
            raise ValueError(
                f"unknown device_engine {self.device_engine!r}; expected one of "
                f"{tuple(self._DEVICE_ENGINES)}")
        return self._DEVICE_ENGINES[self.device_engine]

    def _force(self):
        """The dispatcher's ``force`` for ``device_engine``: the picked plan
        under the PFAC walk (the one the benchmark harness times)."""
        engine = self._engine()
        return None if engine is _PFAC_WALK else engine

    def _candidates(self, cls: np.ndarray):
        planes = self._end_planes(cls)
        if planes is None:
            return self._candidates_pfac2(cls)
        bits, layout = planes
        return scan_batched.ac_matches_batched(self.compiled, cls, bits, layout=layout)

    def _end_planes(self, cls: np.ndarray):
        """``(bits, layout)`` on the device: END-indexed emit planes
        ``uint32[P, >=len(cls)]`` with layout ``"planes"``, or the packed
        (state, count) plane with layout ``"hotstate"`` (huge dictionaries).
        None under ``device_engine="pfac2"``, whose walk emits START-indexed
        planes."""
        force = self._engine()
        if force is _PFAC_WALK:
            return None
        plan = dispatch.planes_plan(self.compiled, self.dev, force)
        bits = plan.fn(plan.tables, self._windows(cls, plan.halo))
        return bits, ("hotstate" if plan.which == "hotstate" else "planes")

    def _candidates_pfac2(self, cls: np.ndarray):
        """AC triples from the pfac2 walk: depth bucketed as the JAX
        package's, lanes padded to ``LANE_BUCKET``, the planes extracted on
        the host."""
        m = self.compiled
        rt = self.dev.ranked
        d = bucket_depth(m.max_depth)
        cls_p = scan_batched.classes_to_device(
            scan_pfac2.pad_classes(cls, d, bucket=LANE_BUCKET), m.num_classes, self.device)
        bits = scan_pfac2.pfac2_bitplanes(
            rt.trie_next, rt.prefix, rt.match_threshold, cls_p, d, (d + 31) // 32, rt.prefix_k,
            m.num_classes, rt.dead_state)
        return emit.ac_matches(m, cls, scan_batched.to_host(bits))

    def _windows(self, cls: np.ndarray, halo: int) -> torch.Tensor:
        """``chunk_classes`` windows, uploaded narrow (uint8 or uint16)."""
        nc = self.compiled.num_classes
        w = scan_batched.chunk_classes(cls, _BATCH_CHUNK, halo, nc)
        return scan_batched.classes_to_device(w, nc, self.device)


class AhoCorasickSet(_PfacEngine):
    """All occurrences of all keywords, overlapping (reference ``AhoCorasickSet``)."""

    kind = AC

    def _device_triples(self, cls):
        return self._candidates(cls)

    def count(self, text: str) -> int:
        """Total match count.  On the device this is a fused count kernel
        (emit-mask popcounts, or the emit counts of a huge dictionary's
        count-packed table, summed on the device): one scalar downloaded,
        no extraction."""
        cls = self._classes(text)
        engine = self._pick_engine(len(cls))
        if engine != "device" or len(cls) == 0 or self._engine() is _PFAC_WALK:
            return int(len(self._match_triples_impl(text, cls)[0]))
        self.last_stats = ScanStats(units=len(cls), engine=engine, kind=self.kind)
        with timed(self.last_stats):
            n = int(self._device_count(cls))
        self.last_stats.matches = n
        return n

    def _device_count(self, cls: np.ndarray):
        plan = dispatch.count_plan(self.compiled, self.dev, self._force())
        return plan.fn(plan.tables, self._windows(cls, plan.halo))


class AhoCorasickMap(AhoCorasickSet):
    kind = AC
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class LongestMatchSet(_PfacEngine):
    """Leftmost-longest non-overlapping (reference ``LongestMatchSet``):
    the planes kernel, then the fused native extract-and-resolve."""

    kind = LONGEST

    def _device_triples(self, cls):
        planes = self._end_planes(cls)
        if planes is None:
            return resolve_longest(*self._candidates(cls))
        bits, layout = planes
        return emit.resolve_end_planes(self.compiled, cls, bits, "longest", layout=layout)


class LongestMatchMap(LongestMatchSet):
    kind = LONGEST
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class WholeWordMatchSet(_PfacEngine):
    """Whole-word-only matches (reference ``WholeWordMatchSet``).

    Device path: pure-word-char keywords match a whole word iff they occur
    as an AC substring with non-word (or text-edge) characters on both
    sides, so the AC candidates from the planes kernel go through the
    JAX package's vectorized boundary filter."""

    kind = WHOLE_WORD

    def __init__(self, keywords, case_sensitive=True, *, word_chars=None, toggle_flags=None, **kw):
        word_chars = _resolve_word_chars(word_chars, toggle_flags)
        super().__init__(keywords, case_sensitive, word_chars=word_chars, **kw)

    def _device_triples(self, cls):
        return boundary_filter(self.compiled.class_is_word, cls, *self._candidates(cls))


class WholeWordMatchMap(WholeWordMatchSet):
    kind = WHOLE_WORD
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class ShortestMatchSet(_Matcher):
    """Leftmost-shortest non-overlapping (reference ``ShortestMatchSet``).

    The reference's lagged restart loop is sequential, so the device path
    scans a plain AC automaton over the insert-surviving keywords
    (``compiler.shortest_survivors``) with the planes kernel and runs the
    exact min-end greedy resolve on the host.  ``save`` bundles that
    internal AC automaton into the one npz; an artifact loaded without it
    takes the sequential restart scan (``ops/scan_dfa``, dense tables) or
    the host path.
    """

    kind = SHORTEST

    def __init__(self, keywords, case_sensitive: bool = True, **kw):
        keywords = list(keywords)
        if kw.get("values") is not None:
            kw["values"] = list(kw["values"])
        super().__init__(keywords, case_sensitive, **kw)
        self._src = (keywords, kw.get("values"), case_sensitive, kw.get("thresholder"))
        self._ac_cache = None
        self._cls_map = None
        if self.engine == "device":
            _require_device_path(self._ac.compiled, AC)

    @property
    def _ac(self):
        """Internal AC matcher over the insert-surviving keywords, on the
        same device (built lazily); None for ``from_compiled`` artifacts
        without one."""
        if self.__dict__.get("_ac_cache") is not None:
            return self._ac_cache
        src = self.__dict__.get("_src")
        if src is None:
            return None
        kws, vals, case_sensitive, thresholder = src
        skws, svals = shortest_survivors(kws, case_sensitive, vals)
        if self.is_map:
            self._ac_cache = AhoCorasickMap(skws, svals, case_sensitive,
                                            thresholder=thresholder, device=self.device)
        else:
            self._ac_cache = AhoCorasickSet(skws, case_sensitive,
                                            thresholder=thresholder, device=self.device)
        # The charmaps normally coincide; remap classes if they ever diverge.
        self._cls_map = _build_cls_map(self.compiled, self._ac_cache.compiled)
        return self._ac_cache

    def _ac_classes(self, cls: np.ndarray) -> np.ndarray:
        """Shortest-charmap classes -> internal-AC-charmap classes."""
        return cls if self._cls_map is None else self._cls_map[cls]

    def save(self, path) -> None:
        """Persist the compiled automaton and the internal AC automaton in
        one npz (``artifact.save(..., ac=)``), for any target: path, bytes
        path or file-like."""
        ac = self._ac
        artifact.save(self.compiled, path, ac=ac.compiled if ac is not None else None)

    @classmethod
    def from_compiled(cls, compiled, engine: str = "auto", device=None, ac_compiled=None):
        """``ac_compiled``: the internal AC automaton saved beside
        ``compiled``; it restores the planes-scan device path."""
        if ac_compiled is None:
            return super().from_compiled(compiled, engine=engine, device=device)
        self = _Matcher.from_compiled.__func__(cls, compiled, "auto", device)
        self._src = None
        ac_cls = AhoCorasickMap if cls.is_map else AhoCorasickSet
        self._ac_cache = ac_cls.from_compiled(ac_compiled, device=self.device)
        self._cls_map = _build_cls_map(compiled, ac_compiled)
        if engine == "device":
            _require_device_path(ac_compiled, AC)
        self.engine = engine
        return self

    def _stream_ac(self):
        """Streaming candidate source: a SUPPLIER of the internal AC
        automaton + class remap, resolved lazily by the cursor only when a
        feed crosses the device threshold — small streams never pay the
        second compile (mirrors ``_pick_engine``'s small-input guard).  None
        for gold matchers; the supplier itself returns None for
        ``from_compiled`` artifacts without their AC automaton (the cursor
        then keeps the sequential restart scan)."""
        if self.engine == "gold":
            return None

        def supplier():
            ac = self._ac
            if ac is None:
                return None
            return (ac.compiled, ac.dev, self._cls_map)

        return supplier

    def _pick_engine(self, n_units: int) -> str:
        if self.engine == "gold":
            return "gold"  # never build the internal AC for gold matchers
        if self.engine == "auto" and n_units < _AUTO_DEVICE_MIN_UNITS:
            return "gold"  # small input: skip the second compile too
        ac = self._ac
        if ac is None:
            if self.compiled.is_row_compressed:
                return "gold"  # artifact without dense tables: host path
            return super()._pick_engine(n_units)
        if not _device_capable(ac.compiled, AC):
            return "gold"
        return "device"

    def _device_triples(self, cls):
        ac = self._ac
        if ac is not None:
            cls = self._ac_classes(cls)
            planes = ac._end_planes(cls)
            if planes is None:
                return resolve_shortest(*ac._candidates(cls))
            bits, layout = planes
            return emit.resolve_end_planes(ac.compiled, cls, bits, "shortest", layout=layout)
        return scan_dfa.shortest_triples(self.compiled, self.dev, cls)


class ShortestMatchMap(ShortestMatchSet):
    kind = SHORTEST
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class WholeWordLongestMatchSet(_Matcher):
    """Whole-word matches that may span separators (reference
    ``WholeWordLongestMatchSet``).

    Device path: the walk outcomes at position 0 and every word start
    (``ops/scan_wwl.py``), downloaded and followed along the restart chain
    on the host (``resolve.wholeword.follow_chain``).  The route is the
    first that applies: the packed scan over the goto closure for
    word-uniform dictionaries (dense or quotient rows); the scan over the
    truncated closure for separator-spanning ones ("New York"), with the
    walks whose die char hit a crossing edge re-run on the host over the
    full trie; else the per-start trie walk.  The JAX package also switches
    dense inputs to a walk from every position (``_WWL_COMPACT_DENSITY``, a
    TPU gather-cost rule); both of its branches feed the same chain
    follower, so the port walks only the chain's lanes."""

    kind = WHOLE_WORD_LONGEST

    def __init__(self, keywords, case_sensitive=True, *, word_chars=None, toggle_flags=None, **kw):
        word_chars = _resolve_word_chars(word_chars, toggle_flags)
        super().__init__(keywords, case_sensitive, word_chars=word_chars, **kw)

    def _device_triples(self, cls):
        m = self.compiled
        compact = scan_wwl.compact_lanes(m, cls)
        if scan_wwl.scan_applicable(m):
            return self._scan_triples(self.dev.wwl_scan, compact, len(cls))
        if scan_wwl.mixed_scan_applicable(m):
            return self._scan_triples(self.dev.wwl_scan_mixed, compact, len(cls))
        return self._walk_triples(compact, len(cls))

    def _scan_triples(self, sc, compact, n: int):
        """The scan route over ``sc`` (``ops/scan_wwl.scan_lane_outcomes``)."""
        arrays = scan_wwl.scan_lane_outcomes(self.compiled, sc, compact)
        return self._chain_from_lanes(arrays, compact[2], compact[3], n)

    def _walk_triples(self, compact, n: int):
        """The per-start trie walk route (any dense dictionary)."""
        arrays = scan_wwl.walk_lane_outcomes(self.compiled, self.dev.wwl_walk, compact,
                                             self.device)
        return self._chain_from_lanes(arrays, compact[2], compact[3], n)

    @staticmethod
    def _chain_from_lanes(arrays, lanes, ws, n: int):
        """Scatter per-lane outcomes to position-indexed arrays and follow
        the restart chain (the JAX matcher's ``_chain_from_lanes``)."""
        pos = [np.zeros(n, dtype=a.dtype) for a in arrays]
        for full, a in zip(pos, arrays):
            full[lanes] = a
        trip = follow_chain(*pos, ws, n)
        if not trip:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        a = np.asarray(trip, dtype=np.int64)
        return a[:, 0], a[:, 1], a[:, 2]


class WholeWordLongestMatchMap(WholeWordLongestMatchSet):
    kind = WHOLE_WORD_LONGEST
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class _MatcherStream:
    """Push-mode façade translating value ids to user values (maps)."""

    def __init__(self, scanner, is_map: bool):
        self._scanner = scanner
        self._is_map = is_map
        self._values = scanner.m.values

    def feed(self, text: str, is_final: bool):
        trips = self._scanner.feed(text, is_final)
        if self._is_map:
            return [(s, e, self._values[v]) for s, e, v in trips]
        return [(s, e) for s, e, _ in trips]

    def state_dict(self) -> dict:
        return self._scanner.state_dict()

    def load_state_dict(self, d: dict) -> None:
        self._scanner.load_state_dict(d)


_CLASS_BY_KIND = {
    (cls.kind, cls.is_map): cls
    for cls in (
        AhoCorasickSet, AhoCorasickMap, LongestMatchSet, LongestMatchMap,
        WholeWordMatchSet, WholeWordMatchMap, ShortestMatchSet, ShortestMatchMap,
        WholeWordLongestMatchSet, WholeWordLongestMatchMap,
    )
}


def _build_cls_map(mc: CompiledMatcher, ac: CompiledMatcher):
    """Outer-charmap class -> internal-AC class remap (None when the
    charmaps coincide, the normal case; see ``ShortestMatchSet._ac``)."""
    if np.array_equal(mc.charmap, ac.charmap):
        return None
    M = np.zeros(mc.num_classes, dtype=np.int32)
    M[mc.charmap] = ac.charmap
    return M


def _resolve_word_chars(word_chars, toggle_flags):
    """Reference constructor overloads (``WholeWordMatchSet.java:16-45``)."""
    if word_chars is None:
        return None  # the compiler installs the default table
    if isinstance(word_chars, np.ndarray) and word_chars.dtype == bool:
        return word_chars
    if toggle_flags is not None:
        return chartables.word_chars_with_toggles(word_chars, toggle_flags)
    return chartables.word_chars_from_list(word_chars)


def load_matcher(path, allow_pickle: bool = False, engine: str = "auto", device=None):
    """Load a matcher artifact saved by either package (``core.artifact``
    npz) and wrap it in the port's matcher for its kind.

    Shortest artifacts bundle their internal AC automaton in the npz; older
    saves kept it in a ``<path>.ac`` sidecar, still read for path targets."""
    import os

    compiled, ac_compiled = artifact.load_with_ac(path, allow_pickle=allow_pickle)
    if (compiled.kind == SHORTEST and ac_compiled is None
            and (isinstance(path, (str, bytes)) or hasattr(path, "__fspath__"))):
        sidecar = os.fsdecode(os.fspath(path)) + ".ac"
        if os.path.exists(sidecar):
            ac_compiled = artifact.load(sidecar, allow_pickle=allow_pickle)
    return convert.from_compiled(compiled, engine=engine, device=device,
                                 ac_compiled=ac_compiled)
