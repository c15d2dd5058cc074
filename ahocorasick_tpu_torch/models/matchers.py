"""Public matcher classes of the PyTorch/CUDA port: ``AhoCorasickSet`` and
``AhoCorasickMap`` (the port of ``ahocorasick_tpu/models/matchers.py``'s AC
kind).

Reporting conventions are the reference's: ``end`` is one past the last
matched UTF-16 unit, a listener returning ``False`` stops delivery, and
matches come in the sequential automaton's emission order.  With no
listener, ``match`` returns ``(start, end)`` tuples (sets) or
``(start, end, value)`` (maps).

Engines: ``"device"`` runs the packed-scan kernels on the matcher's torch
device (their plain PyTorch twins when that device is the CPU); ``"gold"``
runs the sequential host model; ``"auto"`` picks gold below
``_AUTO_DEVICE_MIN_UNITS``.  ``device=None`` means CUDA, and the constructor
raises when CUDA is unavailable.

The compiler, gold model, artifact format, native extractor and value
re-walk are the JAX package's host code, imported as they are.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core.compiler import AC, CompiledMatcher, compile_matcher
from ahocorasick_tpu.utils import chartables
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.ops import dispatch, scan_batched

# Input size (UTF-16 units) from which "auto" takes the device.  The JAX
# package derives it per engine from TPU costs; this port uses one constant
# until it is measured on the card (ROADMAP.md A8).
_AUTO_DEVICE_MIN_UNITS = 1 << 14

# Window body length: B = N / C lanes each scan C steps after the halo.
_BATCH_CHUNK = 512


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to scan with the "
            "plain PyTorch twins of the kernels")
    return dev


def _device_capable(compiled: CompiledMatcher) -> bool:
    """Dense AC matchers always have a device table; row-compressed
    (wide-alphabet) ones only when their quotient DFA packs inline."""
    return not compiled.is_row_compressed or scan_batched.quotient_packable(compiled)


class _DeviceTables:
    """Lazy per-matcher cache of the device tables (torch tensors on the
    matcher's device).  Class columns are padded to a power-of-two bucket as
    in the JAX package, so table bytes match it exactly."""

    def __init__(self, m: CompiledMatcher, device: torch.device):
        self._m = m
        self.device = device
        self._cache = {}

    @property
    def packed_dfa(self) -> scan_batched.PackedDfa:
        """Packed goto-closure DFA (quotient rows for row-compressed
        matchers) for the packed-scan kernels."""
        if "packed_dfa" not in self._cache:
            pd = scan_batched.build_packed(self._m)
            self._cache["packed_dfa"] = convert.packed_from_numpy(
                pd.table, pd.state_bits, pd.halo, self._m.num_classes, self.device)
        return self._cache["packed_dfa"]

    def device_bytes(self) -> int:
        """Bytes of the device tables built so far."""
        total = 0
        for entry in self._cache.values():
            for leaf in entry:
                if isinstance(leaf, torch.Tensor):
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
            thresholder=thresholder,
        )
        if engine == "device" and not _device_capable(self.compiled):
            raise ValueError(
                "dictionary is too wide for the device path "
                f"({self.compiled.num_states} states x "
                f"{self.compiled.num_classes} classes); use engine='auto' "
                "or 'gold'"
            )
        self.dev = _DeviceTables(self.compiled, self.device)

    # ------------------------------------------------------------------ #

    def _classes(self, text: str) -> np.ndarray:
        units = chartables.to_utf16_units(text)
        return self.compiled.charmap[units]

    def _pick_engine(self, n_units: int) -> str:
        if not _device_capable(self.compiled):
            return "gold"
        if self.engine != "auto":
            return self.engine
        return "device" if n_units >= _AUTO_DEVICE_MIN_UNITS else "gold"

    def match_triples(self, text: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All matches as (starts, ends, value_ids) numpy arrays, in the
        reference's emission order."""
        return self._match_triples_impl(text, self._classes(text))

    def _match_triples_impl(self, text: str, cls: np.ndarray):
        from ahocorasick_tpu.utils.stats import ScanStats, timed

        engine = self._pick_engine(len(cls))
        self.last_stats = ScanStats(units=len(cls), engine=engine, kind=self.kind)
        if len(cls) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        with timed(self.last_stats):
            if engine == "gold":
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
        device scan)."""
        return self.dev.device_bytes()

    def host_table_bytes(self) -> int:
        """Host bytes of the compiled form."""
        return self.compiled.memory_bytes()

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

    def match(self, haystack: str, listener: Optional[Callable] = None):
        """Reference ``match``: deliver to a listener, or return the list.

        A listener sees the matches of one full scan; the JAX package's
        chunked early-stop scan waits for the stream cursors (ROADMAP.md A5),
        so a ``False`` stops delivery but not the scan."""
        starts, ends, vals = self.match_triples(haystack)
        if listener is not None:
            self._deliver(haystack, listener, starts, ends, vals)
            return None
        sl = np.asarray(starts).tolist()
        el = np.asarray(ends).tolist()
        if self.is_map:
            values = self.compiled.values
            vl = np.asarray(vals).tolist()
            return [(s, e, values[v]) for s, e, v in zip(sl, el, vl)]
        return list(zip(sl, el))

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
        if engine == "device" and not _device_capable(compiled):
            raise ValueError(
                "row-compressed artifact has no device path; use engine='auto' "
                "or 'gold'"
            )
        self = cls.__new__(cls)
        self.engine = engine
        self.device = _resolve_device(device)
        self.compiled = compiled
        self.dev = _DeviceTables(compiled, self.device)
        return self


class _PfacEngine(_Matcher):
    """All-candidates scan: END-indexed emit planes from the packed-scan
    kernel, hot positions compacted on the device, native extraction."""

    def _candidates(self, cls: np.ndarray):
        return scan_batched.ac_matches_batched(self.compiled, cls, self._end_planes(cls))

    def _end_planes(self, cls: np.ndarray):
        """END-indexed emit planes ``uint32[1, >=len(cls)]`` on the device."""
        plan = dispatch.planes_plan(self.compiled, self.dev)
        return plan.fn(plan.tables, self._windows(cls, plan.halo))

    def _windows(self, cls: np.ndarray, halo: int) -> torch.Tensor:
        """``chunk_classes`` windows, uploaded narrow (uint8 or uint16)."""
        w = scan_batched.chunk_classes(cls, _BATCH_CHUNK, halo, self.compiled.num_classes)
        if w.dtype == np.uint16:  # upload through an int16 view: same bits
            return torch.from_numpy(w.view(np.int16)).to(self.device).view(torch.uint16)
        return torch.from_numpy(w).to(self.device)


class AhoCorasickSet(_PfacEngine):
    """All occurrences of all keywords, overlapping (reference ``AhoCorasickSet``)."""

    kind = AC

    def _device_triples(self, cls):
        return self._candidates(cls)

    def count(self, text: str) -> int:
        """Total match count.  On the device this is the fused count kernel:
        popcounts summed on the device, one scalar downloaded, no
        extraction."""
        from ahocorasick_tpu.utils.stats import ScanStats, timed

        cls = self._classes(text)
        engine = self._pick_engine(len(cls))
        if engine != "device" or len(cls) == 0:
            return int(len(self._match_triples_impl(text, cls)[0]))
        self.last_stats = ScanStats(units=len(cls), engine=engine, kind=self.kind)
        with timed(self.last_stats):
            n = int(self._device_count(cls))
        self.last_stats.matches = n
        return n

    def _device_count(self, cls: np.ndarray):
        plan = dispatch.count_plan(self.compiled, self.dev)
        return plan.fn(plan.tables, self._windows(cls, plan.halo))


class AhoCorasickMap(AhoCorasickSet):
    kind = AC
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


_CLASS_BY_KIND = {(AC, False): AhoCorasickSet, (AC, True): AhoCorasickMap}


def load_matcher(path, allow_pickle: bool = False, engine: str = "auto", device=None):
    """Load a matcher artifact saved by either package (``core.artifact``
    npz) and wrap it in the port's matcher for its kind."""
    from ahocorasick_tpu.core import artifact

    compiled = artifact.load(path, allow_pickle=allow_pickle)
    return convert.from_compiled(compiled, engine=engine, device=device)
