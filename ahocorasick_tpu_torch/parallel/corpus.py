"""Batch corpus scanning: many documents, idempotent retry — the port of
``ahocorasick_tpu/parallel/corpus.py``.

The reference is a synchronous single-call library; its failure story is
"exceptions propagate".  At scale the unit of failure is a document, and
because matchers are pure functions of (tables, text), the correct recovery is
simply to scan the failed document again: bounded idempotent retries.  A
matcher on the CPU then has the gold engine as its terminal fallback (it
shares no state with the failing path).  A matcher on a CUDA device has none:
its kernels' wrappers raise on purpose when a build or a launch fails, and an
answer from the host would hide that, so the last failure propagates (the JAX
module falls back to gold on every device).

``scan_corpus`` returns per-document match lists in input order plus a
``CorpusStats``; document offsets are the caller's business (documents are
independent: unlike one long stream, there is nothing to stitch).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

from ahocorasick_tpu_torch.core import gold


@dataclasses.dataclass
class CorpusStats:
    documents: int = 0
    units: int = 0
    matches: int = 0
    seconds: float = 0.0
    retries: int = 0
    gold_fallbacks: int = 0

    @property
    def gbps(self) -> float:
        return self.units * 2 / self.seconds / 1e9 if self.seconds > 0 else 0.0


def scan_corpus(
    matcher,
    documents: Sequence[str],
    max_retries: int = 2,
    on_result: Optional[Callable[[int, list], None]] = None,
) -> tuple:
    """Scan each document; returns (list of per-document match lists,
    ``CorpusStats``).

    Retries a failed document up to ``max_retries`` times on the configured
    engine.  After that a matcher on the CPU falls back to the sequential
    gold engine and only raises if even the fallback fails; a matcher on a
    CUDA device re-raises the last failure.  ``on_result(doc_index,
    matches)`` streams results as they complete."""
    stats = CorpusStats(documents=len(documents))
    out: List[list] = []
    t0 = time.perf_counter()
    for i, doc in enumerate(documents):
        # UTF-16 units, the package's ScanStats / offset contract (an astral
        # code point counts 2); ASCII documents skip the per-character loop.
        if doc.isascii():
            stats.units += len(doc)
        else:
            stats.units += len(doc) + sum(1 for ch in doc if ord(ch) > 0xFFFF)
        matches = None
        err = None
        for attempt in range(max_retries + 1):
            try:
                matches = matcher.match(doc)
                break
            except KeyboardInterrupt:
                raise
            except Exception as e:  # idempotent: just scan again
                err = e
                if attempt < max_retries:
                    stats.retries += 1  # the last failure retries nowhere
        if matches is None:
            if matcher.device.type != "cpu":
                raise err  # no answer from the host for a matcher on a card
            try:
                trip = gold.gold_match(matcher.compiled, doc)
                values = matcher.compiled.values
                if matcher.is_map:
                    matches = [(s, e, values[v]) for s, e, v in trip]
                else:
                    matches = [(s, e) for s, e, _ in trip]
                stats.gold_fallbacks += 1
            except Exception:
                raise err
        stats.matches += len(matches)
        out.append(matches)
        if on_result is not None:
            on_result(i, matches)
    stats.seconds = time.perf_counter() - t0
    return out, stats
