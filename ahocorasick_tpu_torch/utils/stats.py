"""Per-scan statistics (the port's copy of ``ahocorasick_tpu/utils/stats.py``).

The reference's only observability is test-side ``System.out.println`` of
nanotimes (``SetTest.java:147-189``).  Here every matcher records a
:class:`ScanStats` for its last run (``matcher.last_stats``).  The JAX
module's ``trace()`` wraps ``jax.profiler`` and has no counterpart here yet
(a ``torch.profiler`` wrapper is ROADMAP.md A10).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class ScanStats:
    units: int = 0  # UTF-16 units scanned
    matches: int = 0
    seconds: float = 0.0
    engine: str = ""  # "gold" | "device" | "sharded" | "stream"
    kind: str = ""

    @property
    def bytes_scanned(self) -> int:
        return self.units * 2

    @property
    def gbps(self) -> float:
        return self.bytes_scanned / self.seconds / 1e9 if self.seconds > 0 else 0.0

    @property
    def matches_per_sec(self) -> float:
        return self.matches / self.seconds if self.seconds > 0 else 0.0

    def __str__(self) -> str:
        return (
            f"ScanStats(kind={self.kind}, engine={self.engine}, "
            f"units={self.units}, matches={self.matches}, "
            f"{self.seconds * 1e3:.2f} ms, {self.gbps:.3f} GB/s)"
        )


@contextlib.contextmanager
def timed(stats: ScanStats):
    t0 = time.perf_counter()
    try:
        yield stats
    finally:
        stats.seconds = time.perf_counter() - t0
