"""Per-scan statistics (the port's copy of ``ahocorasick_tpu/utils/stats.py``).

The reference's only observability is test-side ``System.out.println`` of
nanotimes (``SetTest.java:147-189``).  Here every matcher records a
:class:`ScanStats` for its last run (``matcher.last_stats``), and
:func:`trace` captures a ``torch.profiler`` trace of a block (the JAX
module's wraps ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
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


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/ahocorasick_tpu_torch_trace"):
    """Capture a ``torch.profiler`` trace of the block: host activity always,
    the CUDA kernels too when a card is present.  On exit a Chrome trace
    (view with Perfetto or ``chrome://tracing``) is written under
    ``log_dir`` as ``trace-<pid>-<ns>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
