"""Benchmark CLI and timing harnesses — the port of ``ahocorasick_tpu/bench``.

    python -m ahocorasick_tpu_torch.bench --kind ac --keywords 10000 --units 1048576
    python -m ahocorasick_tpu_torch.bench --suite baseline
    python -m ahocorasick_tpu_torch.bench.headline

Prints one JSON line per run with ScanStats fields (``__main__.py``).  The
two harnesses here time a matcher's device kernels alone, on inputs uploaded
once: ``ac_kernel_rate`` (the count kernel the dispatcher picks) and
``wwl_kernel_rate`` (the whole-word-longest route the facade takes).  On the
card a timed call is ``reps`` launches between two CUDA events, after a
warm-up, best of 3; on the CPU the same loop runs the kernels' plain twins
under the host clock.  The JAX harnesses roll the windows per rep to defeat
XLA's common-subexpression elimination; eager launches have none, so the
port launches on the same windows.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _elapsed(run, reps: int, device: torch.device) -> float:
    """Seconds of ``reps`` runs: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                run()
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return time.perf_counter() - t0


def _seconds_per_rep(run, reps: int, device: torch.device) -> float:
    """Best of 3 timed calls of ``reps`` runs, after one warm-up run."""
    run()
    return min(_elapsed(run, reps, device) for _ in range(3)) / reps


def _best_pair(time_lo, time_hi, rounds: int = 3, stop=None):
    """Paired differencing: ``(best lo, best hi)`` over ``rounds`` alternating
    timings of a call doing ``hi`` units of work and one doing ``lo``; their
    difference is the time of ``hi - lo`` units with each call's fixed cost
    cancelled.  ``stop(seconds of the last pair)`` may end the rounds early."""
    his, los = [], []
    for _ in range(rounds):
        his.append(time_hi())
        los.append(time_lo())
        if stop is not None and stop(his[-1] + los[-1]):
            break
    return min(los), min(his)


def _reps_for(reps: int, min_units: int, n: int) -> int:
    """``reps``, raised so that a timed call scans at least ``min_units``."""
    return max(reps, -(-min_units // max(n, 1)))


def ac_kernel_rate(m, cls: np.ndarray, reps: int = 8, chunk: int = 512,
                   min_units: int = 128 << 20):
    """Device-resident scan rate of the count kernel the dispatcher picks
    for the matcher (under its ``device_engine``): ``(GB/s, total, which)``,
    GB/s = 2 x units / seconds per scan.

    The windows are uploaded once; ``reps`` scales so that a timed call
    covers at least ``min_units`` units (128 Mi, as in the JAX package), and
    ``total`` is one scan's match count.  Applies to the AC-candidate kinds
    (AC, longest, whole-word, and shortest's internal AC matcher)."""
    from ahocorasick_tpu_torch.ops import dispatch, scan_batched

    reps = _reps_for(reps, min_units, len(cls))
    nc = m.compiled.num_classes
    plan = dispatch.count_plan(m.compiled, m.dev, m._force())
    windows = scan_batched.classes_to_device(
        scan_batched.chunk_classes(cls, chunk, plan.halo, nc), nc, m.device)
    total = int(plan.fn(plan.tables, windows))
    dt = _seconds_per_rep(lambda: plan.fn(plan.tables, windows), reps, windows.device)
    return (len(cls) * 2) / dt / 1e9, total, plan.which


def wwl_kernel_rate(m, cls: np.ndarray, reps: int = 8, min_units: int = None) -> float:
    """Device walk rate (GB/s of text) of the whole-word-longest route the
    facade takes: where a scan table applies, the engine ``scan_walks_auto``
    picks (the fused scan, or the scan plane and the die sweep) at the
    chain's starts, else the per-start trie walk (``wwl_walks_at``).  The
    lanes come from the facade's own setup (``scan_wwl.compact_lanes``), and
    the picked engine's windows are uploaded once (``scan_wwl.scan_windows``);
    ``reps`` scales to ``min_units`` per timed call (by default 64 Mi units
    for the scan route and 16 Mi for the walk, as in the JAX package)."""
    from ahocorasick_tpu_torch.ops import scan_batched, scan_wwl

    comp = m.compiled
    cls_p, starts, _lanes, _ws, d = scan_wwl.compact_lanes(comp, cls)
    starts_d = torch.from_numpy(np.ascontiguousarray(starts, dtype=np.int32)).to(m.device)
    pure = scan_wwl.scan_applicable(comp)
    if pure or scan_wwl.mixed_scan_applicable(comp):
        reps = _reps_for(reps, (64 << 20) if min_units is None else min_units, len(cls))
        sc = m.dev.wwl_scan if pure else m.dev.wwl_scan_mixed
        fused, windows = scan_wwl.scan_windows(sc, cls_p, d)

        def run():
            return scan_wwl.scan_walks_on(sc, fused, windows, starts_d, d, sc.has_cross)
    else:
        reps = _reps_for(reps, (16 << 20) if min_units is None else min_units, len(cls))
        tables, derived = m.dev.wwl_walk, m.dev.wwl_walk_derived
        cls_d = scan_batched.classes_to_device(cls_p, comp.num_classes, m.device)

        def run():
            return scan_wwl.wwl_walks_at(*tables, cls_d, starts_d, d, walk_tables=derived)

    dt = _seconds_per_rep(run, reps, starts_d.device)
    return (len(cls) * 2) / dt / 1e9
