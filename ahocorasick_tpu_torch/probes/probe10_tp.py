"""The table-sharded scan against the replicated one on one card — the port
of ``tools/probes/probe10_tp.py``.

The table-sharded form trades throughput for device memory: every step
reads the row shard that owns the state.  On one card (a model mesh of one
device) this measures the form's cost against the replicated count kernel,
the number behind the claim that it is slower whenever the table fits:

* the replicated rate: ``bench.ac_kernel_rate(m, cls, reps=4)`` (the count
  kernel the dispatcher picks, CUDA events);
* the table-sharded rate: ``parallel/sharding.TableShardedScanner`` and
  ``_table_sharded_build`` in its count mode, over windows uploaded once,
  ``reps = 8`` launches of ``kernels/table_sharded.table_sharded_scan`` a
  timed call, best of 3 by CUDA events (the JAX file timed its reps inside
  one jit for the same reason: no host work charged to one side only).

It keeps the JAX assertion that the timed call's count is ``total * reps``,
and times nothing of the group form (``chip_smoke.py`` times
``group_scan``).  Left out: the JAX file's ``sys.path`` line.  The records
print unrounded.

    python -m ahocorasick_tpu_torch.probes.probe10_tp [--platform gpu|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ahocorasick_tpu_torch.bench import _elapsed, ac_kernel_rate
from ahocorasick_tpu_torch.bench.__main__ import english_like_keywords, word_soup
from ahocorasick_tpu_torch.kernels import table_sharded
from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet, _resolve_device
from ahocorasick_tpu_torch.ops import scan_batched
from ahocorasick_tpu_torch.parallel import sharding

REPS = 8


def main(device=None, keywords: int = 10_000, units: int = 1 << 23, min_units: int = 128 << 20
         ) -> dict:
    """``{"records": [...], "total", "warm"}``: the printed records, one
    scan's count and the timed call's (``total * REPS``, or it raises).
    ``min_units``: ``ac_kernel_rate``'s units a timed call (its reps scale up
    to them; small for the CPU twins)."""
    dev = _resolve_device(device)
    records = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        records.append(rec)

    rng = np.random.default_rng(0)
    kws = english_like_keywords(rng, keywords)
    m = AhoCorasickSet(kws, engine="device", device=dev)
    text = word_soup(rng, kws, units)  # 8 Mi units: scan >> dispatch
    cls = m._classes(text)

    # Replicated-scan reference (the production engine's fused count).
    kernel_gbps, total, which = ac_kernel_rate(m, cls, reps=4, min_units=min_units)
    emit({"probe": "tp_rate", "engine": which, "replicated_kernel_gbps": kernel_gbps})

    ts = sharding.TableShardedScanner(m, sharding.model_mesh([dev]))
    mode = "count" if ts.layout == "planes" else "count_packed"
    tables, run, A = sharding._table_sharded_build(ts._table, ts._halo, ts._sb, ts.mesh, mode)
    windows = scan_batched.chunk_classes(cls, ts.chunk, ts._halo, A)
    if run(tables, windows) != total:
        raise AssertionError("the table-sharded scan's count differs from the replicated one's")
    wdev = scan_batched.classes_to_device(windows, A, dev)  # uploaded once

    def reps_tp():
        tot = table_sharded.table_sharded_scan(tables[0], wdev, ts._halo, ts._sb, mode)
        for _ in range(1, REPS):
            tot = tot + table_sharded.table_sharded_scan(tables[0], wdev, ts._halo, ts._sb, mode)
        return tot

    warm = int(reps_tp())
    assert warm == total * REPS, (warm, total, REPS)
    best = min(_elapsed(reps_tp, 1, dev) for _ in range(3))
    gbps = len(cls) * 2 * REPS / best / 1e9
    emit({"layout": ts.layout, "tp_count_gbps": gbps, "tp_vs_replicated": gbps / kernel_gbps,
          "scan_s": best / REPS})
    return {"records": records, "total": total, "warm": warm}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m ahocorasick_tpu_torch.probes.probe10_tp")
    ap.add_argument("--platform", choices=("auto", "gpu", "cpu"), default="auto")
    ap.add_argument("--keywords", type=int, default=10_000)
    ap.add_argument("--units", type=int, default=1 << 23)
    a = ap.parse_args()
    cpu = a.platform == "cpu"
    main("cpu" if cpu else None, a.keywords, a.units, a.units if cpu else 128 << 20)
