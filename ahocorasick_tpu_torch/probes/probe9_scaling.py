"""Bound the multi-device scaling claim with what one card can measure —
the port of ``tools/probes/probe9_scaling.py``.

Only one card is attached, so the cross-device collective cannot be timed
here; what can be measured and bounded:

  T_scan  — a shard's scan: the count kernel ``ops/dispatch.count_plan``
            picks, over windows uploaded once;
  T_wrap  — what the data-parallel counter (``parallel/sharding.
            make_sharded_counter`` on a one-device mesh) adds per scan:
            T_sharded - T_scan, its host work, per-shard windows and sums;
  T_coll  — the collective between devices (a halo exchange and a count
            sum): not measurable on one card.  The records keep the JAX key
            ``assumed_ici_us`` so that they line up with the JAX file's; on
            this card it stands for the NCCL / NVLink collective.  The one
            measured point: NCCL's all_reduce at world 1 took 0.05-0.25 ms
            on the card (``PERF.md`` §7).

The implied efficiency at N devices (weak scaling, a fixed shard):
``eff = T_scan / (T_scan + T_wrap + T_coll)``, printed for assumed
collective latencies of 1, 10, 100 and 1,000 us.  Each time is the
difference of reps 10 and 2 over 8 (``bench._best_pair``, 3 rounds), each
call timed on the host clock to a result on the host, as the JAX file
timed both.  The records print unrounded.

    python -m ahocorasick_tpu_torch.probes.probe9_scaling [--units N] [--keywords N]
        [--platform gpu|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ahocorasick_tpu_torch.bench import _best_pair
from ahocorasick_tpu_torch.bench.__main__ import english_like_keywords, word_soup
from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet, _resolve_device
from ahocorasick_tpu_torch.ops import dispatch, scan_batched
from ahocorasick_tpu_torch.parallel import sharding

LO, HI = 2, 10
ASSUMED_US = (1, 10, 100, 1000)


def _seconds(run) -> float:
    t0 = time.perf_counter()
    int(run())
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    """``{"records": [...], "scan_count", "sharded_count"}``: the printed
    records, and one scan's count through each path (equal, or it
    raises)."""
    p = argparse.ArgumentParser(prog="python -m ahocorasick_tpu_torch.probes.probe9_scaling")
    p.add_argument("--units", type=int, default=1 << 24)
    p.add_argument("--keywords", type=int, default=10_000)
    p.add_argument("--platform", choices=("auto", "gpu", "cpu"), default="auto")
    args = p.parse_args(argv)
    dev = _resolve_device("cpu" if args.platform == "cpu" else None)
    print(f"devices: [{dev}]", flush=True)
    records = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        records.append(rec)

    rng = np.random.default_rng(0)
    kws = english_like_keywords(rng, args.keywords)
    m = AhoCorasickSet(kws, engine="device", device=dev)
    text = word_soup(rng, kws, args.units)  # one shard's slice
    cls = m._classes(text)

    # --- local path: the picked count kernel on windows uploaded once ----
    nc = m.compiled.num_classes
    plan = dispatch.count_plan(m.compiled, m.dev)
    wdev = scan_batched.classes_to_device(
        scan_batched.chunk_classes(cls, 512, plan.halo, nc), nc, dev)

    def local(reps):
        tot = plan.fn(plan.tables, wdev)
        for _ in range(1, reps):
            tot = tot + plan.fn(plan.tables, wdev)
        return tot

    scan_count = int(local(1))
    int(local(LO))
    int(local(HI))
    t_lo, t_hi = _best_pair(lambda: _seconds(lambda: local(LO)),
                            lambda: _seconds(lambda: local(HI)))
    t_scan = (t_hi - t_lo) / (HI - LO)
    emit({"which": plan.which, "t_scan_ms": t_scan * 1e3,
          "gbps": len(cls) * 2 / t_scan / 1e9})

    # --- the data-parallel counter on a one-device mesh -------------------
    prepare, count, engine = sharding.make_sharded_counter(m, sharding.data_mesh([dev]))
    x = prepare(cls)
    sharded_count = count(x, reps=1)
    if sharded_count != scan_count:
        raise AssertionError(f"the sharded count {sharded_count} != one scan's {scan_count}")
    count(x, reps=LO)
    count(x, reps=HI)
    s_lo, s_hi = _best_pair(lambda: _seconds(lambda: count(x, reps=LO)),
                            lambda: _seconds(lambda: count(x, reps=HI)))
    t_sharded = (s_hi - s_lo) / (HI - LO)
    t_wrap = t_sharded - t_scan
    emit({"sharded_engine": engine, "t_sharded_ms": t_sharded * 1e3,
          "t_wrap_ms": t_wrap * 1e3})

    for us in ASSUMED_US:
        eff = t_scan / (t_scan + max(t_wrap, 0) + us * 1e-6)
        emit({"assumed_ici_us": us, "implied_weak_scaling_eff": eff})
    return {"records": records, "scan_count": scan_count, "sharded_count": sharded_count}


if __name__ == "__main__":
    main()
