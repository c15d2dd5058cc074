"""A/B of the whole-word-longest scan engines: the fused scan against the
scan plane and the die sweep, with the per-start trie walk beside them — the
port of ``tools/probes/probe_wwl_fused.py``.

    python -m ahocorasick_tpu_torch.probes.probe_wwl_fused [--platform gpu|cpu]

Two cases, each at the starts the facade walks (``compact_lanes``: position
0 and every word start, padded to a bucket):

* ``baseline-4``, the JAX probe's: 1,000 ``english_like_keywords`` and three
  Unicode words, the apostrophe a word char, 1 Mi units of word soup;
* ``10k``, the main cell: ``bench.headline``'s 10,000 keywords over 32 Mi
  units (a 1 Mi-unit word soup tiled 32 times).

For each case it prints one JSON line of the case, then one per mode:
``fused`` (``wwl_scan_walks_fused`` over ``chunk_classes_overlap`` windows),
``sweep`` (``wwl_scan_walks``: ``wwl_scan_plane`` then ``wwl_sweep_at`` over
``chunk_classes`` windows) and ``walk`` (``wwl_walks_at``), all on windows and
starts uploaded once.  ``device_ms`` is the card's time per call: the calls
are queued behind a ``torch.cuda._sleep`` long enough for the host to enqueue
them all, then timed with CUDA events, so no host time falls between them;
``call_ms`` is the same calls back to back without the sleep (CUDA events:
host time between calls included when the host is the slower).  Each is the
best of three rounds taken in turns (fused, sweep, walk, then the reverse
order).  Before timing, the fused and the walk's outcomes are held against
the sweep's at every start slot.  ``scan_wwl.FUSED_DEFAULT`` is set from the
``device_ms`` of the first two modes in both cases.

``--platform cpu`` runs the kernels' plain twins on texts cut to 8 Ki units
and reports ``host_ms`` only (no device figures).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ahocorasick_tpu_torch.models.matchers import WholeWordLongestMatchSet, _resolve_device
from ahocorasick_tpu_torch.ops import scan_batched, scan_wwl
from ahocorasick_tpu_torch.utils import chartables

MODES = ("fused", "sweep", "walk")
ROUNDS = 3
# Cycles of torch.cuda._sleep per queued call: enough for the host's time to
# enqueue one call (at about 2 GHz, 200 us), so the card runs the timed calls
# back to back.
_SLEEP_CYCLES_PER_CALL = 400_000


def baseline4(device, units: int = 1 << 20):
    """The JAX probe's configuration (BASELINE config #4's dictionary)."""
    from ahocorasick_tpu_torch.bench.__main__ import english_like_keywords, word_soup

    rng = np.random.default_rng(0)
    wc = chartables.default_word_chars().copy()
    wc[ord("'")] = True
    kws = english_like_keywords(rng, 1000) + ["naïve", "can't", "übermäßig"]
    text = word_soup(rng, kws, units) + " can't naïve übermäßig can'tx"
    m = WholeWordLongestMatchSet(kws, True, word_chars=wc, engine="device", device=device)
    return m, m._classes(text)


def cell_10k(device, units: int = 1 << 25):
    """The 10k keywords of ``bench.headline`` over ``units`` units of word
    soup (a 1 Mi-unit base tiled)."""
    from ahocorasick_tpu_torch.bench.__main__ import word_soup
    from ahocorasick_tpu_torch.bench.headline import N_KEYWORDS, SEED, make_dictionary

    rng = np.random.default_rng(SEED)
    kws = make_dictionary(rng, N_KEYWORDS)
    base_units = min(units, 1 << 20)
    base = word_soup(rng, kws, base_units)[:base_units]
    text = base * (units // base_units)
    m = WholeWordLongestMatchSet(kws, True, engine="device", device=device)
    return m, m._classes(text)


def routes(m, cls):
    """``(calls, info)``: the three engines as calls on inputs uploaded once,
    and the case's shape."""
    comp = m.compiled
    if not scan_wwl.scan_applicable(comp):
        raise ValueError("the A/B needs a dictionary that the pure scan takes")
    sc = m.dev.wwl_scan
    cls_p, starts, lanes, _, d = scan_wwl.compact_lanes(comp, cls)
    if not scan_wwl.fused_applicable(sc, d):
        raise ValueError("the fused scan does not apply to this dictionary")
    dev = sc.outrows.device
    A = sc.num_classes
    st = torch.from_numpy(starts).to(dev)
    wf = scan_batched.classes_to_device(
        scan_wwl.chunk_classes_overlap(cls_p, scan_wwl._CHUNK, d, d + 1, A), A, dev)
    ws = scan_batched.classes_to_device(scan_batched.chunk_classes(cls_p, scan_wwl._CHUNK, d, A),
                                        A, dev)
    walk_cls = scan_batched.classes_to_device(cls_p, comp.num_classes, dev)
    walk_tables = m.dev.wwl_walk
    kw = dict(halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits, num_classes=A, d=d,
              row_layout=sc.row_layout, cross=False)
    calls = {
        "fused": lambda: scan_wwl.wwl_scan_walks_fused(sc.table, sc.outrows, wf, st, **kw),
        "sweep": lambda: scan_wwl.wwl_scan_walks(sc.table, sc.rows_flat, sc.outrows, ws, st,
                                                 quotient=sc.quotient, **kw),
        "walk": lambda: scan_wwl.wwl_walks_at(*walk_tables, walk_cls, st, d,
                                              walk_tables=m.dev.wwl_walk_derived),
    }
    info = {"units": int(len(cls)), "start_slots": int(len(starts)), "lanes": int(len(lanes)),
            "d": int(d), "id_bits": sc.id_bits, "classes": A, "states": comp.num_states,
            "fused_windows": list(wf.shape), "sweep_windows": list(ws.shape),
            "row_layout": sc.row_layout}
    return calls, info


def check(calls, mode: str = "fused") -> int:
    """Largest |mode - sweep| over the outcome arrays (the walk has no
    ``cont``) at every start slot."""
    got, want = calls[mode](), calls["sweep"]()
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _time_calls(fn, reps: int, device, queued: bool) -> float:
    """ms per call of ``reps`` calls: CUDA events on the card (queued behind
    a sleep when ``queued``), the host clock on the CPU."""
    if device.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(_SLEEP_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def ab(m, cls, reps: int = 20) -> tuple:
    """``(info, {mode: record})`` for one case; on the card a record holds
    ``device_ms``, ``call_ms`` and ``gbps`` (2 x units over ``device_ms``), on
    the CPU only ``host_ms`` (the twins).  ``info["max_abs_err"]`` is the
    fused outcomes against the sweep's, ``info["walk_max_abs_err"]`` the
    walk's."""
    calls, info = routes(m, cls)
    info["max_abs_err"] = check(calls)
    info["walk_max_abs_err"] = check(calls, "walk")
    dev = m.dev.wwl_scan.outrows.device
    on_card = dev.type == "cuda"
    keys = (("device_ms", True), ("call_ms", False)) if on_card else (("host_ms", False),)
    for fn in calls.values():  # warm-up
        fn()
    best = {mode: {key: float("inf") for key, _ in keys} for mode in MODES}
    for r in range(ROUNDS):
        for mode in (MODES if r % 2 == 0 else MODES[::-1]):
            for key, queued in keys:
                best[mode][key] = min(best[mode][key], _time_calls(calls[mode], reps, dev, queued))
    if on_card:
        for rec in best.values():
            rec["gbps"] = 2 * info["units"] / (rec["device_ms"] * 1e-3) / 1e9
    return info, best


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    args = ap.parse_args(argv)
    device = _resolve_device(None if args.platform == "gpu" else "cpu")
    on_card = device.type == "cuda"
    where = card() if on_card else "cpu (plain twins, host clock)"
    cut = None if on_card else 1 << 13
    cases = (("baseline-4", lambda: baseline4(device, cut or 1 << 20)),
             ("10k", lambda: cell_10k(device, cut or 1 << 25)))
    lines = []
    for config, make in cases:
        m, cls = make()
        info, best = ab(m, cls, reps=20 if on_card else 1)
        line = {"probe": "wwl_fused_ab", "config": config, "device": where, **info}
        print(json.dumps(line), flush=True)
        lines.append(line)
        if info["max_abs_err"] or info["walk_max_abs_err"]:
            raise AssertionError(f"{config}: the fused or the walk's outcomes differ from the "
                                 f"sweep's")
        for mode in MODES:
            rec = {"config": config, "mode": mode, **best[mode]}
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    return lines


if __name__ == "__main__":
    main()
