"""``python -m ahocorasick_tpu_torch.bench``: the port of
``python -m ahocorasick_tpu.bench``.

One configuration (``--kind``, ``--keywords``, ``--units``, ...), the
``BASELINE.json`` suite (``--suite baseline``), the scaling record over the
visible CUDA devices (``--scaling``), or an A/B comparison of two result files
(``--compare A B``); each run prints JSON lines with the JAX package's
record keys, so ``--compare`` pairs the two packages' records alike.
``--platform`` is ``gpu`` (the default; a machine without a card raises) or
``cpu`` (the kernels' plain twins); ``--profile DIR`` writes a
``torch.profiler`` trace of one more scan (``utils/stats.trace``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ahocorasick_tpu_torch.core.compiler import KINDS


def english_like_keywords(rng: np.random.Generator, n: int, lo=3, hi=13) -> list:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = set()
    while len(out) < n:
        out.add("".join(rng.choice(letters, size=int(rng.integers(lo, hi)))))
    return sorted(out)


_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def word_soup(rng: np.random.Generator, keywords: list, n_units: int, hit_rate=0.1) -> str:
    """The JAX package's word soup, the same text from the same generator
    state: a filler word's letters are drawn as ``rng.integers(0, 26,
    size)``, the draw its ``rng.choice`` of 26 letters makes, and indexed
    from a byte table (2.4x faster)."""
    pieces = []
    total = 0
    kw = list(rng.choice(keywords, size=min(512, len(keywords))))
    # total counts a trailing separator join never appends, so require one
    # extra unit: the joined text is then always >= n_units long.
    while total < n_units + 1:
        if rng.random() < hit_rate:
            w = kw[int(rng.integers(len(kw)))]
        else:
            w = _LETTERS[rng.integers(0, 26, size=int(rng.integers(3, 11)))].tobytes().decode()
        pieces.append(w)
        total += len(w) + 1
    return " ".join(pieces)[:n_units]


def _upload_bytes_per_unit(compiled) -> int:
    """Host->device class bytes per text unit (scan_batched.class_dtype)."""
    from ahocorasick_tpu_torch.ops import scan_batched

    return int(np.dtype(scan_batched.class_dtype(compiled.num_classes)).itemsize)


def run_config(label: str, *, kind: str, is_map: bool, keywords: list,
               case_sensitive: bool, text: str, reps: int = 3,
               engine: str = "device", word_chars=None,
               listener_costs: bool = False, device=None,
               kernel_min_units: int = None) -> dict:
    """Build one matcher on ``device`` (CUDA by default), scan one text,
    return the stats record.  ``kernel_min_units`` is the kernel harnesses'
    ``min_units`` (their own default when None)."""
    from ahocorasick_tpu_torch.bench import ac_kernel_rate, wwl_kernel_rate
    from ahocorasick_tpu_torch.models import matchers

    cls = matchers._CLASS_BY_KIND[(kind, is_map)]
    kwargs = {"engine": engine, "device": device}
    if word_chars is not None:
        kwargs["word_chars"] = word_chars
    harness = {} if kernel_min_units is None else {"min_units": kernel_min_units}
    t0 = time.perf_counter()
    if is_map:
        m = cls(keywords, list(range(len(keywords))), case_sensitive, **kwargs)
    else:
        m = cls(keywords, case_sensitive, **kwargs)
    compile_s = time.perf_counter() - t0

    m.count(text)  # warmup: tables built and uploaded
    best = None
    for _ in range(reps):
        m.count(text)
        s = m.last_stats
        if best is None or s.seconds < best.seconds:
            best = s

    kernel_gbps = None
    projected_gbps = None
    projected_scan_gbps = None
    if kind in ("ac", "longest", "whole_word", "shortest") and engine == "device":
        # Shortest rides its internal AC automaton over the insert-surviving
        # keywords (candidates-then-resolve); that is the kernel to time.
        target = m._ac if kind == "shortest" else m
        kernel_gbps, _, _ = ac_kernel_rate(target, target._classes(text), reps=max(4, reps),
                                           **harness)
        # Projected end-to-end GB/s: kernel time + class upload per scan
        # (uint8 / uint16 per unit over PCIe, 8 GB/s conservative).  For the
        # resolved and filtered kinds the host extract / resolve / filter
        # step is not in this model, so the field is named for the scan.
        up = _upload_bytes_per_unit(target.compiled)
        ns_per_unit = up / 8 + 2 / kernel_gbps  # upload + kernel, ns
        if kind == "ac":
            projected_gbps = 2 / ns_per_unit
        else:
            projected_scan_gbps = 2 / ns_per_unit
    elif kind == "whole_word_longest" and engine == "device":
        kernel_gbps = wwl_kernel_rate(m, m._classes(text), reps=max(4, reps), **harness)
        up = _upload_bytes_per_unit(m.compiled)
        projected_scan_gbps = 2 / (up / 8 + 2 / kernel_gbps)
    if listener_costs:
        listener_cost_records(label, m, text, reps)
    return {
        "config": label,
        "kind": kind,
        "map": is_map,
        "engine": best.engine,
        "keywords": len(keywords),
        # The reference README's memory column (README.md:135,148-150): host
        # compiled-form bytes (with the shortest kinds' internal AC), and the
        # device tables uploaded for this scan (built lazily, hence post-run).
        "table_mb": round(m.host_table_bytes() / 1e6, 1),
        "device_mb": round(m.device_table_bytes() / 1e6, 1),
        "num_states": m.compiled.num_states,
        "units": best.units,
        "matches": best.matches,
        "compile_s": round(compile_s, 3),
        "scan_s": round(best.seconds, 6),
        "gbps": round(best.gbps, 3),
        "kernel_gbps": round(kernel_gbps, 3) if kernel_gbps is not None else None,
        "projected_gbps": round(projected_gbps, 3) if projected_gbps is not None else None,
        "projected_scan_gbps": (round(projected_scan_gbps, 3)
                                if projected_scan_gbps is not None else None),
        "matches_per_sec": round(best.matches_per_sec, 1),
    }


def listener_cost_records(label: str, m, text: str, reps: int) -> None:
    """The reference's three benchmark columns (README.md:133-150): empty
    listener, substring-collecting listener, value-collecting listener
    (maps).  Times full ``match`` calls — scan, extraction and delivery."""
    variants = ["empty", "value-collect" if m.is_map else "substr-collect"]

    for name in variants:
        calls = [0]
        acc: list = []
        if m.is_map:
            if name == "empty":
                def listener(t, s, e, v, _c=calls):
                    _c[0] += 1
                    return True
            else:
                def listener(t, s, e, v, _c=calls, _a=acc):
                    _c[0] += 1
                    _a.append(v)
                    return True
        else:
            if name == "empty":
                def listener(t, s, e, _c=calls):
                    _c[0] += 1
                    return True
            else:
                def listener(t, s, e, _c=calls, _a=acc):
                    _c[0] += 1
                    _a.append(t[s:e])
                    return True
        best = None
        n_matches = 0
        for _ in range(max(reps, 2)):
            calls[0] = 0
            acc.clear()
            t0 = time.perf_counter()
            m.match(text, listener)
            dt = time.perf_counter() - t0
            n_matches = max(n_matches, calls[0])
            best = dt if best is None else min(best, dt)
        print(json.dumps({
            "config": f"{label}-listener-{name}",
            "kind": m.kind,
            "map": m.is_map,
            "units": len(text),
            "matches": n_matches,
            "scan_s": round(best, 6),
            "gbps": round(len(text) * 2 / best / 1e9, 3),
            "matches_per_sec": round(n_matches / best, 1) if best else 0.0,
        }))


def baseline_suite(full: bool, reps: int, seed: int, device=None) -> None:
    """The BASELINE.json configurations at the JAX package's sizes: 1, 2, 3
    (longest, shortest and the match-dense AC), 4, 7 and 6; 5 (the 1M
    dictionary) only with ``full``, which also runs config 2 on 50 Mi
    units."""
    from ahocorasick_tpu_torch.utils import chartables

    rng = np.random.default_rng(seed)
    run = lambda label, **kw: print(json.dumps(run_config(label, device=device, **kw)))

    # 1: 100 ASCII keywords, case-sensitive English-like text (8 Mi units, so
    # fixed dispatch costs do not mask the small dictionary's throughput).
    kws = english_like_keywords(rng, 100)
    run("baseline-1-small-set", kind="ac", is_map=False, keywords=kws, case_sensitive=True,
        text=word_soup(rng, kws, 1 << 23), reps=reps, listener_costs=True)

    # 2: 10k-keyword map, case-insensitive folding, 100 MB corpus (8 Mi units
    # unless full).
    kws = english_like_keywords(rng, 10_000)
    units = (50 << 20) if full else (1 << 23)
    run("baseline-2-map-folded", kind="ac", is_map=True, keywords=kws, case_sensitive=False,
        text=word_soup(rng, kws, units).upper(), reps=reps, listener_costs=True)

    # 3: longest + shortest, 100k keywords, adversarial overlap text; then
    # the raw AC kind on the same text, tens of millions of candidate spans
    # (match-dense delivery through extraction and the listeners).
    kws = english_like_keywords(rng, 100_000)
    adversarial = ("a" * 28 + "b") * ((1 << 21) // 29) + word_soup(rng, kws, 1 << 21)
    kws3 = kws + ["a" * i for i in range(1, 9)]
    for kind in ("longest", "shortest"):
        run(f"baseline-3-{kind}-adversarial", kind=kind, is_map=False, keywords=kws3,
            case_sensitive=True, text=adversarial, reps=reps)
    run("baseline-3-ac-matchdense", kind="ac", is_map=False, keywords=kws3,
        case_sensitive=True, text=adversarial, reps=reps, listener_costs=True)

    # 4: whole-word longest, Unicode word chars with custom overrides.
    wc = chartables.default_word_chars().copy()
    wc[ord("'")] = True  # custom override: apostrophes are word chars
    kws4 = english_like_keywords(rng, 1000) + ["naïve", "can't", "übermäßig"]
    text4 = word_soup(rng, kws4, 1 << 20) + " can't naïve übermäßig can'tx"
    run("baseline-4-wholeword-unicode", kind="whole_word_longest", is_map=False,
        keywords=kws4, case_sensitive=True, text=text4, reps=reps, word_chars=wc,
        listener_costs=True)

    # 5: 1M-keyword dictionary (one device's shard of the multi-host config).
    if full:
        kws = english_like_keywords(rng, 1_000_000)
        run("baseline-5-1m-keywords", kind="ac", is_map=False, keywords=kws,
            case_sensitive=True, text=word_soup(rng, kws, 1 << 22), reps=max(1, reps - 1))
    else:
        print(json.dumps({"config": "baseline-5-1m-keywords",
                          "skipped": "pass --full (compile ~1 min, large upload)"}))

    # 7: separator-spanning whole-word-longest ("New York"-style phrases
    # among pure words, custom word chars): the truncated-closure scan.
    base7 = english_like_keywords(rng, 950)
    phrases = [f"{a} {b}" for a, b in zip(base7[:50], base7[50:100])]
    kws7 = base7 + phrases
    run("baseline-7-wwl-mixed", kind="whole_word_longest", is_map=False, keywords=kws7,
        case_sensitive=True, text=word_soup(rng, kws7, 1 << 20), reps=reps, word_chars=wc)

    # 6: wide-alphabet full node (the reference's testFullNode extreme,
    # SetTest.java:73-79): ~54 Ki single-character keywords compile to a
    # row-compressed automaton whose quotient DFA (2 rows) the device scans.
    kws6 = [chr(c) for c in range(32, 0xD800)]
    text6 = "".join(chr(int(x)) for x in rng.integers(32, 0xD800, size=1 << 20))
    run("baseline-6-fullnode-quotient", kind="ac", is_map=False, keywords=kws6,
        case_sensitive=True, text=text6, reps=reps)


def scaling_bench(keywords_n: int, units: int, reps: int, seed: int, devices=None) -> None:
    """Bytes/s scaling efficiency across the devices (the visible CUDA
    devices by default; one on a one-card machine): the sharded counter on
    the first 1, 2 and all of them, one record each."""
    from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet
    from ahocorasick_tpu_torch.parallel import sharding

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devices:
        raise RuntimeError("no CUDA device for the scaling bench; pass devices=")
    rng = np.random.default_rng(seed)
    keywords = english_like_keywords(rng, keywords_n)
    m = AhoCorasickSet(keywords, engine="device", device=devices[0])
    text = word_soup(rng, keywords, units)
    cls = m._classes(text)

    sizes = sorted({1, 2, len(devices)} & set(range(1, len(devices) + 1)))
    rate1 = None
    for n in sizes:
        prepare, count, engine = sharding.make_sharded_counter(m, devices[:n])
        x = prepare(cls)
        int(count(x, reps=1))  # tables and kernels loaded; correctness path
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            int(count(x, reps=reps))
            best = min(best, time.perf_counter() - t0)
        rate = units * 2 * reps / best / 1e9
        if rate1 is None:
            rate1 = rate
        print(json.dumps({
            # Workload identity: --compare pairs records by these fields, so
            # scaling runs of different workloads must not pair up.
            "config": f"scaling-{keywords_n}kw-{units}u",
            "devices": n,
            "keywords": keywords_n,
            "units": units,
            "engine": engine,
            "gbps": round(rate, 3),
            "efficiency_vs_1": round(rate / (rate1 * n), 3),
        }))


def compare_results(path_a: str, path_b: str) -> int:
    """A/B compare two bench result files (JSON lines; reference
    ``bin/test-branches:1-18`` analog — there the two sides are git
    branches; here they are result files produced by any two states).

    Records pair up by their identity fields (config/kind/map/keywords/
    units/devices); each shared numeric metric prints a delta and ratio.
    Exit status 1 if any throughput metric regressed by more than 5%.
    """
    # "engine" is deliberately not part of record identity: records must
    # pair up across commits even when the engine pick changed.
    _IDENT = ("config", "kind", "map", "keywords", "units", "devices")
    _HIGHER_IS_BETTER = ("gbps", "kernel_gbps", "projected_gbps",
                         "projected_scan_gbps", "matches_per_sec",
                         "efficiency_vs_1")
    _LOWER_IS_BETTER = ("scan_s", "compile_s", "table_mb", "device_mb")

    def load(path):
        recs = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or not line.startswith("{"):
                    continue
                r = json.loads(line)
                key = tuple((k, r[k]) for k in _IDENT if k in r)
                recs[key] = r
        return recs

    a, b = load(path_a), load(path_b)
    regressed = False
    for key in sorted(set(a) & set(b), key=str):
        ra, rb = a[key], b[key]
        label = ra.get("config") or ra.get("kind")
        if "devices" in ra:
            label = f"{label or 'scaling'}@{ra['devices']}dev"
        label = label or str(dict(key))
        for metric in _HIGHER_IS_BETTER + _LOWER_IS_BETTER:
            va, vb = ra.get(metric), rb.get(metric)
            if not isinstance(va, (int, float)) or not isinstance(vb, (int, float)):
                continue
            # Equal zeros (rounded memory columns, gold records) are a wash;
            # 0 -> nonzero only "regresses" when lower is better.
            if va:
                ratio = vb / va
            else:
                ratio = 1.0 if vb == 0 else float("inf")
            better = ratio >= 1.0 if metric in _HIGHER_IS_BETTER else ratio <= 1.0
            mark = "+" if better else "-"
            if metric in _HIGHER_IS_BETTER and ratio < 0.95:
                regressed = True
            print(f"{mark} {label:40s} {metric:16s} "
                  f"{va:>12g} -> {vb:>12g}  ({ratio:.3f}x)")
    only_a, only_b = set(a) - set(b), set(b) - set(a)
    for key in sorted(only_a, key=str):
        print(f"? only in A: {a[key].get('config') or a[key].get('kind')}")
    for key in sorted(only_b, key=str):
        print(f"? only in B: {b[key].get('config') or b[key].get('kind')}")
    return 1 if regressed else 0


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m ahocorasick_tpu_torch.bench")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None,
                   help="A/B compare two bench result files (JSON lines); "
                        "exits 1 on a >5%% throughput regression")
    p.add_argument("--scaling", action="store_true",
                   help="measure bytes/s scaling efficiency over the CUDA devices")
    p.add_argument("--suite", choices=("baseline",), default=None,
                   help="run the BASELINE.json config suite instead of one config")
    p.add_argument("--full", action="store_true",
                   help="suite at full scale (100 MB corpus, 1M keywords)")
    p.add_argument("--kind", choices=KINDS, default="ac")
    p.add_argument("--map", action="store_true", help="map variant (values attached)")
    p.add_argument("--keywords", type=int, default=10_000)
    p.add_argument("--keyword-file", type=str, default=None,
                   help="newline-separated dictionary file (overrides --keywords)")
    p.add_argument("--units", type=int, default=1 << 20, help="text length in UTF-16 units")
    p.add_argument("--engine", choices=("auto", "device", "gold"), default="device")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--case-insensitive", action="store_true")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace of one more scan to this directory")
    p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                   help="gpu (the default) needs a CUDA device; cpu runs the kernels' "
                        "plain twins")
    args = p.parse_args(argv)

    if args.compare:
        raise SystemExit(compare_results(*args.compare))

    if args.platform == "gpu" and not torch.cuda.is_available():
        raise SystemExit("--platform gpu requested but CUDA is not available; "
                         "pass --platform cpu to run the kernels' plain twins")
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")

    if args.scaling:
        devices = None if args.platform == "gpu" else [device]
        scaling_bench(args.keywords, args.units, max(args.reps, 4), args.seed, devices)
        return
    if args.suite == "baseline":
        baseline_suite(args.full, args.reps, args.seed, device)
        return

    from ahocorasick_tpu_torch.models import matchers

    rng = np.random.default_rng(args.seed)
    if args.keyword_file:
        with open(args.keyword_file) as f:
            keywords = [line.strip() for line in f if line.strip()]
    else:
        keywords = english_like_keywords(rng, args.keywords)
    if args.kind.startswith("whole_word"):
        keywords = [k for k in keywords if k]

    cls = matchers._CLASS_BY_KIND[(args.kind, args.map)]
    t0 = time.perf_counter()
    kwargs = dict(engine=args.engine, device=device)
    if args.map:
        m = cls(keywords, list(range(len(keywords))), not args.case_insensitive, **kwargs)
    else:
        m = cls(keywords, not args.case_insensitive, **kwargs)
    compile_s = time.perf_counter() - t0

    text = word_soup(rng, keywords, args.units)

    def run():
        m.count(text)
        return m.last_stats

    run()  # warmup: tables built and uploaded
    best = None
    for _ in range(args.reps):
        s = run()
        if best is None or s.seconds < best.seconds:
            best = s

    if args.profile:
        from ahocorasick_tpu_torch.utils.stats import trace

        with trace(args.profile):
            run()

    print(json.dumps({
        "kind": args.kind,
        "map": args.map,
        "engine": best.engine,
        "keywords": len(keywords),
        "table_mb": round(m.host_table_bytes() / 1e6, 1),
        "device_mb": round(m.device_table_bytes() / 1e6, 1),
        "num_states": m.compiled.num_states,
        "num_classes": m.compiled.num_classes,
        "units": best.units,
        "matches": best.matches,
        "compile_s": round(compile_s, 3),
        "scan_s": round(best.seconds, 6),
        "gbps": round(best.gbps, 3),
        "matches_per_sec": round(best.matches_per_sec, 1),
    }))


if __name__ == "__main__":
    main()
