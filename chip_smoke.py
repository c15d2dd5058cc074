#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths on the device engine at ``bench.py``'s
configuration, 10,000 seeded keywords over 32 Mi UTF-16 units (64 MiB) of
word-soup text: ``AhoCorasickSet.count`` / ``.match``, and the resolved
kinds ``LongestMatchSet``, ``WholeWordMatchSet``, ``ShortestMatchSet`` and a
map.  Phases, each raising on failure:

1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and power
   limit;
2. build the CUDA kernels from ``ahocorasick_tpu_torch/csrc`` with nvcc;
3. every kernel against its plain PyTorch twin on the card, bit for bit, on
   seeded dictionaries and shapes: the scans up to the main path's
   65,536 x 524 windows, the compaction on every planes tensor they make and
   on synthetic ones, the shortest restart scan on fuzz dictionaries and on
   the 10k dictionary over 64 Ki units;
4. each path through the public classes, its launch counters zeroed just
   before it and read just after: AC count == number of triples; every kind
   ``match`` == its gold matcher on 1 Mi units; 32 Mi-unit triples
   end-ascending (and non-overlapping for the resolved kinds) on the device
   engine; a case-folding map == gold; a listener's ``False`` stops
   delivery; a shortest matcher saved to npz and loaded back, and one
   loaded without its internal AC (the restart-scan kernel), == gold; every
   kernel of a path was launched;
5. times on the card with CUDA events (kernels) and the host clock
   (facade calls), as GB/s = 2 x units / s, the ``bench.py`` definition.

It prints one JSON line of kernel records, then as its last line
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 20260817  # bench.SEED
N_KEYWORDS = 10_000  # bench.N_KEYWORDS
BASE_UNITS = 1 << 20
TEXT_UNITS = 1 << 25  # 32 Mi units = 64 MiB of UTF-16
DEMO = [  # the 20-keyword demo dictionary of __graft_entry__._demo_matcher
    "he", "she", "his", "hers", "the", "then", "them", "there",
    "and", "hand", "sand", "stand", "standard", "art", "start",
    "ten", "tent", "intent", "content", "entropy",
]
KERNELS = {  # name: (source, the TPU kernel or device loop it replaces)
    "packed_scan_count": ("ahocorasick_tpu_torch/csrc/packed_scan.cu",
                          "ahocorasick_tpu/kernels/scan_block.py:152"),
    "packed_scan_planes": ("ahocorasick_tpu_torch/csrc/packed_scan.cu",
                           "ahocorasick_tpu/kernels/scan_block.py:209"),
    "compact_planes": ("ahocorasick_tpu_torch/csrc/compact.cu",
                       "ahocorasick_tpu/ops/scan_batched.py:500"),
    "shortest_states": ("ahocorasick_tpu_torch/csrc/shortest_scan.cu",
                        "ahocorasick_tpu/ops/scan_dfa.py:37"),
}
SHORTEST_TWIN_UNITS = 1 << 16


def word_soup(keywords, rng, n_units: int) -> str:
    """Seeded text: 10% dictionary words, 90% random lowercase noise words
    of 3-10 letters, space-separated (bench.make_text_classes's mix)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    kw_pool = list(rng.choice(keywords, size=512))
    noise_pool = ["".join(rng.choice(letters, size=int(rng.integers(3, 11))))
                  for _ in range(512)]
    k = n_units // 3
    is_kw = rng.random(k) < 0.10
    pick = rng.integers(0, 512, size=k)
    words = [kw_pool[i] if kw else noise_pool[i] for kw, i in zip(is_kw.tolist(), pick.tolist())]
    text = " ".join(words)
    assert len(text) >= n_units
    return text[:n_units]


def fuzz_keywords(rng, alphabet: str, n: int, max_len: int):
    return sorted({"".join(rng.choice(list(alphabet), size=int(rng.integers(1, max_len + 1))))
                   for _ in range(n)})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    import ahocorasick_tpu_torch as port
    from ahocorasick_tpu.core.compiler import compile_matcher
    from ahocorasick_tpu_torch.kernels import build, compact, scan_block, scan_dfa
    from ahocorasick_tpu_torch.ops import scan_batched
    from bench import make_dictionary

    dev = torch.device("cuda")

    # 1. The card.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # 2. Build.
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({path})")
    with open(path[: -len(".so")] + ".log") as fh:
        for line in fh.read().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    def windows(m, cls, chunk):
        pd = m.dev.packed_dfa
        w = scan_batched.chunk_classes(cls, chunk, pd.halo, m.compiled.num_classes)
        return scan_batched.classes_to_device(w, m.compiled.num_classes, dev)

    def widen(planes):
        return planes.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    errs = dict.fromkeys(KERNELS, 0)

    def check_compact(label, bits):
        got = compact.compact_planes(bits)
        want = compact.compact_planes_plain(bits)
        torch.cuda.synchronize()
        k = int(want[0])
        e = abs(int(got[0]) - k)
        if got[1].shape != want[1].shape or got[2].shape != want[2].shape:
            e = max(e, 1)
        elif k:
            e = max(e, int((got[1] - want[1]).abs().max()),
                    int((widen(got[2]) - widen(want[2])).abs().max()))
        errs["compact_planes"] = max(errs["compact_planes"], e)
        print(f"  compact {label}: P={bits.shape[0]} N={bits.shape[1]} hot={int(got[0])} "
              f"twin={k} max_abs_err={e}")
        if e:
            raise AssertionError(f"compact {label}: kernel disagrees with its plain twin")
        return k

    def check(label, m, cls, chunk):
        pd = m.dev.packed_dfa
        w = windows(m, cls, chunk)
        args = (pd.table, w, pd.halo, pd.state_bits)
        kc = int(scan_block.packed_scan_count(*args))
        pc = int(scan_block.packed_scan_count_plain(*args))
        planes = scan_block.packed_scan_planes(*args)
        kp = widen(planes)
        pp = widen(scan_block.packed_scan_planes_plain(*args))
        torch.cuda.synchronize()
        e_count = abs(kc - pc)
        e_planes = int((kp - pp).abs().max())
        errs["packed_scan_count"] = max(errs["packed_scan_count"], e_count)
        errs["packed_scan_planes"] = max(errs["packed_scan_planes"], e_planes)
        print(f"  {label}: B={w.shape[0]} W={w.shape[1]} halo={pd.halo} "
              f"{str(w.dtype).replace('torch.', '')} count={kc} twin={pc} "
              f"planes max_abs_err={e_planes}")
        if e_count or e_planes:
            raise AssertionError(f"{label}: kernel disagrees with its plain twin")
        check_compact(label, planes)
        return kc

    def check_shortest(label, tabs, cls):
        c = scan_batched.classes_to_device(cls, tabs._m.num_classes, dev)
        got = scan_dfa.shortest_states(tabs.dfa_next, tabs.match_len, c)
        t = time.perf_counter()
        want = scan_dfa.shortest_states_plain(tabs.dfa_next, tabs.match_len, c)
        torch.cuda.synchronize()
        t_twin = time.perf_counter() - t
        e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        errs["shortest_states"] = max(errs["shortest_states"], e)
        restarts = int((tabs.match_len[want.to(torch.int64)] > 0).sum())
        print(f"  shortest {label}: N={len(cls)} {str(c.dtype).replace('torch.', '')} "
              f"match states={restarts} max_abs_err={e} (twin {t_twin:.2f} s)")
        if e:
            raise AssertionError(f"shortest {label}: kernel disagrees with its plain twin")
        return restarts

    # 3. Kernels vs plain twins on the card.
    print("kernel vs plain twin:")
    rng = np.random.default_rng(SEED)
    for seed in range(3):
        r = np.random.default_rng(seed)
        kws = fuzz_keywords(r, "abcdef", 60, 8)
        m = port.AhoCorasickSet(kws, engine="device", device=dev)
        text = "".join(r.choice(list("abcdefgh "), size=20_000 + 77 * seed))
        check(f"fuzz seed {seed}", m, m._classes(text), 512)
        sm = compile_matcher(kws[::3], "shortest", True)
        tabs = port.ShortestMatchSet.from_compiled(sm, device=dev).dev
        assert check_shortest(f"fuzz seed {seed}", tabs, sm.charmap[
            np.frombuffer(text[:3000].encode("utf-16-le"), dtype=np.uint16)]) > 0
    m = port.AhoCorasickSet(DEMO, engine="device", device=dev)
    demo_text = word_soup(DEMO, rng, 50_000)
    assert check("demo 20 keywords", m, m._classes(demo_text), 512) > 0
    wide_kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
    m = port.AhoCorasickSet(wide_kws, engine="device", device=dev)
    assert m.compiled.num_classes > 256
    wide_text = "".join(chr(0x100 + int(c)) for c in rng.integers(0, 300, size=30_000))
    assert check(">256 classes (uint16)", m, m._classes(wide_text), 512) > 0
    ws = port.ShortestMatchSet.from_compiled(
        compile_matcher(wide_kws, "shortest", True), device=dev)
    check_shortest(">256 classes (uint16)", ws.dev, ws._classes(wide_text[:2000]))
    m = port.AhoCorasickSet(["abcabcabcab", "bca", "cab", "a", "cc"], engine="device", device=dev)
    abc_text = "".join(rng.choice(list("abc "), size=9_999))
    assert check("halo 11 > chunk 4", m, m._classes(abc_text), 4) > 0
    check("one window", m, m._classes(abc_text[:300]), 512)
    # P = 2 with a ragged tile edge, from its own generator so that the main
    # path's text stays the one earlier runs measured.
    srng = np.random.default_rng(SEED + 1)
    synth = np.zeros((2, 3_000_017), dtype=np.uint32)
    hot = srng.choice(synth.shape[1], size=40_000, replace=False)
    synth[srng.integers(0, 2, size=hot.size), hot] = srng.integers(
        1, 1 << 32, size=hot.size, dtype=np.uint64).astype(np.uint32)
    synth_t = torch.from_numpy(synth.view(np.int32)).to(dev).view(torch.uint32)
    assert check_compact("synthetic P=2", synth_t) == 40_000
    assert check_compact("no bits set", torch.zeros_like(synth_t[:1])) == 0

    keywords = make_dictionary(np.random.default_rng(SEED), N_KEYWORDS)
    big = port.AhoCorasickSet(keywords, engine="device", device=dev)
    base = word_soup(keywords, rng, BASE_UNITS)
    text = base * (TEXT_UNITS // BASE_UNITS)
    cls = big._classes(text)
    pd = big.dev.packed_dfa
    print(f"  10k dictionary: {big.compiled.num_states} states, "
          f"{big.compiled.num_classes} classes (table {tuple(pd.table.shape)}, "
          f"{pd.table.nbytes} B), depth {big.compiled.max_depth}, "
          f"state_bits {pd.state_bits}")
    check("10k keywords x 32 Mi units", big, cls, 512)
    short_compiled = compile_matcher(keywords, "shortest", True)
    restart = port.ShortestMatchSet.from_compiled(short_compiled, engine="device", device=dev)
    short_cls = restart._classes(text[:SHORTEST_TWIN_UNITS])
    check_shortest("10k keywords x 64 Ki units", restart.dev, short_cls)

    # 4. The paths through the public classes, counters zeroed just before
    # each and read just after it.
    small = text[:BASE_UNITS]
    path_launches = {}

    def run_path(label, expected, fn):
        port.reset_launches()
        detail = fn()
        counts = dict(port.launches)
        path_launches[label] = counts
        print(f"path {label}: {detail}; launches {counts}")
        missing = [k for k in expected if counts[k] < 1]
        if missing:
            raise AssertionError(f"path {label}: {missing} never launched: {counts}")

    def resolved_ok(label, m, full_text, gold_m, probe):
        s, e, _ = m.match_triples(full_text)
        if m.last_stats.engine != "device" or len(s) == 0:
            raise AssertionError(f"{label}: engine {m.last_stats.engine}, {len(s)} matches")
        if not (np.all(s < e) and np.all(e[1:] >= e[:-1]) and np.all(s[1:] >= e[:-1])
                and e[-1] <= len(full_text)):
            raise AssertionError(f"{label}: triples overlap or are out of order")
        got, want = m.match(probe), gold_m.match(probe)
        if got != want or not want:
            raise AssertionError(f"{label}: match != gold on {len(probe)} units "
                                 f"({len(got)} vs {len(want)})")
        return f"{len(s)} matches on {len(full_text)} units, {len(want)} == gold on {len(probe)}"

    def ac_path():
        n = big.count(text)
        starts, ends, _ = big.match_triples(text)
        if n != len(starts) or n <= 0:
            raise AssertionError(f"count {n} != {len(starts)} triples")
        if not (np.all(np.diff(ends) >= 0) and np.all(starts < ends) and ends[-1] <= len(text)):
            raise AssertionError("triples out of order or out of range")
        gold_set = port.AhoCorasickSet(keywords, engine="gold", device=dev)
        got, want = big.match(small), gold_set.match(small)
        if got != want or not want:
            raise AssertionError(f"match != gold on 1 Mi units ({len(got)} vs {len(want)})")
        values = [f"v{i}" for i in range(len(keywords))]
        folded = small[: len(small) // 2].upper() + small[len(small) // 2:]
        mp = port.AhoCorasickMap(keywords, values, case_sensitive=False, engine="device", device=dev)
        gold_map = port.AhoCorasickMap(keywords, values, case_sensitive=False, engine="gold", device=dev)
        got_map = mp.match(folded)
        if got_map != gold_map.match(folded) or len(got_map) != len(want):
            raise AssertionError("case-folding map != gold on 1 Mi units")
        calls = []
        big.match(small, lambda t, s, e: calls.append((s, e)) or False)
        if calls != want[:1]:
            raise AssertionError(f"listener False did not stop delivery: {len(calls)} calls")
        return (f"count={n} on {len(text)} units; 1 Mi-unit match == gold ({len(want)} matches); "
                f"map == gold")

    run_path("AhoCorasickSet/Map", ("packed_scan_count", "packed_scan_planes", "compact_planes"),
             ac_path)

    matchers = {}

    def kind_path(cls_name, *args, **kw):
        def drive():
            m = getattr(port, cls_name)(*args, engine="device", device=dev, **kw)
            g = getattr(port, cls_name)(*args, engine="gold", device=dev, **kw)
            matchers[cls_name] = m
            probe = small
            if not kw.get("case_sensitive", True):
                probe = small[: len(small) // 2].upper() + small[len(small) // 2:]
            return resolved_ok(cls_name, m, text, g, probe)
        run_path(cls_name, ("packed_scan_planes", "compact_planes"), drive)

    kind_path("LongestMatchSet", keywords)
    kind_path("WholeWordMatchSet", keywords)
    kind_path("ShortestMatchSet", keywords)
    kind_path("LongestMatchMap", keywords, [f"v{i}" for i in range(len(keywords))],
              case_sensitive=False)

    def shortest_artifacts():
        import io

        buf = io.BytesIO()
        matchers["ShortestMatchSet"].save(buf)
        buf.seek(0)
        loaded = port.load_matcher(buf, engine="device", device=dev)
        if loaded._ac_cache is None:
            raise AssertionError("the npz lost the shortest matcher's internal AC")
        gold_s = port.ShortestMatchSet(keywords, engine="gold", device=dev)
        want = gold_s.match(small)
        if loaded.match(small) != want or loaded.last_stats.engine != "device":
            raise AssertionError("npz-loaded shortest matcher != gold on 1 Mi units")
        got = restart.match(small)
        if got != want or restart.last_stats.engine != "device" or restart._ac is not None:
            raise AssertionError("restart-scan shortest matcher != gold on 1 Mi units")
        return f"npz round trip and restart scan == gold on {len(small)} units ({len(want)} matches)"

    run_path("ShortestMatchSet npz / from_compiled", ("packed_scan_planes", "compact_planes",
                                                      "shortest_states"), shortest_artifacts)
    counts = {k: sum(c[k] for c in path_launches.values()) for k in KERNELS}

    # 5. Times.
    w_full = windows(big, cls, 512)
    args = (pd.table, w_full, pd.halo, pd.state_bits)
    planes_full = scan_block.packed_scan_planes(*args)

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    gbps = lambda ms: 2 * len(text) / (ms * 1e-3) / 1e9
    ms = {
        "packed_scan_count": (cuda_ms(lambda: scan_block.packed_scan_count(*args), 20),
                              cuda_ms(lambda: scan_block.packed_scan_count_plain(*args), 3)),
        "packed_scan_planes": (cuda_ms(lambda: scan_block.packed_scan_planes(*args), 20),
                               cuda_ms(lambda: scan_block.packed_scan_planes_plain(*args), 3)),
        "compact_planes": (cuda_ms(lambda: compact.compact_planes(planes_full), 20),
                           cuda_ms(lambda: compact.compact_planes_plain(planes_full), 5)),
    }
    for k, (t_kernel, t_plain) in ms.items():
        print(f"time {k} at {tuple(w_full.shape)} windows / {tuple(planes_full.shape)} planes: "
              f"kernel {t_kernel} ms ({gbps(t_kernel)} GB/s), plain twin {t_plain} ms "
              f"({gbps(t_plain)} GB/s) [{smi}]")
    rdev = restart.dev
    c_twin = scan_batched.classes_to_device(short_cls, short_compiled.num_classes, dev)
    c_mi = scan_batched.classes_to_device(restart._classes(small), short_compiled.num_classes, dev)
    t_s64 = cuda_ms(lambda: scan_dfa.shortest_states(rdev.dfa_next, rdev.match_len, c_twin), 3)
    t_s1m = cuda_ms(lambda: scan_dfa.shortest_states(rdev.dfa_next, rdev.match_len, c_mi), 2)
    t_p64 = cuda_ms(lambda: scan_dfa.shortest_states_plain(rdev.dfa_next, rdev.match_len, c_twin), 1)
    ms["shortest_states"] = (t_s64, t_p64)
    print(f"time shortest_states: kernel {t_s64} ms on {len(short_cls)} units "
          f"({t_s64 * 1e6 / len(short_cls)} ns/unit), {t_s1m} ms on {len(small)} units "
          f"({t_s1m * 1e6 / len(small)} ns/unit); plain twin {t_p64} ms on {len(short_cls)} "
          f"units ({t_p64 * 1e6 / len(short_cls)} ns/unit) [{smi}]")

    def host_s(fn, reps):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return out

    facade = [("AhoCorasickSet count", lambda: big.count(text)),
              ("AhoCorasickSet match_triples", lambda: big.match_triples(text))]
    facade += [(f"{k} match_triples", (lambda m: lambda: m.match_triples(text))(matchers[k]))
               for k in ("LongestMatchSet", "WholeWordMatchSet", "ShortestMatchSet")]
    for label, fn in facade:
        runs = host_s(fn, 3)
        med = sorted(runs)[1]
        print(f"time facade {label} on {len(text)} units: median {med} s "
              f"({2 * len(text) / med / 1e9} GB/s); runs {runs} [{smi}]")

    # Where the facade's time goes: its stages one by one, each synced.
    stages = {}

    def stage(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[label] = time.perf_counter() - t
        return out

    c = stage("classes (UTF-16 encode + charmap)", lambda: big._classes(text))
    w = stage("windows (chunk_classes)", lambda: scan_batched.chunk_classes(
        c, 512, pd.halo, big.compiled.num_classes))
    wd = stage("upload", lambda: torch.from_numpy(w).to(dev))
    stage("count kernel + scalar download", lambda: int(scan_block.packed_scan_count(
        pd.table, wd, pd.halo, pd.state_bits)))
    bits = stage("planes kernel", lambda: scan_block.packed_scan_planes(
        pd.table, wd, pd.halo, pd.state_bits))
    sp = stage("compaction kernel (compact_planes) + download",
               lambda: scan_batched.planes_to_sparse(bits, len(c)))
    stage("extraction (ac_matches_batched, compaction included)",
          lambda: scan_batched.ac_matches_batched(big.compiled, c, bits))
    print(f"stages on {len(text)} units ({'sparse' if sp else 'dense'} download, "
          f"{len(sp[0]) if sp else 0} hot positions): "
          + "; ".join(f"{k} {v} s" for k, v in stages.items()) + f" [{smi}]")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
         "launches": counts[k], "max_abs_err": errs[k],
         "ms": ms[k][0], "plain_ms": ms[k][1]}
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
