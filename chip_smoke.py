#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path, ``AhoCorasickSet.count`` / ``.match`` on the
device engine, at ``bench.py``'s configuration: 10,000 seeded keywords over
32 Mi UTF-16 units (64 MiB) of word-soup text.  Phases, each raising on
failure:

1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and power
   limit;
2. build the CUDA kernels from ``ahocorasick_tpu_torch/csrc`` with nvcc;
3. every kernel against its plain PyTorch twin on the card (equal counts,
   bit-identical planes) on seeded dictionaries and shapes, up to the main
   path's 65,536 x 524 windows;
4. the main path through the public classes with launch counters zeroed
   first: count == number of triples, ``match`` == the gold model on 1 Mi
   units, a case-folding map with values == gold, a listener's ``False``
   stops delivery, and every kernel was launched;
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
SOURCE = "ahocorasick_tpu_torch/csrc/packed_scan.cu"
REPLACES = {
    "packed_scan_count": "ahocorasick_tpu/kernels/scan_block.py:152",
    "packed_scan_planes": "ahocorasick_tpu/kernels/scan_block.py:209",
}


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
    from ahocorasick_tpu_torch.kernels import build, scan_block
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
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    def windows(m, cls, chunk):
        pd = m.dev.packed_dfa
        w = scan_batched.chunk_classes(cls, chunk, pd.halo, m.compiled.num_classes)
        if w.dtype == np.uint16:
            return torch.from_numpy(w.view(np.int16)).to(dev).view(torch.uint16)
        return torch.from_numpy(w).to(dev)

    def widen(planes):
        return planes.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    errs = {"packed_scan_count": 0, "packed_scan_planes": 0}

    def check(label, m, cls, chunk):
        pd = m.dev.packed_dfa
        w = windows(m, cls, chunk)
        args = (pd.table, w, pd.halo, pd.state_bits)
        kc = int(scan_block.packed_scan_count(*args))
        pc = int(scan_block.packed_scan_count_plain(*args))
        kp = widen(scan_block.packed_scan_planes(*args))
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
        return kc

    # 3. Kernels vs plain twins on the card.
    print("kernel vs plain twin:")
    rng = np.random.default_rng(SEED)
    for seed in range(3):
        r = np.random.default_rng(seed)
        kws = fuzz_keywords(r, "abcdef", 60, 8)
        m = port.AhoCorasickSet(kws, engine="device", device=dev)
        text = "".join(r.choice(list("abcdefgh "), size=20_000 + 77 * seed))
        check(f"fuzz seed {seed}", m, m._classes(text), 512)
    m = port.AhoCorasickSet(DEMO, engine="device", device=dev)
    demo_text = word_soup(DEMO, rng, 50_000)
    assert check("demo 20 keywords", m, m._classes(demo_text), 512) > 0
    wide_kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
    m = port.AhoCorasickSet(wide_kws, engine="device", device=dev)
    assert m.compiled.num_classes > 256
    wide_text = "".join(chr(0x100 + int(c)) for c in rng.integers(0, 300, size=30_000))
    assert check(">256 classes (uint16)", m, m._classes(wide_text), 512) > 0
    m = port.AhoCorasickSet(["abcabcabcab", "bca", "cab", "a", "cc"], engine="device", device=dev)
    abc_text = "".join(rng.choice(list("abc "), size=9_999))
    assert check("halo 11 > chunk 4", m, m._classes(abc_text), 4) > 0
    check("one window", m, m._classes(abc_text[:300]), 512)

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

    # 4. The main path through the public classes.
    port.reset_launches()
    n = big.count(text)
    starts, ends, vals = big.match_triples(text)
    if n != len(starts) or n <= 0:
        raise AssertionError(f"count {n} != {len(starts)} triples")
    if not (np.all(np.diff(ends) >= 0) and np.all(starts < ends) and ends[-1] <= len(text)):
        raise AssertionError("triples out of order or out of range")
    small = text[:BASE_UNITS]
    gold_set = port.AhoCorasickSet(keywords, engine="gold", device=dev)
    got = big.match(small)
    want = gold_set.match(small)
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
    counts = dict(port.launches)
    print(f"main path: count={n} on {len(text)} units; 1 Mi-unit match == gold "
          f"({len(want)} matches); map == gold; launches {counts}")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path was never launched: {counts}")

    # 5. Times.
    w_full = windows(big, cls, 512)
    args = (pd.table, w_full, pd.halo, pd.state_bits)

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
    }
    for k, (t_kernel, t_plain) in ms.items():
        print(f"time {k} at {tuple(w_full.shape)}: kernel {t_kernel} ms "
              f"({gbps(t_kernel)} GB/s), plain twin {t_plain} ms ({gbps(t_plain)} GB/s) "
              f"[{smi}]")

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

    for label, fn in (("count", lambda: big.count(text)),
                      ("match_triples", lambda: big.match_triples(text))):
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
    sp = stage("compaction + download", lambda: scan_batched.planes_to_sparse(bits, len(c)))
    stage("extraction (ac_matches_batched, compaction included)",
          lambda: scan_batched.ac_matches_batched(big.compiled, c, bits))
    print(f"stages on {len(text)} units ({'sparse' if sp else 'dense'} download, "
          f"{len(sp[0]) if sp else 0} hot positions): "
          + "; ".join(f"{k} {v} s" for k, v in stages.items()) + f" [{smi}]")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": counts[k], "max_abs_err": errs[k],
         "ms": ms[k][0], "plain_ms": ms[k][1]}
        for k in ("packed_scan_count", "packed_scan_planes")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
