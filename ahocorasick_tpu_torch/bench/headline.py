"""Headline benchmark: the count kernel's DFA-scan throughput on one device
— the port of the repository's root ``bench.py``.

    python -m ahocorasick_tpu_torch.bench.headline

Configuration (BASELINE.json config #2 scale): 10k seeded English-like
keywords (``make_dictionary``, seed 20260817), case-sensitive set matcher,
32 Mi UTF-16 units (64 MiB) of synthetic text in class space, the total
match count summed on the device (the empty-listener analog).  Only a 1 Mi-
unit int16 base is uploaded; it is tiled to the text length and cut into
halo windows on the device (``parallel/sharding._windows_on_device``).  The
kernel the dispatcher picks for this dictionary is timed with CUDA events in
calls of ``lo`` and ``hi`` launches, and the time of one scan is the
difference of the best ``hi`` and the best ``lo`` call over ``hi - lo``,
which cancels each call's fixed cost (``bench.py``'s paired differencing).
``BENCH_TEXT_UNITS`` sets the text length and ``BENCH_BUDGET_S`` (480 s) the
budget that bounds ``hi``.  Prints one JSON line:
``{"metric": "dfa_scan_throughput", "value", "unit": "GB/s", "vs_baseline"}``.

``vs_baseline``: the reference README reports 3.6 us to full-match one
English paragraph with an empty listener (README.md:148, 235,886-word
dictionary, a 2015 JVM); taking a paragraph as about 700 UTF-16 units gives
about 0.39 GB/s, so 0.4 GB/s is the Java reference's throughput.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

REFERENCE_GBPS = 0.4

N_KEYWORDS = 10_000
TEXT_UNITS = 1 << 25  # 32 Mi units = 64 MiB UTF-16
BASE_UNITS = 1 << 20  # host-generated and uploaded; tiled on the device
CHUNK = 512
SEED = 20260817
# The kernel family the dispatcher picks for this dictionary
# (ops/scan_rowdfa.pick_engine): the headline must not silently time another.
HEADLINE_ENGINE = "packed"


def make_dictionary(rng: np.random.Generator, n: int) -> list:
    """``n`` sorted distinct letter-frequency-weighted lowercase keywords of
    3-12 letters: ``bench.py``'s headline dictionary, kept apart from the
    suite's ``english_like_keywords`` so that its identity never drifts."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    freqs = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.2, 0.8, 4.0,
                      2.4, 6.7, 7.5, 1.9, 0.1, 6.0, 6.3, 9.1, 2.8, 1.0, 2.4, 0.2,
                      2.0, 0.1])
    p = freqs / freqs.sum()
    words = set()
    while len(words) < n:
        length = int(rng.integers(3, 13))
        words.add("".join(rng.choice(letters, size=length, p=p)))
    return sorted(words)


def make_text_classes(m, keywords, rng: np.random.Generator, n_units: int) -> np.ndarray:
    """Seeded word soup built directly in class space (``bench.py``'s): the
    dictionary's own class sequences (10% of words, so there are real
    matches) among random in-alphabet noise words, separated by the class of
    ``' '``."""
    sep = int(m.compiled.charmap[ord(" ")])
    out = np.empty(n_units + 16, dtype=np.int32)
    pos = 0
    classes = np.arange(2, m.compiled.num_classes, dtype=np.int32)
    kw_cls = [m.compiled.charmap[np.frombuffer(kw.encode("utf-16-le"), dtype=np.uint16)
                                 .astype(np.int64)]
              for kw in rng.choice(keywords, size=512)]
    noise = [rng.choice(classes, size=int(rng.integers(3, 11))) for _ in range(512)]
    while pos < n_units:
        if rng.random() < 0.10:
            w = kw_cls[int(rng.integers(len(kw_cls)))]
        else:
            w = noise[int(rng.integers(len(noise)))]
        k = min(len(w), n_units + 16 - pos)
        out[pos: pos + k] = w[:k]
        pos += k
        if pos < n_units + 16:
            out[pos] = sep
            pos += 1
    return out[:n_units]


def measure(device=None) -> dict:
    """The headline run on ``device`` (CUDA by default): the JSON line's
    fields under ``"line"``, and the measurement behind them (``which``, one
    scan's ``total``, ``seconds_per_scan``, ``reps`` lo and hi, the windows'
    ``shape``)."""
    from ahocorasick_tpu_torch.bench import _elapsed
    from ahocorasick_tpu_torch.models.matchers import AhoCorasickSet
    from ahocorasick_tpu_torch.ops import dispatch, scan_batched
    from ahocorasick_tpu_torch.parallel import sharding

    t_start = time.perf_counter()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "480"))
    text_units = int(os.environ.get("BENCH_TEXT_UNITS", TEXT_UNITS))
    base_units = min(BASE_UNITS, text_units)
    if text_units % base_units or text_units % CHUNK:
        raise ValueError(f"BENCH_TEXT_UNITS={text_units} must be a multiple of {base_units} "
                         f"and of {CHUNK}")

    rng = np.random.default_rng(SEED)
    keywords = make_dictionary(rng, N_KEYWORDS)
    m = AhoCorasickSet(keywords, engine="device", device=device)
    base = make_text_classes(m, keywords, rng, base_units)

    plan = dispatch.count_plan(m.compiled, m.dev)
    if plan.which != HEADLINE_ENGINE:
        raise AssertionError(f"headline engine changed: {plan.which}, not {HEADLINE_ENGINE}")
    halo = plan.halo
    if halo > CHUNK:
        raise AssertionError(f"halo {halo} exceeds the chunk {CHUNK}")

    base_dev = torch.from_numpy(base.astype(np.int16)).to(m.device)  # 2 MB upload
    tiled = base_dev.repeat(text_units // base_units)  # narrowed as classes_to_device does
    if scan_batched.class_dtype(m.compiled.num_classes) == np.uint8:
        tiled = tiled.to(torch.uint8)
    else:
        tiled = tiled.view(torch.uint16)
    pad = torch.zeros(halo, dtype=tiled.dtype, device=tiled.device)  # PAD_CLASS == 0
    windows = sharding._windows_on_device(torch.cat([pad, tiled]), CHUNK, halo)

    def run():
        return plan.fn(plan.tables, windows)

    # The first scan loads the kernel library and is the correctness guard.
    total = int(run())
    if total <= 0:
        raise AssertionError("benchmark text produced zero matches")

    def timed(reps: int) -> float:
        return _elapsed(run, reps, windows.device)

    lo = 2
    t_lo = timed(lo)
    per_rep_est = max(t_lo / lo, 1e-6)
    remaining = budget_s - (time.perf_counter() - t_start) - 15.0
    hi = lo + int(max(4, min(32, remaining / (3.5 * per_rep_est))))
    t_his, t_los = [], []
    for _ in range(3):
        t_his.append(timed(hi))
        t_los.append(timed(lo))
        if time.perf_counter() - t_start > budget_s - 2.5 * (t_his[-1] + t_los[-1]):
            break
    # The best hi with the best lo (standard differencing).
    dt = (min(t_his) - min(t_los)) / (hi - lo)
    if dt <= 0:  # noise swamped the extra reps: the raw rate
        dt = min(t_his) / hi

    gbps = (text_units * 2) / dt / 1e9
    return {
        "line": {"metric": "dfa_scan_throughput", "value": round(gbps, 3), "unit": "GB/s",
                 "vs_baseline": round(gbps / REFERENCE_GBPS, 2)},
        "which": plan.which, "total": total, "seconds_per_scan": dt, "reps": (lo, hi),
        "shape": tuple(windows.shape),
    }


def main(device=None) -> None:
    print(json.dumps(measure(device)["line"]))


if __name__ == "__main__":
    main()
