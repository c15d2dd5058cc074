"""The port's benchmark entry points (``ahocorasick_tpu_torch.bench``) against
the JAX package's ``bench`` and the root ``bench.py``, on the CPU at small
sizes: the same generators, the same ``--compare`` output, records with the
JAX package's keys and match counts, the B18 timing harnesses over the
kernels' plain twins, ``trace()``, the scaling records and the headline line.
"""

import json
import os

import numpy as np
import pytest
import torch

import ahocorasick_tpu as jax_pkg
import bench as jax_headline
from ahocorasick_tpu.bench import __main__ as jax_bench
from ahocorasick_tpu_torch import bench as port_bench
from ahocorasick_tpu_torch.bench import __main__ as port_main
from ahocorasick_tpu_torch.bench import headline
from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.utils import stats as port_stats

# The record keys of the JAX package's run_config, main and scaling_bench
# (ahocorasick_tpu/bench/__main__.py).
RUN_CONFIG_KEYS = ("config", "kind", "map", "engine", "keywords", "table_mb", "device_mb",
                   "num_states", "units", "matches", "compile_s", "scan_s", "gbps", "kernel_gbps",
                   "projected_gbps", "projected_scan_gbps", "matches_per_sec")
MAIN_KEYS = ("kind", "map", "engine", "keywords", "table_mb", "device_mb", "num_states",
             "num_classes", "units", "matches", "compile_s", "scan_s", "gbps", "matches_per_sec")
SCALING_KEYS = ("config", "devices", "keywords", "units", "engine", "gbps", "efficiency_vs_1")
LISTENER_KEYS = ("config", "kind", "map", "units", "matches", "scan_s", "gbps", "matches_per_sec")


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generators_equal_jax(seed):
    def rng():
        return np.random.default_rng(seed)

    kws = port_main.english_like_keywords(rng(), 200)
    assert kws == jax_bench.english_like_keywords(rng(), 200)
    assert port_main.english_like_keywords(rng(), 50, 2, 5) == \
        jax_bench.english_like_keywords(rng(), 50, 2, 5)
    soup = port_main.word_soup(rng(), kws, 3001, hit_rate=0.3)
    assert soup == jax_bench.word_soup(rng(), kws, 3001, hit_rate=0.3) and len(soup) == 3001
    words = headline.make_dictionary(rng(), 300)
    assert words == jax_headline.make_dictionary(rng(), 300)
    m = jax_pkg.AhoCorasickSet(words, engine="gold")
    r1, r2 = rng(), rng()
    np.testing.assert_array_equal(headline.make_text_classes(m, words, r1, 5000),
                                  jax_headline.make_text_classes(m, words, r2, 5000))
    assert (headline.SEED, headline.N_KEYWORDS, headline.TEXT_UNITS, headline.BASE_UNITS,
            headline.CHUNK, headline.REFERENCE_GBPS) == (
        jax_headline.SEED, jax_headline.N_KEYWORDS, jax_headline.TEXT_UNITS,
        jax_headline.BASE_UNITS, jax_headline.CHUNK, jax_headline.REFERENCE_GBPS)


# The cases of tests/test_bench_compare.py: (A records, B records or raw B
# text, expected exit status).
_REC = {"config": "c1", "kind": "ac", "map": False, "keywords": 100, "units": 1024,
        "gbps": 1.0, "scan_s": 0.5}
_LONG = {"config": "c", "kind": "longest", "map": False, "keywords": 5, "units": 100}
COMPARE_CASES = {
    "no_regression": ([_REC], [{**_REC, "gbps": 1.05, "scan_s": 0.4}], 0),
    "throughput_regression": ([_REC], [{**_REC, "gbps": 0.9}], 1),
    "unpaired": ([_REC, {**_REC, "config": "only-a"}], [_REC, {**_REC, "config": "only-b"}], 0),
    "non_json_lines": ([_REC], "== side b ==\n" + json.dumps({**_REC, "gbps": 2.0}) + "\n", 0),
    "projected_scan_regression": ([{**_LONG, "projected_scan_gbps": 1.0}],
                                  [{**_LONG, "projected_scan_gbps": 0.5}], 1),
    "projected_scan_ok": ([{**_LONG, "projected_scan_gbps": 1.0}],
                          [{**_LONG, "projected_scan_gbps": 1.01}], 0),
    "memory_columns": ([{**_REC, "table_mb": 100.0, "device_mb": 50.0}],
                       [{**_REC, "table_mb": 120.0, "device_mb": 40.0}], 0),
    "memory_zero_same": ([{**_REC, "device_mb": 0.0}], [{**_REC, "device_mb": 0.0}], 0),
    "memory_zero_grew": ([{**_REC, "device_mb": 0.0}], [{**_REC, "device_mb": 3.0}], 0),
    "scaling": ([{"config": "s", "devices": 1, "gbps": 2.0, "efficiency_vs_1": 1.0},
                 {"config": "s", "devices": 4, "gbps": 7.0, "efficiency_vs_1": 0.875}],
                [{"config": "s", "devices": 1, "gbps": 2.0, "efficiency_vs_1": 1.0},
                 {"config": "s", "devices": 4, "gbps": 6.0, "efficiency_vs_1": 0.75}], 1),
}


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_results_equals_jax(case, package, tmp_path, capsys):
    recs_a, recs_b, status = COMPARE_CASES[case]
    paths = []
    for name, recs in (("a.jsonl", recs_a), ("b.jsonl", recs_b)):
        p = tmp_path / name
        p.write_text(recs if isinstance(recs, str) else
                     "\n".join(json.dumps(r) for r in recs) + "\n")
        paths.append(str(p))
    compare = {"jax": jax_bench.compare_results, "port": port_main.compare_results}
    runs = {}
    for side in ("jax", "port"):
        rc = compare[side](*paths)
        runs[side] = (rc, capsys.readouterr().out)
    assert runs[package][0] == status
    assert runs["port"] == runs["jax"]
    if package == "port":
        with pytest.raises(SystemExit) as exit_info:
            port_main.main(["--compare", *paths])
        assert exit_info.value.code == status
        assert capsys.readouterr().out == runs["jax"][1]


_CONFIGS = [("ac", False), ("ac", True), ("longest", False), ("whole_word", False),
            ("shortest", True), ("whole_word_longest", False)]


@pytest.mark.parametrize("kind, is_map", _CONFIGS,
                         ids=[k + ("_map" if m else "") for k, m in _CONFIGS])
def test_run_config_record_equals_jax_matcher(kind, is_map, capsys):
    rng = np.random.default_rng(3)
    kws = port_main.english_like_keywords(rng, 40, 2, 5)
    text = port_main.word_soup(rng, kws, 3000, hit_rate=0.4)
    rec = port_main.run_config(f"t-{kind}", kind=kind, is_map=is_map, keywords=kws,
                               case_sensitive=True, text=text, reps=1, device="cpu",
                               kernel_min_units=4096, listener_costs=kind == "ac")
    assert tuple(rec) == RUN_CONFIG_KEYS
    cls = jax_pkg.models.matchers._CLASS_BY_KIND[(kind, is_map)]
    args = (kws, list(range(len(kws)))) if is_map else (kws,)
    j = cls(*args, True, engine="gold")
    want = j.count(text)
    if kind == "shortest":
        assert j._ac is not None  # its host bytes count, as on the port's side
    assert (rec["matches"], rec["units"], rec["num_states"], rec["keywords"], rec["table_mb"]) == (
        want, len(text), j.compiled.num_states, len(kws), round(j.host_table_bytes() / 1e6, 1))
    # Rates are rounded to 3 decimals: the CPU twins' round to 0.
    assert rec["engine"] == "device" and want > 0 and rec["kernel_gbps"] is not None
    assert (rec["projected_gbps"] is None) == (kind != "ac")
    assert (rec["projected_scan_gbps"] is None) == (kind == "ac")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    if kind == "ac":
        assert [x["config"] for x in lines] == ["t-ac-listener-empty", "t-ac-listener-" + (
            "value-collect" if is_map else "substr-collect")]
        assert all(tuple(x) == LISTENER_KEYS and x["matches"] == want for x in lines)


@pytest.mark.parametrize("name", ["packed", "rowdfa2", "packedcount"])
def test_ac_kernel_rate_total_equals_count(name):
    kws = ["he", "she", "hers", "his"] if name != "packedcount" else \
        ["a" * i for i in range(1, 40)] + ["the"]
    m = port_matchers.AhoCorasickSet(kws, engine="device", device="cpu")
    if name == "rowdfa2":
        m.device_engine = "batched2"
    text = ("ushers and she said hishers aaaa the " * 80)[:2900]
    before = dict(build.launches)
    gbps, total, which = port_bench.ac_kernel_rate(m, m._classes(text), reps=1,
                                                   min_units=3 * len(text))
    assert build.launches == before  # CPU tensors: the twins, never a kernel
    assert which == name and gbps > 0
    assert total == m.count(text) == jax_pkg.AhoCorasickSet(kws, engine="gold").count(text) > 0


@pytest.mark.parametrize("route", ["scan", "walk"])
def test_wwl_kernel_rate_runs_the_facade_route(route, monkeypatch):
    from ahocorasick_tpu_torch.ops import scan_wwl

    if route == "walk":
        monkeypatch.setattr(scan_wwl, "scan_applicable", lambda m: False)
        monkeypatch.setattr(scan_wwl, "mixed_scan_applicable", lambda m: False)
    calls = []
    for name in ("wwl_scan_walks", "wwl_scan_walks_fused", "wwl_walks_at"):
        real = getattr(scan_wwl, name)
        monkeypatch.setattr(scan_wwl, name,
                            (lambda f, n: lambda *a, **k: calls.append(n) or f(*a, **k))(real, name))
    m = port_matchers.WholeWordLongestMatchSet(["she", "he said", "hers"], engine="device",
                                               device="cpu")
    text = "she said hers and he said she " * 60
    assert port_bench.wwl_kernel_rate(m, m._classes(text), reps=1, min_units=2 * len(text)) > 0
    want = "wwl_walks_at"
    if route == "scan":  # scan_walks_auto's pick
        sc = m.dev.wwl_scan if scan_wwl.scan_applicable(m.compiled) else m.dev.wwl_scan_mixed
        fused = scan_wwl.FUSED_DEFAULT and scan_wwl.fused_applicable(
            sc, scan_wwl.bucket_depth(m.compiled.max_depth))
        want = "wwl_scan_walks_fused" if fused else "wwl_scan_walks"
    assert set(calls) == {want}
    assert len(calls) == 1 + 3 * 2  # a warm-up, then best of 3 calls of 2 reps


def test_main_prints_one_record_with_the_jax_keys_and_a_profile(tmp_path, capsys):
    argv = ["--platform", "cpu", "--keywords", "30", "--units", "2000", "--reps", "1",
            "--kind", "longest", "--seed", "4"]
    port_main.main(argv + ["--profile", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert tuple(rec) == MAIN_KEYS
    rng = np.random.default_rng(4)
    kws = jax_bench.english_like_keywords(rng, 30)
    text = jax_bench.word_soup(rng, kws, 2000)
    j = jax_pkg.LongestMatchSet(kws, True, engine="gold")
    assert (rec["matches"], rec["units"], rec["num_states"], rec["num_classes"]) == (
        j.count(text), 2000, j.compiled.num_states, j.compiled.num_classes)
    assert rec["kind"] == "longest" and rec["engine"] == "device"
    files = os.listdir(tmp_path)
    assert len(files) == 1
    with open(tmp_path / files[0]) as fh:
        assert json.load(fh)["traceEvents"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with port_stats.trace(str(tmp_path / "t")) as log_dir:
        m = port_matchers.AhoCorasickSet(["he", "she"], engine="device", device="cpu")
        assert m.count("ushers she " * 100) == 400
    (name,) = os.listdir(log_dir)
    assert log_dir == str(tmp_path / "t") and name.startswith("trace-") and name.endswith(".json")
    with open(os.path.join(log_dir, name)) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_platform_gpu_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        port_main.main(["--keywords", "10", "--units", "100"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.scaling_bench(10, 100, 1, 0)


def test_scaling_bench_over_four_cpu_devices(capsys):
    port_main.scaling_bench(40, 5000, 1, 0, devices=[torch.device("cpu")] * 4)
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in recs] == [1, 2, 4]
    assert all(tuple(r) == SCALING_KEYS and r["engine"] == "packed" for r in recs)
    assert recs[0]["efficiency_vs_1"] == 1.0 and all(r["gbps"] >= 0 for r in recs)
    assert {r["config"] for r in recs} == {"scaling-40kw-5000u"}


def test_headline_prints_its_line_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_TEXT_UNITS", "8192")
    monkeypatch.setenv("BENCH_BUDGET_S", "1")
    res = headline.measure("cpu")
    # The device-cut windows scan the tiled base exactly as host windows do.
    rng = np.random.default_rng(headline.SEED)
    kws = headline.make_dictionary(rng, headline.N_KEYWORDS)
    m = port_matchers.AhoCorasickSet(kws, engine="device", device="cpu")
    base = headline.make_text_classes(m, kws, rng, 8192)
    assert res["which"] == headline.HEADLINE_ENGINE == "packed"
    assert res["total"] == int(m._device_count(base)) > 0 and res["shape"] == (16, 524)
    headline.main("cpu")
    line = json.loads(capsys.readouterr().out.strip())
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "dfa_scan_throughput" and line["unit"] == "GB/s"
    assert line["value"] >= 0 and res["seconds_per_scan"] > 0
    monkeypatch.setenv("BENCH_TEXT_UNITS", "1000")
    with pytest.raises(ValueError, match="multiple"):
        headline.measure("cpu")


# --------------------------------------------- the "auto" thresholds

@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warmed"])
@pytest.mark.parametrize("n_keywords", [10, 100, 2000])
def test_auto_threshold_is_one_warm_constant(n_keywords, warm):
    """One threshold for every table size, fresh or warmed: repeated calls
    just over it take the device every time (a 2,000-keyword table is over
    1 MiB, where the first-call break-even is 32 Ki units)."""
    thr = port_matchers._AUTO_DEVICE_MIN_UNITS
    assert thr == 1 << 11
    rng = np.random.default_rng(n_keywords)
    kws = port_main.english_like_keywords(rng, n_keywords)
    p = port_matchers.AhoCorasickSet(kws, device="cpu")
    g = jax_pkg.AhoCorasickSet(kws, engine="gold")
    text = port_main.word_soup(rng, kws, 4 * thr, hit_rate=0.3)
    if warm:
        assert p.count(text) == g.count(text) and p.last_stats.engine == "device"
    assert p.device_table_bytes() == (p.dev.packed_dfa.table.nbytes if warm else 0)
    for n, engine in ((thr - 1, "gold"), (thr, "device"), (thr, "device"), (thr + 1, "device")):
        assert p.count(text[:n]) == g.count(text[:n])
        assert p.last_stats.engine == engine


@pytest.mark.parametrize("name", ["AhoCorasickSet", "LongestMatchSet", "ShortestMatchSet",
                                  "WholeWordMatchSet", "WholeWordLongestMatchSet", "mid_table"])
def test_auto_outputs_are_equal_on_both_sides_of_the_threshold(name):
    rng = np.random.default_rng(8)
    if name == "mid_table":  # a table over 1 MiB
        kws, name = port_main.english_like_keywords(rng, 2000), "AhoCorasickSet"
    else:
        kws = port_main.english_like_keywords(rng, 30, 2, 5)
    p = getattr(port_matchers, name)(kws, device="cpu")
    g = getattr(jax_pkg, name)(kws, engine="gold")
    thr = port_matchers._AUTO_DEVICE_MIN_UNITS
    text = port_main.word_soup(rng, kws, thr, hit_rate=0.3)
    for n, engine in ((thr - 1, "gold"), (thr, "device")):
        assert p.match(text[:n]) == g.match(text[:n]) != []
        assert p.last_stats.engine == engine
    assert p.count(text) == g.count(text) and p.last_stats.engine == "device"


def test_stream_threshold_outputs_are_equal_on_both_sides():
    from ahocorasick_tpu_torch.core import stream as port_stream

    rng = np.random.default_rng(9)
    kws = port_main.english_like_keywords(rng, 30, 2, 5)
    p = port_matchers.AhoCorasickSet(kws, device="cpu")
    thr = port_stream._STREAM_DEVICE_MIN
    src = port_stream._CandidateSource(p.compiled, "cpu", p.dev, "auto")
    assert (src._use_device(thr - 1), src._use_device(thr)) == (False, True)
    text = port_main.word_soup(rng, kws, 3 * thr, hit_rate=0.3)
    s, out = p.stream(), []
    i = 0
    for k in (thr - 1, thr, thr + 1):
        out += s.feed(text[i: i + k], i + k >= len(text))
        i += k
    assert out == jax_pkg.AhoCorasickSet(kws, engine="gold").match(text) != []
