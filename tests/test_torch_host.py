"""The port's own host code vs the JAX package's originals, module by module:
the same seeded numpy inputs go through both copies, and since everything
they return is integers, booleans or bytes, every comparison is exact."""

import dataclasses
import hashlib
import io
import os

import numpy as np
import pytest

from ahocorasick_tpu.core import artifact as jax_artifact
from ahocorasick_tpu.core import compiler as jax_compiler
from ahocorasick_tpu.core import gold as jax_gold
from ahocorasick_tpu.native import lib as jax_native
from ahocorasick_tpu.ops import emit as jax_emit
from ahocorasick_tpu.ops import scan_pfac as jax_scan_pfac
from ahocorasick_tpu.ops import scan_pfac2 as jax_scan_pfac2
from ahocorasick_tpu.resolve import parallel as jax_parallel
from ahocorasick_tpu.resolve import queue as jax_queue
from ahocorasick_tpu.resolve import wholeword as jax_wholeword
from ahocorasick_tpu.utils import alloc as jax_alloc
from ahocorasick_tpu.utils import chartables as jax_chartables
from ahocorasick_tpu.utils import lanes as jax_lanes
from ahocorasick_tpu.utils import stats as jax_stats
from ahocorasick_tpu.utils import thresholds as jax_thresholds
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.core import artifact as port_artifact
from ahocorasick_tpu_torch.core import compiler as port_compiler
from ahocorasick_tpu_torch.core import gold as port_gold
from ahocorasick_tpu_torch.native import build as port_native_build
from ahocorasick_tpu_torch.native import lib as port_native
from ahocorasick_tpu_torch.ops import emit as port_emit
from ahocorasick_tpu_torch.ops import scan_dfa as port_scan_dfa
from ahocorasick_tpu_torch.ops import scan_pfac as port_scan_pfac
from ahocorasick_tpu_torch.ops import scan_pfac2 as port_scan_pfac2
from ahocorasick_tpu_torch.resolve import parallel as port_parallel
from ahocorasick_tpu_torch.resolve import queue as port_queue
from ahocorasick_tpu_torch.resolve import wholeword as port_wholeword
from ahocorasick_tpu_torch.utils import alloc as port_alloc
from ahocorasick_tpu_torch.utils import chartables as port_chartables
from ahocorasick_tpu_torch.utils import lanes as port_lanes
from ahocorasick_tpu_torch.utils import stats as port_stats
from ahocorasick_tpu_torch.utils import thresholds as port_thresholds

_CARRIED = {}


def carry(compiled):
    """A reference-compiled automaton as the port's own ``CompiledMatcher``
    (``convert.compiled_from_numpy``), one carried object per original."""
    ent = _CARRIED.get(id(compiled))
    if ent is None or ent[0] is not compiled:
        ent = _CARRIED[id(compiled)] = (
            compiled, convert.compiled_from_numpy(convert.compiled_to_numpy(compiled)))
    return ent[1]


KINDS = ("ac", "longest", "shortest", "whole_word", "whole_word_longest")


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


def _keywords(kind, seed=0, n=60):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdeAB") + ["é", "ß", "\U0001F600"]
    kws = sorted({"".join(rng.choice(alphabet, size=int(rng.integers(1, 8)))) for _ in range(n)})
    if kind == "whole_word_longest":
        kws += ["ab cd", "a b", "de-ab"]
    return kws


def _text(seed=1, n=1500):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("abcdeABéß \U0001F600-,"), size=n))


def _same_field(name, got, want):
    if isinstance(want, jax_compiler.RowTable):
        assert isinstance(got, port_compiler.RowTable), name
        for part in ("rows", "row_id"):
            g, w = getattr(got, part), getattr(want, part)
            assert g.dtype == w.dtype and g.shape == w.shape, (name, part)
            assert g.tobytes() == w.tobytes(), (name, part)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and not isinstance(got, port_compiler.RowTable), name
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
    else:
        assert type(got) is type(want) and got == want, name


def _same_compiled(got, want):
    assert isinstance(got, port_compiler.CompiledMatcher)
    assert isinstance(want, jax_compiler.CompiledMatcher)
    names = [f.name for f in dataclasses.fields(jax_compiler.CompiledMatcher)]
    assert names == [f.name for f in dataclasses.fields(port_compiler.CompiledMatcher)]
    for name in names:
        _same_field(name, getattr(got, name), getattr(want, name))
    assert got.memory_bytes() == want.memory_bytes()
    assert got.is_row_compressed == want.is_row_compressed
    assert got.dead_state == want.dead_state


# ------------------------------------------------------------------- compiler


# A custom thresholder always compiles through the Python path, so the
# row-compressed layout has no native case.
@pytest.mark.parametrize("layout, backend", [("dense", "auto"), ("dense", "python"),
                                             ("rows", "python")])
@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
@pytest.mark.parametrize("kind", KINDS)
def test_compile_matcher_byte_for_byte(kind, is_map, layout, backend):
    kws = _keywords(kind)
    if kind == "whole_word":
        kws = [k for k in kws if "\U0001F600" not in k]
    kw = dict(values=[f"v{i}" for i in range(len(kws))] if is_map else None,
              thresholder=_NeverDense() if layout == "rows" else None, backend=backend)
    want = jax_compiler.compile_matcher(kws, kind, False, **kw)
    got = port_compiler.compile_matcher(kws, kind, False, **kw)
    assert want.is_row_compressed == (layout == "rows")
    _same_compiled(got, want)
    _same_compiled(carry(want), want)


def test_compile_constants_and_errors():
    assert port_compiler.KINDS == jax_compiler.KINDS
    for name in ("AC", "LONGEST", "SHORTEST", "WHOLE_WORD", "WHOLE_WORD_LONGEST",
                 "_DENSE_LIMIT", "DEADCLASS_OTHER", "DEADCLASS_WORD"):
        assert getattr(port_compiler, name) == getattr(jax_compiler, name)
    for mod in (port_compiler, jax_compiler):
        with pytest.raises(ValueError, match="unknown matcher kind"):
            mod.compile_matcher(["a"], "nope", True)
        with pytest.raises(ValueError, match="non-word"):
            mod.compile_matcher(["a b"], "whole_word", True)
        with pytest.raises(ValueError, match="thresholder"):
            mod.compile_matcher(["a"], "ac", True, backend="native", thresholder=_NeverDense())


def test_native_and_python_compilers_agree_in_the_port():
    assert port_native.available()
    for kind in KINDS:
        kws = [k for k in _keywords(kind, seed=3) if kind != "whole_word" or "\U0001F600" not in k]
        a = port_compiler.compile_matcher(kws, kind, True, backend="native")
        b = port_compiler.compile_matcher(kws, kind, True, backend="python")
        for f in dataclasses.fields(port_compiler.CompiledMatcher):
            _same_field(f.name, getattr(a, f.name), getattr(b, f.name))


@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
def test_shortest_survivors_equal(is_map):
    kws = _keywords("shortest", seed=5, n=80)
    vals = list(range(len(kws))) if is_map else None
    for cs in (True, False):
        assert port_compiler.shortest_survivors(kws, cs, vals) == \
            jax_compiler.shortest_survivors(kws, cs, vals)


def test_wide_alphabet_row_compresses_itself():
    kws = [chr(c) for c in range(0x100, 0x100 + 40000)]
    want = jax_compiler.compile_matcher(kws, "ac", True)
    got = port_compiler.compile_matcher(kws, "ac", True)
    assert want.is_row_compressed and isinstance(got.dfa_next, port_compiler.RowTable)
    _same_compiled(got, want)


# ----------------------------------------------------------------- carrying


@pytest.mark.parametrize("layout", ["dense", "rows"])
@pytest.mark.parametrize("kind", KINDS)
def test_compiled_from_numpy_round_trip(kind, layout):
    kws = [k for k in _keywords(kind, seed=7) if kind != "whole_word" or "\U0001F600" not in k]
    ref = jax_compiler.compile_matcher(kws, kind, True, values=list(range(len(kws))),
                                       thresholder=_NeverDense() if layout == "rows" else None)
    fields = convert.compiled_to_numpy(ref)
    if layout == "rows":
        assert set(fields["trie_next"]) == {"rows", "row_id"}
        assert all(not isinstance(v, jax_compiler.RowTable) for v in fields.values())
    got = convert.compiled_from_numpy(fields)
    _same_compiled(got, ref)
    again = convert.compiled_from_numpy(convert.compiled_to_numpy(got))
    _same_compiled(again, ref)
    text = _text(2)
    assert port_gold.gold_match(got, text) == jax_gold.gold_match(ref, text)
    with pytest.raises(ValueError, match="missing"):
        convert.compiled_from_numpy({k: v for k, v in fields.items() if k != "depth"})
    with pytest.raises(ValueError, match="unknown"):
        convert.compiled_from_numpy({**fields, "extra": 1})
    with pytest.raises(ValueError, match="rows"):
        convert.compiled_from_numpy({**fields, "trie_next": {"rows": 1}})


@pytest.mark.parametrize("name", ["AhoCorasickSet", "LongestMatchMap", "WholeWordMatchSet",
                                  "ShortestMatchSet", "WholeWordLongestMatchMap"])
@pytest.mark.parametrize("layout", ["dense", "rows"])
def test_carried_matcher_gives_the_jax_triples(name, layout):
    """A reference-compiled automaton carried through ``compiled_from_numpy``
    gives the port the JAX package's triples on the fuzz text."""
    import ahocorasick_tpu as jax_pkg
    import ahocorasick_tpu_torch as port

    kws = ["ab", "abc", "b", "cab", "de", "e"]
    is_map = name.endswith("Map")
    args = (kws, list(range(len(kws)))) if is_map else (kws,)
    j = getattr(jax_pkg, name)(*args, thresholder=_NeverDense() if layout == "rows" else None)
    p = convert.from_compiled(carry(j.compiled), device="cpu")
    assert type(p).__name__ == name and isinstance(p, getattr(port, name))
    text = _text(3).replace("é", " ").replace("ß", "c")
    want = j.match(text)
    assert p.match(text) == want and len(want) > 20
    assert p.match_stream(io.StringIO(text), chunk_units=37) == want


def test_artifacts_cross_between_the_packages(tmp_path):
    """npz saved by either package loads in the other, pickled values too,
    and no class of either package ends up inside the pickle."""
    class Val:  # a user object: not JSON
        def __init__(self, i):
            self.i = i

        def __eq__(self, other):
            return self.i == other.i

    globals()["Val"] = Val  # picklable by module path
    Val.__qualname__ = "Val"
    kws = _keywords("longest", seed=9, n=20)
    for values in ([f"v{i}" for i in range(len(kws))], [Val(i) for i in range(len(kws))]):
        ref = jax_compiler.compile_matcher(kws, "longest", True, values=values,
                                           thresholder=_NeverDense())
        mine = port_compiler.compile_matcher(kws, "longest", True, values=values,
                                             thresholder=_NeverDense())
        a, b = jax_artifact.save_bytes(ref), port_artifact.save_bytes(mine)
        assert hashlib.sha256(a).digest() == hashlib.sha256(b).digest()
        assert b"ahocorasick_tpu" not in a and b"ahocorasick_tpu" not in b
        pickled = not isinstance(values[0], str)
        _same_compiled(port_artifact.load_bytes(a, allow_pickle=pickled), ref)
        back = jax_artifact.load_bytes(b, allow_pickle=pickled)
        assert isinstance(back, jax_compiler.CompiledMatcher) and back.values == values
        if pickled:
            with pytest.raises(ValueError, match="allow_pickle"):
                port_artifact.load_bytes(a)
    path = tmp_path / "m.npz"
    ac = port_compiler.compile_matcher(kws[:5], "ac", True)
    port_artifact.save(mine, path, ac=ac)
    got, got_ac = port_artifact.load_with_ac(path, allow_pickle=True)
    ref_m, ref_ac = jax_artifact.load_with_ac(path, allow_pickle=True)
    _same_compiled(got, ref_m)
    _same_compiled(got_ac, ref_ac)


# ----------------------------------------------------------------------- gold


@pytest.mark.parametrize("layout", ["dense", "rows"])
@pytest.mark.parametrize("case_sensitive", [True, False], ids=["cs", "fold"])
@pytest.mark.parametrize("kind", KINDS)
def test_gold_match_equal(kind, case_sensitive, layout):
    kws = [k for k in _keywords(kind, seed=11) if kind != "whole_word" or "\U0001F600" not in k]
    kw = dict(values=list(range(len(kws))), thresholder=_NeverDense() if layout == "rows" else None)
    ref = jax_compiler.compile_matcher(kws, kind, case_sensitive, **kw)
    mine = port_compiler.compile_matcher(kws, kind, case_sensitive, **kw)
    for seed in (1, 2):
        text = _text(seed)
        want = jax_gold.gold_match(ref, text)
        assert port_gold.gold_match(mine, text) == want
        assert getattr(port_gold, "gold_" + kind)(mine, text) == want
        assert len(want) > 10
    assert port_gold.gold_match(mine, "") == []


# -------------------------------------------------------------------- resolve


def _candidates(seed, n=3000, span=2000):
    rng = np.random.default_rng(seed)
    ends = np.sort(rng.integers(1, span, size=n))
    lens = rng.integers(1, 9, size=n)
    starts = np.maximum(ends - lens, 0)
    order = np.lexsort((starts, ends))
    return starts[order].astype(np.int64), ends[order].astype(np.int64), \
        rng.integers(0, 50, size=n).astype(np.int64)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("fn", ["resolve_longest", "resolve_shortest", "resolve_longest_py",
                                "resolve_shortest_py"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolvers_equal(fn, seed, native, monkeypatch):
    if not native:
        monkeypatch.setattr(port_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    trip = _candidates(seed)
    want = getattr(jax_queue, fn)(*trip)
    got = getattr(port_queue, fn)(*trip)
    assert len(want[0]) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    empty = (np.zeros(0, np.int64),) * 3
    assert [len(x) for x in getattr(port_queue, fn)(*empty)] == [0, 0, 0]


def _sorted_candidates(trips):
    trips = sorted(trips, key=lambda t: (t[1], t[0]))
    a = np.asarray(trips, dtype=np.int64).reshape(len(trips), 3)
    return a[:, 0], a[:, 1], a[:, 2]


def _sharded_resolve_cases():
    """The cases of ``tests/test_resolve_parallel.py``: (mode, candidates,
    boundaries, max_depth)."""
    chain = [(i, i + 2, i % 2) for i in range(12)]  # "ababab" parity chain
    for boundaries in ([5], [3, 7], [1, 2, 3, 4, 5, 6]):
        yield "longest", chain, boundaries, 2
    for boundaries in ([10], [9], [11]):  # a straddling same-start replacement
        yield "longest", [(0, 3, 0), (6, 9, 1), (6, 12, 2), (12, 14, 3)], boundaries, 6
    yield "longest", [(8, 11, 0), (9, 13, 1), (11, 15, 2)], [12], 4
    yield "shortest", [(2, 6, 0), (4, 8, 1), (6, 9, 2)], [7], 4
    for mode in ("longest", "shortest"):
        yield mode, [], [10], 4
        rng = np.random.default_rng(42 if mode == "longest" else 43)
        for _ in range(60):
            n, d = int(rng.integers(0, 120)), int(rng.integers(1, 9))
            trips = []
            for _ in range(n):
                start = int(rng.integers(0, 80))
                trips.append((start, start + int(rng.integers(1, d + 1)), int(rng.integers(0, 50))))
            trips = list({(s, e): (s, e, v) for s, e, v in trips}.values())
            n_b = int(rng.integers(1, 6))
            yield mode, trips, sorted(int(x) for x in rng.integers(0, 90, size=n_b)), d


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("mode", ["longest", "shortest"])
def test_sharded_resolvers_equal(mode, native, monkeypatch):
    if not native:
        monkeypatch.setattr(port_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    fn = f"resolve_{mode}_sharded"
    ran = 0
    for case_mode, trips, boundaries, d in _sharded_resolve_cases():
        if case_mode != mode:
            continue
        cand = _sorted_candidates(trips)
        want = getattr(jax_parallel, fn)(*cand, boundaries, max_depth=d)
        got = getattr(port_parallel, fn)(*cand, boundaries, max_depth=d)
        glob = getattr(port_queue, f"resolve_{mode}")(*cand)
        for g, w, x in zip(got, want, glob):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, x)
        ran += 1
    assert ran > 60


def test_sharded_longest_resolver_thread_pool_equal():
    """Enough candidates on several shards for the thread-parallel phase."""
    rng = np.random.default_rng(7)
    starts = np.sort(rng.integers(0, 1 << 20, size=1 << 17))
    ends = starts + rng.integers(1, 9, size=len(starts))
    order = np.lexsort((starts, ends))
    cand = (starts[order].astype(np.int64), ends[order].astype(np.int64),
            rng.integers(0, 50, size=len(starts)).astype(np.int64))
    boundaries = [(1 << 20) * i // 8 for i in range(1, 8)]
    want = jax_parallel.resolve_longest_sharded(*cand, boundaries, max_depth=8)
    got = port_parallel.resolve_longest_sharded(*cand, boundaries, max_depth=8)
    for g, w, x in zip(got, want, port_queue.resolve_longest(*cand)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, x)
    assert len(got[0]) > 1 << 15


@pytest.mark.parametrize("seed", [0, 1])
def test_match_queue_equal(seed):
    starts, ends, vals = _candidates(seed, n=600, span=400)
    a, b = port_queue.MatchQueue(), jax_queue.MatchQueue()
    out_a, out_b = [], []
    for i, (s, e, v) in enumerate(zip(starts.tolist(), ends.tolist(), vals.tolist())):
        a.push(s, e, v)
        b.push(s, e, v)
        if i % 37 == 36:
            out_a += a.flush(e - 9)
            out_b += b.flush(e - 9)
    assert out_a + a.drain() == out_b + b.drain()
    assert len(out_a) > 10 and a.drain() == []


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_follow_chain_and_boundary_filter_equal(seed, native, monkeypatch):
    if not native:
        monkeypatch.setattr(port_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    rng = np.random.default_rng(seed)
    n = 4000
    is_word = rng.random(n) < 0.7
    np.testing.assert_array_equal(port_wholeword.word_starts(is_word),
                                  jax_wholeword.word_starts(is_word))
    ws = jax_wholeword.word_starts(is_word)
    die = np.minimum(np.arange(n) + rng.integers(0, 9, size=n), n).astype(np.int32)
    has = rng.random(n) < 0.5
    m_end = np.minimum(die, np.arange(n) + 6).astype(np.int32)
    m_start = np.arange(n, dtype=np.int32)
    m_val = rng.integers(0, 9, size=n).astype(np.int32)
    want = jax_wholeword.follow_chain(die, has, m_start, m_end, m_val, ws, n)
    assert port_wholeword.follow_chain(die, has, m_start, m_end, m_val, ws, n) == want
    assert len(want) > 50
    class_is_word = np.array([False, True, True, False])
    cls = rng.integers(0, 4, size=n).astype(np.int32)
    starts, ends, vals = _candidates(seed, n=800, span=n)
    got = port_wholeword.boundary_filter(class_is_word, cls, starts, ends, vals)
    ref = jax_wholeword.boundary_filter(class_is_word, cls, starts, ends, vals)
    assert 0 < len(ref[0]) < 800
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------- chartables


def test_chartables_equal_incl_astral_and_folding():
    for fn in ("lower_table", "letter_or_digit_table", "compute_lower_table",
               "compute_letter_or_digit_table", "default_word_chars"):
        got, want = getattr(port_chartables, fn)(), getattr(jax_chartables, fn)()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), fn
    assert port_chartables.BMP == jax_chartables.BMP == 65536
    with open(port_chartables._FIXTURE, "rb") as a, open(jax_chartables._FIXTURE, "rb") as b:
        assert a.read() == b.read()
    assert "ahocorasick_tpu_torch" in port_chartables._FIXTURE
    for s in ("", "plain", "İstanbul ǅ ß", "a\U0001F600b\U00010348", "naïve can't", "中文 x"):
        got, want = port_chartables.to_utf16_units(s), jax_chartables.to_utf16_units(s)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
        assert port_chartables.units_to_str(got) == jax_chartables.units_to_str(want) == s
    assert len(port_chartables.to_utf16_units("a\U0001F600b")) == 4
    assert port_chartables.lower_table()[0x130] == ord("i")  # Java's simple mapping
    for chars in ("ab_", ["x", "-"], "é'"):
        np.testing.assert_array_equal(port_chartables.word_chars_from_list(chars),
                                      jax_chartables.word_chars_from_list(chars))
    flags = [True, False]
    np.testing.assert_array_equal(port_chartables.word_chars_with_toggles("a-", flags),
                                  jax_chartables.word_chars_with_toggles("a-", flags))
    wc = jax_chartables.default_word_chars()
    for kw in (" ab ", "--", "a b", "", "'x'"):
        assert port_chartables.trim_word(kw, wc) == jax_chartables.trim_word(kw, wc)


def test_charmap_folds_case_and_keeps_astral_units():
    kws = ["İx", "STRASSE", "a\U0001F600"]
    want = jax_compiler.compile_matcher(kws, "ac", False)
    got = port_compiler.compile_matcher(kws, "ac", False)
    assert got.charmap.tobytes() == want.charmap.tobytes()
    text = "i̇x ix strasse Strasse A\U0001F600 a\U0001F600"
    assert port_gold.gold_match(got, text) == jax_gold.gold_match(want, text) != []


# ------------------------------------------------------- small utils, emit


def test_small_utils_equal():
    assert port_lanes.LANE_BUCKET == jax_lanes.LANE_BUCKET
    for d in range(0, 70):
        assert port_lanes.bucket_depth(d) == jax_lanes.bucket_depth(d)
    for cls in ("RangeNodeThreshold", "DenseTableBudget"):
        a, b = getattr(port_thresholds, cls)(), getattr(jax_thresholds, cls)()
        for args in ((3, 0, 8), (10, 2, 100), (90, 5, 100), (1 << 20, 0, 1 << 30)):
            assert a.is_over_threshold(*args) == b.is_over_threshold(*args)
    assert issubclass(port_thresholds.RangeNodeThreshold, port_thresholds.Thresholder)
    assert port_alloc._THRESHOLD_BYTES == jax_alloc._THRESHOLD_BYTES
    big = port_alloc.big_empty((1 << 22, 2), np.int32)
    assert big.shape == (1 << 22, 2) and big.dtype == np.int32
    big[-1] = 7  # writable, like np.empty
    assert port_alloc.big_empty((3,), np.uint8).shape == (3,)
    a, b = port_stats.ScanStats(units=10, matches=3, engine="x", kind="ac"), \
        jax_stats.ScanStats(units=10, matches=3, engine="x", kind="ac")
    with port_stats.timed(a):
        pass
    b.seconds = a.seconds
    assert str(a) == str(b) and a.bytes_scanned == 20 and a.gbps == b.gbps
    # The JAX module's trace() wraps jax.profiler, the port's torch.profiler
    # (tests/test_torch_bench.py writes a trace).
    assert callable(port_stats.trace) and callable(jax_stats.trace)


def test_emit_helpers_equal():
    kws = _keywords("ac", seed=13)
    ref = jax_compiler.compile_matcher(kws, "ac", True, values=list(range(len(kws))))
    mine = carry(ref)
    text = _text(4)
    cls = ref.charmap[jax_chartables.to_utf16_units(text)]
    trip = jax_gold.gold_match(ref, text)
    starts = np.array([t[0] for t in trip], dtype=np.int64)
    lens = np.array([t[1] - t[0] for t in trip], dtype=np.int64)
    want = jax_emit.walk_values(ref, cls, starts, lens)
    np.testing.assert_array_equal(port_emit.walk_values(mine, cls, starts, lens), want)
    assert want.tolist() == [t[2] for t in trip]
    perm = np.random.default_rng(0).permutation(len(starts))
    for g, w in zip(port_emit.sort_by_end_start(starts[perm], lens[perm]),
                    jax_emit.sort_by_end_start(starts[perm], lens[perm])):
        np.testing.assert_array_equal(g, w)
    sm = jax_compiler.compile_matcher(kws, "shortest", True, values=list(range(len(kws))))
    states = np.random.default_rng(1).integers(0, sm.num_states, size=500)
    for g, w in zip(port_emit.states_to_shortest_matches(carry(sm), states),
                    jax_emit.states_to_shortest_matches(sm, states)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pfac_host_copies_equal(seed):
    """``rank_states``, ``build_ranked`` (also with a prefix cap that forces
    k = 1), ``pad_classes`` and the START-indexed ``bitplanes_to_matches`` /
    ``ac_matches`` of the pfac2 cross-check engine."""
    kws = _keywords("ac", seed=seed)
    ref = jax_compiler.compile_matcher(kws, "ac", True, values=list(range(len(kws))))
    mine = carry(ref)
    np.testing.assert_array_equal(port_scan_pfac2.rank_states(mine),
                                  jax_scan_pfac2.rank_states(ref))
    for cap in (1 << 20, 64):
        got, want = port_scan_pfac2.build_ranked(mine, cap), jax_scan_pfac2.build_ranked(ref, cap)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
            else:
                assert g == w
    text = _text(seed)
    cls = ref.charmap[jax_chartables.to_utf16_units(text)]
    assert port_scan_dfa.pad_classes is port_scan_pfac.pad_classes
    assert port_scan_pfac.PAD_CLASS == port_scan_pfac2.PAD_CLASS == jax_scan_pfac.PAD_CLASS == 0
    for d, bucket in ((0, 1), (7, 1), (5, 4096)):
        want = jax_scan_pfac.pad_classes(cls, d, bucket)
        for fn in (port_scan_pfac.pad_classes, port_scan_pfac2.pad_classes):
            got = fn(cls, d, bucket)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    trip = jax_gold.gold_match(ref, text)
    starts = np.array([t[0] for t in trip], dtype=np.int64)
    lens = np.array([t[1] - t[0] for t in trip], dtype=np.int64)
    bits = np.zeros(((ref.max_depth + 31) // 32, len(cls) + 64), dtype=np.uint32)
    np.bitwise_or.at(bits, ((lens - 1) // 32, starts), np.uint32(1) << ((lens - 1) % 32).astype(
        np.uint32))
    for g, w in zip(port_emit.bitplanes_to_matches(bits, ref.max_depth),
                    jax_emit.bitplanes_to_matches(bits, ref.max_depth)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    got = port_emit.ac_matches(mine, cls, bits)
    for g, w in zip(got, jax_emit.ac_matches(ref, cls, bits)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert [tuple(map(int, t)) for t in zip(*got)] == [tuple(t) for t in trip]


# --------------------------------------------------------------------- native


def test_native_library_is_the_ports_own_build():
    assert port_native.available() and jax_native.available()
    out = port_native_build.build()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(port_native_build.__file__)))
    assert out == os.path.join(pkg, "_build", "libac_native.so") and os.path.exists(out)
    assert port_native_build.SRC == os.path.join(pkg, "native", "src", "ac_native.cpp")
    assert port_native._load()._name == out
    assert os.sep + "ahocorasick_tpu" + os.sep not in out
    assert jax_native._load()._name != out


@pytest.mark.parametrize("mode", ["all", "longest", "shortest"])
@pytest.mark.parametrize("planes", [1, 2])
def test_native_extractors_equal(mode, planes):
    rng = np.random.default_rng(planes)
    n, depth = 5000, 32 * planes - 3
    bits = np.zeros((planes, n + 64), dtype=np.uint32)
    hot = np.sort(rng.choice(np.arange(depth, n), size=600, replace=False))
    for p in range(planes):
        bits[p, hot] = rng.integers(0, 1 << 32, size=600, dtype=np.uint64).astype(np.uint32)
    bits[-1] &= np.uint32((1 << (depth - 32 * (planes - 1))) - 1)
    for g, w in zip(port_native.extract_resolve(bits, n, depth, mode),
                    jax_native.extract_resolve(bits, n, depth, mode)):
        np.testing.assert_array_equal(g, w)
    idx = np.nonzero(bits.any(axis=0))[0].astype(np.int64)
    masks = np.ascontiguousarray(bits[:, idx].T)
    sparse = port_native.extract_resolve_sparse(idx, masks, n, depth, mode)
    for g, w in zip(sparse, jax_native.extract_resolve_sparse(idx, masks, n, depth, mode)):
        np.testing.assert_array_equal(g, w)
    dense = port_native.extract_resolve(bits, n, depth, mode)
    assert len(dense[0]) > 100
    for g, w in zip(sparse, dense):
        np.testing.assert_array_equal(g, w)


def test_native_compile_tables_equal():
    kws = _keywords("ac", seed=17, n=200)
    units = [jax_chartables.to_utf16_units(k) for k in kws]
    flat = np.concatenate(units)
    offsets = np.concatenate([[0], np.cumsum([len(u) for u in units])]).astype(np.int64)
    for kind, with_values in (("ac", True), ("shortest", False)):
        want = jax_native.compile_tables(flat, offsets, kind, with_values)
        got = port_native.compile_tables(flat, offsets, kind, with_values)
        assert got.keys() == want.keys()
        for k, w in want.items():
            if isinstance(w, np.ndarray):
                assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
            else:
                assert got[k] == w, k


def test_missing_library_keeps_the_numpy_paths(monkeypatch):
    """Without the library the callers take their pure-numpy paths, as the
    JAX package's do (``AHOCORASICK_TPU_NO_NATIVE``)."""
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setenv("AHOCORASICK_TPU_NO_NATIVE", "1")
    assert not port_native.available()
    kws = _keywords("longest", seed=19)
    got = port_compiler.compile_matcher(kws, "longest", True)
    with pytest.raises(RuntimeError, match="unavailable"):
        port_compiler.compile_matcher(kws, "longest", True, backend="native")
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.delenv("AHOCORASICK_TPU_NO_NATIVE")
    assert port_native.available()
    _same_compiled(got, jax_compiler.compile_matcher(kws, "longest", True))


# ------------------------------------- the table-sharded scanner's host needs


@pytest.mark.parametrize("name", ["dense", "quirk", "fullnode", "quotient", "mixed",
                                  "mixed_quotient"])
def test_walks_from_raw_equal(name):
    """The sweep of a table-sharded raw plane (``walks_from_raw``) against
    the JAX package's host sweep of the same plane and against the port's
    single-table scan with its every-position sweep: pure, mixed and quotient
    tables, 1-axis and 2-axis meshes."""
    import torch

    from ahocorasick_tpu.ops import scan_wwl as jax_wwl
    from ahocorasick_tpu_torch.ops import scan_batched as port_sb
    from ahocorasick_tpu_torch.ops import scan_wwl as port_wwl
    from ahocorasick_tpu_torch.parallel import sharding as port_sh
    from test_torch_wwl import _build, _dictionary

    m, text = _dictionary(name)
    jsc, psc = _build(jax_wwl, m), _build(port_wwl, carry(m))
    assert psc.quotient == (name in ("fullnode", "quotient", "mixed_quotient"))
    assert psc.has_cross == name.startswith("mixed")
    d = psc.halo
    cls = m.charmap[jax_chartables.to_utf16_units(text)][:1500]
    n = len(cls)
    cls_p = np.pad(cls, (0, d + 1))
    table = psc.table if psc.row_layout else psc.table.reshape(-1, psc.num_classes)
    dev = convert.wwl_scan_from_numpy(psc, "cpu")
    for mesh in (["cpu"] * 3, port_sh.dp_tp_mesh(["cpu"] * 4)):
        # An even number of windows for the two model groups of the 2-axis mesh.
        scanned = cls_p if len(mesh) == 3 else np.pad(cls, (0, 2048 - n))
        raw = port_sh._table_sharded_run(table, scanned, d, psc.id_bits, mesh, 512, "raw")[0]
        want = jax_wwl.host_walks_from_raw(jsc, port_sb.to_host(raw), cls_p, n)
        got = port_wwl.walks_from_raw(psc, dev.rows_flat, dev.outrows, raw, cls_p, n)
        assert len(got) == len(want) == (6 if psc.has_cross else 5)
        for g, w in zip(got, want):
            assert g.numpy().dtype == w.dtype and len(g) == n
            np.testing.assert_array_equal(g.numpy(), w)
        assert got[1].any()
    # The single-table form of the same outcomes, on the same windows.
    windows = port_sb.chunk_classes(cls_p, 512, d, psc.num_classes)
    n_keep = windows.shape[0] * 512 - (d + 1)
    every = port_wwl.wwl_scan_walks_all(
        dev.table, dev.rows_flat, dev.outrows, port_sb.classes_to_device(
            windows, psc.num_classes, torch.device("cpu")),
        halo=d, id_bits=psc.id_bits, depth_bits=psc.depth_bits, num_classes=psc.num_classes,
        d=d, row_layout=psc.row_layout, quotient=psc.quotient, n_keep=n_keep,
        cross=psc.has_cross)
    assert n_keep >= n
    for g, e in zip(got, every):
        assert torch.equal(g, e[:n])


@pytest.mark.parametrize("kws, mixed", [(["a", "ab", "ba", "aab"], False),
                                        (["new york", "new", "york"], True)])
def test_wwl_scan_host_is_the_device_tables_numpy(kws, mixed):
    """One build serves both cache entries, the host copy alone uploads
    nothing and equals the JAX package's; the device bytes do not count it."""
    import torch

    import ahocorasick_tpu as act
    import ahocorasick_tpu_torch as port

    jm = act.WholeWordLongestMatchSet(kws)
    pm = port.WholeWordLongestMatchSet(kws, device="cpu")
    name = "wwl_scan_mixed" if mixed else "wwl_scan"
    host = getattr(pm.dev, name + "_host")
    assert list(pm.dev._host) == [name] and not pm.dev._cache
    dev = getattr(pm.dev, name)
    want = getattr(jm.dev, name + "_host")
    assert getattr(pm.dev, name + "_host") is host and getattr(pm.dev, name) is dev
    assert list(pm.dev._cache) == list(pm.dev._host) == [name]
    for field in host._fields:
        h, d, w = getattr(host, field), getattr(dev, field), getattr(want, field)
        if isinstance(h, np.ndarray):
            assert h.dtype == w.dtype
            np.testing.assert_array_equal(h, w)
            np.testing.assert_array_equal(
                h, d.view(torch.int32).numpy().view(np.uint32) if h.dtype == np.uint32
                else d.numpy())
        else:
            assert h == d == w
    assert pm.dev.device_bytes() == sum(
        getattr(dev, f).nbytes for f in ("table", "outrows")) + (
            dev.rows_flat.nbytes if dev.rows_flat is not None else 0)
