"""Port matchers of the resolved kinds (``device="cpu"``: the kernels' plain
twins) vs the JAX package's ``engine="device"`` matchers and the gold model:
leftmost-longest, whole-word and leftmost-shortest, sets and maps.  Triples
are integers, so every comparison is exact."""

import json
import os

import numpy as np
import pytest

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.utils import chartables
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from test_torch_host import carry

KINDS = ("LongestMatch", "WholeWordMatch", "ShortestMatch")

_FIXTURES = os.path.join(os.path.dirname(__file__), "golden", "fixtures.json")
with open(_FIXTURES) as fh:
    FIXTURES = json.load(fh)


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


def _fuzz(seed, alphabet="abc", n_kw=12, max_len=5, n_text=600, noise=" "):
    rng = np.random.default_rng(seed)
    kws = sorted({"".join(rng.choice(list(alphabet), size=int(rng.integers(1, max_len + 1))))
                  for _ in range(n_kw)})
    text = "".join(rng.choice(list(alphabet + noise), size=n_text))
    return kws, text


def _pair(kind, is_map, kws, **kw):
    """The port's and the JAX package's matcher of one class."""
    name = kind + ("Map" if is_map else "Set")
    args = (kws, [f"v{i}" for i in range(len(kws))]) if is_map else (kws,)
    p = getattr(port, name)(*args, engine="device", device="cpu", **kw)
    j = getattr(jax_pkg, name)(*args, engine="device", **kw)
    return p, j


def _gold(m, text):
    vals = m.compiled.values
    if m.is_map:
        return [(s, e, vals[v]) for s, e, v in gold.gold_match(m.compiled, text)]
    return [(s, e) for s, e, _ in gold.gold_match(m.compiled, text)]


def _check(p, j, text, min_matches=1):
    want = _gold(p, text)
    assert p.match(text) == j.match(text) == want
    assert p.last_stats.engine == "device"
    assert len(want) >= min_matches
    return want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
@pytest.mark.parametrize("kind", KINDS)
def test_kind_equals_jax_device_and_gold(kind, is_map, seed):
    case_sensitive = seed % 2 == 0
    kws, text = _fuzz(seed, noise="  ")
    if not case_sensitive:  # fold: upper-case keywords, mixed-case text
        kws = [k.upper() if i % 2 else k for i, k in enumerate(kws)]
        text = "".join(c.upper() if i % 3 == 0 else c for i, c in enumerate(text))
    p, j = _pair(kind, is_map, kws, case_sensitive=case_sensitive)
    _check(p, j, text, min_matches=10)


@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
@pytest.mark.parametrize("kind", KINDS)
def test_row_compressed_dictionary(kind, is_map):
    kws, text = _fuzz(21, alphabet="abcdefg", n_kw=40, max_len=6, n_text=1500, noise="   ")
    p, j = _pair(kind, is_map, kws, thresholder=_NeverDense())
    assert p.compiled.is_row_compressed
    _check(p, j, text, min_matches=20)


@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
def test_whole_word_word_chars(is_map):
    kws = ["can't", "o'clock", "naive", "x-ray", "ray", "can"]
    text = "can't x-ray ray o'clock can naive x-rays can'tx " * 4
    p, j = _pair("WholeWordMatch", is_map, kws, word_chars=list("abcdefghijklmnopqrstuvwxyz'-"))
    want = _check(p, j, text, min_matches=8)
    assert (0, 5) in [w[:2] for w in want]  # "can't" is one word here


def test_whole_word_toggle_flags():
    kws = ["x-ray", "ray", "x", "b"]
    text = "x-ray ray a_b x b a_bb " * 3
    toggles = dict(word_chars=["-", "_"], toggle_flags=[True, False])
    p, j = _pair("WholeWordMatch", True, kws, **toggles)
    want = _check(p, j, text, min_matches=5)
    assert (0, 5, "v0") in want  # "-" toggled into the word chars
    default = port.WholeWordMatchSet(kws, engine="device", device="cpu")
    assert default.match(text) != [w[:2] for w in want]


@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
def test_shortest_survivors_drop_a_character(is_map):
    """"az" and "by" are skipped at insert, so "z" and "y" are classes of
    neither automaton; they scan as non-keyword characters."""
    kws = ["a", "az", "b", "by", "ab"]
    text = "azbyab zzyy a b" * 20
    p, j = _pair("ShortestMatch", is_map, kws)
    _check(p, j, text, min_matches=20)
    assert p._ac.compiled.num_states < p.compiled.num_states + 3


def test_shortest_remaps_outer_classes_to_the_inner_ac():
    """An inner AC whose class numbering differs from the outer automaton's
    takes classes through ``_cls_map``, and the matches stay exact.  Here
    the inner AC holds one more keyword, of characters the text never has,
    which sort before the others and so shift every class id."""
    from ahocorasick_tpu.core.compiler import compile_matcher, shortest_survivors

    kws = ["b", "ca", "a", "abc", "cab"]
    text = "abcab cba bca acb " * 30
    outer = compile_matcher(kws, "shortest", True)
    survivors, _ = shortest_survivors(kws, True)
    inner = compile_matcher(survivors + ["AZ"], "ac", True)
    assert not np.array_equal(outer.charmap, inner.charmap)
    p = port.ShortestMatchSet.from_compiled(carry(outer), engine="device", device="cpu",
                                            ac_compiled=carry(inner))
    j = jax_pkg.ShortestMatchSet.from_compiled(outer, engine="device", ac_compiled=inner)
    assert p._cls_map is not None and p._cls_map[1] != 1
    _check(p, j, text, min_matches=20)


@pytest.mark.parametrize("kind, mode", [("LongestMatch", "longest"), ("ShortestMatch", "shortest")])
def test_forced_sparse_resolve(monkeypatch, kind, mode):
    kws, text = _fuzz(11, n_text=5000, noise="defghijklmnopqrstuvwxyz ")
    monkeypatch.setattr(port_sb, "_SPARSE_ON_CPU", True)
    monkeypatch.setattr(port_sb, "_SPARSE_MIN_UNITS", 1024)
    from ahocorasick_tpu_torch.native import lib as native_lib

    calls = []
    real = native_lib.extract_resolve_sparse

    def spy(idx, masks, n, max_depth, m):
        calls.append(m)
        return real(idx, masks, n, max_depth, m)

    monkeypatch.setattr(native_lib, "extract_resolve_sparse", spy)
    p, j = _pair(kind, True, kws)
    _check(p, j, text, min_matches=100)
    assert calls == [mode]  # compacted, then resolved sparse


@pytest.mark.parametrize("kind", ["LongestMatch", "ShortestMatch"])
def test_resolve_without_the_native_library(monkeypatch, kind):
    """Without the native extractor, all candidates are extracted and
    resolved in numpy (``resolve_longest`` / ``resolve_shortest``)."""
    from ahocorasick_tpu_torch.native import lib as native_lib

    kws, text = _fuzz(13, n_text=2000)
    monkeypatch.setattr(native_lib, "available", lambda: False)
    p, j = _pair(kind, True, kws)
    _check(p, j, text, min_matches=100)


@pytest.mark.parametrize("engine", ["gold", "device"])
@pytest.mark.parametrize("case", FIXTURES, ids=[c["name"] for c in FIXTURES])
def test_golden_fixtures(case, engine):
    cls = port_matchers._CLASS_BY_KIND[(case["kind"], case["map"])]
    kws = case["keywords"]
    args = (kws, list(range(len(kws)))) if case["map"] else (kws,)
    m = cls(*args, case["case_sensitive"], engine=engine, device="cpu")
    s, e, v = m.match_triples(case["haystack"])
    assert [[int(a), int(b), int(c)] for a, b, c in zip(s, e, v)] == case["triples"]
    assert m.last_stats.engine == engine


def test_shortest_builds_no_inner_ac_for_gold_or_small_auto():
    kws, text = _fuzz(3)
    g = port.ShortestMatchMap(kws, list(range(len(kws))), engine="gold", device="cpu")
    a = port.ShortestMatchSet(kws, device="cpu")
    assert len(text) < port_matchers._AUTO_DEVICE_MIN_UNITS
    assert g.match(text) == _gold(g, text)
    assert a.match(text) == _gold(a, text)
    assert g._ac_cache is None and a._ac_cache is None
    assert a.last_stats.engine == "gold"
    assert g.device_table_bytes() == a.device_table_bytes() == 0
    assert a.host_table_bytes() == a.compiled.memory_bytes()
    big = text * (port_matchers._AUTO_DEVICE_MIN_UNITS // len(text) + 1)
    assert a.count(big) == len(_gold(a, big))
    assert a.last_stats.engine == "device" and a._ac_cache is not None


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "row_compressed"])
@pytest.mark.parametrize("kind", KINDS)
def test_table_bytes_equal_jax(kind, dense):
    kws, text = _fuzz(5, alphabet="abcdefg", n_kw=40, max_len=6)
    p, j = _pair(kind, False, kws, **({} if dense else {"thresholder": _NeverDense()}))
    if kind == "ShortestMatch":
        j._ac.device_engine = "batched"  # the packed table the port uploads
    else:
        j.device_engine = "batched"
    assert p.match(text) == j.match(text)
    assert p.device_table_bytes() == j.device_table_bytes() > 0
    assert p.host_table_bytes() == j.host_table_bytes()
    if kind == "ShortestMatch":
        inner = p._ac.compiled.memory_bytes()
        assert p.host_table_bytes() == p.compiled.memory_bytes() + inner
        assert p.device_table_bytes() == p._ac.device_table_bytes()


def test_device_capable_is_kind_aware():
    from ahocorasick_tpu.models import matchers as jax_matchers
    from ahocorasick_tpu.core.compiler import compile_matcher

    wide = ["a" * 32, "b", "ab"]  # depth 32: no quotient packs inline
    cases = []
    for kind in ("ac", "longest", "whole_word", "shortest"):
        for kws, thr in ((wide, _NeverDense()), (["ab", "b"], _NeverDense()), (wide, None)):
            cases.append(compile_matcher(kws, kind, True, thresholder=thr))
    got = [port_matchers._device_capable(carry(m), m.kind) for m in cases]
    want = [jax_matchers._device_capable(m, m.kind) for m in cases]
    # Dense dictionaries that do not pack inline take the count-packed,
    # hotstate or split layouts in both packages.
    assert got == want
    assert got.count(False) == 3  # ac, longest, whole_word: the wide quotient
    deep_dense = [not m.is_row_compressed and not port_sb.inline_packable(carry(m)) for m in cases]
    assert sum(deep_dense) == 4 and all(g for g, d in zip(got, deep_dense) if d)
    with pytest.raises(ValueError, match="too wide"):
        port.LongestMatchSet(wide, engine="device", device="cpu", thresholder=_NeverDense())
    s = port.ShortestMatchSet(["ab", "b"], device="cpu", thresholder=_NeverDense())
    assert s.compiled.is_row_compressed and s._pick_engine(1 << 20) == "device"


def test_word_chars_reach_the_compiler():
    wc = chartables.word_chars_from_list("ab")
    p = port.WholeWordMatchSet(["ab"], word_chars=list("ab"), engine="device", device="cpu")
    np.testing.assert_array_equal(p.compiled.class_is_word[p.compiled.charmap], wc)
