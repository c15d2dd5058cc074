"""Whole-word-longest in the port (``device="cpu"``: the kernels' plain
twins) vs the JAX package and the gold model: the numpy table builders byte
for byte, the scan and walk kernels' twins against the JAX device loops on
JAX-built tables, and the matchers on every route.  Everything compared is
an integer, so every comparison is exact."""

import functools
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.models import matchers as jax_matchers
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu.ops import scan_wwl as jax_wwl
from ahocorasick_tpu.utils import chartables
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.kernels import scan_wwl as kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_wwl as port_wwl
from test_torch_host import carry

WWL = "whole_word_longest"


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


def _fuzz_keywords(seed, alphabet="abcehlprsx", n=12, max_len=6):
    rng = random.Random(seed)
    return sorted({"".join(rng.choice(alphabet) for _ in range(rng.randint(1, max_len)))
                   for _ in range(n)})


def _soup(seed, kws, n_words=400):
    """Keywords and noise words, each followed by one of a few separators."""
    rng = random.Random(seed)
    noise = ["".join(rng.choice("abcehlprsx") for _ in range(rng.randint(1, 5))) for _ in range(40)]
    return "".join(rng.choice(kws + noise) + rng.choice([" ", " ", ",", ";", ", "])
                   for _ in range(n_words))


def _mixed_keywords():
    words = _fuzz_keywords(2, alphabet="abcde", n=30, max_len=4)
    return words + [f"{a} {b}" for a, b in zip(words[:8], words[8:16])] + ["a, b"]


@functools.lru_cache(maxsize=None)
def _dictionary(name):
    """(compiled WWL matcher, text) of one named shape."""
    rng = np.random.default_rng(len(name))
    if name == "dense":
        kws = _fuzz_keywords(1, n=40)
        text = "".join(rng.choice(list("abche lprs,;x"), size=3000))
        return compile_matcher(kws, WWL, True), text
    if name == "quirk":  # all-separator keywords, kept by the Java trim
        kws = [" ", "!!", "abc", ",,", "ab"]
        text = "".join(rng.choice(list("abc ,!"), size=2000))
        return compile_matcher(kws, WWL, True), text
    if name == "mixed":  # separator-spanning keywords: the truncated closure
        kws = _mixed_keywords()
        text = " ".join(rng.choice(kws + ["zz", "a,", "b"], size=700))
        return compile_matcher(kws, WWL, True), text
    if name == "fullnode":  # quotient, flat layout, uint16 classes
        kws = [chr(c) for c in range(32, 0xD800)]
        text = "".join(chr(int(x)) for x in rng.integers(32, 0xD800, size=3000))
        return compile_matcher(kws, WWL, True), text
    if name == "quotient":  # multi-char quotient via the Thresholder SPI
        kws = [chr(c) + chr(c + 1) for c in range(0x3000, 0x3400, 3)]
        text = "".join(chr(int(x)) for x in rng.integers(0x3000, 0x3400, size=3000))
        return compile_matcher(kws, WWL, True, thresholder=_NeverDense()), text
    if name == "mixed_quotient":
        words = _fuzz_keywords(3, alphabet="abcdef", n=30, max_len=4)
        kws = words + [f"{a} {b}" for a, b in zip(words[:10], words[10:20])]
        text = " ".join(rng.choice(kws + ["q", "ab,"], size=700))
        return compile_matcher(kws, WWL, True, thresholder=_NeverDense()), text
    raise KeyError(name)


SCAN = ["dense", "quirk", "fullnode", "quotient"]
MIXED = ["mixed", "mixed_quotient"]
ALL = SCAN + MIXED


def _np(t):
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _build(pkg, m):
    return (pkg.build_wwl_scan(m) if pkg.scan_applicable(m) else pkg.build_wwl_scan_mixed(m))


@pytest.fixture(params=[False, True], ids=["row", "flat"])
def layout(request, monkeypatch):
    """Both packages' row-layout gate, or the flat layout forced in both."""
    if request.param:
        monkeypatch.setattr(jax_wwl, "_ROW_MAX_BYTES", 0)
        monkeypatch.setattr(port_wwl, "_ROW_MAX_BYTES", 0)
    return request.param


# ------------------------------------------------------------------ builders


@pytest.mark.parametrize("name", ALL)
def test_applicability_agrees(name):
    m, _ = _dictionary(name)
    for fn in ("word_uniform_trie", "scan_applicable", "mixed_scan_applicable"):
        assert getattr(port_wwl, fn)(carry(m)) == getattr(jax_wwl, fn)(m), fn
    assert port_wwl.scan_applicable(carry(m)) == (name in SCAN)
    assert port_wwl.mixed_scan_applicable(carry(m)) == (name in MIXED)
    assert m.is_row_compressed == (name in ("fullnode", "quotient", "mixed_quotient"))


@pytest.mark.parametrize("name", ALL)
def test_scan_tables_identical(name, layout):
    m, _ = _dictionary(name)
    want, got = _build(jax_wwl, m), _build(port_wwl, carry(m))
    assert got._fields == want._fields
    for field, w, g in zip(want._fields, want, got):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, field
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            assert g == w, field
    if layout:
        assert not got.row_layout
    else:  # > 512 classes take the flat layout
        assert got.row_layout == (m.num_classes <= 512)


@pytest.mark.parametrize("name", ["dense", "mixed", "mixed_quotient"])
def test_truncated_closures_identical(name):
    m, _ = _dictionary(name)
    for fn in ("_truncated_closure_dense", "_truncated_closure"):
        for w, g in zip(getattr(jax_wwl, fn)(m), getattr(port_wwl, fn)(carry(m))):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=fn)


@pytest.mark.parametrize("n", [0, 1, 3, 4095, 4096, 5000])
@pytest.mark.parametrize("text_start", [True, False])
def test_compact_lanes_identical(n, text_start):
    m, text = _dictionary("dense")
    cls = m.charmap[chartables.to_utf16_units((text * 2)[:n])]
    want = jax_wwl.compact_lanes(m, cls, text_start=text_start)
    got = port_wwl.compact_lanes(carry(m), cls, text_start=text_start)
    for w, g in zip(want[:4], got[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]
    np.testing.assert_array_equal(port_wwl.chain_lanes(got[3], n), jax_wwl.chain_lanes(want[3], n))


@pytest.mark.parametrize("name", ["mixed", "mixed_quotient", "dense"])
def test_host_walks_at_identical(name):
    m, text = _dictionary(name)
    cls_p, starts, lanes, ws, d = port_wwl.compact_lanes(carry(m), m.charmap[chartables.to_utf16_units(text)])
    for w, g in zip(jax_wwl.host_walks_at(m, cls_p, starts, d),
                    port_wwl.host_walks_at(carry(m), cls_p, starts, d)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_walk_tables_identical():
    m, _ = _dictionary("mixed")
    want = jax_matchers._DeviceTables(m)
    got = port_matchers._DeviceTables(carry(m), "cpu").wwl_walk
    names = ("trie_next", "own_len", "own_val", "fail_len", "fail_off", "fail_val",
             "class_is_word")
    for name, g in zip(names, got):
        w = np.asarray(getattr(want, name))
        assert _np(g).dtype == w.dtype and _np(g).shape == w.shape, name
        np.testing.assert_array_equal(_np(g), w, err_msg=name)


@pytest.mark.parametrize("name", ALL)
def test_wwl_scan_from_numpy_carries_jax_tables(name, layout):
    m, _ = _dictionary(name)
    host = _build(jax_wwl, m)
    sc = convert.wwl_scan_from_numpy(host, "cpu")
    assert sc.table.dtype == torch.uint32
    np.testing.assert_array_equal(_np(sc.table), host.table)
    np.testing.assert_array_equal(_np(sc.outrows), host.outrows)
    assert (sc.rows_flat is None) == (host.rows_flat is None)
    if host.rows_flat is not None:
        np.testing.assert_array_equal(_np(sc.rows_flat), host.rows_flat)
    assert sc[3:] == host[3:]


# --------------------------------------------------------------- kernel twins


def _lengths(m):
    """Text lengths: multiples of 4096 and 512, odd ones, and shorter than d."""
    d = port_wwl.bucket_depth(m.max_depth)
    return [4096, 512, 3001, d - 1, 1]


@pytest.mark.parametrize("name", ALL)
def test_scan_walks_twin_equals_jax(name, layout):
    m, text = _dictionary(name)
    host = _build(jax_wwl, m)
    sc = convert.wwl_scan_from_numpy(host, "cpu")
    cross = host.has_cross
    before = dict(launches)
    for n in _lengths(m):
        cls = m.charmap[chartables.to_utf16_units((text * 2)[:n])]
        cls_p, starts, lanes, ws, d = jax_wwl.compact_lanes(m, cls)
        windows = jax_sb.chunk_classes(cls_p, 512, d, host.num_classes)
        kw = dict(halo=d, id_bits=host.id_bits, depth_bits=host.depth_bits,
                  num_classes=host.num_classes, d=d, row_layout=host.row_layout,
                  quotient=host.quotient, cross=cross)
        want = jax_wwl.wwl_scan_walks(
            jnp.asarray(host.table), None if host.rows_flat is None else jnp.asarray(host.rows_flat),
            jnp.asarray(host.outrows), jnp.asarray(windows), jnp.asarray(starts), **kw)
        w_t = torch.from_numpy(windows.view(np.int16)).view(torch.uint16) \
            if windows.dtype == np.uint16 else torch.from_numpy(windows)
        got = port_wwl.wwl_scan_walks(sc.table, sc.rows_flat, sc.outrows, w_t,
                                      torch.from_numpy(starts), **kw)
        assert len(got) == len(want) == (6 if cross else 5)
        for w, g in zip(want, got):
            assert _np(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=f"n={n}")
        # The narrow upload the matcher uses gives the same outcomes.
        narrow = port_wwl.scan_walks(sc, cls_p, starts, d, "cpu")
        for w, g in zip(want, narrow):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert launches == before  # the twins count no launches


def test_scan_walks_int32_windows_and_padded_starts():
    """int32 windows, and starts at and past L read the zero sweep word."""
    m, text = _dictionary("dense")
    host = jax_wwl.build_wwl_scan(m)
    sc = convert.wwl_scan_from_numpy(host, "cpu")
    cls = m.charmap[chartables.to_utf16_units(text[:700])]
    cls_p, _, _, _, d = jax_wwl.compact_lanes(m, cls)
    windows = jax_sb.chunk_classes(cls_p, 512, d)  # int32
    L = windows.shape[0] * 512 - (d + 1)
    starts = np.array([0, 5, L - 1, L, L + 3, 699], dtype=np.int32)
    kw = dict(halo=d, id_bits=host.id_bits, depth_bits=host.depth_bits,
              num_classes=host.num_classes, d=d, row_layout=True, quotient=False)
    want = jax_wwl.wwl_scan_walks(jnp.asarray(host.table), None, jnp.asarray(host.outrows),
                                  jnp.asarray(windows), jnp.asarray(starts), **kw)
    got = port_wwl.wwl_scan_walks(sc.table, None, sc.outrows, torch.from_numpy(windows),
                                  torch.from_numpy(starts), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert _np(got[0])[3:5].tolist() == [L, L + 3]  # k_die = 0 past L
    assert not _np(got[1])[3:5].any()


def _walk_inputs(name, n, narrow):
    m, text = _dictionary(name)
    jt = jax_matchers._DeviceTables(m)
    tables = [jt.trie_next, jt.own_len, jt.own_val, jt.fail_len, jt.fail_off, jt.fail_val,
              jt.class_is_word]
    cls = m.charmap[chartables.to_utf16_units((text * 2)[:n])]
    cls_p, starts, lanes, ws, d = jax_wwl.compact_lanes(m, cls)
    port_tables = [torch.from_numpy(np.array(t)) for t in tables]
    c = torch.from_numpy(cls_p.astype(np.int32))
    if narrow:
        from ahocorasick_tpu_torch.ops import scan_batched

        c = scan_batched.classes_to_device(cls_p, m.num_classes, "cpu")
    return m, tables, port_tables, cls_p, c, starts, d


@pytest.mark.parametrize("n", [4096, 3001, 3])
@pytest.mark.parametrize("name, narrow", [("dense", False), ("dense", True), ("mixed", True),
                                          ("quirk", False)])
def test_walks_at_twin_equals_jax(name, narrow, n):
    m, tables, port_tables, cls_p, c, starts, d = _walk_inputs(name, n, narrow)
    want = jax_wwl.wwl_walks_at(*tables, jnp.asarray(cls_p.astype(np.int32)),
                                jnp.asarray(starts), d)
    got = port_wwl.wwl_walks_at(*port_tables, c, torch.from_numpy(starts), d)
    for w, g in zip(want, got):
        assert _np(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("name", ["dense", "mixed"])
def test_walks_every_position_twin_equals_jax(name):
    m, tables, port_tables, cls_p, c, starts, d = _walk_inputs(name, 2000, False)
    want = jax_wwl.wwl_walks(*tables, jnp.asarray(cls_p.astype(np.int32)), d)
    got = port_wwl.wwl_walks(*port_tables, c, d)
    assert got[0].shape[0] == len(cls_p) - d - 1
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_wrappers_reject_bad_inputs():
    m, _ = _dictionary("dense")
    sc = convert.wwl_scan_from_numpy(port_wwl.build_wwl_scan(carry(m)), "cpu")
    w = torch.zeros((2, 520), dtype=torch.uint8)
    with pytest.raises(TypeError, match="windows"):
        kernels.wwl_scan_plane(sc.table, w.to(torch.int64), 8, sc.id_bits, sc.num_classes, False)
    with pytest.raises(ValueError, match="halo"):
        kernels.wwl_scan_plane(sc.table, w, 520, sc.id_bits, sc.num_classes, False)
    plane, _ = kernels.wwl_scan_plane(sc.table, w, 8, sc.id_bits, sc.num_classes, False)
    starts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        kernels.wwl_sweep_at(plane, plane.view(torch.int32), None, sc.outrows, starts, d=8,
                             id_bits=sc.id_bits, depth_bits=sc.depth_bits, cross=False)
    with pytest.raises(TypeError, match="starts"):
        kernels.wwl_sweep_at(plane, None, None, sc.outrows, starts.long(), d=8,
                             id_bits=sc.id_bits, depth_bits=sc.depth_bits, cross=False)
    with pytest.raises(ValueError, match="row_layout"):
        port_wwl.wwl_scan_walks(sc.table, None, sc.outrows, w, starts, halo=8,
                                id_bits=sc.id_bits, depth_bits=sc.depth_bits,
                                num_classes=sc.num_classes, d=8, row_layout=False,
                                quotient=False)
    walk = port_matchers._DeviceTables(carry(m), "cpu").wwl_walk
    with pytest.raises(TypeError, match="class_is_word"):
        kernels.wwl_walks_at(*walk[:6], walk[6][:3], w[0], starts, 4)


# ------------------------------------------------------------------ matchers


def _pair(is_map, kws, **kw):
    name = "WholeWordLongestMatch" + ("Map" if is_map else "Set")
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


def _routes(monkeypatch):
    """The route each ``_device_triples`` call takes, by spying."""
    taken = []
    cls = port.WholeWordLongestMatchSet
    for route in ("_scan_triples", "_walk_triples"):
        real = getattr(cls, route)

        def spy(self, *a, _real=real, _route=route, **k):
            taken.append("walk" if _route == "_walk_triples" else
                         ("mixed" if a[0].has_cross else "scan"))
            return _real(self, *a, **k)

        monkeypatch.setattr(cls, route, spy)
    return taken


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
def test_wwl_equals_jax_device_and_gold(seed, is_map, monkeypatch):
    taken = _routes(monkeypatch)
    case_sensitive = seed % 2 == 0
    kws = _fuzz_keywords(10 + seed)
    text = _soup(seed, kws)
    if not case_sensitive:
        kws = [k.upper() if i % 2 else k for i, k in enumerate(kws)]
        text = "".join(ch.upper() if i % 3 == 0 else ch for i, ch in enumerate(text))
    p, j = _pair(is_map, kws, case_sensitive=case_sensitive)
    _check(p, j, text, min_matches=20)
    assert taken == ["scan"]


@pytest.mark.parametrize("name, route", [("dense", "scan"), ("quirk", "scan"),
                                         ("fullnode", "scan"), ("quotient", "scan"),
                                         ("mixed", "mixed"), ("mixed_quotient", "mixed")])
def test_routes_equal_jax_and_gold(name, route, layout, monkeypatch):
    taken = _routes(monkeypatch)
    m, text = _dictionary(name)
    p = port.WholeWordLongestMatchSet.from_compiled(carry(m), engine="device", device="cpu")
    j = jax_pkg.WholeWordLongestMatchSet.from_compiled(m, engine="device")
    _check(p, j, text, min_matches=5)
    assert taken == [route]
    assert p.device_table_bytes() == j.device_table_bytes() > 0
    if route == "mixed":
        assert set(p.dev._cache) == {"wwl_scan_mixed"}
    # The walk route, called directly, gives the same triples on dense tries.
    if not m.is_row_compressed:
        cls = p._classes(text)
        s, e, _ = p._walk_triples(port_wwl.compact_lanes(carry(m), cls), len(cls))
        assert list(zip(s.tolist(), e.tolist())) == _gold(p, text)


def test_mixed_route_continues_crossing_walks(monkeypatch):
    """The mixed dictionary really crosses: some walks are re-run on the host."""
    m, text = _dictionary("mixed")
    fixed = []
    real = port_wwl.apply_crossing_fixes

    def spy(mm, cls_p, d, arrays, idx, starts):
        fixed.append(len(idx))
        return real(mm, cls_p, d, arrays, idx, starts)

    monkeypatch.setattr(port_wwl, "apply_crossing_fixes", spy)
    kws = _mixed_keywords()
    p, j = _pair(True, kws)
    want = _check(p, j, text, min_matches=20)
    assert fixed and fixed[0] > 0
    assert any(" " in kws[int(v[1:])] for _, _, v in want)


def test_walk_route_table_bytes_equal_jax(monkeypatch):
    """Where no scan table applies, both packages walk; their walk tables
    are the same bytes."""
    for mod in (jax_wwl, port_wwl):
        monkeypatch.setattr(mod, "scan_applicable", lambda m: False)
        monkeypatch.setattr(mod, "mixed_scan_applicable", lambda m: False)
    taken = _routes(monkeypatch)
    kws = _fuzz_keywords(5, n=30)
    text = _soup(5, kws)
    p, j = _pair(True, kws)
    _check(p, j, text, min_matches=20)
    assert taken == ["walk"]
    assert p.device_table_bytes() == j.device_table_bytes() > 0


@pytest.mark.parametrize("engine", ["gold", "device"])
def test_word_chars_and_toggle_flags(engine):
    kws = ["can't", "o'clock", "naive", "x-ray", "ray", "can", "new york"]
    text = "can't x-ray ray o'clock can naive x-rays can'tx new york new yorker " * 4
    wc = dict(word_chars=list("abcdefghijklmnopqrstuvwxyz'-"))
    p = port.WholeWordLongestMatchSet(kws, engine=engine, device="cpu", **wc)
    j = jax_pkg.WholeWordLongestMatchSet(kws, engine=engine, **wc)
    want = _gold(p, text)
    assert p.match(text) == j.match(text) == want
    assert (0, 5) in want  # "can't" is one word here
    toggles = dict(word_chars=["-", "_"], toggle_flags=[True, False])
    p = port.WholeWordLongestMatchMap(kws, list(range(len(kws))), engine=engine,
                                      device="cpu", **toggles)
    j = jax_pkg.WholeWordLongestMatchMap(kws, list(range(len(kws))), engine=engine, **toggles)
    want = _gold(p, text)
    assert p.match(text) == j.match(text) == want
    assert (6, 11, 3) in want  # "-" toggled into the word chars


def test_case_folding_map_non_bmp_and_empty_text():
    kws = ["Hello", "WORLD", "hell", "\U0001F600 x", "ß", "straße"]
    vals = ["a", "b", "c", "d", "e", "f"]
    text = "hello world HELL hello;hell \U0001F600 x STRASSE straße ß " * 8
    p, j = (cls(kws, vals, case_sensitive=False, engine="device", **kw)
            for cls, kw in ((port.WholeWordLongestMatchMap, {"device": "cpu"}),
                            (jax_pkg.WholeWordLongestMatchMap, {})))
    want = _check(p, j, text, min_matches=20)
    assert any(v == "d" for _, _, v in want)
    assert p.match("") == [] and p.count("") == 0
    e = port.WholeWordLongestMatchSet(["ab"], engine="device", device="cpu")
    assert e.match("") == [] and e.device_table_bytes() == 0


def test_auto_engine_threshold():
    kws = _fuzz_keywords(7)
    p = port.WholeWordLongestMatchSet(kws, device="cpu")
    small = "abc hel " * 10
    big = "abc hel lp " * (port_matchers._AUTO_DEVICE_MIN_UNITS // 10 + 1)
    assert p.match(small) == _gold(p, small)
    assert p.last_stats.engine == "gold"
    assert p.match(big) == _gold(p, big)
    assert p.last_stats.engine == "device"
