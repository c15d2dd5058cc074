"""The port's stream cursors, ``match_stream`` / ``stream()`` /
``match_readable`` and chunked early-stop listener scans (``device="cpu"``:
the kernels' plain twins) vs the JAX package's and the gold model, for all
ten classes.  The same seeded texts and feed splits go through both packages;
triples, offsets and resume points are integers, so every comparison is
exact equality."""

import io
import json

import numpy as np
import pytest
import torch

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core import stream as jax_stream
from ahocorasick_tpu.core.compiler import compile_matcher as jax_compile
from ahocorasick_tpu.core.compiler import shortest_survivors
from ahocorasick_tpu_torch.core import stream as port_stream
from ahocorasick_tpu_torch.kernels import scan_dfa as port_kernels
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.ops import scan_wwl as port_wwl
from test_torch_host import carry

KINDS = ("AhoCorasick", "LongestMatch", "ShortestMatch", "WholeWordMatch",
         "WholeWordLongestMatch")
NAMES = [k + s for k in KINDS for s in ("Set", "Map")]
ENGINES = ("auto", "device", "gold")
CPU = torch.device("cpu")

KEYWORDS = {
    "AhoCorasick": ["he", "she", "his", "hers", "ab", "abab", "x"],
    "LongestMatch": ["he", "she", "hers", "herself", "ab", "abab", "aba"],
    "ShortestMatch": ["she", "he", "hers", "abab", "x"],
    "WholeWordMatch": ["he", "she", "hers", "abab", "stand"],
    "WholeWordLongestMatch": ["as", "as if", "as if by", "he", "she said", "stand up"],
}

TEXT = (
    "she said he stands as if by magic ababab x hers herself stand up "
    "as ifx as   if he she said stand up now abab she"
) * 3


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


def _kws(name):
    return KEYWORDS[name[:-3]]


def _pair(name, engine, kws=None, **kw):
    """The port's and the JAX package's matcher of one class."""
    kws = _kws(name) if kws is None else kws
    args = (kws, [f"v{i}" for i in range(len(kws))]) if name.endswith("Map") else (kws,)
    p = getattr(port, name)(*args, engine=engine, device="cpu", **kw)
    j = getattr(jax_pkg, name)(*args, engine=engine, **kw)
    return p, j


def _gold(m, text):
    vals = m.compiled.values
    if m.is_map:
        return [(s, e, vals[v]) for s, e, v in gold.gold_match(m.compiled, text)]
    return [(s, e) for s, e, _ in gold.gold_match(m.compiled, text)]


def _word_soup(rng, n_words, alpha="abchers xyif"):
    return " ".join("".join(rng.choice(list(alpha), size=int(rng.integers(1, 9))))
                    for _ in range(n_words))


def _split(rng, text, max_piece):
    pieces, i = [], 0
    while i < len(text):
        k = int(rng.integers(1, max_piece))
        pieces.append(text[i: i + k])
        i += k
    return pieces


# ------------------------------------------------------- streams, all classes


@pytest.mark.parametrize("engine, chunk", [("auto", 1), ("auto", 7), ("auto", 4096),
                                           ("gold", 2), ("gold", 16),
                                           ("device", 16), ("device", 600)])
@pytest.mark.parametrize("name", NAMES)
def test_match_stream_equals_jax_and_string(name, engine, chunk):
    p, j = _pair(name, engine)
    want = _gold(p, TEXT)
    assert len(want) > 10
    assert p.match_stream(io.StringIO(TEXT), chunk_units=chunk) == want
    assert j.match_stream(io.StringIO(TEXT), chunk_units=chunk) == want
    assert p.match(TEXT) == want


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", NAMES)
def test_stream_fuzz_random_pieces(name, engine):
    """Iterable sources, irregular pieces; the push-mode stream of both
    packages fed the same pieces agrees feed by feed, resume points too."""
    rng = np.random.default_rng(1234 + NAMES.index(name))
    p, j = _pair(name, engine)
    for trial in range(3):
        text = _word_soup(rng, int(rng.integers(20, 150)))
        want = _gold(p, text)
        pieces = _split(rng, text, 12 if engine != "device" else 300)
        assert p.match_stream(pieces) == j.match_stream(pieces) == want, (trial, text)
        ps, js = p.stream(), j.stream()
        got = []
        for i, piece in enumerate(pieces):
            final = i == len(pieces) - 1
            a, b = ps.feed(piece, final), js.feed(piece, final)
            assert a == b, (trial, i)
            assert ps.state_dict() == js.state_dict(), (trial, i)
            got += a
        assert got == want


@pytest.mark.parametrize("engine", ["auto", "device"])
@pytest.mark.parametrize("name", NAMES)
def test_state_dicts_cross_between_the_packages(name, engine):
    """A JAX cursor's resume point continues in a port cursor, and the
    reverse, through JSON, for every cursor class."""
    p, j = _pair(name, engine)
    assert type(p._stream_scanner(None).cursor).__name__ == type(
        j._stream_scanner(None).cursor).__name__
    text = TEXT + " " + TEXT
    want = _gold(p, text)
    for cut in (len(text) // 3, len(text) // 2 + 1):
        for first, second in ((p, j), (j, p), (p, p)):
            s1 = first.stream(chunk_units=97)
            got = s1.feed(text[:cut], is_final=False)
            state = json.loads(json.dumps(s1.state_dict()))
            s2 = second.stream()
            s2.load_state_dict(state)
            got += s2.feed(text[cut:], is_final=True)
            assert got == want, (cut, type(first).__module__)


@pytest.mark.parametrize("name", ["AhoCorasickSet", "AhoCorasickMap", "LongestMatchSet",
                                  "LongestMatchMap"])
def test_legacy_state_dict_resumes_exactly(name):
    """Resume points of the older format ({"state", "off"}) still load: the
    cursor carries the state id through the sequential scan until the tail
    is determined; output and later resume points equal the JAX package's."""
    p, j = _pair(name, "device")
    text = TEXT + " " + TEXT
    cut = 40
    want = _gold(p, text)
    state = 0
    for u in p._classes(text[:cut]):
        state = int(p.compiled.dfa_next[state, u])
    outs = []
    for m in (p, j):
        s1 = m.stream()
        got = s1.feed(text[:cut], is_final=False)
        legacy = {"state": state, "off": cut}
        if name.startswith("Longest"):
            legacy["queue"] = s1.state_dict()["queue"]
        s2 = m.stream()
        s2.load_state_dict(legacy)
        assert s2.state_dict()["state"] == state
        dicts = []
        for i in range(cut, len(text), 13):
            got += s2.feed(text[i: i + 13], is_final=i + 13 >= len(text))
            dicts.append(s2.state_dict())
        assert got == want
        outs.append(dicts)
    assert outs[0] == outs[1]
    assert "tail" in outs[0][-1]  # converged back to the tail format


@pytest.mark.parametrize("name", ["WholeWordMatchSet", "WholeWordLongestMatchSet",
                                  "WholeWordMatchMap", "WholeWordLongestMatchMap"])
def test_cross_cursor_resume_formats(name):
    """Whole-word resume points cross-load between the device cursors and the
    host tail-replay cursor, both directions, incl. the older ``tail_off``
    format into ``_WwCursor``; both packages agree."""
    p, j = _pair(name, "device")
    text, cut = TEXT, 37
    want = [(s, e) for s, e, *_ in _gold(p, text)]

    def pairs(trips):
        return [(a, b) for a, b, _ in trips]

    def scanners(m, device_cursor):
        if m is p:
            if device_cursor:
                return port_stream.StreamScanner(m.compiled, device=CPU, dev=m.dev,
                                                 engine="device")
            return port_stream.StreamScanner(m.compiled, device=CPU)
        if device_cursor:
            return jax_stream.StreamScanner(m.compiled, dev=m.dev, engine="device")
        return jax_stream.StreamScanner(m.compiled)

    dicts = []
    for m in (p, j):
        for first_device in (True, False):
            s1 = scanners(m, first_device)
            assert isinstance(s1.cursor, port_stream._WordCursor if m is p else
                              jax_stream._WordCursor) == (not first_device)
            got = pairs(s1.feed(text[:cut], is_final=False))
            d = json.loads(json.dumps(s1.state_dict()))
            assert ("tail_off" in d) == (not first_device)
            s2 = scanners(m, not first_device)
            s2.load_state_dict(d)
            got += pairs(s2.feed(text[cut:], is_final=True))
            assert got == want, (first_device, type(m).__module__)
            dicts.append(d)
    assert dicts[:2] == dicts[2:]


def test_whole_word_boundary_holdback_and_resume():
    p, j = _pair("WholeWordMatchSet", "device", ["he", "hers"])
    outs = []
    for m in (p, j):
        s1 = m.stream()
        assert s1.feed("x he", is_final=False) == []  # 'he' pending (right edge)
        d = json.loads(json.dumps(s1.state_dict()))
        got = [d]
        for rest in (" x", "rs x", ""):
            s = m.stream()
            s.load_state_dict(d)
            got.append(s.feed(rest, is_final=True))
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][1:] == [[(2, 4)], [(2, 6)], [(2, 4)]]


def test_empty_sources_and_empty_final_feed():
    for name in NAMES:
        p, _ = _pair(name, "auto")
        assert p.match_stream(io.StringIO("")) == []
        assert p.match_stream([]) == []
    p, j = _pair("LongestMatchSet", "device")
    for m in (p, j):  # a resumed cursor finalizes on an empty source
        s1 = m.stream()
        assert s1.feed("xx she", is_final=False) == []
        s2 = m._stream_scanner(None)
        s2.load_state_dict(s1.state_dict())
        assert list(s2.scan(io.StringIO(""))) == [(3, 6, -1)]


def test_stream_listener_early_stop_and_readable():
    p, j = _pair("AhoCorasickSet", "gold", ["a"])
    for m in (p, j):
        seen = []
        m.match_stream(io.StringIO("aaaa"), lambda s, e: seen.append((s, e)) or len(seen) < 2,
                       chunk_units=1)
        assert seen == [(0, 1), (1, 2)]
        with pytest.raises(TypeError):
            m.match_readable(io.StringIO("a"), lambda v: True)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", [n for n in NAMES if n.endswith("Map")])
def test_match_readable_values_only(name, engine, tmp_path):
    """A real file through ``match_readable``: values only, ``False`` stops."""
    p, j = _pair(name, engine)
    path = tmp_path / "text.txt"
    path.write_text(TEXT, encoding="utf-8")
    want = [v for _, _, v in _gold(p, TEXT)]
    for m in (p, j):
        got = []
        with open(path, encoding="utf-8") as fh:
            m.match_readable(fh, got.append, chunk_units=50)
        assert got == want
        got = []
        with open(path, encoding="utf-8") as fh:
            m.match_readable(fh, lambda v: got.append(v) or len(got) < 3, chunk_units=50)
        assert got == want[:3]
        seen = []
        with open(path, encoding="utf-8") as fh:
            m.match_stream(fh, lambda s, e, v: seen.append((s, e, v)) or len(seen) < 4)
        assert seen == _gold(p, TEXT)[:4]


def test_shortest_map_boundary_single_report():
    """A match pending exactly at a buffer boundary is reported once (String
    mode is the spec), as the JAX package does."""
    p, j = _pair("ShortestMatchMap", "gold", ["ab"])
    text = "ab" * 8
    want = p.match(text)
    assert len(want) == 8
    for chunk in (1, 2, 3):
        assert p.match_stream(io.StringIO(text), chunk_units=chunk) == want
        assert j.match_stream(io.StringIO(text), chunk_units=chunk) == want


def test_long_keyword_spanning_many_chunks():
    kw = "a" * 50
    p, j = _pair("LongestMatchSet", "gold", [kw, "aa"])
    text = "b" + "a" * 120 + "b" + "a" * 3
    want = _gold(p, text)
    assert p.match_stream(io.StringIO(text), chunk_units=7) == want
    assert j.match_stream(io.StringIO(text), chunk_units=7) == want


@pytest.mark.parametrize("name", ["AhoCorasickSet", "LongestMatchMap", "WholeWordMatchSet"])
def test_hotstate_layout_under_a_cursor(name):
    """Streams over a dictionary whose emit masks do not pack inline take the
    hotstate plane per feed; a dropped layout would give wrong matches."""
    kws = ["a" * i for i in range(1, 70)] + ["ab", "ba"]
    p, j = _pair(name, "device", kws)
    assert port_sb.hotstate_layout(p.compiled)
    text = "".join(np.random.default_rng(11).choice(list("aab "), size=3000))
    want = _gold(p, text)
    assert len(want) > 50
    for chunk in (64, 700):
        assert p.match_stream(io.StringIO(text), chunk_units=chunk) == want, chunk
    assert j.match_stream(io.StringIO(text), chunk_units=700) == want


def test_non_bmp_surrogate_pairs():
    p, j = _pair("AhoCorasickSet", "device", ["a\U0001F600b", "\U0001F600"])
    text = "x\U0001F600 a\U0001F600b yes a\U0001F600bz"
    want = _gold(p, text)
    assert want
    for chunk in (1, 2, 3, 5):
        assert p.match_stream(io.StringIO(text), chunk_units=chunk) == want
        assert j.match_stream(io.StringIO(text), chunk_units=chunk) == want


@pytest.mark.parametrize("engine", ["gold", "device"])
def test_wwl_separator_keywords_and_stream_start(engine):
    """The initial walk starts at position 0 whatever its wordness; a
    mid-stream buffer's index 0 is not a word start."""
    for kws, text in (([" ", "-"], " "), ([" ", "-"], " -x "), (["- a", "a"], "- a - a-"),
                      (["中"], " a 中  中中中 中中 ")):
        p, j = _pair("WholeWordLongestMatchSet", engine, kws)
        want = _gold(p, text)
        for chunk in (1, 2, 3, 7):
            assert p.match_stream(io.StringIO(text), chunk_units=chunk) == want, (kws, chunk)
            assert j.match_stream(io.StringIO(text), chunk_units=chunk) == want, (kws, chunk)


@pytest.mark.parametrize("route", ["scan", "mixed", "walk"])
def test_wwl_cursor_takes_every_route(route, monkeypatch):
    """The device cursor picks the batch path's route: the scan over the goto
    closure, the truncated-closure scan with host crossing fixes, or (both
    scans switched off) the per-start walk."""
    kws = (["new york", "new", "york", "ab"] if route == "mixed"
           else ["he", "she", "hers", "ab", "ch"])
    p, j = _pair("WholeWordLongestMatchSet", "device", kws)
    assert port_wwl.scan_applicable(p.compiled) == (route != "mixed")
    assert port_wwl.mixed_scan_applicable(p.compiled) == (route == "mixed")
    if route == "walk":
        monkeypatch.setattr(port_wwl, "scan_applicable", lambda m: False)
        monkeypatch.setattr(port_wwl, "mixed_scan_applicable", lambda m: False)
    taken = []
    for fn in ("scan_lane_outcomes", "walk_lane_outcomes"):
        real = getattr(port_wwl, fn)
        monkeypatch.setattr(port_wwl, fn, lambda *a, _r=real, _f=fn: (taken.append(_f), _r(*a))[1])
    assert isinstance(p._stream_scanner(None).cursor, port_stream._WwlCursor)
    rng = np.random.default_rng(13)
    words = [kws[0] if int(rng.integers(10)) < 2 else
             "".join(rng.choice(list("newyorkabhers"), size=int(rng.integers(2, 6))))
             for _ in range(300)]
    text = " ".join(words)
    want = _gold(p, text)
    assert len(want) > 20
    pieces = _split(rng, text, 300)
    assert p.match_stream(pieces) == want
    assert set(taken) == {"walk_lane_outcomes" if route == "walk" else "scan_lane_outcomes"}
    assert j.match_stream(pieces) == want


# ------------------------------------------------------------------- shortest


def test_shortest_small_stream_skips_second_compile():
    p, j = _pair("ShortestMatchSet", "auto", ["she", "he", "hers"])
    for m in (p, j):
        assert m._ac_cache is None
        got = m.match_stream(io.StringIO("ushers and he"), chunk_units=4)
        assert m._ac_cache is None  # small feeds never resolve the supplier
        assert got == _gold(p, "ushers and he")


@pytest.mark.parametrize("is_map", [False, True], ids=["set", "map"])
def test_shortest_upgrades_from_seq_to_candidates_mid_stream(is_map):
    """A later feed that crosses the device threshold upgrades the cursor
    exactly; the mode, the carried state id and the tail are observable
    through ``state_dict`` and equal the JAX package's at every step."""
    rng = np.random.default_rng(3)
    p, j = _pair("ShortestMatch" + ("Map" if is_map else "Set"), "auto")
    small = _word_soup(rng, 30) + " "
    big = _word_soup(rng, 4200)
    assert len(big) >= port_stream._STREAM_DEVICE_MIN
    tailpiece = " she x abab"
    want = _gold(p, small + big + tailpiece)
    ps, js = p.stream(), j.stream()
    got = ps.feed(small, False)
    assert got == js.feed(small, False)
    assert p._ac_cache is None and "state" in ps.state_dict()  # SEQ mode
    assert ps.state_dict() == js.state_dict()
    a, b = ps.feed(big, False), js.feed(big, False)
    assert a == b and p._ac_cache is not None  # upgraded
    assert ps.state_dict() == js.state_dict() and "state" not in ps.state_dict()
    got += a
    a, b = ps.feed(tailpiece, True), js.feed(tailpiece, True)
    assert a == b
    assert got + a == want


def _remapped_shortest(pkg, engine="device", with_ac=True):
    """A shortest matcher whose inner AC numbers its classes differently."""
    kws = ["b", "ca", "a", "abc", "cab"]
    outer = jax_compile(kws, "shortest", True)
    survivors, _ = shortest_survivors(kws, True)
    inner = jax_compile(survivors + ["AZ"], "ac", True)
    assert not np.array_equal(outer.charmap, inner.charmap)
    if pkg is port:
        return port.ShortestMatchSet.from_compiled(
            carry(outer), engine=engine, device="cpu",
            ac_compiled=carry(inner) if with_ac else None)
    return jax_pkg.ShortestMatchSet.from_compiled(
        outer, engine=engine, ac_compiled=inner if with_ac else None)


def test_shortest_tail_switches_class_space_and_ac_space_errors():
    text = "abcab cba bca acb " * 30
    p, j = _remapped_shortest(port), _remapped_shortest(jax_pkg)
    want = _gold(p, text)
    dicts = []
    for m in (p, j):
        s1 = m.stream()
        got = s1.feed(text[:100], False)
        d = json.loads(json.dumps(s1.state_dict()))
        assert d["ac_space"] is True and "state" not in d
        s2 = m.stream()
        s2.load_state_dict(d)
        assert got + s2.feed(text[100:], True) == want
        dicts.append(d)
    assert dicts[0] == dicts[1]
    # No AC source: an ac_space tail cannot be read; a plain tail resumes in
    # SEQ mode from a state replayed over the tail.
    for pkg in (port, jax_pkg):
        bare = _remapped_shortest(pkg, engine="auto", with_ac=False)
        with pytest.raises(ValueError, match="class-remapped"):
            bare.stream().load_state_dict(dicts[0])
        plain = _remapped_shortest(pkg, engine="gold")
        s1 = plain.stream()
        got = s1.feed(text[:100], False)
        d = s1.state_dict()
        assert "state" in d and "ac_space" not in d
        s2 = bare.stream()
        s2.load_state_dict({"tail": d["tail"], "off": d["off"], "p": d["p"]})
        assert s2.state_dict()["state"] == d["state"]
        assert got + s2.feed(text[100:], True) == want
        # A tail in the outer class space into a matcher that remaps: refused.
        with pytest.raises(ValueError, match="class space"):
            _remapped_shortest(pkg).stream().load_state_dict(
                {"tail": d["tail"], "off": d["off"], "p": d["p"]})


def test_shortest_legacy_resume_stays_pinned_to_seq_mode():
    """A resume point without the restart cursor ``p`` must not launder
    p = 0 into a trusted value on re-save; both packages agree."""
    p, j = _pair("ShortestMatchSet", "auto", ["abcd", "bc"])
    outs = []
    for m in (p, j):
        s1 = m.stream()
        s1.load_state_dict({"state": 0, "off": 100})
        seq = [s1.state_dict()]
        assert "p" not in seq[0] and "tail" not in seq[0]
        s1.feed("xxxx", is_final=False)
        seq.append(s1.state_dict())
        assert "p" not in seq[1]
        trips = s1.feed("xabcdx", is_final=False)
        seq.append(s1.state_dict())
        assert trips and seq[2]["p"] == trips[-1][1] and "tail" in seq[2]
        outs.append((seq, trips))
    assert outs[0] == outs[1]


# ------------------------------------------------- row-compressed gold branch


@pytest.mark.parametrize("name", ["AhoCorasickSet", "AhoCorasickMap", "LongestMatchSet",
                                  "ShortestMatchSet", "ShortestMatchMap"])
def test_row_compressed_gold_branch_feeds_one_cursor(name, monkeypatch):
    """Row-compressed AC / Longest / Shortest dictionaries answer ``gold``
    through one cursor feed over the RowTable form of the sequential scan,
    not the per-character gold loop."""
    calls = []
    real = port_kernels.seq_states

    def spy(table, row_id, cls, s0=0, sync_depth=None):
        calls.append((row_id is not None, int(cls.shape[0]), sync_depth))
        return real(table, row_id, cls, s0, sync_depth)

    monkeypatch.setattr(port_kernels, "seq_states", spy)
    monkeypatch.setattr(port_matchers.gold, "gold_match",
                        lambda *a: pytest.fail("the per-character gold loop ran"))
    wide = ["a" * 32, "b", "ab", "ba"]  # depth 32: no quotient packs inline
    p, j = _pair(name, "auto", wide, thresholder=_NeverDense())
    assert p.compiled.is_row_compressed
    text = "".join(np.random.default_rng(2).choice(list("ab "), size=900)) + "a" * 40
    want = j.match(text)
    assert p.match(text) == want and len(want) > 30
    assert p.last_stats.engine == "gold" and p.last_stats.units == len(text)
    # The goto closure synchronizes at its depth; the Shortest kinds scan
    # the restart table, which does not.
    depth = None if name.startswith("Shortest") else max(p.compiled.max_depth, 1)
    assert calls == [(True, len(text), depth)]
    assert p.match_stream(io.StringIO(text), chunk_units=64) == want


# ------------------------------------------------------------------- devices


def test_cursors_take_an_explicit_device():
    p, _ = _pair("AhoCorasickSet", "auto")
    with pytest.raises(TypeError):
        port_stream.make_cursor(p.compiled)
    with pytest.raises(TypeError):
        port_stream.StreamScanner(p.compiled)
    cur = port_stream.make_cursor(p.compiled, "cpu", p.dev)
    assert cur.src.device == CPU and cur.src.seq_scan().device == CPU
    assert cur.src.seq_scan()._tensors is p.dev.seq_tables

    class _Elsewhere:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="table cache"):
        port_stream.make_cursor(p.compiled, "cpu", _Elsewhere())
    sc = p._stream_scanner(None)
    assert sc.chunk_units == port_stream._STREAM_READ_UNITS  # device-sized reads
    assert p._stream_scanner(5).chunk_units == 5
    g, _ = _pair("AhoCorasickSet", "gold")
    assert g._stream_scanner(None).chunk_units == 4096


def test_whole_word_auto_keeps_the_host_cursor_on_the_cpu():
    for name in ("WholeWordMatchSet", "WholeWordLongestMatchMap"):
        for engine, want in (("auto", "_WordCursor"), ("gold", "_WordCursor")):
            p, j = _pair(name, engine)
            assert type(p._stream_scanner(None).cursor).__name__ == want
            assert type(j._stream_scanner(None).cursor).__name__ == want
    p, _ = _pair("WholeWordMatchSet", "device")
    assert isinstance(p._stream_scanner(None).cursor, port_stream._WwCursor)


def test_package_exports_match_the_jax_package():
    assert set(jax_pkg.__all__) <= set(port.__all__)
    for name in jax_pkg.__all__:
        assert hasattr(port, name), name
