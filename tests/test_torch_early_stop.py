"""The port's sequential-scan kernel twin (``kernels/scan_dfa.seq_states``)
vs the JAX package's ``_SeqScan`` and ``dfa_states``, and its chunked
early-stop listener scans vs the JAX package's, for all ten classes
(``device="cpu"``).  Everything compared is an integer: exact equality."""

import io

import numpy as np
import pytest
import torch

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core import stream as jax_stream
from ahocorasick_tpu.core.compiler import compile_matcher as jax_compile
from ahocorasick_tpu.ops import scan_dfa as jax_scan_dfa
from ahocorasick_tpu_torch.core import stream as port_stream
from ahocorasick_tpu_torch.kernels import scan_dfa as port_kernels
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_dfa as port_ops_dfa
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


# ------------------------------------------------------------------ the kernel


def _tables(form):
    """A goto closure (dense, padded as the matchers pad it; or RowTable) and
    the shortest restart table of a fuzz dictionary, from the JAX package."""
    rng = np.random.default_rng(5)
    kws = sorted({"".join(rng.choice(list("abcd"), size=int(rng.integers(1, 6))))
                  for _ in range(40)})
    thr = _NeverDense() if form == "rows" else None
    kind = "shortest" if form == "restart" else "ac"
    m = jax_compile(kws, kind, True, thresholder=thr)
    table = (jax_stream._ShortestCursor._restart_table(m) if form == "restart"
             else m.dfa_next)
    return m, table


@pytest.mark.parametrize("s0", [0, 3])
@pytest.mark.parametrize("n", [1, 2, 257, 4100])
@pytest.mark.parametrize("form", ["dense", "rows", "restart"])
def test_seq_states_twin_equals_jax_seqscan(form, n, s0):
    m, table = _tables(form)
    assert (form == "rows") == m.is_row_compressed
    cls = np.random.default_rng(n + s0).integers(0, m.num_classes, size=n).astype(np.int32)
    want, want_carry = jax_stream._SeqScan(table).states(cls, s0)
    tab, rid = port_stream.seq_tensors(
        carry(m).dfa_next if form == "rows" else np.asarray(table), CPU)
    assert (rid is not None) == (form == "rows")
    got = port_kernels.seq_states(tab, rid, torch.from_numpy(cls), s0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    states, got_carry = port_stream._SeqScan(
        carry(m).dfa_next if form == "rows" else table, CPU).states(cls, s0)
    np.testing.assert_array_equal(states, want)
    assert got_carry == want_carry == int(want[-1])


@pytest.mark.parametrize("s0", [0, 7])
def test_dfa_states_equals_jax(s0):
    import jax.numpy as jnp

    m, _ = _tables("dense")
    cls = np.random.default_rng(s0).integers(0, m.num_classes, size=900).astype(np.int32)
    want = np.asarray(jax_scan_dfa.dfa_states(jnp.asarray(m.dfa_next), jnp.asarray(cls), s0))
    dev = port_matchers._DeviceTables(carry(m), CPU)
    got = port_ops_dfa.dfa_states(dev.dfa_next, torch.from_numpy(cls), s0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert dev.seq_tables[0] is dev.dfa_next and dev.seq_tables[1] is None


def test_seq_states_checks_its_arguments():
    tab = torch.zeros((4, 8), dtype=torch.int32)
    cls = torch.zeros(3, dtype=torch.int32)
    assert port_kernels.seq_states(tab, None, cls[:0], 0).shape == (0,)
    with pytest.raises(TypeError):
        port_kernels.seq_states(tab.to(torch.int64), None, cls, 0)
    with pytest.raises(TypeError):
        port_kernels.seq_states(tab, None, cls.to(torch.uint8), 0)
    with pytest.raises(ValueError, match="entry state"):
        port_kernels.seq_states(tab, None, cls, 4)
    with pytest.raises(ValueError, match="entry state"):
        port_kernels.seq_states(tab, torch.zeros(2, dtype=torch.int32), cls, 2)
    with pytest.raises(ValueError, match="contiguous"):
        port_kernels.seq_states(tab.t(), None, cls, 0)


def test_empty_scan_keeps_the_carry():
    states, s = port_stream._SeqScan(np.zeros((2, 2), np.int32), CPU).states(
        np.zeros(0, np.int32), 1)
    assert len(states) == 0 and s == 1


@pytest.mark.parametrize("form", ["dense", "rows"])
def test_restart_table_equals_jax_and_is_memoized(form):
    kws = ["she", "he", "hers", "abab", "x"]
    m = jax_compile(kws, "shortest", True, thresholder=_NeverDense() if form == "rows" else None)
    want = jax_stream._ShortestCursor._restart_table(m)
    pm = carry(m)
    got = port_stream._ShortestCursor._restart_table(pm)
    assert port_stream._ShortestCursor._restart_table(pm) is got
    if form == "rows":
        np.testing.assert_array_equal(got.rows, want.rows)
        np.testing.assert_array_equal(got.row_id, want.row_id)
    else:
        np.testing.assert_array_equal(got, want)


def test_expand_state_emits_equals_jax():
    m, table = _tables("dense")
    cls = np.random.default_rng(1).integers(0, m.num_classes, size=700).astype(np.int32)
    states, _ = jax_stream._SeqScan(table).states(cls, 0)
    want = jax_stream.expand_state_emits(m, states, 11)
    got = port_stream.expand_state_emits(carry(m), states, 11)
    assert len(want[0]) > 20
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_constants_and_chunk_rule_equal_jax():
    # The device threshold is the card's own (PERF.md); the read size
    # of a device-capable scanner is the JAX package's, so streams chunk alike.
    assert port_stream._STREAM_READ_UNITS == jax_stream._STREAM_DEVICE_MIN == 1 << 14
    assert port_stream._STREAM_DEVICE_MIN == 1 << 12
    assert port_stream._STREAM_CHUNK == jax_stream._STREAM_CHUNK == 512
    for d in (1, 7, 2048, 2049, 5000):
        assert port_stream.default_chunk_units(d) == jax_stream.default_chunk_units(d)
    assert (port.AhoCorasickSet._LISTENER_CHUNK, port.AhoCorasickSet._LISTENER_CHUNK_MIN) == (
        jax_pkg.AhoCorasickSet._LISTENER_CHUNK, jax_pkg.AhoCorasickSet._LISTENER_CHUNK_MIN)
    assert list(port_stream._read_chunks(io.StringIO("abcdefg"), 3)) == ["abc", "def", "g"]
    assert list(port_stream._read_chunks(["ab", "", "cdefg"], 3)) == ["ab", "cdefg"]


# --------------------------------------------------------- early-stop listener


def _patch_chunks(monkeypatch, big, small):
    for base in (port_matchers._Matcher, jax_pkg.models.matchers._Matcher):
        monkeypatch.setattr(base, "_LISTENER_CHUNK", big)
        monkeypatch.setattr(base, "_LISTENER_CHUNK_MIN", small)


@pytest.mark.parametrize("stop_at", [1, 7, None])
@pytest.mark.parametrize("name", NAMES)
def test_early_stop_listener_equals_jax(name, stop_at, monkeypatch):
    """With the chunk constants patched small in both packages: the same
    delivered prefix, the same ``last_stats.units`` / ``.matches``, and a
    scan that stopped after the chunk of the stopping match."""
    _patch_chunks(monkeypatch, 1024, 64)
    rng = np.random.default_rng(7 + NAMES.index(name))
    kws = _kws(name)
    text = " ".join(kws[int(rng.integers(len(kws)))] if int(rng.integers(8)) == 0
                    else _word_soup(rng, 1) for _ in range(1400))
    p, j = _pair(name, "device")
    full = _gold(p, text)
    assert len(full) > 20 and len(text) > 4096
    stats = []
    for m in (p, j):
        assert m._listener_chunkable(text)
        got = []

        def listener(t, *trip):
            assert t is text
            got.append(trip)
            return stop_at is None or len(got) < stop_at

        assert m.match(text, listener) is None
        assert got == full[: stop_at or len(full)]
        stats.append((m.last_stats.units, m.last_stats.matches, m.last_stats.engine))
    assert stats[0] == stats[1]
    assert stats[0][1] == (stop_at or len(full))
    if stop_at is None:
        assert stats[0][0] == len(text)
    else:
        assert stats[0][0] < len(text) // 2


def test_chunk_schedule_grows_fourfold(monkeypatch):
    _patch_chunks(monkeypatch, 1024, 64)
    p, _ = _pair("AhoCorasickSet", "device", ["needle"])
    fed = []
    real = port_stream.StreamScanner.feed_arrays

    def spy(self, text, is_final):
        fed.append(len(text))
        return real(self, text, is_final)

    monkeypatch.setattr(port_stream.StreamScanner, "feed_arrays", spy)
    p.match("x" * 3000, lambda t, s, e: True)
    assert fed == [64, 256, 1024, 1024, 632]
    assert p.last_stats.units == 3000 and p.last_stats.matches == 0


def test_short_texts_and_gold_keep_the_full_scan(monkeypatch):
    _patch_chunks(monkeypatch, 1024, 64)
    p, j = _pair("AhoCorasickSet", "gold")
    text = TEXT * 8
    assert not p._listener_chunkable(text) and not j._listener_chunkable(text)
    p2, j2 = _pair("AhoCorasickSet", "device")
    assert not p2._listener_chunkable("x" * 512)  # cannot reach the gate
    assert not p2._listener_chunkable("x" * 1024) and p2._listener_chunkable("x" * 1025)
    got = []
    p.match(text, lambda t, s, e: got.append((s, e)) or len(got) < 2)
    assert got == _gold(p, text)[:2]
    assert p.last_stats.units == len(text)  # delivery stopped, the scan did not


def test_listener_gate_and_stats_count_utf16_units(monkeypatch):
    """Astral code points count twice: a text under the gate in code points
    but over it in units is chunked, and ``last_stats.units`` counts units."""
    _patch_chunks(monkeypatch, 1024, 64)
    hay = "needle " + "\U0001F600" * 600 + " needle"
    assert len(hay) < 1024
    stats = []
    for m in _pair("AhoCorasickSet", "device", ["needle"]):
        assert m._listener_chunkable(hay)
        seen = []
        m.match(hay, lambda t, s, e: (seen.append((s, e)), False)[1])
        assert seen == [(0, 6)]
        stats.append(m.last_stats.units)
        everything = []
        m.match(hay, lambda t, s, e: everything.append((s, e)) or True)
        assert everything == [(0, 6), (1208, 1214)]
        stats.append(m.last_stats.units)
    assert stats == [7 + 2 * 57, 1214] * 2


