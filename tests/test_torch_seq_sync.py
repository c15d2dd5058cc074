"""The lane scan of ``kernels/scan_dfa.seq_states`` (``sync_depth=d``) and
the stride-2 count on the count lane (``kernels/scan_rowdfa.rowdfa2_count``),
through their plain twins, against the JAX package.

The synchronized twin steps every lane of the kernel's decomposition
together: lanes of ``sync_lane_len(N, d)`` positions, lane 0 from ``s0``,
every other lane from the root warmed over the d classes before it.  On a
goto closure (d-synchronizing at d = ``max(max_depth, 1)``) it must give the
JAX package's ``_SeqScan`` and ``dfa_states`` states bit for bit, dense and
RowTable, from the root and from a deep state, at every length around the
lane boundaries, and with ``L == d`` patched in.  The shortest restart table
does not synchronize and keeps the serial walk; a spy shows which callers
pass which depth.  The stride-2 count twin runs K = 1, 2 and 4 lanes a
window (the cap patched).  Everything compared is an integer: exact
equality.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import stream as jax_stream
from ahocorasick_tpu.core.compiler import compile_matcher as jax_compile
from ahocorasick_tpu.ops import scan_dfa as jax_scan_dfa
from ahocorasick_tpu.ops import scan_rowdfa as jax_rowdfa
from ahocorasick_tpu_torch.core import stream as port_stream
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.kernels import scan_dfa as port_kernels
from ahocorasick_tpu_torch.kernels import scan_rowdfa as krow
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from test_torch_host import carry
from test_torch_rowdfa import _classes, _compiled, _text

CPU = torch.device("cpu")


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


_TABLES = {}


def _goto(form):
    """A goto closure from the JAX package: ``fuzz`` (depth 5, the fixture
    of ``test_torch_early_stop._tables``) or ``deep`` (depth 39), dense or
    kept row-compressed (``_rows``)."""
    if form not in _TABLES:
        rows = form.endswith("_rows")
        if form.startswith("fuzz"):
            rng = np.random.default_rng(5)
            kws = sorted({"".join(rng.choice(list("abcd"), size=int(rng.integers(1, 6))))
                          for _ in range(40)})
        else:
            kws = ["a" * i for i in range(1, 40)] + ["the", "abc", "ba", "tat"]
        m = jax_compile(kws, "ac", True, thresholder=_NeverDense() if rows else None)
        assert m.is_row_compressed == rows
        _TABLES[form] = m
    return _TABLES[form]


def _port_tensors(m):
    return port_stream.seq_tensors(carry(m).dfa_next if m.is_row_compressed else m.dfa_next,
                                   CPU)


def _deep_state(m) -> int:
    """A state at the dictionary's greatest depth."""
    s = int(np.argmax(m.depth[: m.num_states]))
    assert m.depth[s] == m.max_depth
    return s


def _lengths(d):
    """n in {1, d - 1, d, L - 1, L, L + 1, several L and a ragged tail}."""
    L = port_kernels.sync_lane_len(4 * d, d)
    assert L >= d and L % 4 == 0
    return [1, max(d - 1, 1), d, L - 1, L, L + 1, 5 * L + 3]


FORMS = ("fuzz", "fuzz_rows", "deep", "deep_rows")


def _check_sync(m, n, s0, seed):
    d = max(m.max_depth, 1)
    table = m.dfa_next
    cls = np.random.default_rng(seed).integers(0, m.num_classes, size=n).astype(np.int32)
    if m.max_depth > 20:  # runs of the deep keyword's letter, so deep states recur
        cls[: n // 2] = m.charmap[ord("a")]
    want, want_carry = jax_stream._SeqScan(table).states(cls, s0)
    tab, rid = _port_tensors(m)
    got = port_kernels.seq_states(tab, rid, torch.from_numpy(cls), s0, sync_depth=d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    states, got_carry = port_stream._SeqScan(
        carry(m).dfa_next if m.is_row_compressed else table, CPU, sync_depth=d).states(cls, s0)
    np.testing.assert_array_equal(states, want)
    assert got_carry == want_carry == int(want[-1])
    return want


@pytest.mark.parametrize("where", ["root", "deep"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("which", range(7))
def test_sync_twin_equals_jax_seqscan(form, where, which):
    """At every length around the lane boundaries, from the root and from a
    deep state, dense and RowTable, d = 5 and d = 39."""
    m = _goto(form)
    n = _lengths(max(m.max_depth, 1))[which]
    s0 = 0 if where == "root" else _deep_state(m)
    _check_sync(m, n, s0, seed=n + 31 * which)


@pytest.mark.parametrize("s0", ["root", "deep"])
@pytest.mark.parametrize("form", FORMS)
def test_sync_twin_with_lanes_of_exactly_d(form, s0, monkeypatch):
    """``L == d`` (not a multiple of 4 for d = 5 and 39): every lane's
    warm-up reads the whole lane before it."""
    m = _goto(form)
    d = max(m.max_depth, 1)
    monkeypatch.setattr(port_kernels, "sync_lane_len", lambda n, depth: depth)
    for n in (d, d + 1, 7 * d + 2):
        _check_sync(m, n, 0 if s0 == "root" else _deep_state(m), seed=n)


@pytest.mark.parametrize("form", ["fuzz", "deep_rows"])
def test_sync_twin_with_long_lanes(form, monkeypatch):
    """A cap of 8 lanes makes L far longer than d, as on long feeds."""
    m = _goto(form)
    monkeypatch.setattr(port_kernels, "SEQ_MAX_LANES", 8)
    d = max(m.max_depth, 1)
    assert port_kernels.sync_lane_len(3000, d) == 376 > d
    _check_sync(m, 3000, _deep_state(m), seed=1)


def test_sync_lane_len_rule(monkeypatch):
    assert port_kernels.sync_lane_len(1, 1) == 4
    assert port_kernels.sync_lane_len(1 << 16, 12) == 12
    assert port_kernels.sync_lane_len(1 << 16, 39) == 40
    assert port_kernels.sync_lane_len(1 << 25, 12) == (1 << 25) // port_kernels.SEQ_MAX_LANES
    monkeypatch.setattr(port_kernels, "SEQ_MAX_LANES", 1000)
    assert port_kernels.sync_lane_len(1 << 20, 1) == 1052


@pytest.mark.parametrize("s0", [0, 7])
def test_dfa_states_sync_equals_jax(s0):
    m = _goto("fuzz")
    cls = np.random.default_rng(s0).integers(0, m.num_classes, size=900).astype(np.int32)
    want = np.asarray(jax_scan_dfa.dfa_states(jnp.asarray(m.dfa_next), jnp.asarray(cls), s0))
    dev = port_matchers._DeviceTables(carry(m), CPU)
    got = port_kernels.seq_states(dev.dfa_next, None, torch.from_numpy(cls), s0,
                                  sync_depth=m.max_depth)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sync_depth_is_checked():
    tab = torch.zeros((4, 8), dtype=torch.int32)
    cls = torch.zeros(3, dtype=torch.int32)
    assert port_kernels.seq_states(tab, None, cls[:0], 0, sync_depth=2).shape == (0,)
    with pytest.raises(ValueError, match="sync_depth"):
        port_kernels.seq_states(tab, None, cls, 0, sync_depth=0)
    with pytest.raises(TypeError):
        port_kernels.seq_states(tab, None, cls.to(torch.uint8), 0, sync_depth=2)


# ------------------------------------------------------------ the restart table


def _restart(form):
    kws = ["aa", "aaa"]  # a match restarts at the root: "aa" every other "a"
    m = jax_compile(kws, "shortest", True, thresholder=_NeverDense() if form == "rows" else None)
    return m, jax_stream._ShortestCursor._restart_table(m)


@pytest.mark.parametrize("form", ["dense", "rows"])
def test_restart_table_keeps_the_serial_walk(form, monkeypatch):
    """``sync_depth=None`` runs the serial twin, never the lane scan, and
    equals the JAX package; the lane scan on the same table would not (the
    restart table does not synchronize)."""
    m, table = _restart(form)
    rng = np.random.default_rng(3)
    text = "".join(rng.choice(list("abc"), size=600))
    cls = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)].astype(np.int32)
    want, _ = jax_stream._SeqScan(table).states(cls, 0)
    port_table = (port_stream._ShortestCursor._restart_table(carry(m)) if form == "rows"
                  else table)
    tab, rid = port_stream.seq_tensors(port_table, CPU)
    real = port_kernels._sync_states_plain
    monkeypatch.setattr(port_kernels, "_sync_states_plain",
                        lambda *a: pytest.fail("the lane scan ran on the restart table"))
    got = port_kernels.seq_states(tab, rid, torch.from_numpy(cls), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    states, _ = port_stream._SeqScan(port_table, CPU).states(cls, 0)
    np.testing.assert_array_equal(states, want)
    lanes = real(tab, rid, torch.from_numpy(cls), 0, max(m.max_depth, 1))
    assert not np.array_equal(lanes.numpy(), want)


# ------------------------------------------------------- which callers pass d


@pytest.fixture
def depths(monkeypatch):
    """The ``sync_depth`` of every ``seq_states`` call."""
    calls = []
    real = port_kernels.seq_states

    def spy(table, row_id, cls, s0=0, sync_depth=None):
        calls.append(sync_depth)
        return real(table, row_id, cls, s0, sync_depth)

    monkeypatch.setattr(port_kernels, "seq_states", spy)
    return calls


KWS = ["he", "she", "his", "hers", "ab", "abab", "x"]
TEXT = "she said he stands as if by magic ababab x hers herself " * 5


def _pair(name, engine, kws=KWS, **kw):
    args = (kws, [f"v{i}" for i in range(len(kws))]) if name.endswith("Map") else (kws,)
    return (getattr(port, name)(*args, engine=engine, device="cpu", **kw),
            getattr(jax_pkg, name)(*args, engine=engine, **kw))


@pytest.mark.parametrize("name", ["AhoCorasickSet", "LongestMatchMap"])
def test_small_feeds_pass_the_halo(name, depths):
    """``_CandidateSource`` scans a small feed over tail + feed from the root
    with the lane scan at d = ``max(max_depth, 1)``."""
    p, j = _pair(name, "auto")
    pieces = [TEXT[i: i + 37] for i in range(0, len(TEXT), 37)]
    assert p.match_stream(pieces) == j.match_stream(pieces) and p.match(TEXT)
    assert depths and set(depths) == {max(p.compiled.max_depth, 1)}


@pytest.mark.parametrize("name", ["AhoCorasickMap", "LongestMatchSet"])
def test_legacy_resume_passes_the_halo(name, depths):
    """A pre-tail resume point ({"state", "off"}) scans from its state with
    the lane scan, until the tail determines the state."""
    outs = []
    for m in _pair(name, "auto"):
        s = m.stream()
        s.load_state_dict({"state": 3, "off": 10, "queue": []})
        outs.append([s.feed("ers a", is_final=False), s.feed(TEXT[:90], is_final=True)])
    assert outs[0] == outs[1] and any(outs[0])
    assert depths and set(depths) == {4}


@pytest.mark.parametrize("name", ["AhoCorasickSet", "LongestMatchMap", "ShortestMatchSet",
                                  "ShortestMatchMap"])
def test_gold_branch_passes_the_halo_or_none(name, depths):
    """The row-compressed gold branch: AC and Longest scan the goto closure
    (d = ``max(max_depth, 1)``), Shortest the restart table (None)."""
    wide = ["a" * 32, "b", "ab", "ba"]
    p, j = _pair(name, "auto", wide, thresholder=_NeverDense())
    assert p.compiled.is_row_compressed
    text = "".join(np.random.default_rng(4).choice(list("ab "), size=700)) + "a" * 40
    assert p.match(text) == j.match(text) and p.last_stats.engine == "gold"
    want = None if name.startswith("Shortest") else 32
    assert depths == [want]


def test_shortest_cursor_passes_none(depths):
    p, j = _pair("ShortestMatchSet", "gold")
    pieces = [TEXT[i: i + 50] for i in range(0, len(TEXT), 50)]
    assert p.match_stream(pieces) == j.match_stream(pieces)
    assert depths and set(depths) == {None}


# ------------------------------------------------- the stride-2 count's lanes


def _ragged_chunk(halo: int, odd: bool) -> int:
    """A body that K = 4 segments of at least four halos and 32 steps cover,
    with an even (C % 4 == 0) or odd (C % 4 == 2) number of pairs."""
    return 16 * max(halo, 8) + (6 if odd else 8)


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("odd", [False, True], ids=["pairs even", "pairs odd"])
@pytest.mark.parametrize("name", ["dense", "quotient", "odd_depth", "wide"])
def test_rowdfa2_count_twin_in_lane_decomposition_equals_jax(name, odd, K, monkeypatch):
    """The stride-2 count twin at K lanes per window equals the JAX
    ``rowdfa_count``, on uint8 windows and, for ``wide``, uint16 ones."""
    m = _compiled(name)
    rd = port_matchers._DeviceTables(carry(m), CPU).row_dfa
    chunk = _ragged_chunk(rd.halo, odd)
    cls = _classes(m, _text(name, 3 * chunk + 77, seed=K))
    w = port_sb.classes_to_device(port_sb.chunk_classes(cls, chunk, rd.halo, m.num_classes),
                                  m.num_classes, CPU)
    assert w.dtype == (torch.uint16 if name == "wide" else torch.uint8)
    monkeypatch.setattr(krow, "ROWDFA2_COUNT_MAX_LANES", K * w.shape[0])
    assert scan_block.segments(w.shape[0], chunk, rd.halo, krow.ROWDFA2_COUNT_MAX_LANES)[0] == K
    got = krow.rowdfa2_count(rd.table, w, rd.halo, rd.state_bits, rd.num_classes)
    jrd = jax_pkg.models.matchers._DeviceTables(m).row_dfa
    jw = jnp.asarray(jax_rowdfa.chunk_classes2(cls, chunk, jrd.halo))
    want = int(jax_rowdfa.rowdfa_count(jrd.table, jw, jrd.halo, jrd.state_bits,
                                       jrd.num_classes))
    assert got.dtype == torch.int64 and int(got) == want > 0


def test_rowdfa2_count_cap_gives_the_predicted_k():
    """At 65,536 windows of 512 body classes the cap gives K = 2, at 8,192
    K = 4 (the shapes of the A/B)."""
    cap = krow.ROWDFA2_COUNT_MAX_LANES
    assert scan_block.segments(65_536, 512, 12, cap)[0] == 2
    assert scan_block.segments(8_192, 512, 12, cap)[0] == 4
