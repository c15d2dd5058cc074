"""Speculate and repair, the form of ``kernels/scan_dfa.seq_states`` without
``sync_depth`` and of ``kernels/scan_dfa.shortest_states``, through their
plain twins, against the JAX package.

The twins run the kernels' decomposition: the classes cut into chunks of K
(``SPEC_CHUNK_LEN`` patched to force K), chunk 0 walked from ``s0`` and
every other chunk from the root, then each chunk whose true entry is not the
root walked again until it meets the recorded states.  They must give the
JAX package's ``_SeqScan`` states over the shortest restart table (dense and
``RowTable``) and its ``shortest_states`` (uint8, uint16 and int32 classes)
bit for bit, at every K and length around the chunk boundaries, from the
root, a live state and a padding row; on the periodic text that keeps the
two runs apart, where every second chunk repairs to its end; and through
the facades that reach them.  On a goto closure no chunk repairs more than d
states.  Everything compared is an integer: exact equality.
"""

import numpy as np
import pytest
import torch

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
import jax.numpy as jnp
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core import stream as jax_stream
from ahocorasick_tpu.core.compiler import RowTable as JaxRowTable
from ahocorasick_tpu.core.compiler import compile_matcher as jax_compile
from ahocorasick_tpu.models import matchers as jax_matchers
from ahocorasick_tpu.ops import scan_dfa as jax_scan_dfa
from ahocorasick_tpu_torch.kernels import scan_dfa as port_kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.ops import scan_dfa as port_ops_dfa
from dict_corpus import dict_corpus, dict_words
from test_torch_host import carry
from test_torch_seq_sync import _goto, _NeverDense, _restart

CPU = torch.device("cpu")
KS = ("1", "2", "7", "d", "d+1", "64", "K>=N")
LENGTHS = ("0", "1", "K-1", "K", "K+1", "many")
MANY = 600  # "many" chunks: at least this many units, and 9 K + 5
PAD_ROWS = 3  # zero rows past the restart tables' states: s0 may be one


def _cls(m, text: str) -> np.ndarray:
    units = np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)
    return m.charmap[units].astype(np.int32)


def _k(which: str, d: int, n_max: int) -> int:
    return {"d": d, "d+1": d + 1, "K>=N": n_max + 5}.get(which) or int(which)


def _n(which: str, K: int) -> int:
    return {"0": 0, "1": 1, "K-1": K - 1, "K": K, "K+1": K + 1,
            "many": max(MANY, 9 * K + 5)}[which]


_CASES = {}


def _restart_case(name: str):
    """``(m, tables, cls)``: a shortest dictionary compiled by the JAX
    package, its restart table in both forms padded with ``PAD_ROWS`` zero
    rows (``{"dense": array, "rows": (rows, row_id)}``), and classes of a
    seeded text long enough for every length."""
    if name not in _CASES:
        if name == "aa":
            m = _restart("dense")[0]
            text = "".join(np.random.default_rng(3).choice(list("ab"), size=1400, p=[.8, .2]))
        else:  # a dictionary-corpus fuzz dictionary over its own corpus
            words = dict_words(200, seed=41)
            m = jax_compile(words, "shortest", True)
            text = dict_corpus(words, 1400, seed=41)
        dense = jax_stream._ShortestCursor._restart_table(m)
        A = dense.shape[1]
        padded = np.vstack([dense, np.zeros((PAD_ROWS, A), dtype=dense.dtype)])
        # The RowTable form of the same table: its distinct rows, one zero row.
        rows, row_id = np.unique(padded, axis=0, return_inverse=True)
        tables = {"dense": padded, "rows": (rows.astype(np.int32),
                                            row_id.reshape(-1).astype(np.int32))}
        _CASES[name] = (m, tables, _cls(m, text))
    return _CASES[name]


def _jax_states(table, cls, s0):
    if isinstance(table, tuple):
        table = JaxRowTable(*table)
    return jax_stream._SeqScan(table).states(cls, s0)[0]


def _port_tensors(table):
    if isinstance(table, tuple):
        return tuple(torch.from_numpy(a) for a in table)
    return torch.from_numpy(table), None


def _entry_states(m):
    """The root, a live state (the deepest) and the first padding row."""
    live = int(np.argmax(m.depth[: m.num_states]))
    assert live > 0
    return {"root": 0, "live": live, "padding": m.num_states}


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("k_of", KS)
@pytest.mark.parametrize("form", ["dense", "rows"])
@pytest.mark.parametrize("name", ["aa", "corpus"])
def test_restart_twin_equals_jax_seqscan(name, form, k_of, length, monkeypatch):
    """Every forced K and length around it, from the root, a live state and
    a padding row: the twin == the JAX ``_SeqScan`` of the restart table."""
    m, tables, cls = _restart_case(name)
    d = max(m.max_depth, 1)
    K = _k(k_of, d, MANY + 9 * 65)
    n = _n(length, K) if k_of != "K>=N" else _n(length, 40)
    assert n <= len(cls)
    monkeypatch.setattr(port_kernels, "SPEC_CHUNK_LEN", K)
    tab, rid = _port_tensors(tables[form])
    c = torch.from_numpy(cls[:n])
    for where, s0 in _entry_states(m).items():
        want = _jax_states(tables[form], cls[:n], s0)
        got = port_kernels.seq_states(tab, rid, c, s0)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=where)
        states, repair = port_kernels.spec_states_plain(tab, rid, c, s0, K)
        np.testing.assert_array_equal(states.numpy(), want)
        C = -(-n // min(K, n)) if n else 0
        assert repair.shape == (C,) and repair.dtype == torch.int32
        lens = np.minimum(K, n - K * np.arange(C))
        assert (repair.numpy() >= 0).all() and (repair.numpy() <= lens).all()
        assert C == 0 or int(repair[0]) == 0


def _shortest_case(name):
    """A shortest dictionary, its JAX device tables and classes of a text."""
    key = "shortest " + name
    if key not in _CASES:
        rng = np.random.default_rng(len(name) + 11)
        if name == "wide":  # > 256 classes: uint16 classes
            kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
            text = "".join(rng.choice(kws + ["x", chr(0x1FF)], size=900))
        elif name == "aa":
            kws = ["aa", "aaa"]
            text = "".join(rng.choice(list("ab"), size=1400, p=[.8, .2]))
        else:
            kws = dict_words(150, seed=7)
            text = dict_corpus(kws, 1400, seed=7)
        m = jax_compile(kws, "shortest", True)
        _CASES[key] = (m, jax_matchers._DeviceTables(m), _cls(m, text))
    return _CASES[key]


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("k_of", KS)
@pytest.mark.parametrize("name", ["aa", "corpus", "wide"])
def test_shortest_twin_equals_jax(name, k_of, length, monkeypatch):
    """``shortest_states`` at every forced K and length, on narrow (uint8 or
    uint16) and int32 classes, == the JAX ``shortest_states``; the cached
    restart rows give the same states as the ones built from match_len."""
    m, jdev, cls = _shortest_case(name)
    d = max(m.max_depth, 1)
    K = _k(k_of, d, MANY + 9 * 65)
    n = _n(length, K) if k_of != "K>=N" else _n(length, 40)
    monkeypatch.setattr(port_kernels, "SPEC_CHUNK_LEN", K)
    pdev = port_matchers._DeviceTables(carry(m), CPU)
    want = np.asarray(jax_scan_dfa.shortest_states(jdev.dfa_next, jdev.match_len,
                                                   jnp.asarray(cls)))[:n]
    narrow = port_sb.classes_to_device(cls[:n], m.num_classes, "cpu")
    assert narrow.dtype == (torch.uint16 if name == "wide" else torch.uint8)
    for c in (narrow, torch.from_numpy(cls[:n])):
        for row_id in (None, pdev.restart_row_id):
            got = port_kernels.shortest_states(pdev.dfa_next, pdev.match_len, c, row_id)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            port_kernels.shortest_states_plain(pdev.dfa_next, pdev.match_len, c).numpy(), want)


def test_restart_row_id_is_built_once_per_table():
    m, _, _ = _shortest_case("aa")
    pdev = port_matchers._DeviceTables(carry(m), CPU)
    rid = pdev.restart_row_id
    assert rid is pdev.restart_row_id and rid.dtype == torch.int32
    ml = pdev.match_len.numpy()
    np.testing.assert_array_equal(rid.numpy(), np.where(ml > 0, 0, np.arange(len(ml))))


# ------------------------------------------ the text that keeps the runs apart


@pytest.mark.parametrize("K", [3, 7, 65])
@pytest.mark.parametrize("form", ["dense", "rows", "shortest"])
def test_periodic_text_repairs_every_second_chunk_to_its_end(form, K, monkeypatch):
    """Keywords ``ab`` and ``ba`` over ``abab...`` at an odd K: a chunk that
    starts on a ``b`` is guessed from the root one match out of phase and
    never meets the true run, so it repairs to its end; a chunk that starts
    on an ``a`` meets it at once.  The states still equal the JAX
    package's."""
    m = jax_compile(["ab", "ba"], "shortest", True)
    cls = _cls(m, "ab" * (10 * K + 3))
    n = len(cls)
    monkeypatch.setattr(port_kernels, "SPEC_CHUNK_LEN", K)
    if form == "shortest":
        jdev = jax_matchers._DeviceTables(m)
        want = np.asarray(jax_scan_dfa.shortest_states(jdev.dfa_next, jdev.match_len,
                                                       jnp.asarray(cls)))
        pdev = port_matchers._DeviceTables(carry(m), CPU)
        tab, rid = pdev.dfa_next, pdev.restart_row_id
        got = port_kernels.shortest_states(pdev.dfa_next, pdev.match_len, torch.from_numpy(cls))
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        dense = jax_stream._ShortestCursor._restart_table(m)
        table = dense if form == "dense" else (
            lambda u: (u[0].astype(np.int32), u[1].reshape(-1).astype(np.int32)))(
                np.unique(dense, axis=0, return_inverse=True))
        want = _jax_states(table, cls, 0)
        tab, rid = _port_tensors(table)
    states, repair = port_kernels.spec_states_plain(tab, rid, torch.from_numpy(cls), 0, K)
    np.testing.assert_array_equal(states.numpy(), want)
    C = -(-n // K)
    lens = np.minimum(K, n - K * np.arange(C))
    odd = (K * np.arange(C)) % 2 == 1
    np.testing.assert_array_equal(repair.numpy()[odd], lens[odd])
    assert (repair.numpy()[~odd] == 0).all() and odd.sum() >= 5


# ------------------------------------------------------- goto closures: <= d


@pytest.mark.parametrize("k_of", ["1", "2", "7", "d", "d+1", "64"])
@pytest.mark.parametrize("form", ["fuzz", "fuzz_rows", "deep", "deep_rows"])
def test_goto_closure_repairs_at_most_d(form, k_of):
    """On a goto closure (d-synchronizing) a chunk entered in the wrong state
    meets the true run within d classes: no repair is longer than d, and the
    states equal the JAX ``_SeqScan``'s from the root and a deep state."""
    m = _goto(form)
    d = max(m.max_depth, 1)
    K = _k(k_of, d, 0)
    n = max(MANY, 9 * K + 5)
    rng = np.random.default_rng(K)
    cls = rng.integers(0, m.num_classes, size=n).astype(np.int32)
    if m.max_depth > 20:  # runs of the deep keyword's letter, so deep states recur
        cls[: n // 2] = m.charmap[ord("a")]
    table = (carry(m).dfa_next if m.is_row_compressed else m.dfa_next)
    tab, rid = ((torch.from_numpy(np.asarray(table.rows, dtype=np.int32)),
                 torch.from_numpy(np.asarray(table.row_id, dtype=np.int32)))
                if m.is_row_compressed else (torch.from_numpy(table), None))
    for s0 in (0, int(np.argmax(m.depth[: m.num_states]))):
        want = jax_stream._SeqScan(m.dfa_next).states(cls, s0)[0]
        states, repair = port_kernels.spec_states_plain(tab, rid, torch.from_numpy(cls), s0, K)
        np.testing.assert_array_equal(states.numpy(), want)
        assert int(repair.max()) <= d
        assert int(repair.sum()) > 0 or K == 1 or n <= K


# --------------------------------------------------------------- the chunks


def test_chunk_length_rule(monkeypatch):
    """K is the power of two at or above sqrt(N * SPEC_REPAIR);
    ``SPEC_CHUNK_LEN`` forces K."""
    r = port_kernels.SPEC_REPAIR
    for n in (1, 2, 10, 100, 4095, 1 << 16, 1 << 20, 1 << 25):
        K = port_kernels.spec_chunk_len(n)
        assert K & (K - 1) == 0
        assert K * K >= n * r and (K // 2) ** 2 < n * r or K == 1
    for r, n, K in ((1, 1 << 16, 256), (2, 1 << 16, 512), (2, 1 << 20, 2048), (2, 1 << 25, 8192),
                    (2, 1, 2), (16, 10, 16)):
        monkeypatch.setattr(port_kernels, "SPEC_REPAIR", r)
        assert port_kernels.spec_chunk_len(n) == K
    monkeypatch.setattr(port_kernels, "SPEC_CHUNK_LEN", 7)
    assert port_kernels.spec_chunk_len(1 << 20) == 7


def test_cpu_tensors_launch_nothing():
    m, tables, cls = _restart_case("aa")
    before = dict(launches)
    tab, rid = _port_tensors(tables["rows"])
    port_kernels.seq_states(tab, rid, torch.from_numpy(cls), 0)
    port_kernels.spec_states(tab, rid, torch.from_numpy(cls), 0)
    pdev = port_matchers._DeviceTables(carry(m), CPU)
    port_kernels.shortest_states(pdev.dfa_next, pdev.match_len, torch.from_numpy(cls))
    assert launches == before


@pytest.mark.parametrize("bad", ["int64", "short", "two_dim"])
def test_shortest_states_rejects_a_bad_row_map(bad):
    m, _, cls = _shortest_case("aa")
    pdev = port_matchers._DeviceTables(carry(m), CPU)
    rid = {"int64": pdev.restart_row_id.to(torch.int64), "short": pdev.restart_row_id[:-1],
           "two_dim": pdev.restart_row_id.reshape(1, -1)}[bad]
    with pytest.raises(ValueError):
        port_kernels.shortest_states(pdev.dfa_next, pdev.match_len, torch.from_numpy(cls), rid)


# ---------------------------------------------------------------- facades


TEXT_RNG = np.random.default_rng(23)
KWS = ["she", "he", "hers", "abab", "x", "ab", "ba", "a" * 9]
TEXT = " ".join("".join(TEXT_RNG.choice(list("abhers x"), size=int(TEXT_RNG.integers(1, 9))))
                for _ in range(220))


def _pair(name, engine, **kw):
    args = (KWS, [f"v{i}" for i in range(len(KWS))]) if name.endswith("Map") else (KWS,)
    return (getattr(port, name)(*args, engine=engine, device="cpu", **kw),
            getattr(jax_pkg, name)(*args, engine=engine, **kw))


def _triples(m):
    return [np.asarray(x).tolist() for x in m.match_triples(TEXT)]


def _gold(m, text):
    return [(s, e) for s, e, _ in gold.gold_match(m.compiled, text)]


@pytest.mark.parametrize("K", [None, 7])
@pytest.mark.parametrize("name", ["ShortestMatchSet", "ShortestMatchMap"])
def test_row_compressed_gold_branch_equals_jax(name, K, monkeypatch):
    """The row-compressed Shortest gold branch (the restart table's
    RowTable) == the JAX package's triples and the gold loop."""
    monkeypatch.setattr(port_kernels, "SPEC_CHUNK_LEN", K)
    p, j = _pair(name, "auto", thresholder=_NeverDense())
    assert p.compiled.is_row_compressed
    assert _triples(p) == _triples(j)
    assert p.last_stats.engine == "gold"
    if name.endswith("Set"):
        assert p.match(TEXT) == _gold(p, TEXT)


@pytest.mark.parametrize("K", [None, 1, 7])
@pytest.mark.parametrize("name", ["ShortestMatchSet", "ShortestMatchMap"])
def test_artifact_without_ac_equals_jax(name, K, monkeypatch):
    """A Shortest artifact loaded without its AC automaton scans with
    ``shortest_states`` over the cached restart rows == the JAX triples."""
    monkeypatch.setattr(port_kernels, "SPEC_CHUNK_LEN", K)
    values = [f"v{i}" for i in range(len(KWS))] if name.endswith("Map") else None
    compiled = jax_compile(KWS, "shortest", True, values=values)
    p = getattr(port, name).from_compiled(carry(compiled), engine="device", device="cpu")
    j = getattr(jax_pkg, name).from_compiled(compiled, engine="device")
    assert p._ac is None
    seen = []
    real = port_kernels.shortest_states

    def spy(dfa_next, match_len, cls, row_id=None):
        seen.append(row_id)
        return real(dfa_next, match_len, cls, row_id)

    monkeypatch.setattr(port_kernels, "shortest_states", spy)
    assert _triples(p) == _triples(j)
    assert seen and all(r is p.dev.restart_row_id for r in seen)
    assert p.match(TEXT) == j.match(TEXT)


@pytest.mark.parametrize("K", [None, 2, 7])
def test_seq_mode_cursor_streams_equal_jax(K, monkeypatch):
    """SEQ-mode Shortest cursors (engine ``gold`` keeps every feed there)
    over uneven pieces, and a legacy-pinned resume (``{"state", "off"}``,
    no ``p``), == the JAX package's."""
    monkeypatch.setattr(port_kernels, "SPEC_CHUNK_LEN", K)
    rng = np.random.default_rng(5)
    cuts = np.sort(rng.choice(len(TEXT), size=12, replace=False))
    pieces = [TEXT[a:b] for a, b in zip([0, *cuts], [*cuts, len(TEXT)])]
    for name in ("ShortestMatchSet", "ShortestMatchMap"):
        p, j = _pair(name, "gold")
        assert p.match_stream(pieces) == j.match_stream(pieces)
    p, j = _pair("ShortestMatchSet", "auto")
    outs = []
    for mm in (p, j):
        s = mm.stream()
        s.load_state_dict({"state": 0, "off": 50})
        got = [s.feed(piece, is_final=False) for piece in pieces[:-1]]
        got.append(s.feed(pieces[-1], is_final=True))
        outs.append((got, s.state_dict()))
    assert outs[0] == outs[1] and any(outs[0][0])


def test_stream_ops_entry_uses_the_cached_row_map():
    """``ops.scan_dfa.shortest_triples`` equals gold on the port's tables."""
    compiled = jax_compile(KWS, "shortest", True)
    p = port.ShortestMatchSet.from_compiled(carry(compiled), engine="device", device="cpu")
    cls = _cls(compiled, TEXT)
    s, e, _ = port_ops_dfa.shortest_triples(p.compiled, p.dev, cls)
    assert list(zip(s.tolist(), e.tolist())) == _gold(p, TEXT)
    assert "restart_row_id" in p.dev._cache
