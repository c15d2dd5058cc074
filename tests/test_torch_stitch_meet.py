"""The chunk stitch's forms for any table (no ``sync_depth``): the sigma maps
by meeting a reference run and the rescan by speculate and repair with one
row a chunk, through their plain twins in ``kernels/stitch.py`` and
``ops/stitch.py``, against the JAX package's ``ops/stitch.py``,
``shortest_states`` and ``sharded_arrival_states``.

The tables: the shortest restart table of ``aa``/``aaa`` and of a
dictionary-corpus fuzz dictionary (``test_torch_seq_spec._restart_case``),
goto closures of depth 5 and 39 passed with no depth, a copy of the first
whose padding rows are sinks, and ``ab``/``ba`` over ``abab...``, where some
lane of every chunk never meets the reference run and every sub-chunk that
starts on the wrong letter repairs to its end.  Each is padded with
zero-filled rows.  The sub-chunk length is forced to 7 through
``scan_dfa.SPEC_CHUNK_LEN`` (K = 0, 1, 2, 6, 7, 8 and 68: many sub-chunks),
or left to the rule (K = 300); C = 1, 3 and 64; entry states the root, a
live state and a padding row.  Everything compared is an integer: exact
equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu as act
from ahocorasick_tpu.core import stream as jax_stream
from ahocorasick_tpu.core.compiler import compile_matcher as jax_compile
from ahocorasick_tpu.ops import scan_dfa as jax_scan_dfa
from ahocorasick_tpu.ops import stitch as jax_stitch
from ahocorasick_tpu.parallel import sharding as jax_sh
from ahocorasick_tpu_torch.kernels import scan_dfa as port_scan_dfa
from ahocorasick_tpu_torch.kernels import stitch as kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import stitch as port_stitch
from ahocorasick_tpu_torch.parallel import sharding as port_sh
from test_torch_seq_spec import PAD_ROWS, _restart_case
from test_torch_stitch_sync import _classes, _table

CPU = torch.device("cpu")
SUB = 7  # the forced sub-chunk length
KS = {"0": 0, "1": 1, "2": 2, "sub-1": SUB - 1, "sub": SUB, "sub+1": SUB + 1,
      "many": 9 * SUB + 5, "rule": 300}
CHUNKS = (1, 3, 64)
TABLES = ("aa", "corpus", "fuzz", "deep", "sinks", "abba")


@functools.lru_cache(maxsize=None)
def _abba():
    """``(m, padded restart table)`` of the shortest matcher of ``ab``/``ba``."""
    m = jax_compile(["ab", "ba"], "shortest", True)
    dense = jax_stream._ShortestCursor._restart_table(m)
    return m, np.vstack([dense, np.zeros((PAD_ROWS, dense.shape[1]), dtype=dense.dtype)])


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """``(table int32[S, A], classes int32[64 * 300], entries, d)``: the
    table, a class stream long enough for every shape, the entry states
    (root, live, padding) and the synchronizing depth of a goto closure
    (None for the tables that do not synchronize)."""
    n = max(CHUNKS) * max(KS.values())
    if name in ("aa", "corpus"):
        m, tables, cls = _restart_case(name)
        live = int(np.argmax(m.depth[: m.num_states]))
        return (np.ascontiguousarray(tables["dense"], dtype=np.int32),
                np.resize(cls, n).astype(np.int32), (0, live, m.num_states), None)
    if name == "abba":
        m, table = _abba()
        units = np.frombuffer(("ab" * (n // 2)).encode("utf-16-le"), dtype=np.uint16)
        return (np.ascontiguousarray(table, dtype=np.int32),
                m.charmap[units].astype(np.int32), (0, int(table[0, m.charmap[ord("a")]]),
                                                    m.num_states), None)
    form = "fuzz" if name == "sinks" else name
    table, d, live = _table(form, sinks=name == "sinks")
    return table, _classes(form, 1, n, seed=17).reshape(-1), (0, live // 2, live + 1), d


@functools.lru_cache(maxsize=None)
def _jax_ref(name: str, K: int):
    """The JAX package's maps, entries (one per entry state of ``_case``) and
    rescans of 64 chunks of K, and its rescan from a vector of entry states
    cycling through root, live and padding.  Every output of the first C
    chunks is its output over those C chunks alone (chunks are independent,
    and the fold is a prefix fold)."""
    table, cls, entries, _ = _case(name)
    C = max(CHUNKS)
    jt, jc = jnp.asarray(table), jnp.asarray(cls[: C * K].reshape(C, K))
    sigma = jax_stitch.chunk_state_maps(jt, jc)
    per_s0 = {}
    for s0 in entries:
        entry = jax_stitch.entry_states(sigma, s0)
        per_s0[s0] = (np.asarray(entry), np.asarray(jax_stitch.stitched_states(jt, jc, entry)))
    mixed = np.resize(np.asarray(entries, dtype=np.int32), C)
    rescanned = np.asarray(jax_stitch.stitched_states(jt, jc, jnp.asarray(mixed)))
    return np.asarray(sigma), per_s0, mixed, rescanned


def _sub_lengths(K: int, sub: int) -> np.ndarray:
    P = -(-K // min(sub, K))
    return np.minimum(sub, K - sub * np.arange(P))


@pytest.mark.parametrize("C", CHUNKS)
@pytest.mark.parametrize("k", list(KS))
@pytest.mark.parametrize("name", TABLES)
def test_any_table_stitch_equals_jax(name, k, C, monkeypatch):
    """sigma, the meet positions, the entries, the rescan and its repair
    lengths, through every wrapper and twin, == the JAX package's; on the
    goto closures every lane meets within d classes and every repair is at
    most d long."""
    K = KS[k]
    if k != "rule":
        monkeypatch.setattr(port_scan_dfa, "SPEC_CHUNK_LEN", SUB)
    sub = port_scan_dfa.spec_chunk_len(K)
    table, cls, entries, d = _case(name)
    want_sigma, per_s0, mixed, want_mixed = _jax_ref(name, K)
    pt = torch.from_numpy(table)
    pc = torch.from_numpy(np.ascontiguousarray(cls[: C * K].reshape(C, K)))
    S = table.shape[0]
    before = dict(launches)

    sigma, meet = kernels.meet_maps(pt, pc)
    assert sigma.dtype == meet.dtype == torch.int32 and tuple(meet.shape) == (C, S)
    np.testing.assert_array_equal(sigma.numpy(), want_sigma[:C])
    np.testing.assert_array_equal(kernels.state_maps(pt, pc).numpy(), want_sigma[:C])
    np.testing.assert_array_equal(port_stitch.chunk_state_maps(pt, pc).numpy(), want_sigma[:C])
    m = meet.numpy()
    assert ((0 <= m) & (m <= K)).all()
    assert (m[:, 0] == 0).all() if K else (m == 0).all()
    if K:  # a lane that met leaves as the reference run does
        run = kernels.spec_rescan_plain(pt, pc, torch.zeros(C, dtype=torch.int32))[0].numpy()
        met = m < K
        np.testing.assert_array_equal(sigma.numpy()[met],
                                      np.broadcast_to(run[:, -1:], m.shape)[met])
    if d is not None and name != "sinks":
        assert (m <= min(d, K)).all()  # within d + 1 classes

    for s0 in entries:
        want_entry, want_states = per_s0[s0]
        entry = port_stitch.entry_states(sigma, s0)
        np.testing.assert_array_equal(entry.numpy(), want_entry[:C])
        states, repair = kernels.spec_rescan(pt, pc, entry)
        assert states.dtype == repair.dtype == torch.int32
        np.testing.assert_array_equal(states.numpy(), want_states[:C])
        np.testing.assert_array_equal(kernels.rescan(pt, pc, entry).numpy(), want_states[:C])
        np.testing.assert_array_equal(port_stitch.stitched_states(pt, pc, entry).numpy(),
                                      want_states[:C])
        np.testing.assert_array_equal(port_stitch.stitched_scan(pt, pc, s0).numpy(),
                                      want_states[:C])
        flat = port_scan_dfa.seq_states(pt, None, pc.reshape(-1), s0)
        np.testing.assert_array_equal(states.reshape(-1).numpy(), flat.numpy())
        r = repair.numpy()
        if K == 0:
            assert r.shape == (C, 0)
            continue
        lens = _sub_lengths(K, sub)
        assert r.shape == (C, len(lens)) and (r[:, 0] == 0).all()
        assert ((0 <= r) & (r <= lens)).all()
        if d is not None and name != "sinks":
            assert (r <= d).all()
    states, _ = kernels.spec_rescan(pt, pc, torch.from_numpy(mixed[:C].copy()))
    np.testing.assert_array_equal(states.numpy(), want_mixed[:C])
    assert launches == before  # CPU tensors: the twins, no launch


@pytest.mark.parametrize("K", [1, 6, 7, 68])
def test_periodic_text_keeps_lanes_and_sub_chunks_apart(K, monkeypatch):
    """``ab``/``ba`` over ``abab...``: in a chunk that starts on an ``a`` the
    lane of state ``b`` never meets the reference run, in one that starts on
    a ``b`` the lane of state ``a``; with sub-chunks of 7 (odd), every
    sub-chunk that starts on a ``b`` repairs to its end and every other one
    not at all."""
    monkeypatch.setattr(port_scan_dfa, "SPEC_CHUNK_LEN", SUB)
    m, table = _abba()
    a, b = (int(table[0, m.charmap[ord(ch)]]) for ch in "ab")
    _, cls, _, _ = _case("abba")
    C = 5
    pt = torch.from_numpy(np.ascontiguousarray(table, dtype=np.int32))
    pc = torch.from_numpy(np.ascontiguousarray(cls[: C * K].reshape(C, K)))
    sigma, meet = kernels.meet_maps(pt, pc)
    starts = K * np.arange(C)
    never = np.where(starts % 2 == 0, b, a)
    assert (meet.numpy()[np.arange(C), never] == K).all()
    entry = kernels.entry_fold(sigma, 0)
    _, repair = kernels.spec_rescan(pt, pc, entry)
    lens = _sub_lengths(K, SUB)
    odd = (starts[:, None] + SUB * np.arange(len(lens))) % 2 == 1
    odd[:, 0] = False  # sub-chunk 0 starts from the chunk's own entry
    want = np.where(odd, lens, 0)
    np.testing.assert_array_equal(repair.numpy(), want)


@functools.lru_cache(maxsize=None)
def _shortest(name):
    rng = np.random.default_rng(len(name))
    if name == "aa":
        kws, text = ["aa", "aaa"], "".join(rng.choice(list("ab"), size=700, p=[.8, .2]))
    else:
        kws = ["aaa", "ab", "bc", "cab", "abc", "ca"]
        text = "".join(rng.choice(list("abc "), size=700))
    m = act.ShortestMatchSet(kws, True, engine="device")
    cls = m.compiled.charmap[act.chartables.to_utf16_units(text)].astype(np.int32)
    restart = np.asarray(jax_scan_dfa.shortest_states(m.dev.dfa_next, m.dev.match_len,
                                                      jnp.asarray(cls)))
    return np.asarray(m.dev.dfa_next_shortest).copy(), cls, restart


@pytest.mark.parametrize("sub", [SUB, None])
@pytest.mark.parametrize("C", [1, 4, 70])
@pytest.mark.parametrize("name", ["aa", "fuzz"])
def test_restart_table_stitch_equals_shortest_states(name, C, sub, monkeypatch):
    """The stitch of the JAX package's restart table (match rows restart at
    the root) == its ``shortest_states`` and its own stitched scan."""
    if sub is not None:
        monkeypatch.setattr(port_scan_dfa, "SPEC_CHUNK_LEN", sub)
    table, cls, restart = _shortest(name)
    K = len(cls) // C
    chunks = cls[: C * K].reshape(C, K)
    got = port_stitch.stitched_scan(torch.from_numpy(table), torch.from_numpy(chunks))
    np.testing.assert_array_equal(got.reshape(-1).numpy(), restart[: C * K])
    want = np.asarray(jax_stitch.stitched_scan(jnp.asarray(table), jnp.asarray(chunks)))
    np.testing.assert_array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _jmesh(w):
    return jax_sh.data_mesh(jax.devices()[:w])


@pytest.mark.parametrize("w", [8, 1, 3])
@pytest.mark.parametrize("name", ["corpus", "deep"])
def test_sharded_arrival_states_any_table_equals_jax(name, w):
    """``sharded_arrival_states`` with no ``sync_depth`` (C = 1 a shard) ==
    the JAX one, on the restart table and on a goto closure."""
    table, cls, _, _ = _case(name)
    cls = cls[:603]
    want = jax_sh.sharded_arrival_states(jnp.asarray(table), cls, _jmesh(w))
    before = dict(launches)
    got = port_sh.sharded_arrival_states(torch.from_numpy(table), cls, [CPU] * w)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert launches == before


@pytest.mark.parametrize("K", [0, 1, 5, 40])
def test_meet_twin_counts_the_first_equality(K, monkeypatch):
    """The meet positions against a per-lane numpy walk: the first i with
    the lane's state after class i equal to the root's, 0 for the root's
    lane, K where it never is; sigma the lane's own state then."""
    monkeypatch.setattr(port_scan_dfa, "SPEC_CHUNK_LEN", SUB)
    table, cls, _, _ = _case("sinks")
    c = cls[: 3 * K].reshape(3, K)
    sigma, meet = kernels.meet_maps_plain(torch.from_numpy(table), torch.from_numpy(c))
    for ch in range(3):
        run, s = [], 0
        for x in c[ch]:
            s = int(table[s, x])
            run.append(s)
        for lane in range(table.shape[0]):
            s, at = lane, K
            for i, x in enumerate(c[ch]):
                s = int(table[s, x])
                if s == run[i]:
                    at = i
                    break
            assert int(meet[ch, lane]) == at
            assert int(sigma[ch, lane]) == (run[-1] if at < K else s)
