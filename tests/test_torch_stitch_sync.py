"""The synchronized forms of the chunk stitch (``sync_depth=d``: the maps'
agreement test and tail, the rescan as a lane scan with one row a chunk),
through their plain twins in ``kernels/stitch.py`` and ``ops/stitch.py``,
against the JAX package's ``ops/stitch.py`` and ``sharded_arrival_states``.

The tables are goto closures of depth 5 and 39 (``test_torch_seq_sync._goto``)
padded with zero-filled rows and a zero-filled column, as the matchers pad
``dfa_next``, and d = ``max(max_depth, 1)``.  The chunk lengths sit around
d + 1 (where every lane of a map agrees) and around the lane boundaries of
the rescan; entry states are the root, a live state and a padding row.  A
copy whose padding rows are sinks (each maps to itself) keeps phase 1 from
agreeing, so the maps' continuation runs.  The forms for any table (no
``sync_depth``) stay the form for the shortest restart table, and a spy shows
which form each caller takes.  Everything compared is an integer: exact equality.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu as act
from ahocorasick_tpu.ops import scan_dfa as jax_scan_dfa
from ahocorasick_tpu.ops import stitch as jax_stitch
from ahocorasick_tpu.parallel import sharding as jax_sh
from ahocorasick_tpu_torch import graft_entry
from ahocorasick_tpu_torch.kernels import scan_dfa as port_scan_dfa
from ahocorasick_tpu_torch.kernels import stitch as kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import stitch as port_stitch
from ahocorasick_tpu_torch.parallel import sharding as port_sh
from test_torch_seq_sync import _goto

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _table(form: str, sinks: bool = False):
    """``(table int32[S + 3, A + 1], d, live states)`` of a goto closure;
    padding rows zero-filled, or sinks."""
    m = _goto(form)
    S, A = m.dfa_next.shape
    t = np.zeros((S + 3, A + 1), dtype=np.int32)
    t[:S, :A] = m.dfa_next
    if sinks:
        t[S:] = np.arange(S, S + 3, dtype=np.int32)[:, None]
    return t, max(int(m.max_depth), 1), S


def _classes(form: str, C: int, K: int, seed: int) -> np.ndarray:
    """Chunks of classes that reach deep states: runs of the deep
    dictionary's ``a``, or the fuzz dictionary's four letters."""
    A = _goto(form).dfa_next.shape[1]
    rng = np.random.default_rng(seed)
    if form == "deep":
        a = int(_goto(form).charmap[ord("a")])
        c = np.where(rng.random(C * K) < 0.9, a, rng.integers(0, A, size=C * K))
    else:
        c = rng.integers(0, A, size=C * K)
    return c.astype(np.int32).reshape(C, K)


def _lengths(d: int):
    """Chunk lengths around d + 1 and around the rescan's lane boundaries."""
    L = port_scan_dfa.sync_lane_len(1, d)
    return {"1": 1, "d": d, "d+1": d + 1, "d+2": d + 2, "L-1": L - 1, "L": L, "L+1": L + 1,
            "5L+3": 5 * L + 3}


def _entries(live: int):
    """The root, a live state and a zero-filled (or sink) padding row."""
    return (0, live // 2, live + 1)


def _check_against_jax(table, cls, d, s0s):
    jt, jc = jnp.asarray(table), jnp.asarray(cls)
    pt, pc = torch.from_numpy(table), torch.from_numpy(cls)
    before = dict(launches)
    want_sigma = np.asarray(jax_stitch.chunk_state_maps(jt, jc))
    got_sigma = kernels.state_maps(pt, pc, d)
    assert got_sigma.dtype == torch.int32
    np.testing.assert_array_equal(got_sigma.numpy(), want_sigma)
    np.testing.assert_array_equal(port_stitch.chunk_state_maps(pt, pc, d).numpy(), want_sigma)
    for s0 in s0s:
        want_entry = np.asarray(jax_stitch.entry_states(jnp.asarray(want_sigma), s0))
        entry = port_stitch.entry_states(got_sigma, s0)
        np.testing.assert_array_equal(entry.numpy(), want_entry)
        want_states = np.asarray(jax_stitch.stitched_states(jt, jc, jnp.asarray(want_entry)))
        got_states = kernels.rescan(pt, pc, entry, d)
        assert got_states.dtype == torch.int32
        np.testing.assert_array_equal(got_states.numpy(), want_states)
        np.testing.assert_array_equal(port_stitch.stitched_states(pt, pc, entry, d).numpy(),
                                      want_states)
        got_scan = port_stitch.stitched_scan(pt, pc, s0, d)
        np.testing.assert_array_equal(got_scan.numpy(), want_states)
        # ... the forms for any table agree, and so does the one sequential scan.
        np.testing.assert_array_equal(port_stitch.stitched_scan(pt, pc, s0).numpy(),
                                      want_states)
        flat = port_scan_dfa.seq_states(pt, None, pc.reshape(-1), s0)
        np.testing.assert_array_equal(got_scan.reshape(-1).numpy(), flat.numpy())
    assert launches == before  # CPU tensors: the twins, no launch


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("k", ["1", "d", "d+1", "d+2", "L-1", "L", "L+1", "5L+3"])
@pytest.mark.parametrize("form", ["fuzz", "deep"])
def test_synchronized_stitch_equals_jax(form, k, C):
    table, d, live = _table(form)
    K = _lengths(d)[k]
    cls = _classes(form, C, K, seed=K + 10 * C)
    _check_against_jax(table, cls, d, _entries(live))


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("k", ["d+1", "2d+3"])
@pytest.mark.parametrize("form", ["fuzz", "deep"])
def test_sink_padding_takes_the_continuation(form, k, C):
    table, d, live = _table(form, sinks=True)
    K = d + 1 if k == "d+1" else 2 * d + 3
    cls = _classes(form, C, K, seed=C * K)
    t = d + 1
    head = kernels.state_maps_plain(torch.from_numpy(table), torch.from_numpy(cls[:, :t]))
    assert all(len(set(row.tolist())) > 1 for row in head)  # phase 1 never agrees
    # No sink is reachable from the root: the declaration holds for the
    # root and the live entry state.
    _check_against_jax(table, cls, d, (0, live // 2))


def test_lanes_of_exactly_d(monkeypatch):
    """``sync_lane_len`` patched to d: lanes that end off a multiple of 4,
    warm-ups that start at the chunk's first class."""
    table, d, live = _table("fuzz")
    monkeypatch.setattr(port_scan_dfa, "sync_lane_len", lambda n, depth: depth)
    for K in (d, d + 1, 2 * d, 3 * d + 2):
        _check_against_jax(table, _classes("fuzz", 3, K, seed=K), d, (0, live + 1))


def test_zero_chunks_and_empty_chunks():
    table, d, _ = _table("fuzz")
    pt = torch.from_numpy(table)
    empty = np.zeros((0, 7), dtype=np.int32)
    want = np.asarray(jax_stitch.stitched_scan(jnp.asarray(table), jnp.asarray(empty)))
    got = port_stitch.stitched_scan(pt, torch.from_numpy(empty), 0, d)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (0, 7)
    assert tuple(kernels.state_maps(pt, torch.from_numpy(empty), d).shape) == (0, table.shape[0])
    # K = 0: every map is the identity, which the lanes do not agree on.
    nothing = torch.zeros((3, 0), dtype=torch.int32)
    want_sigma = np.asarray(jax_stitch.chunk_state_maps(jnp.asarray(table), jnp.zeros((3, 0),
                                                                                     jnp.int32)))
    ident = kernels.state_maps(pt, nothing, d)
    np.testing.assert_array_equal(ident.numpy(), want_sigma)
    assert ident.tolist() == [list(range(table.shape[0]))] * 3
    assert tuple(kernels.rescan(pt, nothing, torch.zeros(3, dtype=torch.int32), d).shape) == (3, 0)
    # A one-row table agrees at once, over no class.
    one = torch.zeros((1, 4), dtype=torch.int32)
    assert kernels.state_maps(one, nothing, d).tolist() == [[0]] * 3


def test_restart_table_keeps_the_first_designs():
    """The shortest restart table does not synchronize: without
    ``sync_depth`` the stitch equals the JAX package and its restart scan."""
    rng = np.random.default_rng(4)
    m = act.ShortestMatchSet(["aaa", "ab", "bc"], True, engine="device")
    text = "".join(rng.choice(list("abc"), size=128))
    cls = m.compiled.charmap[act.chartables.to_utf16_units(text)].astype(np.int32)
    table = np.asarray(m.dev.dfa_next_shortest)
    chunks = cls.reshape(-1, 32)
    want = np.asarray(jax_stitch.stitched_scan(jnp.asarray(table), jnp.asarray(chunks)))
    got = port_stitch.stitched_scan(torch.from_numpy(table.copy()), torch.from_numpy(chunks))
    np.testing.assert_array_equal(got.numpy(), want)
    restart = np.asarray(jax_scan_dfa.shortest_states(m.dev.dfa_next, m.dev.match_len,
                                                      jnp.asarray(cls)))
    np.testing.assert_array_equal(got.reshape(-1).numpy(), restart)


@functools.lru_cache(maxsize=None)
def _jmesh(w):
    return jax_sh.data_mesh(jax.devices()[:w])


@pytest.mark.parametrize("w", [8, 1, 2, 3])
def test_sharded_arrival_states_synchronized_equals_jax(w):
    table, d, _ = _table("deep")
    cls = _classes("deep", 1, 301, seed=w).reshape(-1)
    want = jax_sh.sharded_arrival_states(jnp.asarray(table), cls, _jmesh(w))
    before = dict(launches)
    got = port_sh.sharded_arrival_states(torch.from_numpy(table), cls, [CPU] * w, sync_depth=d)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_sh.sharded_arrival_states(torch.from_numpy(table), cls, [CPU] * w), want)
    empty = port_sh.sharded_arrival_states(torch.from_numpy(table), cls[:0], [CPU] * w,
                                           sync_depth=d)
    assert empty.shape == (0,)
    assert launches == before


@pytest.fixture
def spy(monkeypatch):
    """Records the ``sync_depth`` each call of the stitch's maps and rescan
    was given."""
    seen = {"state_maps": [], "rescan": []}
    for name in seen:
        real = getattr(kernels, name)
        sig = inspect.signature(real)

        def record(*args, _real=real, _name=name, _sig=sig, **kw):
            seen[_name].append(_sig.bind(*args, **kw).arguments.get("sync_depth"))
            return _real(*args, **kw)

        monkeypatch.setattr(kernels, name, record)
    return seen


@pytest.mark.parametrize("sync", [None, 5])
def test_sharded_arrival_states_passes_its_form(spy, sync):
    table, d, _ = _table("fuzz")
    assert d == 5
    cls = _classes("fuzz", 1, 100, seed=1).reshape(-1)
    port_sh.sharded_arrival_states(torch.from_numpy(table), cls, [CPU] * 3, sync_depth=sync)
    assert spy == {"state_maps": [sync] * 3, "rescan": [sync] * 3}


def test_dryrun_multigpu_declares_the_demo_depth(spy):
    graft_entry.dryrun_multigpu(2, ["cpu"] * 2)
    d = max(graft_entry._demo_matcher(CPU).compiled.max_depth, 1)
    assert d > 1
    assert spy == {"state_maps": [d], "rescan": [d]}


@pytest.mark.parametrize("bad", [0, -1, 2.5, "3"])
def test_wrappers_reject_a_bad_depth(bad):
    table, _, _ = _table("fuzz")
    pt = torch.from_numpy(table)
    c = torch.from_numpy(_classes("fuzz", 2, 8, seed=0))
    with pytest.raises((ValueError, TypeError)):
        kernels.state_maps(pt, c, bad)
    with pytest.raises((ValueError, TypeError)):
        kernels.rescan(pt, c, torch.zeros(2, dtype=torch.int32), bad)
