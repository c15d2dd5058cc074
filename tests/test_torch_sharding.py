"""The port's data-parallel sharded scanner (CPU devices: the kernels' plain
twins) vs the JAX package's on its virtual 8-device CPU mesh and vs gold, on
the dictionaries, texts and seeds of ``tests/test_sharding.py``.  World 8
runs every case; worlds 1, 2 and 3 (uneven shards) a subset.  Everything
compared is an integer, so every comparison is exact."""

import functools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ahocorasick_tpu as act
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.ops import scan_dfa as jax_scan_dfa
from ahocorasick_tpu.parallel import sharding as jax_sh
from ahocorasick_tpu_torch import convert, graft_entry
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import dispatch
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.parallel import sharding as port_sh
from test_torch_host import carry

WORLDS = [8, 1, 2, 3]
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _jmesh(w):
    """One mesh object per world: the JAX module caches its traced shard
    bodies by the mesh's identity."""
    return jax_sh.data_mesh(jax.devices()[:w])


def _pmesh(w):
    return [CPU] * w


def _random_text(rng, n, alphabet="abcdef "):
    return "".join(rng.choice(alphabet) for _ in range(n))


def _pair(name, *args, engine="device", **kw):
    """The same matcher class of both packages over the same keywords."""
    return (getattr(act, name)(*args, engine=engine, **kw),
            getattr(port, name)(*args, engine=engine, device="cpu", **kw))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int32).numpy().view(np.uint32) if t.dtype == torch.uint32 else t.numpy()
    return np.asarray(t)


def _check(jm, pm, text, w, with_vals=False, jax_triples=True):
    """Port == JAX == gold: triples, count and shard boundaries; returns the
    two scanners.  (The JAX scanner counts the four resolved kinds by
    ``len(match_triples)``, so its count is asked only for AC.)"""
    jsc = jax_sh.ShardedScanner(jm, _jmesh(w))
    psc = port_sh.ShardedScanner(pm, _pmesh(w))
    got = psc.match_triples(text)
    if jax_triples:
        for g, x in zip(got, jsc.match_triples(text)):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, np.asarray(x))
    gold_trip = gold.GOLD_BY_KIND[jm.kind](jm.compiled, text)
    cut = 3 if with_vals else 2
    assert list(zip(*[x.tolist() for x in got[:cut]])) == [t[:cut] for t in gold_trip]
    assert psc.count(text) == len(gold_trip)
    if jm.kind == "ac":
        assert jsc.count(text) == len(gold_trip)
    n = len(pm._classes(text))
    chunks = {512}
    for sc in (psc, psc._inner):
        if sc is not None and sc._planes is not None:
            chunks.add(sc._planes[2])
    for chunk in chunks:
        assert psc._shard_boundaries(n, chunk) == jsc._shard_boundaries(n, chunk)
        assert len(psc._shard_boundaries(n, chunk)) == w - 1
    return jsc, psc


def _check_planes(jm, pm, text, w):
    """``make_sharded_planes`` of both packages, trimmed to the text."""
    cls = pm._classes(text)
    jfn, jwhich, jchunk = jax_sh.make_sharded_planes(jm, _jmesh(w))
    pfn, pwhich, pchunk = port_sh.make_sharded_planes(pm, _pmesh(w))
    assert pchunk == jchunk
    assert (pwhich == "hotstate") == (jwhich == "hotstate")
    assert pwhich == dispatch.planes_plan(pm.compiled, pm.dev).which
    want, got = np.asarray(jfn(jm._classes(text))), pfn(cls)
    assert got.dtype == torch.uint32 and got.device == CPU
    got = _np(got)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, : len(cls)], want[:, : len(cls)])


# --------------------------------------------------------------- AC, counts


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_count_matches_gold(w):
    rng = random.Random(21)
    text = _random_text(rng, 5000)
    jm, pm = _pair("AhoCorasickSet", ["ab", "abc", "fed", "caf", "e"], True)
    before = dict(launches)
    _check(jm, pm, text, w)
    _check_planes(jm, pm, text, w)
    assert launches == before  # the twins count no launches


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_triples_match_gold(w):
    rng = random.Random(22)
    text = _random_text(rng, 3000, "abcd")
    jm, pm = _pair("AhoCorasickMap", ["aa", "ab", "abc", "bcd", "dd"], [5, 4, 3, 2, 1], True)
    _check(jm, pm, text, w, with_vals=True)


def test_sharded_cross_boundary_matches():
    # A keyword spanning every shard boundary: the halo must catch it.
    text = ("xyzw" + "a" * 97) * 11
    jm, pm = _pair("AhoCorasickSet", ["xyzw"], True)
    _, psc = _check(jm, pm, text, 8)
    assert psc.count(text) == 11


@pytest.mark.parametrize("text", ["", "a", "ab"])
def test_sharded_tiny_and_empty_texts(text):
    jm, pm = _pair("AhoCorasickSet", ["ab", "b"], True)
    _check(jm, pm, text, 8)
    jl, pl = _pair("LongestMatchSet", ["ab", "b"], True)
    _check(jl, pl, text, 8)


@pytest.mark.parametrize("label", ["block", "batched", "row"])
def test_make_sharded_counter_all_tiers(label):
    rng = np.random.default_rng(77)
    cases = {"block": ["he", "she", "hers"], "batched": ["a" * 35, "b" * 33, "ab" * 17]}
    cases["row"] = list({
        "".join(rng.choice(list("abcdefgh"), size=int(rng.integers(3, 9))))
        for _ in range(900)})
    text = ""
    for name in cases:  # the reference test draws its texts in this order
        text = "".join(rng.choice(list("abhersx "), size=7001))
        if name == "batched":
            text += "a" * 40 + " " + "ab" * 17
        if name == label:
            break
    jm, pm = _pair("AhoCorasickSet", cases[label], engine="gold")
    jprep, jcount, _ = jax_sh.make_sharded_counter(jm, _jmesh(8))
    pprep, pcount, pwhich = port_sh.make_sharded_counter(pm, _pmesh(8))
    assert pwhich == dispatch.count_plan(pm.compiled, pm.dev).which
    assert pwhich == ("packedcount" if label == "batched" else "packed")
    total = pcount(pprep(pm._classes(text)))
    assert isinstance(total, int)
    assert total == int(jcount(jprep(jm._classes(text)))) == len(
        gold.gold_match(jm.compiled, text))


def test_make_sharded_counter_reps_scale_counts():
    jm, pm = _pair("AhoCorasickSet", ["ab", "ba"], engine="gold")
    jprep, jcount, _ = jax_sh.make_sharded_counter(jm, _jmesh(8))
    pprep, pcount, _ = port_sh.make_sharded_counter(pm, _pmesh(8))
    text = "abba " * 400
    x = pprep(pm._classes(text))
    one = pcount(x, reps=1)
    assert pcount(x, reps=1) == one == int(jcount(jprep(jm._classes(text)), reps=1))
    # Rolled windows change emit positions; the total is what JAX's is.
    assert pcount(x, reps=3) == int(jcount(jprep(jm._classes(text)), reps=3))


def test_sharded_hotstate_planes_long_keywords():
    kws = ["a" * i for i in range(1, 80)] + ["ab", "ba", "bb"]
    jm, pm = _pair("AhoCorasickSet", kws, True)
    assert port_sb.hotstate_layout(pm.compiled)
    text = _random_text(random.Random(7), 9000, "ab")
    _, psc = _check(jm, pm, text, 8)
    assert psc._planes[1] == "hotstate"
    _check_planes(jm, pm, text, 8)


def test_sharded_halo_exceeds_chunk():
    kws = ["ab" * 300, "ab", "ba", "bb"]  # 600 units > the 512 chunk
    jm, pm = _pair("AhoCorasickSet", kws, True)
    text = ("ab" * 310 + "x") * 3 + _random_text(random.Random(3), 3000, "ab")
    _, psc = _check(jm, pm, text, 8)
    assert psc._planes[2] == 1024
    assert port_sh._chunk_for(600, 512) == jax_sh._chunk_for(600, 512) == 1024
    assert port_sh._chunk_for(5, 512) == 512
    with pytest.raises(ValueError, match="exceeds the window chunk"):
        port_sh._windows_on_device(torch.zeros(2048, dtype=torch.uint8), 512, 600)


def test_windows_on_device_equal_the_host_chunker():
    rng = np.random.default_rng(5)
    for nc, halo, chunk in ((200, 7, 512), (40000, 600, 1024), (300, 512, 512)):
        cls = rng.integers(0, nc, size=4 * chunk)
        want = port_sb.chunk_classes(cls, chunk, halo, nc)
        region = port_sb.classes_to_device(np.pad(cls, (halo, 0)), nc, CPU)
        got = port_sh._windows_on_device(region, chunk, halo)
        assert got.dtype == (torch.uint8 if nc <= 256 else torch.uint16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16)
                                      if nc > 256 else got.numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(jax_sh._windows_on_device(jnp.asarray(np.pad(cls, (halo, 0))), chunk, halo)),
            want)


# ------------------------------------------------------- the resolved kinds


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_longest_resolution(w):
    text = _random_text(random.Random(23), 2000, "abc")
    jm, pm = _pair("LongestMatchSet", ["ab", "abc", "bc", "c"], True)
    _check(jm, pm, text, w)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_shortest_matches_gold(w):
    text = "ushers abababab heshe xx " * 13
    jm, pm = _pair("ShortestMatchMap", ["she", "he", "hers", "abab"], [1, 2, 3, 4],
                   engine="gold")
    _, psc = _check(jm, pm, text, w, with_vals=True)
    assert psc._inner is not None and psc._inner._planes is not None


def test_sharded_shortest_artifact_takes_the_host_cursor():
    text = "ushers abababab heshe xx " * 13
    jm = act.ShortestMatchSet(["she", "he", "hers", "abab"])
    pm = convert.from_compiled(carry(jm.compiled), device="cpu")
    assert pm._ac is None
    psc = port_sh.ShardedScanner(pm, _pmesh(8))
    got = psc.match_triples(text)
    want = jax_sh.ShardedScanner(act.ShortestMatchSet.from_compiled(jm.compiled),
                                 _jmesh(8)).match_triples(text)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(x))
    assert psc._inner is None and len(got[0]) > 0


def test_sharded_whole_word():
    text = _random_text(random.Random(53), 2500, "ab !")
    jm, pm = _pair("WholeWordMatchSet", ["ab", "a", "bab"])
    _check(jm, pm, text, 8)


def test_constructor_refuses_dictionaries_without_a_device_path():
    class _NeverDense:
        def is_over_threshold(self, size, lo, hi):
            return False

    wide = ["a" * 32, "b", "ab"]  # depth 32: no quotient packs inline
    jm = act.LongestMatchSet(wide, thresholder=_NeverDense())
    pm = port.LongestMatchSet(wide, device="cpu", thresholder=_NeverDense())
    with pytest.raises(ValueError, match="no sharded"):
        jax_sh.ShardedScanner(jm, _jmesh(8))
    with pytest.raises(ValueError, match="no sharded"):
        port_sh.ShardedScanner(pm, _pmesh(8))
    with pytest.raises(ValueError, match="no packed quotient"):
        port_sh.make_sharded_counter(pm, _pmesh(8))


def test_data_mesh_defaults_to_cuda_and_orders_devices():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_sh.data_mesh()
    assert port_sh.data_mesh(["cpu"] * 3) == [CPU] * 3
    with pytest.raises(ValueError, match="at least one device"):
        port_sh.data_mesh([])


# ------------------- whole-word-longest: the wide and the long dictionaries
# (the fuzz over both branches is in test_torch_sharding_wwl.py)


def _check_walks(jm, pm, text, w):
    """The raw per-position outcomes of both ``sharded_wwl_walks``."""
    cls = pm._classes(text)
    want = jax_sh.sharded_wwl_walks(jm, jm._classes(text), _jmesh(w))
    got = port_sh.sharded_wwl_walks(pm, cls, _pmesh(w))
    assert len(got) == len(want) == 6
    for g, x in zip(got, want):
        assert (g is None) == (x is None)
        if g is not None:
            assert g.dtype == np.asarray(x).dtype and len(g) == len(cls)
            np.testing.assert_array_equal(g, np.asarray(x))
    return got


def test_sharded_wwl_scan_engine_quotient():
    kws = [chr(c) for c in range(32, 0xD800)]
    jm, pm = _pair("WholeWordLongestMatchSet", kws, engine="auto")
    assert pm.compiled.is_row_compressed
    rng = np.random.default_rng(5)
    t = "".join(chr(int(x)) for x in rng.integers(32, 0xD800, size=9000))
    _check(jm, pm, t, 8)
    assert _check_walks(jm, pm, t, 8)[5] is None


def test_sharded_wwl_long_keywords_halo_widening():
    long_kw = "ab" * 300  # 600 units > 512: cw widens to 1024
    jm, pm = _pair("WholeWordLongestMatchSet", [long_kw, "ab", "abab", "b"], engine="auto")
    text = (" " + long_kw + " abab b ab " + long_kw[:-1] + " ") * 8
    _check(jm, pm, text, 8)
    _check_walks(jm, pm, text, 8)


# ------------------------------------------------------------ arrival states


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_arrival_states_match_flat(w):
    jm, pm = _pair("AhoCorasickSet", ["ab", "bc", "cab"], engine="gold")
    rng = np.random.default_rng(0)
    cls = jm.compiled.charmap[
        np.frombuffer("".join(rng.choice(list("abcx"), size=301)).encode("utf-16-le"),
                      dtype=np.uint16)]
    np.testing.assert_array_equal(np.asarray(jm.dev.dfa_next), pm.dev.dfa_next.numpy())
    want = jax_sh.sharded_arrival_states(jm.dev.dfa_next, cls, _jmesh(w))
    got = port_sh.sharded_arrival_states(pm.dev.dfa_next, cls, _pmesh(w))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    flat = np.asarray(jax_scan_dfa.dfa_states(jm.dev.dfa_next, jnp.asarray(cls.astype(np.int32))))
    np.testing.assert_array_equal(got, flat)
    empty = port_sh.sharded_arrival_states(pm.dev.dfa_next, cls[:0], _pmesh(w))
    assert empty.shape == (0,)


# ------------------------------------------------------------------- streams


def _feed_all(st, text, cuts):
    got = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        s, e, v = st.feed(text[a:b], is_final=(b == len(text)))
        got += list(zip(np.asarray(s).tolist(), np.asarray(e).tolist()))
    return got


def test_sharded_stream_chunked_feeds():
    jm, pm = _pair("AhoCorasickSet", ["ab", "abc", "bcd", "dd"])
    jsc, psc = jax_sh.ShardedScanner(jm, _jmesh(8)), port_sh.ShardedScanner(pm, _pmesh(8))
    text = _random_text(random.Random(57), 5000, "abcd ")
    want = [(a, b) for a, b, _ in gold.gold_ac(jm.compiled, text)]
    cuts = [0, 1203, 2011, 3999, len(text)]
    assert _feed_all(psc.stream(), text, cuts) == _feed_all(jsc.stream(), text, cuts) == want
    assert len(want) > 0
    assert psc.stream().feed("")[0].shape == (0,)
    # A resume point taken in either package continues in the other.
    for first, second in ((jsc, psc), (psc, jsc)):
        st = first.stream()
        got = _feed_all(st, text[:2500], [0, 2500])
        state = st.state_dict()
        assert state == {"tail": state["tail"], "off": 2500} and isinstance(state["tail"], list)
        st2 = second.stream()
        st2.load_state_dict(state)
        s, e, _ = st2.feed(text[2500:], is_final=True)
        got += list(zip(np.asarray(s).tolist(), np.asarray(e).tolist()))
        assert got == want


def test_stream_gate_rejects_resolved_kinds():
    jm, pm = _pair("LongestMatchSet", ["ab", "abcd"], engine="gold")
    with pytest.raises(ValueError, match="AC tail invariant"):
        jax_sh.ShardedScanner(jm, _jmesh(8)).stream()
    with pytest.raises(ValueError, match="AC tail invariant"):
        port_sh.ShardedScanner(pm, _pmesh(8)).stream()


def test_sharded_stream_hotstate_layout():
    kws = ["a" * i for i in range(1, 80)] + ["ab", "ba", "bb"]
    jm, pm = _pair("AhoCorasickSet", kws, True)
    text = _random_text(random.Random(62), 3000, "ab")
    want = [(a, b) for a, b, _ in gold.gold_ac(jm.compiled, text)]
    psc = port_sh.ShardedScanner(pm, _pmesh(8))
    cuts = [0, 700, 1501, len(text)]
    assert _feed_all(psc.stream(), text, cuts) == want and len(want) > 0
    assert psc._planes[1] == "hotstate"
    assert _feed_all(jax_sh.ShardedScanner(jm, _jmesh(8)).stream(), text, cuts) == want


# ----------------------------------------------------------- the entry points


def test_dryrun_multigpu_on_cpu_devices():
    graft_entry.dryrun_multigpu(8, [CPU] * 8)
    graft_entry.dryrun_multigpu(3, ["cpu"] * 3)
    with pytest.raises(RuntimeError, match="mesh of 2"):
        graft_entry.dryrun_multigpu(8, [CPU] * 2)


def test_entry_is_the_planes_kernel_call():
    import __graft_entry__ as jax_entry

    fn, args = graft_entry.entry("cpu")
    jfn, jargs = jax_entry.entry()
    got, want = fn(*args), np.asarray(jfn(*jargs))
    assert args[1].shape == jargs[1].shape
    np.testing.assert_array_equal(_np(got), want)
