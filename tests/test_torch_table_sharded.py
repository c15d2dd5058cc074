"""The port's table-sharded scanner (CPU devices: the kernel's plain twin) vs
the JAX package's on its virtual 8-device CPU mesh and vs gold:
``_table_sharded_run`` in all five modes on the same packed tables and
classes, and every table-sharded case of ``tests/test_sharding.py`` with its
dictionaries, texts and seeds, on 1-axis meshes of 8, 1, 2 and 3 devices and
2-axis meshes.  Everything compared is an integer, so every comparison is
exact."""

import functools
import random

import numpy as np
import pytest
import torch

import jax

import ahocorasick_tpu as act
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu.parallel import sharding as jax_sh
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.kernels import table_sharded as kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.parallel import sharding as port_sh
from test_torch_host import carry
from test_torch_sharding import CPU, _feed_all, _np, _pair, _random_text

MODES = ["count", "count_packed", "planes", "hotstate", "raw"]
# 1-axis worlds, then 2-axis (data, model) shapes.
MESHES = [8, 1, 2, 3, (1, 8), (2, 4), (4, 2)]
DEEP = ["a" * i for i in range(1, 80)] + ["ab", "ba", "bb"]


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


@functools.lru_cache(maxsize=None)
def _jmesh(shape="model"):
    """One mesh object per shape: the JAX scanners trace per mesh."""
    if shape == "model":
        return jax_sh.model_mesh()
    return jax_sh.dp_tp_mesh(shape=shape)


def _pmesh(mesh):
    if isinstance(mesh, int):
        return [CPU] * mesh
    return port_sh.dp_tp_mesh([CPU] * (mesh[0] * mesh[1]), shape=mesh)


def _ids(mesh):
    return str(mesh).replace(" ", "")


# ------------------------------------------------------ _table_sharded_run


@functools.lru_cache(maxsize=None)
def _table(name):
    """(packed uint32[S, A] table, classes, halo, state_bits) of one shape."""
    rng = np.random.default_rng(20260820)
    if name == "packed":
        kws = sorted({"".join(rng.choice(list("abcd"), size=int(rng.integers(1, 6))))
                      for _ in range(60)})
        m = act.AhoCorasickSet(kws, engine="gold")
        pd = jax_sb.build_packed(m.compiled)
        assert pd.emit_mask is None
        cls = m._classes("".join(rng.choice(list("abcdx"), size=64 * 12 - 5)))
        return pd.table, cls, pd.halo, pd.state_bits
    if name == "count_packed":
        m = act.AhoCorasickSet(DEEP, engine="gold")
        flat, sb, halo = jax_sb.build_count_packed(m.compiled)
        cls = m._classes("".join(rng.choice(list("ab"), size=64 * 8)))
        return flat.reshape(m.compiled.num_states, m.compiled.num_classes), cls, halo, sb
    if name == "wwl":
        m = act.WholeWordLongestMatchSet(["new york", "new", "york", "a b", "ab"],
                                         case_sensitive=False)
        sc = m.dev.wwl_scan_mixed_host
        assert sc.row_layout and sc.has_cross
        cls = m._classes("new york a b ab!x york new  york " * 12)[: 64 * 4]
        return np.asarray(sc.table), cls, sc.halo, sc.id_bits
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _jax_run(name, mode):
    table, cls, halo, sb = _table(name)
    out = jax_sh._table_sharded_run(table, cls, halo, sb, _jmesh(), 64, mode)
    return np.asarray(out)


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["packed", "count_packed", "wwl"])
def test_table_sharded_run_equals_jax(name, mode, mesh):
    table, cls, halo, sb = _table(name)
    want = _jax_run(name, mode)
    before = dict(launches)
    got = port_sh._table_sharded_run(table, cls, halo, sb, _pmesh(mesh), 64, mode)
    assert launches == before  # the twin counts no launches
    if mode in ("count", "count_packed"):
        assert isinstance(got, int) and got == int(want)
        assert name == "wwl" or got > 0
    else:
        assert got.dtype == torch.uint32 and got.device == CPU
        assert tuple(got.shape) == want.shape == (1, -(-len(cls) // 64) * 64)
        np.testing.assert_array_equal(_np(got), want)
        assert want.any()


def test_table_sharded_run_on_a_2_axis_jax_mesh():
    """The JAX module's own data x model composition gives what its 1-axis
    mesh gives, so the comparisons above hold for its 2-axis meshes too."""
    table, cls, halo, sb = _table("packed")
    for mode in ("count", "planes"):
        got = np.asarray(jax_sh._table_sharded_run(table, cls, halo, sb, _jmesh((2, 4)), 64, mode))
        np.testing.assert_array_equal(got, _jax_run("packed", mode))


def test_windows_must_divide_over_the_model_groups():
    table, cls, halo, sb = _table("packed")
    with pytest.raises(ValueError, match="do not divide"):
        port_sh._table_sharded_run(table, cls[: 64 * 3], halo, sb, _pmesh((2, 4)), 64, "count")
    with pytest.raises(ValueError, match="unknown mode"):
        port_sh._table_sharded_run(table, cls, halo, sb, _pmesh(8), 64, "states")
    with pytest.raises(TypeError, match="packed table"):
        port_sh._table_sharded_build(table.astype(np.int64), halo, sb, _pmesh(8), "count")


def test_mesh_helpers_follow_the_jax_shape_rule():
    for n in range(1, 9):
        want = jax_sh.dp_tp_mesh(np.asarray(jax.devices()[:n])).devices.shape
        got = port_sh.dp_tp_mesh([CPU] * n)
        assert (len(got), len(got[0])) == want
    assert port_sh.model_mesh(["cpu"] * 3) == [CPU] * 3
    with pytest.raises(ValueError, match="does not hold"):
        port_sh.dp_tp_mesh([CPU] * 8, shape=(3, 2))
    with pytest.raises(ValueError, match="1-axis .* or 2-axis"):
        port_sh._model_groups([[[CPU]]])
    with pytest.raises(ValueError, match="equally long"):
        port_sh._model_groups([[CPU, CPU], [CPU]])


# ------------------------------------------------------------- the wrapper


def _sharded(table, n_model):
    rows_per = -(-table.shape[0] // n_model)
    padded = np.pad(table, ((0, rows_per * n_model - table.shape[0]), (0, 0)))
    return kernels.ShardedTable([port_sh._shard_tensor(padded[k * rows_per: (k + 1) * rows_per], CPU)
                                 for k in range(n_model)])


def test_shards_are_separate_allocations_and_zero_padded():
    table, _, _, _ = _table("packed")
    tables, _, A = port_sh._table_sharded_build(table, 1, 8, _pmesh((2, 4)), "count")
    assert A == table.shape[1] and len(tables) == 2
    # Two model groups on one device share each shard; the shards of a group
    # are allocations of their own, none aliasing the host table.
    assert all(a is b for a, b in zip(tables[0].shards, tables[1].shards))
    ptrs = {t.data_ptr() for t in tables[0].shards}
    assert len(ptrs) == 4 and table.ctypes.data not in ptrs
    rows_per = tables[0].rows_per
    assert rows_per == -(-table.shape[0] // 4)
    whole = np.concatenate([_np(t) for t in tables[0].shards])
    np.testing.assert_array_equal(whole[: table.shape[0]], table)
    assert not whole[table.shape[0]:].any()
    assert tables[0].pointers(CPU).tolist() == [t.data_ptr() for t in tables[0].shards]


def test_wrapper_takes_int32_windows_and_validates():
    table, cls, halo, sb = _table("packed")
    st = _sharded(table, 3)
    narrow = torch.from_numpy(port_sb.chunk_classes(cls, 64, halo, table.shape[1]))
    wide = torch.from_numpy(port_sb.chunk_classes(cls, 64, halo))
    assert narrow.dtype == torch.uint8 and wide.dtype == torch.int32
    for mode in MODES:
        a = kernels.table_sharded_scan(st, narrow, halo, sb, mode)
        b = kernels.table_sharded_scan(st, wide, halo, sb, mode)
        assert torch.equal(a.view(torch.int32) if a.dim() else a,
                           b.view(torch.int32) if b.dim() else b)
    with pytest.raises(ValueError, match="unknown mode"):
        kernels.table_sharded_scan(st, narrow, halo, sb, "states")
    with pytest.raises(TypeError, match="windows must be"):
        kernels.table_sharded_scan(st, narrow.to(torch.int64), halo, sb, "count")
    with pytest.raises(ValueError, match="halo"):
        kernels.table_sharded_scan(st, narrow, narrow.shape[1], sb, "count")
    with pytest.raises(ValueError, match="state_bits"):
        kernels.table_sharded_scan(st, narrow, halo, 32, "count")
    with pytest.raises(TypeError, match="one shape"):
        kernels.ShardedTable([st.shards[0], st.shards[0][:1]])
    with pytest.raises(ValueError, match="at least one"):
        kernels.ShardedTable([])


def test_states_past_the_last_shard_read_zero():
    """A word whose state no shard owns is 0 from every shard, as in the JAX
    body: the scan stays in range."""
    table = np.array([[5, 1], [0, 0]], dtype=np.uint32)  # state 5 is past 2 rows
    st = kernels.ShardedTable([port_sh._shard_tensor(table, CPU)])
    w = torch.tensor([[0, 0, 0, 1]], dtype=torch.uint8)
    got = kernels.table_sharded_scan(st, w, 0, 3, "raw")
    assert _np(got).tolist() == [[5, 0, 5, 0]]


# ------------------------- the table-sharded cases of tests/test_sharding.py


def _check_tp(jm, pm, text, mesh=8, with_vals=False, jax_triples=True, layout=None):
    """Port == JAX == gold: triples and count; returns the two scanners."""
    jts = jax_sh.TableShardedScanner(jm, _jmesh("model" if isinstance(mesh, int) else mesh))
    pts = port_sh.TableShardedScanner(pm, _pmesh(mesh))
    assert pts.layout == jts.layout and (layout is None or pts.layout == layout)
    got = pts.match_triples(text)
    if jax_triples:
        for g, x in zip(got, jts.match_triples(text)):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, np.asarray(x))
    gold_trip = gold.GOLD_BY_KIND[jm.kind](jm.compiled, text)
    cut = 3 if with_vals else 2
    assert list(zip(*[x.tolist() for x in got[:cut]])) == [t[:cut] for t in gold_trip]
    assert pts.count(text) == len(gold_trip)
    if jm.kind == "ac" and jax_triples:
        assert jts.count(text) == len(gold_trip)
    return jts, pts


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_sharded_table_count_tp_analog(mesh):
    table, cls, halo, sb = _table("packed")
    got = port_sh.sharded_table_count(table, cls, halo, sb, _pmesh(mesh), chunk=64)
    assert isinstance(got, int) and got == int(_jax_run("packed", "count")) > 0
    if mesh == 8:  # the default chunk, as tests/test_sharding.py calls it
        assert got == port_sh.sharded_table_count(table, cls, halo, sb, _pmesh(mesh)) \
            == jax_sh.sharded_table_count(table, cls, halo, sb, _jmesh())


@pytest.mark.parametrize("mesh", [8, 1, 3, (2, 4)], ids=_ids)
def test_table_sharded_scanner_planes_extraction(mesh):
    rng = np.random.default_rng(42)
    kws = list({"".join(rng.choice(list("abcd"), size=int(rng.integers(1, 6))))
                for _ in range(60)})
    jm, pm = _pair("AhoCorasickMap", kws, [f"v{i}" for i in range(len(kws))], engine="auto")
    text = "".join(rng.choice(list("abcdx"), size=3000))
    before = dict(launches)
    _check_tp(jm, pm, text, mesh, with_vals=True, jax_triples=mesh == 8, layout="planes")
    assert launches == before


@pytest.mark.parametrize("mesh", [8, 2, (4, 2)], ids=_ids)
def test_table_sharded_scanner_hotstate_extraction(mesh):
    jm, pm = _pair("AhoCorasickSet", DEEP, True, engine="auto")
    assert port_sb.hotstate_layout(pm.compiled)
    text = _random_text(random.Random(9), 6000, "ab")
    _check_tp(jm, pm, text, mesh, jax_triples=mesh == 8, layout="hotstate")


def test_table_sharded_scanner_quotient():
    rng = np.random.default_rng(3)
    kws = list({"".join(rng.choice(list("abcdefgh"), size=int(rng.integers(1, 5))))
                for _ in range(40)})
    jm, pm = _pair("AhoCorasickSet", kws, engine="auto", thresholder=_NeverDense())
    assert pm.compiled.is_row_compressed
    text = "".join(rng.choice(list("abcdefghx"), size=2500))
    _check_tp(jm, pm, text, layout="planes")


def test_table_sharded_longest():
    jm, pm = _pair("LongestMatchSet", ["ab", "abc", "bc", "c"], engine="gold")
    _check_tp(jm, pm, _random_text(random.Random(51), 2500, "abc"))


def test_table_sharded_longest_hotstate():
    jm, pm = _pair("LongestMatchSet", DEEP, engine="gold")
    _check_tp(jm, pm, _random_text(random.Random(52), 4000, "ab"), layout="hotstate")


@pytest.mark.parametrize("mesh", [8, 3, (2, 4)], ids=_ids)
def test_table_sharded_shortest_map(mesh):
    jm, pm = _pair("ShortestMatchMap", ["she", "he", "hers", "abab"], [1, 2, 3, 4],
                   engine="gold")
    text = "ushers abababab heshe xx " * 13
    _, pts = _check_tp(jm, pm, text, mesh, with_vals=True, jax_triples=mesh == 8,
                       layout="shortest")
    assert pts._inner.layout == "planes"
    want = jm.match_triples(text)
    for g, x in zip(pts.match_triples(text), want):
        np.testing.assert_array_equal(g, np.asarray(x))


def test_table_sharded_shortest_artifact_takes_the_host_cursor():
    text = "ushers abababab heshe xx " * 13
    jm = act.ShortestMatchSet(["she", "he", "hers", "abab"])
    pm = convert.from_compiled(carry(jm.compiled), device="cpu")
    assert pm._ac is None
    pts = port_sh.TableShardedScanner(pm, _pmesh(8))
    jts = jax_sh.TableShardedScanner(act.ShortestMatchSet.from_compiled(jm.compiled), _jmesh())
    assert pts.layout == jts.layout == "host" and pts._inner is None
    got = pts.match_triples(text)
    for g, x in zip(got, jts.match_triples(text)):
        np.testing.assert_array_equal(g, np.asarray(x))
    assert pts.count(text) == len(got[0]) > 0


def test_table_sharded_whole_word():
    jm, pm = _pair("WholeWordMatchSet", ["ab", "a", "bab"], engine="gold")
    _check_tp(jm, pm, _random_text(random.Random(53), 2500, "ab !"))


@pytest.mark.parametrize("mesh", [8, 1, 3, (2, 4)], ids=_ids)
def test_table_sharded_wwl(mesh):
    jm, pm = _pair("WholeWordLongestMatchSet", ["a", "ab", "ba", "aab"], engine="gold")
    text = _random_text(random.Random(54), 2500, "ab !")
    _check_tp(jm, pm, text, mesh, jax_triples=mesh == 8, layout="wwl")


def test_table_sharded_wwl_quotient():
    kws = [chr(c) for c in range(97, 123)] + ["ab", "ba"]
    jm, pm = _pair("WholeWordLongestMatchSet", kws, engine="auto", thresholder=_NeverDense())
    assert pm.compiled.is_row_compressed
    _, pts = _check_tp(jm, pm, _random_text(random.Random(55), 2500, "ab x!"))
    assert pts._wwl.quotient


def test_table_sharded_wwl_flat_layout_and_wide_alphabet():
    """The flat scan table of a wide alphabet (uint16 classes): the scanner
    reshapes it to rows of ``num_classes``, not of the matcher's padding."""
    kws = [chr(c) for c in range(32, 0xD800, 7)]
    jm, pm = _pair("WholeWordLongestMatchSet", kws, engine="auto")
    rng = np.random.default_rng(5)
    t = "".join(chr(int(x)) for x in rng.integers(32, 0xD800, size=3000))
    _, pts = _check_tp(jm, pm, t, layout="wwl")
    assert not pts._wwl.row_layout and pts._table.shape[1] == pts._wwl.num_classes > 256


def test_table_sharded_dp_tp_2d_mesh():
    rng = random.Random(56)
    jm, pm = _pair("AhoCorasickSet", ["ab", "abc", "bcd", "dd"], engine="gold")
    _check_tp(jm, pm, _random_text(rng, 4000, "abcd"), (2, 4))
    jm, pm = _pair("WholeWordLongestMatchSet", ["a", "ab", "ba", "aab"], engine="gold")
    _check_tp(jm, pm, _random_text(rng, 2500, "ab !"), (2, 4))


@pytest.mark.parametrize("mesh", [8, 2, (4, 2)], ids=_ids)
def test_table_sharded_wwl_mixed(mesh):
    jm, pm = _pair("WholeWordLongestMatchSet", ["new york", "new", "york", "a b", "ab"],
                   engine="auto", case_sensitive=False)
    rng = random.Random(58)
    t = "".join(rng.choice(["new", "york", " ", "a", "b ", "!x"])
                for _ in range(2000)) + " new york a b"
    _, pts = _check_tp(jm, pm, t, mesh, jax_triples=mesh == 8)
    assert pts._wwl.has_cross


def test_table_sharded_scanner_caches_build():
    jm, pm = _pair("AhoCorasickSet", ["ab", "bc"], engine="auto")
    pts = port_sh.TableShardedScanner(pm, _pmesh(8))
    text = "abcabc" * 40
    c1 = pts.count(text)
    built1 = dict(pts._built)
    assert list(built1) == ["count"]
    assert pts.count(text) == c1 == 160
    assert all(pts._built[k][0] is built1[k][0] and pts._built[k][1] is built1[k][1]
               for k in built1)
    # One build per mode, and every mode scans the shards uploaded once.
    pts.match_triples(text)
    assert sorted(pts._built) == ["count", "planes"]
    assert pts._built["planes"][0] is pts._built["count"][0]
    assert pts._built["planes"][1] is not pts._built["count"][1]


@pytest.mark.parametrize("shape", [(1, 8), (4, 2)], ids=_ids)
def test_table_sharded_mesh_shapes(shape):
    jm, pm = _pair("AhoCorasickSet", ["ab", "abc", "bcd"], engine="gold")
    _check_tp(jm, pm, _random_text(random.Random(60), 1500, "abcd"), shape)


def test_table_sharded_edges():
    # More model shards than quotient rows: padded rows must stay inert.
    jq, pq = _pair("AhoCorasickSet", ["x", "y"], engine="auto", thresholder=_NeverDense())
    assert pq.compiled.is_row_compressed and port_sb.effective_rows(pq.compiled) < 8
    _, pts = _check_tp(jq, pq, "xxyxy x!y")
    assert pts._built["planes"][0][0].rows_per == 1
    # Empty text through every kind path that builds.
    for name, kws in (("AhoCorasickSet", ["ab", "abc", "bcd"]), ("LongestMatchSet", ["ab", "abcd"]),
                      ("WholeWordLongestMatchSet", ["ab"])):
        _, pm = _pair(name, kws, engine="gold")
        pts = port_sh.TableShardedScanner(pm, _pmesh(8))
        s, e, v = pts.match_triples("")
        assert len(s) == len(e) == len(v) == 0 and pts.count("") == 0


def test_table_sharded_constructor_refusals():
    _, pm = _pair("AhoCorasickSet", ["ab"], engine="gold")
    with pytest.raises(ValueError, match="not both"):
        port_sh.TableShardedScanner(pm, _pmesh(2), group=object())
    with pytest.raises(ValueError, match="1-axis .* or 2-axis"):
        port_sh.TableShardedScanner(pm, [[[CPU]]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_sh.TableShardedScanner(pm)


@pytest.mark.parametrize("device", [None, "cuda", torch.device("cuda", 0)],
                         ids=["none", "cuda", "cuda0"])
def test_group_form_refuses_a_cuda_device(device):
    """The process-group form is the plain column loop: it raises for a CUDA
    device (None means CUDA) before it touches the group, a backend or the
    card, and never scans tensors on a card without the kernel."""
    table = np.zeros((4, 3), dtype=np.uint32)
    cls = np.zeros(10, dtype=np.int32)
    with pytest.raises(NotImplementedError, match="no kernel"):
        port_sh.sharded_table_count(table, cls, 1, 4, group=object(), device=device)
    with pytest.raises(NotImplementedError, match="no kernel"):
        port_sh._table_sharded_build(table, 1, 4, None, "raw", group=object(), device=device)
    _, pm = _pair("AhoCorasickSet", ["ab"], engine="gold")
    pm.device = torch.device("cuda") if device is None else torch.device(device)
    with pytest.raises(NotImplementedError, match="no kernel"):
        port_sh.TableShardedScanner(pm, group=object())


def test_table_sharded_wwl_uploads_no_whole_table():
    """The scanner cuts the host build into row shards; beside them only the
    outcome rows lie on the scanning device, and the sweep runs there."""
    jm, pm = _pair("WholeWordLongestMatchSet", ["ab", "abc", "b"], engine="auto")
    pts = port_sh.TableShardedScanner(pm, _pmesh(3))
    assert pts.layout == "wwl" and pts._wwl is pm.dev.wwl_scan_host
    got = pts.match_triples("ab abc b abb")
    assert not pm.dev._cache  # no device copy of the whole table was made
    assert list(pts._sweep) == [CPU]
    rows_flat, outrows = pts._sweep[CPU]
    assert rows_flat is None and outrows.shape == pts._wwl.outrows.shape
    assert [(int(s), int(e)) for s, e in zip(got[0], got[1])] == jm.match("ab abc b abb")


def test_stream_gate_rejects_resolved_kinds():
    jm, pm = _pair("LongestMatchSet", ["ab", "abcd"], engine="gold")
    with pytest.raises(ValueError, match="AC tail invariant"):
        jax_sh.TableShardedScanner(jm, _jmesh()).stream()
    with pytest.raises(ValueError, match="AC tail invariant"):
        port_sh.TableShardedScanner(pm, _pmesh(8)).stream()


@pytest.mark.parametrize("mesh", [8, (2, 4)], ids=_ids)
def test_table_sharded_stream_chunked_feeds(mesh):
    jm, pm = _pair("AhoCorasickSet", ["ab", "abc", "bcd", "dd"], engine="gold")
    text = _random_text(random.Random(61), 4000, "abcd ")
    want = [(a, b) for a, b, _ in gold.gold_ac(jm.compiled, text)]
    cuts = [0, 977, 2011, 3500, len(text)]
    pts = port_sh.TableShardedScanner(pm, _pmesh(mesh))
    assert _feed_all(pts.stream(), text, cuts) == want and len(want) > 0
    jts = jax_sh.TableShardedScanner(jm, _jmesh("model" if mesh == 8 else mesh))
    if mesh == 8:
        assert _feed_all(jts.stream(), text, cuts) == want
    # A resume point taken in the port continues in the JAX package.
    st = pts.stream()
    got = _feed_all(st, text[:2500], [0, 2500])
    st2 = jts.stream()
    st2.load_state_dict(st.state_dict())
    s, e, _ = st2.feed(text[2500:], is_final=True)
    assert got + list(zip(np.asarray(s).tolist(), np.asarray(e).tolist())) == want


def test_sharded_stream_hotstate_layout():
    jm, pm = _pair("AhoCorasickSet", DEEP, True)
    text = _random_text(random.Random(62), 3000, "ab")
    want = [(a, b) for a, b, _ in gold.gold_ac(jm.compiled, text)]
    pts = port_sh.TableShardedScanner(pm, _pmesh(8))
    cuts = [0, 700, 1501, len(text)]
    assert pts.layout == "hotstate"
    assert _feed_all(pts.stream(), text, cuts) == want and len(want) > 0


# ----------------------------------------------------------------- the fuzz


def _fuzz_case(trial):
    r = random.Random(700 + trial)
    name = ["AhoCorasickSet", "LongestMatchSet", "WholeWordMatchSet",
            "WholeWordLongestMatchSet"][trial % 4]
    pool = ["a", "b", "ab", "ba", "aab", "bab", "abba", "b a", "!!"]
    kws = sorted({r.choice(pool) for _ in range(r.randint(2, 7))})
    if name == "WholeWordMatchSet":
        kws = [k for k in kws if " " not in k and "!" not in k] or ["ab"]
    text = "".join(r.choice("ab !") for _ in range(r.randint(1, 3000)))
    return name, kws, text, [8, 3, (2, 4), 2][r.randrange(4)]


@pytest.mark.parametrize("trial", range(12))
def test_table_sharded_fuzz(trial):
    """The raw scan output of both scanners every trial, the JAX triples
    every fifth (both packages resolve with the same host code), gold
    always."""
    name, kws, text, mesh = _fuzz_case(trial)
    jm, pm = _pair(name, kws, engine="auto")
    jts, pts = _check_tp(jm, pm, text, mesh, jax_triples=trial % 5 == 0)
    cls = pm._classes(text)
    mode = "raw" if pts.layout == "wwl" else pts.layout
    want = np.asarray(jts._scan(jm._classes(text), mode))
    got = _np(pts._scan(cls, mode))
    np.testing.assert_array_equal(got[:, : len(cls)], want[:, : len(cls)])
