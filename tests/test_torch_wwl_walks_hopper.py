"""The whole-word-longest walks' card designs, held on the CPU: the per-start
walk's derived tables (the k-gram prefix table and one outcome row a state)
and its prefix decomposition against the JAX package's ``wwl_walks_at``; the
fused scan's lanes (``fused_segments``, K = 1, 2, 4 and 8) through its twin
against the JAX ``wwl_scan_walks_fused`` and ``wwl_scan_walks``; the slots
each lane takes (``fused_lane_slots``, ``lane_slots``); and the rules that
size both launches.  Everything compared is an integer, so every comparison
is exact."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.models import matchers as jax_matchers
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu.ops import scan_wwl as jax_wwl
from ahocorasick_tpu.utils import chartables
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.kernels import scan_wwl as kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_wwl as port_wwl
from test_torch_host import carry
from test_torch_wwl import _dictionary, _np
from test_torch_wwl_fused import _assert_same, _fused_dictionary, _host_scan, _jax_outcomes, _tensor

WWL = "whole_word_longest"


# ------------------------------------------------------------ walk tables


@functools.lru_cache(maxsize=None)
def _walk_dictionary(name):
    """(compiled matcher, text): the test_torch_wwl shapes, and ``steps``,
    whose walks die at each step 0, 1, 2 of a 3-gram or live past it."""
    if name == "steps":
        kws = ["b", "cb", "acb", "aab", "aaab", "aaaab", "ab"]
        rng = np.random.default_rng(7)
        return compile_matcher(kws, WWL, True), "".join(rng.choice(list("abc ,"), size=3000))
    return _dictionary(name)


def _tables(name):
    """(JAX matcher, JAX walk tables, the port's, the port's derived
    tables at the matcher's walk depth, d)."""
    m, _ = _walk_dictionary(name)
    jt = jax_matchers._DeviceTables(m)
    jax_tables = [jt.trie_next, jt.own_len, jt.own_val, jt.fail_len, jt.fail_off, jt.fail_val,
                  jt.class_is_word]
    port = port_matchers._DeviceTables(carry(m), "cpu").wwl_walk
    d = port_wwl.bucket_depth(m.max_depth)
    return m, jax_tables, port, d


def _jax_walks(jax_tables, cls_p, starts, d):
    return [np.asarray(x) for x in jax_wwl.wwl_walks_at(
        *jax_tables, jnp.asarray(cls_p.astype(np.int32)), jnp.asarray(starts), d)]


def _classes(cls_p, dtype):
    if dtype == "uint16":
        return torch.from_numpy(cls_p.astype(np.uint16).view(np.int16)).view(torch.uint16)
    return torch.from_numpy(cls_p.astype({"uint8": np.uint8, "int32": np.int32}[dtype]))


WALK_DICTS = ["dense", "quirk", "mixed", "steps"]


@pytest.mark.parametrize("depth", ["prefix", "walk"])
@pytest.mark.parametrize("name", WALK_DICTS)
def test_prefix_table_equals_jax_walk_over_every_gram(name, depth):
    """Every k-gram of the padded classes, walked by JAX from its first
    class: with max_depth = k - 1 the walk is the prefix entry alone (died
    at step j < k with its pre-die state, or alive after k), with the
    matcher's depth it goes on into the next gram's classes."""
    m, jax_tables, port, d = _tables(name)
    A = port[0].shape[1]
    k = kernels.walk_prefix_k(A, d)
    md = k - 1 if depth == "prefix" else d
    wt = port_wwl.build_walk_tables(*port[:6], md)
    assert wt.prefix_k == k and wt.prefix.numel() == A ** k and wt.prefix.dtype == torch.uint32
    grams = np.arange(A ** k)
    digits = np.stack([(grams // A ** (k - 1 - j)) % A for j in range(k)], axis=1)
    cls_p = np.concatenate([digits.reshape(-1), np.zeros(d + 1, dtype=np.int64)]).astype(np.int32)
    starts = (grams * k).astype(np.int32)
    want = _jax_walks(jax_tables, cls_p, starts, md)
    c, st = torch.from_numpy(cls_p), torch.from_numpy(starts)
    got = kernels.wwl_walks_prefix(port[0], port[6], c, st, md, wt)
    _assert_same(got, want, msg=f"{name} prefix decomposition")
    _assert_same(kernels.wwl_walks_at_plain(*port, c, st, md), want, msg=f"{name} twin")
    if depth == "prefix":
        e = _np(wt.prefix).astype(np.int64)
        died = (e & kernels.WALK_DIED) != 0
        kd = want[0] - starts
        np.testing.assert_array_equal(kd[died], (e[died] >> kernels.WALK_STATE_BITS) & 3)
        assert (kd[~died] == -1).all()  # alive through every step
        # Deaths at every step of the gram, and walks that live past it.
        assert set(np.unique(kd)) >= set(range(-1, k)) if name == "steps" else died.any()


@pytest.mark.parametrize("name", WALK_DICTS)
def test_outcome_rows_are_the_five_arrays(name):
    m, _, port, d = _tables(name)
    wt = port_wwl.build_walk_tables(*port[:6], d)
    rows = _np(wt.rows)
    assert rows.dtype == np.int32 and rows.shape == (port[0].shape[0], 8)
    for col, arr in enumerate(port[1:6]):
        np.testing.assert_array_equal(rows[:, col], _np(arr))
    assert not rows[:, 5:].any()
    assert wt.rows.is_contiguous() and wt.rows.data_ptr() % 16 == 0


def _edge_starts(cls_p, starts, lanes, d):
    n = len(cls_p)
    return np.sort(np.array([0, 0, 1, 1, 1, n - d - 2, n - d - 1, n - 2, n - 1, n, n, n + 5]
                            + list(starts[: len(lanes)][:40]), dtype=np.int64)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
@pytest.mark.parametrize("rule", ["lanes", "edges"])
@pytest.mark.parametrize("name", ["dense", "mixed", "steps"])
def test_walk_twin_prefix_and_jax_agree_at_edges(name, rule, dtype):
    """The facade's start slots (the pad slots at len(cls) included), and
    starts at 0, within d + 1 of the end, repeated and past the classes."""
    m, jax_tables, port, d = _tables(name)
    _, text = _walk_dictionary(name)
    cls = m.charmap[chartables.to_utf16_units(text[:1500])]
    cls_p, starts, lanes, _, d = jax_wwl.compact_lanes(m, cls)
    st_np = starts if rule == "lanes" else _edge_starts(cls_p, starts, lanes, d)
    if rule == "lanes":
        assert (st_np[len(lanes):] == len(cls)).all() and len(st_np) > len(lanes)
    want = _jax_walks(jax_tables, cls_p, st_np, d)
    c, st = _classes(cls_p, dtype), torch.from_numpy(st_np)
    wt = port_wwl.build_walk_tables(*port[:6], d)
    before = dict(launches)
    _assert_same(kernels.wwl_walks_at(*port, c, st, d), want, msg="wrapper")
    _assert_same(kernels.wwl_walks_prefix(port[0], port[6], c, st, d, wt), want, msg="prefix")
    assert launches == before  # CPU tensors launch nothing


def test_walk_below_the_prefix_depth():
    """max_depth 0 and 1 cut k to max_depth + 1; a handed table of a larger
    k is refused on the card's path."""
    m, jax_tables, port, d = _tables("dense")
    _, text = _walk_dictionary("dense")
    cls_p, starts, lanes, _, _ = jax_wwl.compact_lanes(m, m.charmap[chartables.to_utf16_units(
        text[:800])])
    for md in (0, 1, 2):
        wt = port_wwl.build_walk_tables(*port[:6], md)
        assert wt.prefix_k == md + 1
        c, st = torch.from_numpy(cls_p.astype(np.int32)), torch.from_numpy(starts)
        _assert_same(kernels.wwl_walks_prefix(port[0], port[6], c, st, md, wt),
                     _jax_walks(jax_tables, cls_p, starts, md), msg=f"max_depth {md}")
    wt3 = port_wwl.build_walk_tables(*port[:6], d)
    with pytest.raises(ValueError, match="prefix_k"):
        kernels._check_walk_tables(wt3, *port[0].shape, 1, torch.device("cpu"))


def test_derived_tables_raise_past_the_state_bits(monkeypatch):
    _, _, port, d = _tables("dense")
    S = port[0].shape[0]
    monkeypatch.setattr(kernels, "WALK_STATE_BITS", max(S - 1, 2).bit_length() - 1)
    with pytest.raises(ValueError, match="do not fit"):
        port_wwl.build_walk_tables(*port[:6], d)
    with pytest.raises(ValueError, match="do not fit"):
        kernels._check_walk_tables(None, S, port[0].shape[1], d, torch.device("cpu"))


def test_derived_tables_on_the_card_only():
    """The matcher's device tables build the derived ones for the card;
    on the CPU the twin needs none (so the table bytes stay the JAX
    package's)."""
    m, _ = _walk_dictionary("dense")
    dev = port_matchers._DeviceTables(carry(m), "cpu")
    assert dev.wwl_walk_derived is None
    assert "wwl_walk_derived" not in dev._cache


@pytest.mark.parametrize("stride, max_depth, k", [
    (32, 12, 3), (64, 12, 3), (101, 12, 3), (102, 12, 2), (1024, 12, 2), (1025, 12, 1),
    (32, 0, 1), (32, 1, 2)])
def test_walk_prefix_k_rule(stride, max_depth, k):
    assert kernels.walk_prefix_k(stride, max_depth) == k
    assert stride ** k <= kernels.WALK_MAX_PREFIX_ENTRIES or k == 1


# ------------------------------------------------------------- fused lanes


FUSED_KS = (1, 2, 4, 8)
EDGE_LENGTHS = (0, 3, 512, 1023, 4096, 4097)


@functools.lru_cache(maxsize=None)
def _fused_case(name, n):
    """(port scan tables, overlap windows, starts, d, JAX fused and sweep
    outcomes) of the first n units of the dictionary's text."""
    m, text = _fused_dictionary(name)
    host = _host_scan(m)
    sc = convert.wwl_scan_from_numpy(host, "cpu")
    cls = m.charmap[chartables.to_utf16_units((text * 3)[:n])]
    cls_p, starts, lanes, _, d = jax_wwl.compact_lanes(m, cls)
    windows = jax_wwl.chunk_classes_overlap(cls_p, 512, d, d + 1, m.num_classes)
    want = _jax_outcomes(jax_wwl.wwl_scan_walks_fused, host, windows, starts, d)
    sweep = _jax_outcomes(jax_wwl.wwl_scan_walks, host,
                          jax_sb.chunk_classes(cls_p, 512, d, m.num_classes), starts, d,
                          quotient=False)
    return sc, windows, starts, d, want, sweep


@pytest.mark.parametrize("K", FUSED_KS)
@pytest.mark.parametrize("n", EDGE_LENGTHS)
@pytest.mark.parametrize("name", ["d12", "mixed"])
def test_fused_lanes_twin_equals_jax(name, n, K, monkeypatch):
    sc, windows, starts, d, want, sweep = _fused_case(name, n)
    monkeypatch.setattr(kernels, "FUSED_MAX_K", K)
    monkeypatch.setattr(kernels, "FUSED_MAX_LANES", 1 << 30)
    B, W = windows.shape
    assert kernels.fused_segments(B, W - d - (d + 1), d)[0] == K
    got = kernels.wwl_scan_fused(sc.table, sc.outrows, _tensor(windows),
                                 torch.from_numpy(starts), halo=d, id_bits=sc.id_bits,
                                 depth_bits=sc.depth_bits, num_classes=sc.num_classes, d=d,
                                 cross=sc.has_cross)
    _assert_same(got, want, msg=f"K={K} vs JAX fused")
    _assert_same(got[:5], sweep[:5], msg=f"K={K} vs JAX sweep")
    if sc.has_cross:
        _assert_same(got[5:], sweep[5:], msg=f"K={K} crossing bits vs JAX sweep")


@pytest.mark.parametrize("B, K, L, d", [(1, 1, 512, 12), (3, 2, 256, 12), (5, 4, 128, 4),
                                        (9, 8, 64, 12), (4, 3, 172, 12)])
def test_fused_lane_slots_equal_searchsorted(B, K, L, d):
    """Each lane's first slot, from the start's lane by arithmetic, equals a
    search of the sorted starts for the lane's first position (live past
    the last lane); starts below 0 come before lane 0, starts at or past
    live after the last lane."""
    C = 512
    live = B * C - (d + 1)
    rng = np.random.default_rng(B * 7 + K)
    w = np.sort(np.concatenate([rng.integers(-5, B * C + 20, size=300), [0, 0, live - 1, live,
                                                                          live, C * B]]))
    starts = torch.from_numpy(w.astype(np.int32))
    for slots in (len(w), len(w) - 7, 1):
        got = kernels.fused_lane_slots(starts, B, C, d, K, L, slots).numpy()
        firsts = [min(b * C + k * L, live) for b in range(B) for k in range(K)] + [live]
        want = np.searchsorted(w[:slots], firsts, side="left")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("values, slots", [
    ([5], 1), ([1, 2, 3], 3), ([1, 2, 2], 2), ([4, 4, 4, 4], 1), ([0, 0, 1, 9, 9, 9], 4),
    ([-2, 3, 3, 7], 4)])
def test_lane_slots_trailing_run(values, slots):
    """The lanes take every slot but a trailing run of equal starts after
    its first (the padded slots); the rest copy that slot's record."""
    assert kernels.lane_slots(torch.tensor(values, dtype=torch.int32)) == slots


def test_lane_slots_raise_on_unsorted_and_cache():
    with pytest.raises(ValueError, match="sorted"):
        kernels.lane_slots(torch.tensor([3, 1, 2], dtype=torch.int32))
    st = torch.tensor([1, 5, 5], dtype=torch.int32)
    assert kernels.lane_slots(st) == 2
    st[2] = 6  # a new version is read again
    assert kernels.lane_slots(st) == 3


@pytest.mark.parametrize("windows, body, halo, K", [
    (65_537, 512, 12, 8), (2_057, 512, 12, 8), (9, 512, 32, 4), (9, 512, 0, 1),
    (9, 100, 12, 2), (9, 40, 12, 1)])
def test_fused_segments_rule(windows, body, halo, K):
    """K up to 8 at the 10k cell's and baseline-4's windows, segments of at
    least four halos and 32 steps, L a multiple of 4 covering the body,
    one lane a window without a halo."""
    k, L = kernels.fused_segments(windows, body, halo)
    assert k == K
    assert (k - 1) * L < body <= k * L and (k == 1 or (L % 4 == 0 and L >= max(4 * halo, 32)))
    assert windows * k <= kernels.FUSED_MAX_LANES
    assert scan_block.segments(windows, body, halo) != (8, L)  # the planes' rule stops at 4
