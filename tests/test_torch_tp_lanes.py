"""The row-sharded scan on the lane loops, and the grouped die sweep, in the
port (CPU tensors: the kernels' plain twins) vs the JAX package.

* The row-sharded twin scans the kernel's lanes (``lane_segments``: K lanes
  per window, each warmed over the halo before its segment, a count lane
  counting only its own positions) with the JAX body's lookup, the masked
  sum over the shards: held against the JAX ``_table_sharded_run`` (one lane
  per window) in every mode, at K = 1, 2 and 4 (the lane caps patched), on
  1, 3 and 8 shards, ragged bodies, uint8, uint16 and int32 windows, and
  halo 0; a table whose next states reach past the last shard against a
  numpy statement of the segmented scan.
* The host's division constants: ``(s * magic + add) >> shift`` (the
  kernel's formula) == ``s // rows_per`` over edge and seeded states.
* The pointer stage's limit: more shards than ``MAX_SHARDS`` raise.
* The sweep twin (``ops.scan_wwl.wwl_scan_walks``: the plane and the sweep)
  vs the JAX ``wwl_scan_walks`` at d = 0, 1 and 39, dense and quotient,
  crossing bits on and off, starts unsorted, repeated, at and past L.

Everything compared is an integer, so every comparison is exact."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ahocorasick_tpu as act
from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu.ops import scan_wwl as jax_wwl
from ahocorasick_tpu.parallel import sharding as jax_sh
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.kernels import scan_wwl as kwwl
from ahocorasick_tpu_torch.kernels import table_sharded as ktp
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.ops import scan_wwl as port_wwl
from ahocorasick_tpu_torch.parallel import sharding as port_sh
from test_torch_sharding import CPU, _np
from test_torch_table_sharded import _jmesh

MODES = list(ktp.MODES)
# The table each mode reads: an emit-mask table for the counts and planes, a
# count-packed one for the emit count and the hotstate plane, a
# whole-word-longest table with crossing bits for the raw words.
MODE_TABLE = {"count": "packed", "planes": "packed", "count_packed": "count_packed",
              "hotstate": "count_packed", "raw": "wwl"}
# Bodies that split into 4 or 2 segments of lengths off a multiple of 4 K
# (each segment at least four halos and 32 steps long).
CHUNK = {"packed": 130, "count_packed": 330, "wwl": 130, "wide": 130}


@functools.lru_cache(maxsize=None)
def _table(name):
    """(packed uint32[S, A] table, classes, halo, state_bits) of one shape."""
    rng = np.random.default_rng(20261017)
    if name == "packed":
        kws = sorted({"".join(rng.choice(list("abcd"), size=int(rng.integers(1, 6))))
                      for _ in range(60)})
        m = act.AhoCorasickSet(kws, engine="gold")
        pd = jax_sb.build_packed(m.compiled)
        cls = m._classes("".join(rng.choice(list("abcdx"), size=5 * 130 + 17)))
        return pd.table, cls, pd.halo, pd.state_bits
    if name == "count_packed":
        m = act.AhoCorasickSet(["a" * i for i in range(1, 21)] + ["ab", "ba", "bb"],
                               engine="gold")
        flat, sb, halo = jax_sb.build_count_packed(m.compiled)
        cls = m._classes("".join(rng.choice(list("ab"), size=3 * 330 + 71)))
        return flat.reshape(m.compiled.num_states, m.compiled.num_classes), cls, halo, sb
    if name == "wwl":
        m = act.WholeWordLongestMatchSet(["new york", "new", "york", "a b", "ab"],
                                         case_sensitive=False)
        sc = m.dev.wwl_scan_mixed_host
        assert sc.row_layout and sc.has_cross
        cls = m._classes("new york a b ab!x york new  york " * 25)
        return np.asarray(sc.table), cls, sc.halo, sc.id_bits
    if name == "wide":  # > 256 classes: uint16 windows
        m = act.AhoCorasickSet([chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)],
                               engine="gold")
        pd = jax_sb.build_packed(m.compiled)
        cls = m._classes("".join(chr(0x100 + int(c)) for c in rng.integers(0, 300, size=900)))
        return pd.table, cls, pd.halo, pd.state_bits
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _jax_run(name, mode, halo=None):
    table, cls, table_halo, sb = _table(name)
    halo = table_halo if halo is None else halo
    return np.asarray(jax_sh._table_sharded_run(table, cls, halo, sb, _jmesh(), CHUNK[name],
                                                mode))


def _sharded(table, n_model):
    """The port's row shards (zero-padded, each an allocation of its own)."""
    return port_sh._table_sharded_build(table, 1, 8, [CPU] * n_model, "count")[0][0]


def _windows(name, halo, narrow=True):
    table, cls, _, _ = _table(name)
    A = table.shape[1]
    w = port_sb.chunk_classes(cls, CHUNK[name], halo, A if narrow else None)
    if w.dtype == np.uint16:
        return torch.from_numpy(w.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(w)


def _force_k(monkeypatch, k, lanes):
    """Lane caps that make ``segments`` pick K = k for ``lanes`` windows."""
    cap = {4: 1 << 30, 2: 2 * lanes, 1: lanes}[k]
    monkeypatch.setattr(scan_block, "MAX_LANES", cap)
    monkeypatch.setattr(scan_block, "COUNT_MAX_LANES", cap)


def _assert_equal(got, want, mode):
    if mode in ("count", "count_packed"):
        assert got.dim() == 0 and int(got) == int(want)
    else:
        assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_np(got), want)


# --------------------------------------------- the segmented twin vs JAX


@pytest.mark.parametrize("n_model", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_segmented_twin_equals_jax(mode, k, n_model, monkeypatch):
    name = MODE_TABLE[mode]
    table, _, halo, sb = _table(name)
    want = _jax_run(name, mode)
    w = _windows(name, halo)
    B, C = w.shape[0], w.shape[1] - halo
    _force_k(monkeypatch, k, B)
    K, L = ktp.lane_segments(B, C, halo, mode)
    assert K == k and (K == 1 or C % (4 * K))  # ragged: the last segment is shorter
    before = dict(launches)
    got = ktp.table_sharded_scan(_sharded(table, n_model), w, halo, sb, mode)
    assert launches == before  # the twin counts no launches
    _assert_equal(got, want, mode)
    assert want.any()


@pytest.mark.parametrize("mode", MODES)
def test_uint16_windows_at_four_lanes(mode, monkeypatch):
    table, _, halo, sb = _table("wide")
    w = _windows("wide", halo)
    assert w.dtype == torch.uint16
    _force_k(monkeypatch, 4, w.shape[0])
    assert ktp.lane_segments(w.shape[0], w.shape[1] - halo, halo, mode)[0] == 4
    _assert_equal(ktp.table_sharded_scan(_sharded(table, 3), w, halo, sb, mode),
                  _jax_run("wide", mode), mode)


@pytest.mark.parametrize("mode", ["count", "planes"])
@pytest.mark.parametrize("k", [2, 4])
def test_int32_windows(mode, k, monkeypatch):
    table, _, halo, sb = _table("packed")
    w = _windows("packed", halo, narrow=False)
    assert w.dtype == torch.int32
    _force_k(monkeypatch, k, w.shape[0])
    _assert_equal(ktp.table_sharded_scan(_sharded(table, 8), w, halo, sb, mode),
                  _jax_run("packed", mode), mode)


@pytest.mark.parametrize("mode", MODES)
def test_halo_zero_runs_one_lane_per_window(mode, monkeypatch):
    name = MODE_TABLE[mode]
    table, _, _, sb = _table(name)
    w = _windows(name, 0)
    _force_k(monkeypatch, 4, w.shape[0])
    assert ktp.lane_segments(w.shape[0], w.shape[1], 0, mode) == (1, w.shape[1])
    _assert_equal(ktp.table_sharded_scan(_sharded(table, 3), w, 0, sb, mode),
                  _jax_run(name, mode, 0), mode)


def _segmented_reference(table, windows, halo, sb, mode, K, L):
    """numpy: each lane of each window from the root over the halo before its
    segment, a state past the table's rows reading 0."""
    S = table.shape[0]
    B, W = windows.shape
    C = W - halo
    count, planes = 0, np.zeros((B, C), dtype=np.uint64)
    for b in range(B):
        for k in range(K):
            lo, hi = k * L, min((k + 1) * L, C)
            s = 0
            for t in range(lo, hi + halo):
                v = int(table[s, windows[b, t]]) if s < S else 0
                if t >= lo + halo:
                    pay = v >> sb
                    count += bin(pay).count("1") if mode == "count" else pay
                    planes[b, t - halo] = (pay if mode == "planes" else
                                           (v if pay else 0) if mode == "hotstate" else v)
                s = v & ((1 << sb) - 1)
    return count if mode in ("count", "count_packed") else planes.reshape(1, -1)


@pytest.mark.parametrize("n_model", [1, 3, 8])
def test_states_past_the_last_shard_read_zero_in_every_lane(n_model, monkeypatch):
    rng = np.random.default_rng(7)
    S, A, sb = 29, 5, 7
    table = (rng.integers(0, 3 * S, size=(S, A))
             | rng.integers(0, 1 << 12, size=(S, A)) << sb).astype(np.uint32)
    windows = rng.integers(0, A, size=(6, 4 + 150)).astype(np.uint8)
    _force_k(monkeypatch, 4, 6)
    st = _sharded(table, n_model)
    assert st.rows_per * n_model < 3 * S  # some next states lie past every shard
    for mode in MODES:
        K, L = ktp.lane_segments(6, 150, 4, mode)
        assert K == 4
        want = _segmented_reference(table, windows, 4, sb, mode, K, L)
        got = ktp.table_sharded_scan(st, torch.from_numpy(windows), 4, sb, mode)
        if mode in ("count", "count_packed"):
            assert int(got) == want
        else:
            np.testing.assert_array_equal(_np(got).astype(np.uint64), want)


# --------------------------------------- the host's division constants


ROWS_PER = [1, 2, 3, 7, 1 << 10, (1 << 10) - 1, (1 << 10) + 1, 1 << 31, (1 << 31) - 1,
            (1 << 31) + 1, 641, 6_700_417, 14_700_000, (1 << 32) - 1]


@pytest.mark.parametrize("rows_per", ROWS_PER)
def test_division_constants_are_exact(rows_per):
    magic, add, shift = ktp.division_constants(rows_per)
    assert 0 <= magic < 1 << 32 and 0 <= add < 1 << 32 and 32 <= shift <= 63
    rng = np.random.default_rng(rows_per % 1000)
    top = (1 << 32) - 1
    states = {0, 1, top, top - 1, *(int(x) for x in rng.integers(0, 1 << 32, size=4000))}
    for q in (*range(0, 300), *range(top // rows_per - 300, top // rows_per + 2)):
        for s in (q * rows_per - 1, q * rows_per, q * rows_per + 1):
            if 0 <= s <= top:
                states.add(s)
    for s in states:
        # The kernel: one 32 x 32 + 64-bit multiply-add (no overflow), a shift.
        assert s * magic + add < 1 << 64
        assert (s * magic + add) >> shift == s // rows_per, (rows_per, s)


def test_division_constants_refuse_rows_outside_32_bits():
    for bad in (0, 1 << 32):
        with pytest.raises(ValueError, match="rows_per"):
            ktp.division_constants(bad)


def test_sharded_table_carries_its_constants():
    table, _, _, _ = _table("packed")
    st = _sharded(table, 3)
    assert st.divisor == ktp.division_constants(st.rows_per)


def test_more_shards_than_the_pointer_stage_holds_raise(monkeypatch):
    table, _, halo, sb = _table("packed")
    w = _windows("packed", halo)
    st = _sharded(table, 3)
    assert ktp.MAX_SHARDS == (48 * 1024 - 256 * 17 * 4) // 8
    monkeypatch.setattr(ktp, "MAX_SHARDS", 2)
    with pytest.raises(ValueError, match="MAX_SHARDS = 2"):
        ktp.table_sharded_scan(st, w, halo, sb, "count")
    monkeypatch.setattr(ktp, "MAX_SHARDS", 3)
    assert int(ktp.table_sharded_scan(st, w, halo, sb, "count")) == int(_jax_run("packed",
                                                                              "count"))


# ------------------------------------------------ the die sweep vs JAX


def _synthetic_wwl(d, quotient, cross, seed):
    """A flat table of S states whose entries hold depths <= d (so every walk
    dies within d + 1 words), wordness and crossing bits at random, an
    outrows of small values and, for the quotient form, a rows_flat."""
    rng = np.random.default_rng(seed)
    S, A, id_bits, depth_bits = 40, 6, 6, 6
    entry = (rng.integers(0, S, size=S * A) | rng.integers(0, d + 1, size=S * A) << id_bits
             | rng.integers(0, 2, size=S * A) << (id_bits + depth_bits))
    if cross:
        entry |= rng.integers(0, 2, size=S * A) << (id_bits + depth_bits + 1)
    outrows = rng.integers(0, 5, size=(S + 3, 8)).astype(np.int32)
    rows_flat = rng.integers(0, S + 3, size=S * A).astype(np.int32) if quotient else None
    cls = rng.integers(0, A, size=3 * 512 + 100).astype(np.int32)
    return dict(table=entry.astype(np.uint32), rows_flat=rows_flat, outrows=outrows, cls=cls,
                halo=0, id_bits=id_bits, depth_bits=depth_bits, num_classes=A, d=d,
                row_layout=False, quotient=quotient, cross=cross)


def _dictionary_wwl(kws, d):
    """A whole-word-longest dictionary's dense scan tables over its own soup,
    swept at walk depth ``d`` (>= its max depth)."""
    m = compile_matcher(kws, "whole_word_longest", True)
    assert jax_wwl.scan_applicable(m) and m.max_depth <= d
    host = jax_wwl.build_wwl_scan(m)
    rng = np.random.default_rng(d)
    text = "".join(rng.choice(kws + [" ", ", ", "x"]) for _ in range(700))
    cls, _, _, _, _ = jax_wwl.compact_lanes(m, m.charmap[np.frombuffer(
        text.encode("utf-16-le"), dtype=np.uint16)])
    return dict(table=np.asarray(host.table), rows_flat=None, outrows=np.asarray(host.outrows),
                cls=cls, halo=d, id_bits=host.id_bits, depth_bits=host.depth_bits,
                num_classes=host.num_classes, d=d, row_layout=host.row_layout, quotient=False,
                cross=False)


SWEEPS = {
    "d=0 dense": lambda: _synthetic_wwl(0, False, False, 1),
    "d=0 quotient": lambda: _synthetic_wwl(0, True, False, 2),
    "d=1 dense cross": lambda: _synthetic_wwl(1, False, True, 3),
    "d=1 quotient cross": lambda: _synthetic_wwl(1, True, True, 4),
    "d=1 single chars": lambda: _dictionary_wwl(["a", "b", "c"], 1),
    "d=39 a..a*39": lambda: _dictionary_wwl(["a" * i for i in range(1, 40)] + ["ab"], 39),
    "d=39 quotient cross": lambda: _synthetic_wwl(39, True, True, 5),
    "d=12 dense": lambda: _synthetic_wwl(12, False, False, 6),
}


def _starts(L, Lp, n, rng):
    """Unsorted and repeated starts in [0, L), and the padded slots [L, Lp)
    the JAX engine reads as its zero-padded plane."""
    inside = rng.integers(0, L, size=400)
    return np.concatenate([inside, inside[:60], np.sort(inside)[::7], np.arange(L, Lp),
                           [0, L - 1]]).astype(np.int32)


@pytest.mark.parametrize("name", list(SWEEPS))
def test_sweep_twin_equals_jax_at_odd_starts(name):
    cfg = SWEEPS[name]()
    cls, halo, d = cfg["cls"], cfg["halo"], cfg["d"]
    windows = jax_sb.chunk_classes(cls, 512, halo, cfg["num_classes"])
    L = windows.shape[0] * 512 - (d + 1)
    Lp = -(-L // 16) * 16
    starts = _starts(L, Lp, len(cls), np.random.default_rng(len(name)))
    kw = {k: cfg[k] for k in ("halo", "id_bits", "depth_bits", "num_classes", "d", "row_layout",
                              "quotient", "cross")}
    table = cfg["table"]
    want = jax_wwl.wwl_scan_walks(
        jnp.asarray(table), None if cfg["rows_flat"] is None else jnp.asarray(cfg["rows_flat"]),
        jnp.asarray(cfg["outrows"]), jnp.asarray(windows), jnp.asarray(starts), **kw)
    t = torch.from_numpy(table.view(np.int32)).view(torch.uint32)
    rows_flat = None if cfg["rows_flat"] is None else torch.from_numpy(cfg["rows_flat"])
    w_t = (torch.from_numpy(windows.view(np.int16)).view(torch.uint16)
           if windows.dtype == np.uint16 else torch.from_numpy(windows))
    got = port_wwl.wwl_scan_walks(t, rows_flat, torch.from_numpy(cfg["outrows"]), w_t,
                                  torch.from_numpy(starts), **kw)
    assert len(got) == len(want) == (6 if cfg["cross"] else 5)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(x))
    kd = _np(got[0]) - starts
    assert (kd >= 0).all() and (kd <= d).all()
    assert (kd[starts >= L] == 0).all()
    if d >= 1:
        assert len(set(kd[starts < L].tolist())) > 1  # walks die at several depths
    # The every-position sweep over the same plane == the sweep at 0 .. L-1.
    plane, entry = kwwl.wwl_scan_plane(t.reshape(-1) if not cfg["row_layout"] else t, w_t, halo,
                                       cfg["id_bits"], cfg["num_classes"], cfg["quotient"])
    sw = dict(d=d, id_bits=cfg["id_bits"], depth_bits=cfg["depth_bits"], cross=cfg["cross"])
    outrows = torch.from_numpy(cfg["outrows"])
    every = kwwl.wwl_sweep_all(plane, entry, rows_flat, outrows, L, **sw)
    at = kwwl.wwl_sweep_at(plane, entry, rows_flat, outrows,
                           torch.arange(L, dtype=torch.int32), **sw)
    for a, b in zip(every, at):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("quotient", [False, True])
def test_sweep_starts_outside_the_plane_read_the_zero_word(quotient, cross):
    """Negative starts and starts far past L walk nowhere: k_die 0 from the
    root, the outcome of outrows row 0 (no JAX counterpart: its gather clamps
    there)."""
    cfg = _synthetic_wwl(12, quotient, cross, 9)
    t = torch.from_numpy(cfg["table"].view(np.int32)).view(torch.uint32)
    windows = torch.from_numpy(jax_sb.chunk_classes(cfg["cls"], 512, 0, cfg["num_classes"]))
    plane, entry = kwwl.wwl_scan_plane(t, windows, 0, cfg["id_bits"], cfg["num_classes"],
                                       quotient)
    N = plane.shape[0]
    starts = torch.tensor([-5, -1, N - 13, N, N + 1000, 1 << 30], dtype=torch.int32)
    outrows = torch.from_numpy(cfg["outrows"])
    rows_flat = None if cfg["rows_flat"] is None else torch.from_numpy(cfg["rows_flat"])
    got = kwwl.wwl_sweep_at(plane, entry, rows_flat, outrows, starts, d=12,
                            id_bits=cfg["id_bits"], depth_bits=cfg["depth_bits"], cross=cross)
    own, own_v, fail_l, fail_o, fail_v = (int(x) for x in cfg["outrows"][0, :5])
    has_own, has_fail = own > 0, fail_l > 0 and own == 0
    end = starts if has_own else starts - fail_o
    assert torch.equal(got[0], starts)
    assert got[1].tolist() == [has_own or has_fail] * 6
    assert torch.equal(got[3], end)
    assert torch.equal(got[2], end - (own if has_own else fail_l))
    assert got[4].tolist() == [own_v if has_own else fail_v] * 6
    if cross:
        assert not got[5].any()
