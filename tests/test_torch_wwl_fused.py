"""The fused whole-word-longest scan in the port (``device="cpu"``: its plain
twin, the JAX ring formulation) against the JAX package's
``wwl_scan_walks_fused`` and the port's plane-and-sweep route; the module half
(``chunk_classes_overlap``, ``fused_applicable``, ``scan_walks_auto``); the
depth property the card's cursor design rests on; and the segmented plane
twin.  Everything compared is an integer, so every comparison is exact."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu.ops import scan_wwl as jax_wwl
from ahocorasick_tpu.utils import chartables
from ahocorasick_tpu_torch import bench, convert
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.kernels import scan_wwl as kernels
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.ops import scan_wwl as port_wwl
from test_torch_host import carry
from test_torch_wwl import ALL, _build, _dictionary, _fuzz_keywords, _np, _soup
from test_torch_wwl import layout  # noqa: F401  (the row / flat fixture)

WWL = "whole_word_longest"


def _tensor(a):
    """numpy -> torch, uint16 through an int16 view (same bits)."""
    if a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.uint16)
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _fused_dictionary(name):
    """(compiled WWL matcher, text) of the dense dictionaries the fused scan
    takes: walk depths d = 4, 12 and 32, separators kept as keywords, a
    separator-spanning one (crossing bits) and one of > 256 classes."""
    rng = np.random.default_rng(len(name) + 40)
    if name == "d4":
        kws = _fuzz_keywords(21, alphabet="abcehl", n=30, max_len=4)
        return compile_matcher(kws, WWL, True), _soup(21, kws, 700)
    if name == "d12":
        kws = _fuzz_keywords(22, alphabet="abce", n=40, max_len=12)
        return compile_matcher(kws, WWL, True), _soup(22, kws, 500)
    if name == "d32":  # the fuzz dictionary of tests/test_wwl_scan.py, max depth 29
        kws = ["a" * i for i in range(1, 30)] + ["abc", "bca"]
        return compile_matcher(kws, WWL, True), "".join(rng.choice(list("abc !"), size=4000))
    if name == "wide":  # dense, uint16 classes
        kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
        text = "".join(chr(0x100 + int(c)) if c < 300 else " "
                       for c in rng.integers(0, 340, size=4000))
        return compile_matcher(kws, WWL, True), text
    if name in ("quirk", "mixed"):
        return _dictionary(name)
    raise KeyError(name)


FUSED = ["d4", "d12", "d32", "wide", "quirk", "mixed"]


def _host_scan(m):
    """The JAX package's scan tables of ``m`` (pure, else mixed)."""
    return _build(jax_wwl, m)


# ------------------------------------------------------------------ windows


@pytest.mark.parametrize("d", [4, 12])
@pytest.mark.parametrize("n", [0, 1, 511, 512, 4097])
def test_chunk_classes_overlap_identical(n, d):
    rng = np.random.default_rng(n + d)
    for num_classes in (None, 27, 300):
        cls = rng.integers(0, num_classes or 1000, size=n).astype(np.int32)
        want = jax_wwl.chunk_classes_overlap(cls, 512, d, d + 1, num_classes)
        got = port_wwl.chunk_classes_overlap(cls, 512, d, d + 1, num_classes)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        # The body and halo are chunk_classes' windows; the overlap the next chunk's head.
        plain = port_sb.chunk_classes(cls, 512, d, num_classes)
        np.testing.assert_array_equal(got[:, : d + 512], plain)


@pytest.mark.parametrize("name", ALL)
def test_fused_applicable_agrees(name):
    m, _ = _dictionary(name)
    host, pm = _host_scan(m), carry(m)
    sc = _build(port_wwl, pm)
    for d in (4, 12, 32, 1 << 20):
        assert port_wwl.fused_applicable(sc, d) == jax_wwl.fused_applicable(host, d), d
    assert port_wwl.fused_applicable(sc, 12) == (not sc.quotient)


# ------------------------------------------------------------ depth property


def _dense_tables():
    """Every dense scan table these tests and ``tests/test_torch_wwl.py``
    build: (label, port matcher, port WwlScan)."""
    names = [("wwl", n) for n in ALL] + [("fused", n) for n in FUSED]
    out = []
    for src, name in names:
        m, _ = (_dictionary if src == "wwl" else _fused_dictionary)(name)
        if m.is_row_compressed:
            continue
        pm = carry(m)
        for flat in (False, True):
            saved = port_wwl._ROW_MAX_BYTES
            port_wwl._ROW_MAX_BYTES = 0 if flat else saved
            try:
                out.append((f"{name}{' flat' if flat else ''}", pm, _build(port_wwl, pm)))
            finally:
                port_wwl._ROW_MAX_BYTES = saved
    for seed in range(4):  # test_torch_wwl.test_wwl_equals_jax_device_and_gold's dictionaries
        pm = carry(compile_matcher(_fuzz_keywords(10 + seed), WWL, True))
        out.append((f"fuzz {seed}", pm, _build(port_wwl, pm)))
    return out


def test_depth_never_grows_by_more_than_one():
    """depth(delta(s, c)) <= depth(s) + 1 for every state and class of every
    dense table, pure and mixed: the property that makes g(p) = p - depth
    non-decreasing, so that one cursor per lane finds every walk's die."""
    seen = {"pure": 0, "mixed": 0}
    for label, pm, sc in _dense_tables():
        assert not sc.quotient
        S, A = pm.num_states, sc.num_classes
        table = sc.table[:S, :A] if sc.row_layout else sc.table.reshape(S, A)
        target = (table & np.uint32((1 << sc.id_bits) - 1)).astype(np.int64)
        depth = np.asarray(pm.depth[:S], dtype=np.int64)
        packed_depth = (table >> np.uint32(sc.id_bits)) & np.uint32((1 << sc.depth_bits) - 1)
        np.testing.assert_array_equal(packed_depth, depth[target], err_msg=label)
        bad = depth[target] > depth[:, None] + 1
        assert not bad.any(), f"{label}: {int(bad.sum())} entries deepen by more than one"
        seen["mixed" if sc.has_cross else "pure"] += 1
    assert seen["pure"] >= 8 and seen["mixed"] >= 2


# ------------------------------------------------------------ fused vs JAX


def _jax_outcomes(fn, host, windows, starts, d, **extra):
    kw = dict(halo=d, id_bits=host.id_bits, depth_bits=host.depth_bits,
              num_classes=host.num_classes, d=d, row_layout=host.row_layout,
              cross=host.has_cross, **extra)
    return [np.asarray(x) for x in fn(jnp.asarray(host.table), *(
        [None if host.rows_flat is None else jnp.asarray(host.rows_flat)]
        if fn is jax_wwl.wwl_scan_walks else []), jnp.asarray(host.outrows),
        jnp.asarray(windows), jnp.asarray(starts), **kw)]


def _port_sweep(sc, cls_p, starts, d):
    w = port_sb.classes_to_device(port_sb.chunk_classes(cls_p, 512, d, sc.num_classes),
                                  sc.num_classes, "cpu")
    return port_wwl.wwl_scan_walks(
        sc.table, sc.rows_flat, sc.outrows, w, torch.from_numpy(starts), halo=d,
        id_bits=sc.id_bits, depth_bits=sc.depth_bits, num_classes=sc.num_classes, d=d,
        row_layout=sc.row_layout, quotient=sc.quotient, cross=sc.has_cross)


def _port_fused(sc, cls_p, starts, d, narrow=True):
    w = port_wwl.chunk_classes_overlap(cls_p, 512, d, d + 1, sc.num_classes if narrow else None)
    return port_wwl.wwl_scan_walks_fused(
        sc.table, sc.outrows, _tensor(w), torch.from_numpy(starts), halo=d, id_bits=sc.id_bits,
        depth_bits=sc.depth_bits, num_classes=sc.num_classes, d=d, row_layout=sc.row_layout,
        cross=sc.has_cross)


def _assert_same(got, want, n=None, msg=""):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g) if isinstance(g, torch.Tensor) else g, _np(w) if isinstance(
            w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype, (msg, k)
        np.testing.assert_array_equal(g[:n], w[:n], err_msg=f"{msg} output {k}")


@pytest.mark.parametrize("name", FUSED)
def test_fused_twin_equals_jax_fused_and_sweep(name, layout):
    m, text = _fused_dictionary(name)
    host = _host_scan(m)
    sc = convert.wwl_scan_from_numpy(host, "cpu")
    assert not sc.quotient and sc.row_layout == (not layout)
    cls = m.charmap[chartables.to_utf16_units(text)]
    cls_p, starts, lanes, _, d = jax_wwl.compact_lanes(m, cls)
    assert {"d4": 4, "d12": 12, "d32": 32}.get(name, d) == d
    assert port_wwl.fused_applicable(sc, d) and jax_wwl.fused_applicable(host, d)
    assert (m.num_classes > 256) == (name == "wide")
    W = len(lanes)
    want_fused = _jax_outcomes(jax_wwl.wwl_scan_walks_fused, host,
                               jax_wwl.chunk_classes_overlap(cls_p, 512, d, d + 1, m.num_classes),
                               starts, d)
    want_sweep = _jax_outcomes(jax_wwl.wwl_scan_walks, host,
                               jax_sb.chunk_classes(cls_p, 512, d, m.num_classes), starts, d,
                               quotient=False)
    _assert_same(want_fused, want_sweep, W, "JAX fused vs JAX sweep")
    before = dict(launches)
    sweep = _port_sweep(sc, cls_p, starts, d)
    for narrow in (True, False):
        got = _port_fused(sc, cls_p, starts, d, narrow)
        assert len(got) == (6 if sc.has_cross else 5)
        _assert_same(got, want_fused, W, f"narrow={narrow} vs JAX fused")
        _assert_same(got, sweep, None, f"narrow={narrow} vs the port's sweep, every slot")
    assert launches == before  # the twins count no launches
    if sc.has_cross:
        assert _np(sweep[5])[:W].any()  # the mixed route really crosses


@pytest.mark.parametrize("n", [0, 3, 512, 1023, 4096, 4097])
@pytest.mark.parametrize("name", ["d4", "d12", "mixed"])
def test_fused_twin_equals_sweep_on_edge_lengths(name, n):
    """Empty and tiny texts, lengths on and off the 512-unit chunk, and
    starts past L and duplicated (the padded slots), on every slot."""
    m, text = _fused_dictionary(name)
    pm = carry(m)
    sc = convert.wwl_scan_from_numpy(_build(port_wwl, pm), "cpu")
    cls = m.charmap[chartables.to_utf16_units((text * 3)[:n])]
    cls_p, starts, lanes, _, d = port_wwl.compact_lanes(pm, cls)
    assert (starts[len(lanes):] == n).all() and len(starts) > len(lanes)
    _assert_same(_port_fused(sc, cls_p, starts, d), _port_sweep(sc, cls_p, starts, d))
    # Starts of the caller's choosing: negative, at and past L, duplicated.
    B = -(-len(cls_p) // 512)
    L = B * 512 - (d + 1)
    odd = np.array(sorted([-3, 0, 0, 2, 2, 2, L - 1, L, L, L + 5, B * 512 + 9]), dtype=np.int32)
    _assert_same(_port_fused(sc, cls_p, odd, d), _port_sweep(sc, cls_p, odd, d))


# --------------------------------------------------- segmented plane twin


def _plane_reference(table, windows, halo, id_bits, num_classes, quotient):
    """One lane per window from its own halo (the JAX ``_wwl_core`` scan),
    in numpy: the packed entry and the flat entry index at every body
    position, flat text order."""
    B, W = windows.shape
    stride = table.shape[1] if table.ndim == 2 else num_classes
    tf = table.reshape(-1).astype(np.int64)
    w = windows.astype(np.int64)
    s = np.zeros(B, dtype=np.int64)
    idmask = (1 << id_bits) - 1
    for t in range(halo):
        s = tf[s * stride + w[:, t]] & idmask
    plane = np.zeros((B, W - halo), dtype=np.int64)
    entry = np.zeros((B, W - halo), dtype=np.int64)
    for t in range(halo, W):
        v = tf[s * stride + w[:, t]]
        plane[:, t - halo] = v
        entry[:, t - halo] = s * num_classes + w[:, t]
        s = v & idmask
    return plane.reshape(-1).astype(np.uint32), entry.reshape(-1).astype(np.int32)


@pytest.mark.parametrize("chunk", [512, 100, 127])
@pytest.mark.parametrize("name", ["dense", "mixed", "fullnode", "quotient"])
def test_segmented_plane_twin_equals_one_lane_scan(name, chunk, layout):
    m, text = _dictionary(name)
    host = _build(jax_wwl, m)
    sc = convert.wwl_scan_from_numpy(host, "cpu")
    cls = m.charmap[chartables.to_utf16_units(text)]
    cls_p, starts, lanes, _, d = jax_wwl.compact_lanes(m, cls)
    windows = jax_sb.chunk_classes(cls_p, chunk, d, host.num_classes)
    K, L = scan_block.segments(windows.shape[0], chunk, d)
    assert K > 1  # a few windows: the kernel and its twin split them
    plane, entry = kernels.wwl_scan_plane(sc.table, _tensor(windows), d, sc.id_bits,
                                          sc.num_classes, sc.quotient)
    want_plane, want_entry = _plane_reference(host.table, windows, d, host.id_bits,
                                              host.num_classes, host.quotient)
    np.testing.assert_array_equal(_np(plane), want_plane)
    assert (entry is None) == (not sc.quotient)
    if sc.quotient:
        np.testing.assert_array_equal(_np(entry), want_entry)
    if chunk == 512:  # and the sweep over it gives the JAX engine's outcomes
        want = _jax_outcomes(jax_wwl.wwl_scan_walks, host, windows, starts, d,
                             quotient=host.quotient)
        _assert_same(_port_sweep(sc, cls_p, starts, d), want)


# ------------------------------------------------------------- the chooser


def _spy_routes(monkeypatch):
    taken = []
    for name in ("wwl_scan_fused", "wwl_scan_plane"):
        real = getattr(kernels, name)

        def spy(*a, _real=real, _name=name, **k):
            taken.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(kernels, name, spy)
    return taken


def _gold(m, text):
    vals = m.compiled.values
    if m.is_map:
        return [(s, e, vals[v]) for s, e, v in gold.gold_match(m.compiled, text)]
    return [(s, e) for s, e, _ in gold.gold_match(m.compiled, text)]


@pytest.mark.parametrize("name", ["d12", "mixed", "quirk", "fullnode"])
@pytest.mark.parametrize("fused_default", [True, False], ids=["fused", "sweep"])
def test_scan_walks_auto_matcher_stream_and_bench(name, fused_default, monkeypatch):
    monkeypatch.setattr(port_wwl, "FUSED_DEFAULT", fused_default)
    m, text = (_dictionary if name == "fullnode" else _fused_dictionary)(name)
    pm = carry(m)
    p = port.WholeWordLongestMatchSet.from_compiled(pm, engine="device", device="cpu")
    j = jax_pkg.WholeWordLongestMatchSet.from_compiled(m, engine="device")
    sc = p.dev.wwl_scan if port_wwl.scan_applicable(pm) else p.dev.wwl_scan_mixed
    d = port_wwl.bucket_depth(pm.max_depth)
    fused = fused_default and port_wwl.fused_applicable(sc, d)
    assert fused == (fused_default and name != "fullnode")
    want_route = ["wwl_scan_fused" if fused else "wwl_scan_plane"]
    taken = _spy_routes(monkeypatch)
    # The matcher.
    want = _gold(p, text)
    assert len(want) >= 5
    assert p.match(text) == j.match(text) == want
    assert p.last_stats.engine == "device" and taken == want_route
    # The stream cursor, over random cuts.
    rng = np.random.default_rng(len(name))
    pieces, i = [], 0
    while i < len(text):
        k = int(rng.integers(1, 700))
        pieces.append(text[i: i + k])
        i += k
    del taken[:]
    assert p.match_stream(pieces) == j.match_stream(pieces) == want
    assert taken and set(taken) == set(want_route)
    # The bench harness times the same pick; its outcomes are the JAX engine's.
    del taken[:]
    got = []
    real = port_wwl.scan_walks_on
    monkeypatch.setattr(port_wwl, "scan_walks_on", lambda *a: got.append(real(*a)) or got[-1])
    cls = m.charmap[chartables.to_utf16_units(text)]
    assert bench.wwl_kernel_rate(p, cls, reps=1, min_units=1) > 0
    assert taken and set(taken) == set(want_route)
    cls_p, starts, lanes, _, dj = jax_wwl.compact_lanes(m, cls)
    host = _host_scan(m)
    want_out = _jax_outcomes(jax_wwl.wwl_scan_walks, host,
                             jax_sb.chunk_classes(cls_p, 512, dj, m.num_classes), starts, dj,
                             quotient=host.quotient)
    for outs in got:
        _assert_same(outs, want_out, len(lanes))


# ------------------------------------------------------------ the wrapper


def test_fused_wrapper_rejects_bad_inputs():
    m, text = _fused_dictionary("d12")
    host = _host_scan(m)
    sc = convert.wwl_scan_from_numpy(host, "cpu")
    cls_p, starts, _, _, d = jax_wwl.compact_lanes(m, m.charmap[chartables.to_utf16_units(text)])
    w = _tensor(port_wwl.chunk_classes_overlap(cls_p, 512, d, d + 1, sc.num_classes))
    st = torch.from_numpy(starts)
    kw = dict(halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits, num_classes=sc.num_classes,
              d=d, cross=False)
    kernels.wwl_scan_fused(sc.table, sc.outrows, w, st, **kw)
    with pytest.raises(ValueError, match="dense tables only"):
        kernels.wwl_scan_fused(sc.table, sc.outrows, w, st, quotient=True, **kw)
    with pytest.raises(ValueError, match="sorted"):
        kernels.wwl_scan_fused(sc.table, sc.outrows, w, st.flip(0).contiguous(), **kw)
    changed = st.clone()  # found sorted once, then changed in place: checked again
    kernels.wwl_scan_fused(sc.table, sc.outrows, w, changed, **kw)
    changed[0] = changed[-1] + 1
    with pytest.raises(ValueError, match="sorted"):
        kernels.wwl_scan_fused(sc.table, sc.outrows, w, changed, **kw)
    with pytest.raises(TypeError, match="starts"):
        kernels.wwl_scan_fused(sc.table, sc.outrows, w, st.long(), **kw)
    with pytest.raises(TypeError, match="outrows"):
        kernels.wwl_scan_fused(sc.table, sc.outrows[:2], w, st, **kw)
    with pytest.raises(ValueError, match="overlap"):
        kernels.wwl_scan_fused(sc.table, sc.outrows, w[:, : d + d + 1].contiguous(), st, **kw)
    with pytest.raises(ValueError, match="32 bits"):
        kernels.wwl_scan_fused(sc.table, sc.outrows, w, st, **{**kw, "id_bits": 27})
    with pytest.raises(ValueError, match="row_layout"):
        port_wwl.wwl_scan_walks_fused(sc.table, sc.outrows, w, st, halo=d, id_bits=sc.id_bits,
                                      depth_bits=sc.depth_bits, num_classes=sc.num_classes,
                                      d=d, row_layout=not sc.row_layout)
    # A quotient dictionary is not fused_applicable: the chooser takes the sweep.
    q, _ = _dictionary("quotient")
    qsc = _build(port_wwl, carry(q))
    assert qsc.quotient and not port_wwl.fused_applicable(qsc, 4)
