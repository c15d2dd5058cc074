"""Huge-dictionary layouts of the port (count-packed count, hotstate plane,
split scans) vs the JAX package and the gold model, on dictionaries whose
state bits plus max depth exceed 32: the builders byte for byte, each plain
twin against its JAX device loop on the same windows and on tables carried
across by ``convert``, the dispatcher's plans, and every class through the
device path (``device="cpu"``: the kernels' plain twins).  Tables, planes,
counts and triples are integers, so every comparison is exact."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.models import matchers as jax_matchers
from ahocorasick_tpu.ops import dispatch as jax_dispatch
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.kernels import scan_batched as huge
from ahocorasick_tpu_torch.kernels.scan_block import segments
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import dispatch as port_dispatch
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.core.compiler import compile_matcher as port_compile
from test_torch_host import carry

DEEP = ["a" * i for i in range(1, 40)] + ["the"]  # depth 39: P = 2


def _ab_long():
    """The long two-letter keywords of ``tests/test_batched.py``'s
    count-packed test (depth 43: P = 2)."""
    rng = np.random.default_rng(20260820)
    return ["".join(rng.choice(list("ab"), size=int(rng.integers(30, 45))))
            for _ in range(12)] + ["ab", "ba", "aab"]


DICTS = {
    "deep": DEEP,
    "a100": ["a" * i for i in range(1, 101)],  # depth 100: P = 4
    "ab_long": _ab_long(),
    # > 256 classes (uint16 windows), depth 30: P = 1
    "wide_deep": [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
    + ["".join(chr(0x100 + (11 * i) % 300) for i in range(30))],
}
NAMES = list(DICTS)
NOISE = "qrsuvwz"


def _compiled(name, kind="ac"):
    return compile_matcher(DICTS[name], kind, True)


def _text(name, n, kw_share, seed=0):
    """Seeded text: dictionary keywords (share ``kw_share`` of the pieces)
    among noise words of letters no dictionary holds."""
    rng = np.random.default_rng(seed)
    kws = DICTS[name]
    pieces, total = [], 0
    while total < n:
        if rng.random() < kw_share:
            w = kws[int(rng.integers(len(kws)))]
        else:
            w = "".join(rng.choice(list(NOISE), size=int(rng.integers(2, 7))))
        pieces.append(w)
        total += len(w) + 1
    return " ".join(pieces)[:n]


def _windows(m, text, halo, chunk=64):
    """The same narrow windows for both packages: numpy and torch."""
    cls = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    w = port_sb.chunk_classes(cls, chunk, halo, m.num_classes)
    return cls, w, port_sb.classes_to_device(w, m.num_classes, "cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def _gold_count(m, text):
    return len(gold.gold_match(m, text))


# ------------------------------------------------------------------ builders


@pytest.mark.parametrize("name", NAMES)
def test_layout_predicates_identical(name):
    m = _compiled(name)
    assert port_sb.count_packable(carry(m)) == jax_sb.count_packable(m) is True
    assert port_sb.hotstate_layout(carry(m)) == jax_sb.hotstate_layout(m) is True
    assert port_sb.inline_packable(carry(m)) == jax_sb.inline_packable(m) is False
    assert (m.num_classes > 256) == (name == "wide_deep")


@pytest.mark.parametrize("name", NAMES)
def test_build_count_packed_identical(name):
    m = _compiled(name)
    got, want = port_sb.build_count_packed(carry(m)), jax_sb.build_count_packed(m)
    assert got[0].dtype == want[0].dtype == np.uint32 and got[0].ndim == 1
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_build_count_packed_refuses_row_compressed():
    class _NeverDense:
        def is_over_threshold(self, size, lo, hi):
            return False

    m = compile_matcher(["ab", "b"], "ac", True, thresholder=_NeverDense())
    assert m.is_row_compressed
    assert not port_sb.count_packable(carry(m)) and not jax_sb.count_packable(m)
    assert not port_sb.hotstate_layout(carry(m))
    with pytest.raises(ValueError, match="emit counts"):
        port_sb.build_count_packed(carry(m))


@pytest.mark.parametrize("name", NAMES)
def test_host_emit_planes_identical(name):
    m = _compiled(name)
    got = port_sb.host_emit_planes(carry(m))
    want = jax_sb.host_emit_planes(m)
    assert got.dtype == want.dtype == np.uint32
    assert got.shape == want.shape == (m.num_states, (m.max_depth + 31) // 32)
    np.testing.assert_array_equal(got, want)
    assert port_sb.host_emit_planes(carry(m)) is got  # cached


def test_host_emit_planes_lru_holds_weak_references():
    port_sb._HOST_EMIT_PLANES.clear()
    ms = [port_compile(["a" * i for i in range(1, 36 + k)], "ac", True) for k in range(5)]
    for m in ms:
        port_sb.host_emit_planes(m)
    assert len(port_sb._HOST_EMIT_PLANES) == 4  # LRU of 4
    assert id(ms[0]) not in port_sb._HOST_EMIT_PLANES
    port_sb.host_emit_planes(ms[1])  # refresh: ms[1] is now the newest
    assert list(port_sb._HOST_EMIT_PLANES)[-1] == id(ms[1])
    del ms[1:], m
    gc.collect()
    assert list(port_sb._HOST_EMIT_PLANES) == []  # entries left with their matchers


@pytest.mark.parametrize("branch", ["sparse", "dense"])
@pytest.mark.parametrize("name", NAMES)
def test_hotstate_sparse_identical(name, branch, monkeypatch):
    m = _compiled(name)
    n = 3000
    text = _text(name, n, 0.03 if branch == "sparse" else 0.6, seed=1)
    flat, state_bits, halo = jax_sb.build_count_packed(m)
    cls, w, wt = _windows(m, text, halo)
    jax_bits = jax_sb.packedcount_hotstate_plane(
        jnp.asarray(flat), jnp.asarray(w), halo, state_bits, m.num_classes)
    table, _, _ = convert.count_packed_from_numpy(flat, state_bits, halo, "cpu")
    bits = huge.packedcount_hotstate_plane(table, wt, halo, state_bits, m.num_classes)
    if branch == "sparse":
        for mod in (port_sb, jax_sb):
            monkeypatch.setattr(mod, "_SPARSE_ON_CPU", True)
            monkeypatch.setattr(mod, "_SPARSE_MIN_UNITS", 256)
    seen = []
    real = port_sb.planes_to_sparse
    monkeypatch.setattr(port_sb, "planes_to_sparse",
                        lambda b, k: seen.append(real(b, k)) or seen[-1])
    idx, masks = port_sb.hotstate_sparse(carry(m), bits, n)
    want_idx, want_masks = jax_sb.hotstate_sparse(m, jax_bits, n)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(masks, want_masks)
    assert idx.dtype == np.int64 and masks.dtype == np.uint32
    assert masks.shape == (len(idx), (m.max_depth + 31) // 32)
    assert len(idx) > 0
    # Compacted, or (CPU tensors by default) the dense download.
    assert len(seen) == 1 and (seen[0] is not None) == (branch == "sparse")


@pytest.mark.parametrize("name", NAMES)
def test_device_tables_identical(name):
    m = _compiled(name)
    jt = jax_matchers._DeviceTables(m)
    pt = port_matchers._DeviceTables(carry(m), "cpu")
    flat, state_bits, halo = pt.count_packed_dfa
    want_flat, want_bits, want_halo = jt.count_packed_dfa
    assert flat.dtype == torch.uint32 and flat.dim() == 1
    np.testing.assert_array_equal(_u32(flat), np.asarray(want_flat))
    assert (state_bits, halo) == (want_bits, want_halo)
    dfa_flat, emit_tab, halo = pt.split_dfa
    want_dfa, want_emit, want_halo = jt.split_dfa
    np.testing.assert_array_equal(_u32(dfa_flat), np.asarray(want_dfa))
    np.testing.assert_array_equal(_u32(emit_tab), np.asarray(want_emit))
    assert halo == want_halo and emit_tab.shape == want_emit.shape
    assert pt.device_bytes() == jt.device_bytes() > 0
    # The JAX package's tables carry across unchanged.
    carried = convert.split_from_numpy(*(np.asarray(x) for x in jt.split_dfa[:2]), want_halo, "cpu")
    np.testing.assert_array_equal(_u32(carried[0]), np.asarray(want_dfa))
    np.testing.assert_array_equal(_u32(carried[1]), np.asarray(want_emit))


def test_convert_rejects_wrong_layouts():
    with pytest.raises(ValueError, match="flat uint32"):
        convert.count_packed_from_numpy(np.zeros((2, 3), np.uint32), 4, 3, "cpu")
    with pytest.raises(ValueError, match="emit planes"):
        convert.split_from_numpy(np.zeros(6, np.uint32), np.zeros(6, np.uint32), 3, "cpu")


# ------------------------------------------------- twins vs the JAX loops


@pytest.mark.parametrize("name", NAMES)
def test_packedcount_twins_equal_jax(name):
    m = _compiled(name)
    text = _text(name, 2500, 0.4, seed=2)
    flat, state_bits, halo = jax_sb.build_count_packed(m)
    cls, w, wt = _windows(m, text, halo)
    assert wt.dtype == (torch.uint16 if name == "wide_deep" else torch.uint8)
    args_j = (jnp.asarray(flat), jnp.asarray(w), halo, state_bits, m.num_classes)
    table, _, _ = convert.count_packed_from_numpy(flat, state_bits, halo, "cpu")
    args_p = (table, wt, halo, state_bits, m.num_classes)
    got = huge.packedcount_count(*args_p)
    assert got.dtype == torch.int64
    assert int(got) == int(jax_sb.packedcount_count(*args_j)) == _gold_count(m, text) > 0
    plane = huge.packedcount_hotstate_plane(*args_p)
    want = np.asarray(jax_sb.packedcount_hotstate_plane(*args_j))
    assert plane.dtype == torch.uint32 and tuple(plane.shape) == want.shape
    np.testing.assert_array_equal(_u32(plane), want)
    assert (want != 0).sum() > 0


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("ragged", [False, True], ids=["C%4==0", "C%4==3"])
@pytest.mark.parametrize("name", NAMES)
def test_hotstate_twin_in_lane_decomposition_equals_jax(name, ragged, K, monkeypatch):
    """The hotstate twin takes the kernel's K lanes per window (each warmed
    over the halo before its segment): bit for bit the JAX plane, with C a
    multiple of 4 (the kernel's 16-byte stores) or not (4-byte stores), on
    a few windows (lanes not a multiple of the 256-thread block)."""
    m = _compiled(name)
    flat, state_bits, halo = jax_sb.build_count_packed(m)
    chunk = 16 * halo + (3 if ragged else 8)  # segments of at least four halos at K = 4
    text = _text(name, 3 * chunk + 77, 0.4, seed=9)
    cls, w, wt = _windows(m, text, halo, chunk)
    B = wt.shape[0]
    monkeypatch.setattr(huge, "HOTSTATE_MAX_LANES", K * B)
    assert segments(B, chunk, halo, huge.HOTSTATE_MAX_LANES)[0] == K and (B * K) % 256
    table, _, _ = convert.count_packed_from_numpy(flat, state_bits, halo, "cpu")
    plane = huge.packedcount_hotstate_plane(table, wt, halo, state_bits, m.num_classes)
    want = np.asarray(jax_sb.packedcount_hotstate_plane(
        jnp.asarray(flat), jnp.asarray(w), halo, state_bits, m.num_classes))
    assert plane.dtype == torch.uint32 and tuple(plane.shape) == want.shape == (1, B * chunk)
    np.testing.assert_array_equal(_u32(plane), want)
    assert (want != 0).sum() > 0


@pytest.mark.parametrize("name", NAMES)
def test_split_twins_equal_jax(name):
    m = _compiled(name)
    text = _text(name, 2500, 0.4, seed=3)
    dfa_flat, emit_tab, halo = jax_matchers._DeviceTables(m).split_dfa
    P = (m.max_depth + 31) // 32
    assert P == {"deep": 2, "a100": 4, "ab_long": 2, "wide_deep": 1}[name]
    cls, w, wt = _windows(m, text, halo)
    args_j = (dfa_flat, emit_tab, jnp.asarray(w), halo, m.num_classes, P)
    pd, pe, _ = convert.split_from_numpy(np.asarray(dfa_flat), np.asarray(emit_tab), halo, "cpu")
    args_p = (pd, pe, wt, halo, m.num_classes, P)
    assert int(huge.split_count(*args_p)) == int(jax_sb.split_count(*args_j)) \
        == _gold_count(m, text) > 0
    planes = huge.split_emit_planes(*args_p)
    want = np.asarray(jax_sb.split_emit_planes(*args_j))
    assert planes.dtype == torch.uint32 and tuple(planes.shape) == want.shape
    assert want.shape == (P, w.shape[0] * (w.shape[1] - halo))
    np.testing.assert_array_equal(_u32(planes), want)
    assert (want[-1] != 0).any()  # the top plane carries the longest keywords
    # The planes decode to the gold matches.
    s, e, _ = port_sb.ac_matches_batched(carry(m), cls, planes)
    assert list(zip(s.tolist(), e.tolist())) == [(a, b) for a, b, _ in gold.gold_match(m, text)]


def test_wrappers_check_their_inputs():
    flat = torch.zeros(12, dtype=torch.uint32)
    w = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(TypeError, match="flat uint32"):
        huge.packedcount_count(flat.view(3, 4), w, 2, 2, 4)
    with pytest.raises(ValueError, match="not S x 5"):
        huge.packedcount_count(flat, w, 2, 2, 5)
    with pytest.raises(ValueError, match="cannot address"):
        huge.packedcount_hotstate_plane(flat, w, 2, 1, 4)  # 3 states, 1 bit
    with pytest.raises(TypeError, match="windows"):
        huge.packedcount_count(flat, w.to(torch.int32), 2, 2, 4)
    with pytest.raises(ValueError, match="halo"):
        huge.packedcount_count(flat, w, 8, 2, 4)
    emit = torch.zeros((3, 2), dtype=torch.uint32)
    with pytest.raises(TypeError, match="emit_tab"):
        huge.split_count(flat, emit, w, 2, 4, 1)
    with pytest.raises(ValueError, match="is not 3 x 5"):
        huge.split_emit_planes(flat, emit, w, 2, 5, 2)
    port.reset_launches()
    assert int(huge.split_count(flat, emit, w, 2, 4, 2)) == 0
    assert huge.split_emit_planes(flat, emit, w, 2, 4, 2).shape == (2, 12)
    assert port.launches["split_count"] == port.launches["split_emit_planes"] == 0  # twins


# ---------------------------------------------------------------- dispatch


@pytest.mark.parametrize("split", [False, True], ids=["count_packed", "split"])
@pytest.mark.parametrize("name", NAMES)
def test_dispatch_which_equals_jax(name, split, monkeypatch):
    if split:  # the dictionaries of ~2**26 states that reach split, in small
        for mod in (port_sb, jax_sb):
            monkeypatch.setattr(mod, "count_packable", lambda m: False)
    m = _compiled(name)
    pt, jt = port_matchers._DeviceTables(carry(m), "cpu"), jax_matchers._DeviceTables(m)
    for plan_fn in ("count_plan", "planes_plan"):
        got = getattr(port_dispatch, plan_fn)(m, pt)
        want = getattr(jax_dispatch, plan_fn)(m, jt)
        assert got.which == want.which and got.halo == want.halo
    want = ("split", "split") if split else ("packedcount", "hotstate")
    assert (port_dispatch.count_plan(carry(m), pt).which,
            port_dispatch.planes_plan(carry(m), pt).which) == want
    text = _text(name, 1500, 0.4, seed=4)
    cls, _, wt = _windows(m, text, port_dispatch.count_plan(carry(m), pt).halo, chunk=512)
    plan = port_dispatch.count_plan(carry(m), pt)
    assert int(plan.fn(plan.tables, wt)) == _gold_count(m, text)


@pytest.mark.parametrize("name", ["AhoCorasickSet", "LongestMatchSet", "WholeWordMatchSet"])
def test_split_path_through_the_classes(name, monkeypatch):
    """With ``count_packable`` False the classes scan the split layout: the
    result equals the JAX package's split path and gold."""
    for mod in (port_sb, jax_sb):
        monkeypatch.setattr(mod, "count_packable", lambda m: False)
    text = _text("deep", 4000, 0.3, seed=5)
    p = getattr(port, name)(DEEP, engine="device", device="cpu")
    j = getattr(jax_pkg, name)(DEEP, engine="device")
    want = getattr(port, name)(DEEP, engine="gold", device="cpu").match(text)
    assert p.match(text) == j.match(text) == want and len(want) > 100
    assert p.last_stats.engine == "device"
    assert p.count(text) == j.count(text) == len(want)
    assert set(p.dev._cache) == {"split_dfa"}
    assert p.device_table_bytes() == j.device_table_bytes() > 0


# ----------------------------------------------------------------- classes

DEEP_INNER = ["a" * i + "b" for i in range(40)]  # Shortest: its inner AC is deep too
CLASS_CASES = [
    ("AhoCorasickSet", DEEP), ("AhoCorasickMap", DEEP),
    ("LongestMatchSet", DEEP), ("LongestMatchMap", DICTS["ab_long"]),
    ("WholeWordMatchSet", DEEP), ("WholeWordMatchMap", DICTS["a100"]),
    ("ShortestMatchSet", DEEP_INNER), ("ShortestMatchMap", DEEP_INNER),
    ("LongestMatchSet", DICTS["wide_deep"]),
]


def _class_text(kws, n, seed):
    rng = np.random.default_rng(seed)
    pieces, total = [], 0
    while total < n:
        w = (kws[int(rng.integers(len(kws)))] if rng.random() < 0.4
             else "".join(rng.choice(list(NOISE), size=int(rng.integers(2, 7)))))
        pieces.append(w)
        total += len(w) + 1
    return " ".join(pieces)[:n]


@pytest.mark.parametrize("name, kws", CLASS_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CLASS_CASES)])
def test_every_class_on_deep_dictionaries(name, kws):
    args = (kws, [f"v{i}" for i in range(len(kws))]) if name.endswith("Map") else (kws,)
    p = getattr(port, name)(*args, engine="device", device="cpu")
    j = getattr(jax_pkg, name)(*args, engine="device")
    g = getattr(port, name)(*args, engine="gold", device="cpu")
    inner = p._ac.compiled if name.startswith("Shortest") else p.compiled
    assert not port_sb.inline_packable(carry(inner)) and port_sb.hotstate_layout(carry(inner))
    text = _class_text(kws, 3000, seed=len(name))
    want = g.match(text)
    assert p.match(text) == j.match(text) == want and len(want) > 20
    assert p.last_stats.engine == "device"
    starts, _, _ = p.match_triples(text)
    assert p.count(text) == len(starts) == len(want)
    assert p.device_table_bytes() == j.device_table_bytes() > 0


def test_hotstate_without_the_native_extractor(monkeypatch):
    """The numpy extraction and resolvers read the hotstate masks (P = 2)."""
    from ahocorasick_tpu_torch.native import lib as native_lib

    monkeypatch.setattr(native_lib, "available", lambda: False)
    text = _class_text(DEEP, 3000, seed=6)
    for name in ("AhoCorasickMap", "LongestMatchSet", "WholeWordMatchSet"):
        args = (DEEP, list(range(len(DEEP)))) if name.endswith("Map") else (DEEP,)
        p = getattr(port, name)(*args, engine="device", device="cpu")
        want = getattr(port, name)(*args, engine="gold", device="cpu").match(text)
        assert p.match(text) == want and len(want) > 20, name
    s = port.ShortestMatchSet(DEEP_INNER, engine="device", device="cpu")
    text = _class_text(DEEP_INNER, 3000, seed=7)
    assert s.match(text) == port.ShortestMatchSet(DEEP_INNER, engine="gold",
                                                  device="cpu").match(text)


def test_forced_sparse_hotstate_through_the_classes(monkeypatch):
    """Hotstate compaction feeding the native extract-and-resolve."""
    monkeypatch.setattr(port_sb, "_SPARSE_ON_CPU", True)
    monkeypatch.setattr(port_sb, "_SPARSE_MIN_UNITS", 1024)
    text = _text("deep", 6000, 0.03, seed=8)
    for name in ("AhoCorasickSet", "LongestMatchSet", "WholeWordMatchSet"):
        p = getattr(port, name)(DEEP, engine="device", device="cpu")
        want = getattr(port, name)(DEEP, engine="gold", device="cpu").match(text)
        assert p.match(text) == want and len(want) > 20, name
