"""The stride-2 row DFA (B9): the port's builder, twins, pick rule and the
``device_engine="batched2"`` knob against the JAX package and gold.

The same seeded dictionaries and windows go through the port's
``ops/scan_rowdfa.build_rowdfa`` and its kernels' plain twins
(``kernels/scan_rowdfa``, which the wrappers run for CPU tensors) and through
the JAX package's ``build_rowdfa`` / ``rowdfa_count`` / ``rowdfa_emit_planes``
(XLA on the CPU).  Tables, counts and bits are integers, so every comparison
is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.ops import scan_rowdfa as jax_rowdfa
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.kernels import scan_rowdfa as krow
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import dispatch
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.ops import scan_rowdfa
from test_torch_host import carry


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


def _words(seed, alphabet, n, lo, hi):
    r = np.random.default_rng(seed)
    return sorted({"".join(r.choice(list(alphabet), size=int(r.integers(lo, hi))))
                   for _ in range(n)})


def _dictionary(name):
    """(keywords, compile kwargs, text alphabet) of a seeded dictionary."""
    if name == "dense":
        return _words(0, "abcdef", 60, 1, 9), {}, "abcdefgh "
    if name == "quotient":  # row-compressed: rows are quotient-DFA states
        return _words(1, "abcd", 25, 1, 5), {"thresholder": _NeverDense()}, "abcd "
    if name == "odd_depth":  # depth 7: the halo rounds up to 8
        return ["abcdefg", "bcd", "ga", "fff"], {}, "abcdefg "
    if name == "sb_d_32":  # 12 state bits + depth 20 = 32
        return _words(5, "abcdefgh", 700, 3, 9) + ["abcdefghabcdefghabcd"], {}, "abcdefgh "
    if name == "wide":  # 301 classes: uint16 windows
        kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
        return kws, {}, [chr(0x100 + i) for i in range(300)]
    raise KeyError(name)


_COMPILED = {}


def _compiled(name):
    if name not in _COMPILED:
        kws, kw, _ = _dictionary(name)
        _COMPILED[name] = compile_matcher(kws, "ac", True, **kw)
    return _COMPILED[name]


def _text(name, n, seed=0):
    alphabet = _dictionary(name)[2]
    return "".join(np.random.default_rng(seed + n).choice(list(alphabet), size=n))


def _classes(m, text):
    return m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]


DICTS = ("dense", "quotient", "odd_depth", "sb_d_32", "wide")


@pytest.mark.parametrize("name", DICTS)
def test_build_rowdfa_is_the_jax_table_byte_for_byte(name):
    m = _compiled(name)
    want = jax_rowdfa.build_rowdfa(m)
    got = scan_rowdfa.build_rowdfa(carry(m))
    assert got.table.dtype == np.uint32 and got.table.flags.c_contiguous
    assert got.table.tobytes() == np.asarray(want.table).tobytes()
    assert (got.state_bits, got.halo, got.num_classes) == (
        want.state_bits, want.halo, want.num_classes)
    assert got.halo % 2 == 0 and got.halo >= max(m.max_depth, 1)
    assert scan_rowdfa.table_bytes(carry(m)) == got.table.nbytes
    assert scan_rowdfa.fits(carry(m)) and jax_rowdfa.fits(m, max_bytes=1 << 30)
    if name == "sb_d_32":
        assert got.state_bits + m.max_depth == 32
    if name == "quotient":
        assert m.is_row_compressed
        assert got.table.shape[0] == port_sb.effective_rows(carry(m)) * m.num_classes


def _port_twins(m, cls, chunk):
    rd = port_matchers._DeviceTables(carry(m), "cpu").row_dfa
    w = port_sb.classes_to_device(
        port_sb.chunk_classes(cls, chunk, rd.halo, m.num_classes), m.num_classes, "cpu")
    args = (rd.table, w, rd.halo, rd.state_bits, rd.num_classes)
    return int(krow.rowdfa2_count(*args)), krow.rowdfa2_planes(*args).numpy(), w.shape


def _jax_scans(m, cls, chunk):
    rd = jax_pkg.models.matchers._DeviceTables(m).row_dfa
    w = jnp.asarray(jax_rowdfa.chunk_classes2(cls, chunk, rd.halo))
    args = (rd.table, w, rd.halo, rd.state_bits, rd.num_classes)
    return (int(jax_rowdfa.rowdfa_count(*args)),
            np.asarray(jax_rowdfa.rowdfa_emit_planes(*args, 1)))


def _packed_twins(m, cls, chunk):
    pd = port_matchers._DeviceTables(carry(m), "cpu").packed_dfa
    w = port_sb.classes_to_device(port_sb.chunk_classes(cls, chunk, pd.halo, m.num_classes),
                                  m.num_classes, "cpu")
    args = (pd.table, w, pd.halo, pd.state_bits)
    return int(scan_block.packed_scan_count(*args)), scan_block.packed_scan_planes(*args).numpy()


@pytest.mark.parametrize("name, n, chunk", [
    ("dense", 999, 64), ("quotient", 501, 16), ("odd_depth", 777, 8),
    ("sb_d_32", 2001, 512), ("wide", 3001, 32),
    ("dense", 0, 64), ("dense", 1, 64), ("odd_depth", 2, 2),
])
def test_twins_equal_jax_packed_and_gold(name, n, chunk):
    """Odd and even lengths (the tail pair padded with PAD_CLASS), empty and
    one-unit text, chunks down to one pair."""
    m = _compiled(name)
    text = _text(name, n)
    if name == "sb_d_32":
        text = text[:-20] + "abcdefghabcdefghabcd"  # the depth-20 keyword ends in the text
    cls = _classes(m, text)
    count, planes, (B, W) = _port_twins(m, cls, chunk)
    assert planes.dtype == np.uint32 and planes.shape == (1, B * chunk)
    want_count, want_planes = _jax_scans(m, cls, chunk)
    assert count == want_count
    np.testing.assert_array_equal(planes, want_planes)
    packed_count, packed_planes = _packed_twins(m, cls, chunk)
    assert count == packed_count == int(np.bitwise_count(planes).sum())
    np.testing.assert_array_equal(planes, packed_planes)
    # Positions past the text (the PAD_CLASS tail) emit nothing.
    assert not planes[:, len(cls):].any()
    s, e, _ = port_sb.ac_matches_batched(carry(m), cls, torch.from_numpy(planes.view(np.int32))
                                         .view(torch.uint32))
    want = [(a, b) for a, b, _ in gold.gold_match(m, text)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert count > 0 or n <= 2


def test_cpu_tensors_take_the_twin_not_the_kernel():
    m = _compiled("dense")
    before = dict(krow.launches)
    count, _, _ = _port_twins(m, _classes(m, _text("dense", 500)), 64)
    assert krow.launches == before and count > 0


@pytest.mark.parametrize("bad", ["odd_halo", "odd_body", "table_shape", "state_bits",
                                 "int32_windows"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    m = carry(_compiled("dense"))
    rd = port_matchers._DeviceTables(m, "cpu").row_dfa
    w = torch.from_numpy(port_sb.chunk_classes(_classes(m, _text("dense", 300)), 64, rd.halo,
                                               m.num_classes))
    args = [rd.table, w, rd.halo, rd.state_bits, rd.num_classes]
    if bad == "odd_halo":
        args[2] = rd.halo - 1
    elif bad == "odd_body":
        args[1] = w[:, :-1].contiguous()
    elif bad == "table_shape":
        args[0] = rd.table[:, :-1].contiguous()
    elif bad == "state_bits":
        args[3] = 1
    else:
        args[1] = w.to(torch.int32)
    for fn in (krow.rowdfa2_count, krow.rowdfa2_planes):
        with pytest.raises((TypeError, ValueError)):
            fn(*args)


def test_pick_rule_and_dispatch_which():
    """The picked plan is the packed kernel (or a huge layout); ``force`` is
    the ``device_engine`` knob: ``"rowdfa2"`` takes the stride-2 kernels
    wherever the table fits, ``None`` never does."""
    deep = compile_matcher(["a" * i for i in range(1, 40)] + ["the"], "ac", True)
    cases = {name: carry(_compiled(name)) for name in DICTS} | {"deep": carry(deep)}
    for name, m in cases.items():
        t = port_matchers._DeviceTables(m, "cpu")
        fits = name != "deep"
        assert scan_rowdfa.fits(m) == fits == port_sb.inline_packable(m)
        assert scan_rowdfa.pick_engine(m) == "packed"
        picked = ("packed", "packed") if fits else ("packedcount", "hotstate")
        want = {None: picked, "rowdfa2": ("rowdfa2", "rowdfa2") if fits else picked}
        for force, (count_which, planes_which) in want.items():
            cp, pp = dispatch.count_plan(m, t, force), dispatch.planes_plan(m, t, force)
            assert (cp.which, pp.which) == (count_which, planes_which), (name, force)
            assert ("row_dfa" in t._cache) == (force is not None and fits)
            if cp.which == "rowdfa2":
                assert cp.halo == pp.halo == t.row_dfa.halo and cp.tables[0] is t.row_dfa.table
    m = cases["dense"]
    assert not scan_rowdfa.fits(m, max_bytes=10)
    for bad in ("rowdfa1", "packed"):
        with pytest.raises(ValueError, match="forced engine"):
            dispatch.count_plan(m, port_matchers._DeviceTables(m, "cpu"), bad)


def test_row_table_is_uploaded_lazily_and_counted():
    kws, _, _ = _dictionary("dense")
    text = _text("dense", 3000)
    p = port.AhoCorasickSet(kws, engine="device", device="cpu")
    assert p.device_table_bytes() == 0
    want = [(a, b) for a, b, _ in gold.gold_match(p.compiled, text)]
    assert p.match(text) == want and p.count(text) == len(want)
    packed = p.dev.packed_dfa.table.nbytes
    assert p.device_table_bytes() == packed  # the default engine: the packed table only
    p.device_engine = "batched2"
    assert p.match(text) == want
    assert p.device_table_bytes() == packed + p.dev.row_dfa.table.nbytes


_KINDS = [(k, is_map) for k in ("AhoCorasick", "LongestMatch", "WholeWordMatch", "ShortestMatch")
          for is_map in (False, True)]


@pytest.mark.parametrize("kind, is_map", _KINDS,
                         ids=[k + ("Map" if m else "Set") for k, m in _KINDS])
def test_batched2_equals_jax_batched2(kind, is_map):
    kws = _words(11, "abc", 14, 1, 6)
    text = "".join(np.random.default_rng(12).choice(list("abc "), size=900))
    name = kind + ("Map" if is_map else "Set")
    args = (kws, [f"v{i}" for i in range(len(kws))]) if is_map else (kws,)
    p = getattr(port, name)(*args, engine="device", device="cpu")
    j = getattr(jax_pkg, name)(*args, engine="device")
    p.device_engine = j.device_engine = "batched2"
    if kind == "ShortestMatch":  # the knob of the internal AC matcher
        p._ac.device_engine = j._ac.device_engine = "batched2"
    inner = p._ac if kind == "ShortestMatch" else p
    assert inner._force() == "rowdfa2"
    before = dict(krow.launches)
    got, want = p.match_triples(text), j.match_triples(text)
    assert krow.launches == before  # CPU tensors: the twins
    assert dispatch.planes_plan(inner.compiled, inner.dev, inner._force()).which == "rowdfa2"
    assert len(got[0]) > 20
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert p.count(text) == j.count(text) == len(got[0])
    assert p.match(text) == j.match(text)
