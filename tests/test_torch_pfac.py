"""The PFAC cross-check engine (``device_engine="pfac2"``): the port's ranked
tables, its walk's plain twins and every AC-family class under the knob,
against the JAX package's ``ops/scan_pfac2.py`` / ``ops/scan_pfac.py`` and gold.

The cases of ``tests/test_pfac2.py`` go through both packages: the JAX
walks (XLA on the CPU, ``bitplanes_both``) and the port's
``kernels/scan_pfac`` twins, which the wrappers run for CPU tensors.  Tables,
planes and counts are integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ahocorasick_tpu as jax_pkg
import ahocorasick_tpu_torch as port
from ahocorasick_tpu.core.compiler import compile_matcher as jax_compile
from ahocorasick_tpu.ops import scan_pfac2 as jax_pfac2
from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_pfac, scan_pfac2
from test_pfac2 import bitplanes_both
from test_torch_host import carry

CASES = [
    (["he", "she", "his", "hers"], "ushers and heshe"),
    (["a"], "aaaa"),
    (["a", "aa", "aaa", "aaaa"], "aaaaab"),
    (["abc"], "ab"),  # keyword longer than text
    (["x"], ""),  # empty text
    (["ab", "abcdefgh", "bcd"], "xxabcdefghxx"),
]


def _tensor(a):
    a = np.array(a)  # a writable copy
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(a)


def _port_planes(keywords, text, depth=None):
    """The port's v1 and v2 walks on its own tables (ranked, padded as the
    JAX package pads them) and on the JAX package's padded v1 tables."""
    ref = jax_compile(keywords, "ac", True)
    m = carry(ref)
    dev = port_matchers._DeviceTables(m, torch.device("cpu"))
    rt = dev.ranked
    cls = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    d = max(m.max_depth, 1) if depth is None else depth
    planes = (d + 31) // 32
    cls_p = _tensor(scan_pfac2.pad_classes(cls, d).astype(np.int32))
    v2 = scan_pfac2.pfac2_bitplanes(rt.trie_next, rt.prefix, rt.match_threshold, cls_p, d, planes,
                                    rt.prefix_k, m.num_classes, rt.dead_state)
    jdev = jax_pkg.models.matchers._DeviceTables(ref)
    trie = _tensor(np.asarray(jdev.trie_next))
    v1 = scan_pfac.pfac_bitplanes(trie, _tensor(np.asarray(jdev.is_match)), cls_p, d, planes,
                                  trie.shape[0] - 1)
    n = len(cls)
    return (v1.view(torch.int32).numpy().view(np.uint32)[:, :n],
            v2.view(torch.int32).numpy().view(np.uint32)[:, :n], m, rt, cls_p, d)


def _same_ranked(got, want):
    for f in ("prefix_k", "match_threshold", "num_states", "dead_state"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("trie_next", "prefix"):
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


@pytest.mark.parametrize("keywords,text", CASES)
def test_bitplanes_equal_jax_v1_and_v2(keywords, text):
    jv1, jv2, *_ = bitplanes_both(keywords, text)
    v1, v2, *_ = _port_planes(keywords, text)
    np.testing.assert_array_equal(v2, jv2)
    np.testing.assert_array_equal(v1, jv1)
    np.testing.assert_array_equal(v2, jv1)


def _fuzz(trial):
    rng = np.random.default_rng(3)
    alpha = "abcdef"
    for _ in range(trial + 1):
        kws = ["".join(rng.choice(list(alpha), size=int(rng.integers(1, 7))))
               for _ in range(int(rng.integers(1, 30)))]
        text = "".join(rng.choice(list(alpha + " "), size=int(rng.integers(0, 200))))
    return kws, text


@pytest.mark.parametrize("trial", range(15))
def test_bitplanes_fuzz(trial):
    """``tests/test_pfac2.py``'s fuzz dictionaries, one case per trial."""
    kws, text = _fuzz(trial)
    jv1, jv2, *_ = bitplanes_both(kws, text)
    v1, v2, *_ = _port_planes(kws, text)
    np.testing.assert_array_equal(v2, jv2, err_msg=str(kws))
    np.testing.assert_array_equal(v1, jv1, err_msg=str(kws))


def test_count_equals_jax_and_popcount():
    rng = np.random.default_rng(4)
    kws = ["ab", "ba", "aab", "b"]
    text = "".join(rng.choice(list("ab"), size=500))
    jv1, _, jm, _, jrt, jcls = bitplanes_both(kws, text)
    d = max(jm.max_depth, 1)
    want = int(jax_pfac2.pfac2_count(
        jrt.trie_next, jrt.prefix, jnp.uint32(jrt.match_threshold),
        jnp.asarray(jax_pfac2.pad_classes(jcls, d).astype(np.int32)), d, jrt.prefix_k,
        jm.num_classes))
    _, _, m, rt, cls_p, _ = _port_planes(kws, text)
    got = scan_pfac2.pfac2_count(rt.trie_next, rt.prefix, rt.match_threshold, cls_p, d,
                                 rt.prefix_k, m.num_classes, rt.dead_state)
    assert got.dtype == torch.int64
    assert int(got) == want == int(np.unpackbits(jv1.view(np.uint8)).sum())


@pytest.mark.parametrize("keywords,text", CASES + [_fuzz(4), _fuzz(9)])
def test_ranked_tables_byte_for_byte(keywords, text):
    ref = jax_compile(keywords, "ac", True)
    _same_ranked(scan_pfac2.build_ranked(carry(ref)), jax_pfac2.build_ranked(ref))
    # The device layout: padded to (S_pad, A_pad) with the dead state.
    got = port_matchers._DeviceTables(carry(ref), torch.device("cpu")).ranked
    want = jax_pkg.models.matchers._DeviceTables(ref).ranked
    _same_ranked(got._replace(trie_next=got.trie_next.view(torch.int32).numpy().view(np.uint32),
                              prefix=got.prefix.view(torch.int32).numpy().view(np.uint32)), want)


def _big_alphabet(n_chars, seed):
    rng = np.random.default_rng(seed)
    chars = [chr(0x4E00 + i) for i in range(n_chars)]  # every one a class of its own
    kws = sorted(set(chars) | {"".join(rng.choice(chars, size=int(rng.integers(2, 4))))
                               for _ in range(300)})
    text = "".join(rng.choice(chars + [" "], size=600))
    return kws, text


@pytest.mark.parametrize("n_chars, k", [(1100, 1), (150, 2)])
def test_prefix_k_from_large_alphabets(n_chars, k):
    kws, text = _big_alphabet(n_chars, n_chars)
    jv1, jv2, _, _, jrt, _ = bitplanes_both(kws, text)
    v1, v2, _, rt, *_ = _port_planes(kws, text)
    assert rt.prefix_k == jrt.prefix_k == k
    np.testing.assert_array_equal(v2, jv2)
    np.testing.assert_array_equal(v1, jv1)
    assert jv1.any()


def test_max_depth_equal_to_prefix_k():
    """The walk at depth == prefix_k (the guard's edge) is the prefix lookup
    alone; below it the port raises as the JAX package asserts."""
    kws, text = ["ab", "b", "ba"], "abbab ba ab" * 5
    ref = jax_compile(kws, "ac", True)
    jrt = jax_pkg.models.matchers._DeviceTables(ref).ranked
    cls = ref.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    k = jrt.prefix_k
    assert k == ref.max_depth == 2
    want = np.asarray(jax_pfac2.pfac2_bitplanes(
        jrt.trie_next, jrt.prefix, jnp.uint32(jrt.match_threshold),
        jnp.asarray(jax_pfac2.pad_classes(cls, k).astype(np.int32)), k, 1, k, ref.num_classes))
    _, got, m, rt, cls_p, _ = _port_planes(kws, text, depth=k)
    np.testing.assert_array_equal(got, want[:, : len(cls)])
    assert got.any()
    with pytest.raises(ValueError, match="prefix_k"):
        scan_pfac2.pfac2_bitplanes(rt.trie_next, rt.prefix, rt.match_threshold, cls_p[:-1], k - 1,
                                   1, k, m.num_classes, rt.dead_state)
    with pytest.raises(AssertionError):
        jax_pfac2.pfac2_bitplanes(
            jrt.trie_next, jrt.prefix, jnp.uint32(jrt.match_threshold),
            jnp.asarray(jax_pfac2.pad_classes(cls, k - 1).astype(np.int32)), k - 1, 1, k,
            ref.num_classes)


@pytest.mark.parametrize("text", ["xxabcdefg", "abcdefgh" * 3 + "abcdefg", "bcd"])
def test_pad_class_tails(text):
    """Walks that run off the text's end into PAD_CLASS die without a bit."""
    kws = ["ab", "abcdefgh", "bcd", "cdefghij"]
    jv1, jv2, *_ = bitplanes_both(kws, text)
    v1, v2, *_ = _port_planes(kws, text)
    np.testing.assert_array_equal(v2, jv2)
    np.testing.assert_array_equal(v1, jv1)


_KINDS = [(k, is_map) for k in ("AhoCorasick", "LongestMatch", "WholeWordMatch", "ShortestMatch")
          for is_map in (False, True)]


@pytest.mark.parametrize("kind, is_map", _KINDS,
                         ids=[k + ("Map" if m else "Set") for k, m in _KINDS])
def test_pfac2_engine_equals_jax_and_gold(kind, is_map, monkeypatch):
    rng = np.random.default_rng(12)
    kws = sorted({"".join(rng.choice(list("abc"), size=int(rng.integers(1, 6))))
                  for _ in range(14)})
    text = "".join(rng.choice(list("abc "), size=900))
    name = kind + ("Map" if is_map else "Set")
    args = (kws, [f"v{i}" for i in range(len(kws))]) if is_map else (kws,)
    p = getattr(port, name)(*args, engine="device", device="cpu")
    j = getattr(jax_pkg, name)(*args, engine="device")
    p.device_engine = j.device_engine = "pfac2"
    if kind == "ShortestMatch":  # the knob of the internal AC matcher
        p._ac.device_engine = j._ac.device_engine = "pfac2"
    walks = []
    real = scan_pfac2.pfac2_bitplanes
    monkeypatch.setattr(scan_pfac2, "pfac2_bitplanes",
                        lambda *a, **k: walks.append(1) or real(*a, **k))
    before = dict(build.launches)
    got, want = p.match_triples(text), j.match_triples(text)
    assert walks and build.launches == before  # CPU tensors: the walk's twin
    assert len(got[0]) > 20
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    gold_m = getattr(jax_pkg, name)(*args, engine="gold")
    assert p.match(text) == j.match(text) == gold_m.match(text)
    assert p.count(text) == j.count(text) == len(got[0])
