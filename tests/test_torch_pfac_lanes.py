"""The PFAC v2 walk's edges (``kernels/scan_pfac.pfac2_planes`` /
``pfac2_count``, whose CUDA kernel is ``csrc/pfac_walk.cuh``): the port's
wrappers on CPU tensors (the plain twins) against the JAX package's
``ops/scan_pfac2.pfac2_bitplanes`` / ``pfac2_count`` and the port's v1 walk,
and the launch rule ``kernels.scan_pfac.launch_shape``.

The inputs are made from a seed with numpy; the JAX package compiles each
dictionary and ``test_torch_host.carry`` hands it to the port.  Planes and
counts are integers, so every comparison is exact.  The cases are the
kernel's edges: text lengths around a prefix pass (``32 * PER_LANE``
starts) and a warp's span, depths around the plane boundaries and equal to
``prefix_k``, every walk live to the full depth, every walk dead at once,
uint8 / uint16 / int32 classes, and alphabets whose prefix table does or
does not fit in shared memory.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ahocorasick_tpu as jax_pkg
from ahocorasick_tpu.core.compiler import compile_matcher as jax_compile
from ahocorasick_tpu.ops import scan_pfac2 as jax_pfac2
from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels import scan_pfac as kpf
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_pfac, scan_pfac2
from test_torch_host import carry

SEED = 2020
B = 32 * kpf.PER_LANE  # starts a warp's prefix pass takes
H100_SMS = 132


def _rng(*salt):
    return np.random.default_rng([SEED, *salt])


def _fuzz_dict(alphabet="abcdef", n=60, max_len=8, salt=0):
    rng = _rng(1, salt)
    return sorted({"".join(rng.choice(list(alphabet), size=int(rng.integers(1, max_len + 1))))
                   for _ in range(n)})


def _soup(n, alphabet="abcdefg ", salt=0):
    return "".join(_rng(2, salt, n).choice(list(alphabet), size=n))


def _classes(arr, dtype):
    """The padded classes as a CPU tensor of ``dtype`` (uint16 through an
    int16 view, the same bits)."""
    arr = np.ascontiguousarray(arr.astype(dtype))
    if dtype == "uint16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(arr)


@functools.lru_cache(maxsize=None)
def _compiled(keywords):
    ref = jax_compile(list(keywords), "ac", True)
    return ref, carry(ref)


@functools.lru_cache(maxsize=None)
def _jax_walk(keywords, text, depth):
    """The JAX package's v2 planes (trimmed to the text) and count."""
    ref, _ = _compiled(keywords)
    rt = jax_pkg.models.matchers._DeviceTables(ref).ranked
    cls = ref.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    cp = jnp.asarray(jax_pfac2.pad_classes(cls, depth).astype(np.int32))
    P = (depth + 31) // 32
    planes = np.asarray(jax_pfac2.pfac2_bitplanes(
        rt.trie_next, rt.prefix, jnp.uint32(rt.match_threshold), cp, depth, P, rt.prefix_k,
        ref.num_classes))
    count = int(jax_pfac2.pfac2_count(rt.trie_next, rt.prefix, jnp.uint32(rt.match_threshold),
                                      cp, depth, rt.prefix_k, ref.num_classes))
    return planes[:, : len(cls)], count


def _port_walk(keywords, text, depth, dtype):
    """The port's v2 planes and count through the wrappers, its v1 planes,
    the ranked tables."""
    _, m = _compiled(keywords)
    dev = port_matchers._DeviceTables(m, torch.device("cpu"))
    rt = dev.ranked
    cls = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    cp = _classes(scan_pfac.pad_classes(cls, depth), dtype)
    P = (depth + 31) // 32
    planes = kpf.pfac2_planes(rt.trie_next, rt.prefix, rt.match_threshold, cp, depth, P,
                              rt.prefix_k, m.num_classes, rt.dead_state)
    count = kpf.pfac2_count(rt.trie_next, rt.prefix, rt.match_threshold, cp, depth, rt.prefix_k,
                            m.num_classes, rt.dead_state)
    trie = dev.trie_next
    v1 = kpf.pfac1_planes(trie, dev.is_match, cp, depth, P, trie.shape[0] - 1)
    as_np = lambda t: t.view(torch.int32).numpy().view(np.uint32)
    n = len(cls)
    return as_np(planes)[:, :n], int(count), as_np(v1)[:, :n], rt, m


def _popcount(planes):
    return int(np.unpackbits(np.ascontiguousarray(planes).view(np.uint8)).sum())


def _check(keywords, text, depth=None, dtype="uint8"):
    keywords = tuple(keywords)
    _, m = _compiled(keywords)
    d = max(m.max_depth, 1) if depth is None else depth
    want, want_count = _jax_walk(keywords, text, d)
    got, count, v1, rt, _ = _port_walk(keywords, text, d, dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(v1, want)
    assert count == want_count == _popcount(got)
    return got, count, rt


FUZZ = tuple(_fuzz_dict())


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
@pytest.mark.parametrize("n", [B - 1, B, B + 1, B + 8])
def test_lengths_around_a_prefix_pass(n, dtype):
    """Text lengths around a warp's prefix pass (the bucketed depth of the
    fuzz dictionary is 8)."""
    _check(FUZZ, _soup(n), dtype=dtype)


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17])
def test_short_texts(n):
    """Fewer starts than a warp's span of 16."""
    _check(FUZZ, _soup(n, salt=3))


@pytest.mark.parametrize("offset", [-1, 0, 1, 8])
def test_lengths_around_a_warp_span(offset):
    """Around the span a warp takes when one SM holds the launch."""
    span = kpf.launch_shape(20_000, 1, 7 ** 3, 1).span
    _check(FUZZ, _soup(span + offset, salt=4))


@pytest.mark.parametrize("dtype", ["uint8", "int32"])
@pytest.mark.parametrize("depth", [31, 32, 33, 64, 65])
def test_every_walk_live_to_the_depth(depth, dtype):
    """``a`` * n against ``a``..``a``^depth: every walk goes to the full
    depth and crosses each plane boundary."""
    got, count, _ = _check(["a" * i for i in range(1, depth + 1)], "a" * 700, depth, dtype)
    assert count == sum(min(depth, 700 - i) for i in range(700))
    assert got.shape[0] == (depth + 31) // 32


@pytest.mark.parametrize("depth", [31, 33, 64, 65])
def test_deep_keywords_in_mixed_text(depth):
    kws = ["a" * i for i in range(1, depth + 1)] + list(FUZZ)
    _check(kws, _soup(1500, "aaaaaaab ", salt=depth), depth, "uint16")


@pytest.mark.parametrize("keywords,alphabet,depth", [
    (["ab", "b", "ba"], "ab", 2),
    (["abc", "ab", "c"], "abc", 3),
    (["x", "y"], "xyz", 1),
])
def test_depth_equal_to_prefix_k(keywords, alphabet, depth):
    """The walk ends at the prefix: no trie load at all."""
    _, _, rt = _check(keywords, _soup(600, alphabet, salt=depth), depth)
    assert rt.prefix_k == depth


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
def test_every_walk_dead_at_once(dtype):
    got, count, _ = _check(FUZZ, "zzzz " * 200, None, dtype)
    assert count == 0 and not got.any()


def _wide_dict(n_chars, salt):
    rng = _rng(5, salt)
    chars = [chr(0x4E00 + i) for i in range(n_chars)]
    kws = sorted(set(chars[:40]) | {"".join(rng.choice(chars, size=int(rng.integers(2, 5))))
                                    for _ in range(200)})
    text = "".join(rng.choice(chars + [" "], size=800))
    return kws, text


@pytest.mark.parametrize("n_chars,dtype", [(60, "uint8"), (300, "uint16"), (300, "int32")])
def test_class_widths(n_chars, dtype):
    """More than 256 classes take uint16 or int32 classes."""
    kws, text = _wide_dict(n_chars, n_chars)
    _, m = _compiled(tuple(kws))
    assert (m.num_classes > 256) == (n_chars > 256)
    _check(kws, text, None, dtype)


@pytest.mark.parametrize("case", range(6))
def test_count_is_the_planes_popcount(case):
    rng = _rng(6, case)
    kws = _fuzz_dict("abcd", 30, 6, salt=case)
    text = "".join(rng.choice(list("abcd "), size=int(rng.integers(200, 1200))))
    got, count, _ = _check(kws, text)
    assert count == _popcount(got)


# ---------------------------------------------------------------- launch rule

def test_shape_of_the_10k_cell():
    """The 10k dictionary (27 classes, k = 3) over 32 Mi lanes: one block of
    THREADS an SM, the 78.7 KB prefix table in shared memory, every SM."""
    sh = kpf.launch_shape(1 << 25, 1, 27 ** 3, H100_SMS)
    assert sh.prefix_shared and sh.blocks_per_sm == kpf.BLOCKS_PER_SM
    assert sh.grid == H100_SMS
    assert sh.smem == kpf._round16(4 * 27 ** 3) + (kpf.THREADS // 32) * kpf.warp_bytes(1, kpf.PER_LANE)
    assert sh.smem <= kpf.BLOCK_SMEM_MAX


@pytest.mark.parametrize("classes,k,shared", [
    (7, 3, True), (27, 3, True), (40, 3, False), (61, 3, False), (101, 3, False),
    (102, 2, True), (150, 2, True), (300, 2, False), (1100, 1, True)])
def test_prefix_placement(classes, k, shared):
    """The prefix table is staged where 4 A^k bytes fit beside the warps'
    areas in a block's share of an SM, else read with __ldg."""
    sh = kpf.launch_shape(1 << 20, 1 if classes <= 256 else 2, classes ** k, H100_SMS)
    assert sh.prefix_shared == shared


def test_prefix_placement_follows_the_budget(monkeypatch):
    monkeypatch.setattr(kpf, "SM_SMEM", 60_000)
    sh = kpf.launch_shape(1 << 20, 1, 7 ** 3, H100_SMS)
    assert not sh.prefix_shared and sh.smem == (kpf.THREADS // 32) * kpf.warp_bytes(1, kpf.PER_LANE)


@pytest.mark.parametrize("n", [1, 15, 16, 17, B, 9_999, 300_000, 1 << 25, (1 << 25) + 7])
@pytest.mark.parametrize("sms", [1, H100_SMS])
def test_spans_cover_the_starts(n, sms):
    """Spans are multiples of 16 starts, the grid's warps cover every start,
    no block is without one, and the grid fits the SMs at once."""
    sh = kpf.launch_shape(n, 1, 7 ** 3, sms)
    warps = kpf.THREADS // 32
    assert sh.span % 16 == 0 and sh.span >= 16
    assert sh.grid * warps * sh.span >= n > (sh.grid - 1) * warps * sh.span
    assert sh.grid <= sh.blocks_per_sm * sms


@pytest.mark.parametrize("threads,per_lane,blocks", [(1024, 4, 1), (512, 4, 2), (512, 8, 2),
                                                     (256, 4, 4)])
def test_other_widths(threads, per_lane, blocks):
    """The A/B's widths: the budget is an SM's share over the blocks."""
    sh = kpf.launch_shape(1 << 25, 1, 27 ** 3, H100_SMS, threads, per_lane, blocks)
    areas = threads // 32 * kpf.warp_bytes(1, per_lane)
    assert sh.smem == areas + (kpf._round16(4 * 27 ** 3) if sh.prefix_shared else 0)
    assert sh.prefix_shared == (kpf._round16(4 * 27 ** 3) + areas
                                <= kpf.SM_SMEM // blocks - kpf.BLOCK_SMEM_RESERVED)
    assert sh.blocks_per_sm <= blocks


@pytest.mark.parametrize("cls_bytes,per_lane,want", [(1, 8, 272 + 8 * 288), (2, 8, 528 + 8 * 288),
                                                     (4, 4, 528 + 8 * 160), (1, 4, 144 + 8 * 160)])
def test_warp_area(cls_bytes, per_lane, want):
    """pfac_walk.cuh's WarpArea: the stage of 32 * per_lane + 2 classes
    rounded to 16 bytes, and 8 bytes for each of 32 + 32 * per_lane queue
    slots."""
    assert kpf.warp_bytes(cls_bytes, per_lane) == want


def test_cpu_tensors_launch_nothing():
    build.reset_launches()
    _check(FUZZ, _soup(300, salt=9))
    assert build.launches["pfac2_planes"] == build.launches["pfac2_count"] == 0


def test_wrappers_refuse_a_depth_below_prefix_k():
    _, m = _compiled(("abc", "ab"))
    rt = port_matchers._DeviceTables(m, torch.device("cpu")).ranked
    cp = _classes(scan_pfac.pad_classes(np.zeros(10, dtype=np.int64), 2), "uint8")
    with pytest.raises(ValueError):
        kpf.pfac2_count(rt.trie_next, rt.prefix, rt.match_threshold, cp, 2, rt.prefix_k,
                        m.num_classes, rt.dead_state)
