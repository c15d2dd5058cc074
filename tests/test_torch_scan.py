"""The packed-scan kernels' plain twins vs the JAX scans they replace.

Same windows through the port's ``packed_scan_count`` / ``packed_scan_planes``
(on CPU tensors the wrapper runs the plain twin) and through the JAX
package's Pallas block kernel (interpret mode on the CPU, as in
``tests/test_block.py``), its stride-1 row-gather scan and its batched scan.
Counts and bits are integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.kernels import scan_block as jax_block
from ahocorasick_tpu.models import matchers as jax_matchers
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu.ops import scan_rowdfa
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from test_torch_host import carry

DEMO = [
    "he", "she", "his", "hers", "the", "then", "them", "there",
    "and", "hand", "sand", "stand", "standard", "art", "start",
    "ten", "tent", "intent", "content", "entropy",
]


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


def _case(name):
    """(compiled matcher, class ids, chunk) from a seed."""
    rng = np.random.default_rng(len(name))
    if name == "demo":  # 20 keywords; B = 24 windows, far from 1024
        m = compile_matcher(DEMO, "ac", True)
        words = list(rng.choice(DEMO + ["xq", "zz", "standing"], size=300))
        text = " ".join(words)[:1500]
        chunk = 64
    elif name == "halo_gt_chunk":  # halo 11 > chunk 4
        m = compile_matcher(["abcabcabcab", "bca", "cab", "a", "cc"], "ac", True)
        text = "".join(rng.choice(list("abc "), size=301))
        chunk = 4
    elif name == "wide":  # 300 classes: uint16 windows
        kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
        m = compile_matcher(kws, "ac", True)
        text = "".join(chr(0x100 + int(c)) for c in rng.integers(0, 300, size=700))
        chunk = 32
    elif name == "quotient":  # row-compressed: the quotient DFA scans
        kws = sorted({"".join(rng.choice(list("abcd"), size=int(rng.integers(1, 5))))
                      for _ in range(25)})
        m = compile_matcher(kws, "ac", True, thresholder=_NeverDense())
        assert m.is_row_compressed
        text = "".join(rng.choice(list("abcd "), size=500))
        chunk = 16
    elif name == "straddle":  # depth-9 keyword across every segment boundary
        kw = "abcdefghi"
        m = compile_matcher([kw, "bcd", "hia", "ia", "x"], "ac", True)
        chunk, seg = 144, 36  # K = 4 segments of 36
        text = list(rng.choice(list("xyz"), size=(len(kw) + 1) * chunk))
        for w in range(len(kw) + 1):  # window w: the keyword starts w before each boundary
            for k in range(1, 4):
                at = w * chunk + k * seg - w
                text[at: at + len(kw)] = kw
        text = "".join(text)
    elif name == "wide_segments":  # 300 classes (uint16 windows), K = 4
        kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
        m = compile_matcher(kws, "ac", True)
        text = "".join(chr(0x100 + int(c)) for c in rng.integers(0, 300, size=700))
        chunk = 128
    elif name == "few_windows":  # B = 3 windows: few lanes, K up to 4 by the caps
        kws = sorted({"".join(rng.choice(list("abcd"), size=int(rng.integers(1, 7))))
                      for _ in range(30)})
        m = compile_matcher(kws, "ac", True)
        text = "".join(rng.choice(list("abcd "), size=1300))
        chunk = 512
    elif name in ("short_chunk", "ragged", "halo0"):  # C < 128; C % K != 0; halo 0
        kws = sorted({"".join(rng.choice(list("abcd"), size=int(rng.integers(1, 7))))
                      for _ in range(30)})
        m = compile_matcher(kws, "ac", True)
        text = "".join(rng.choice(list("abcd "), size=900))
        chunk = {"short_chunk": 100, "ragged": 127, "halo0": 128}[name]
    elif name == "deep12":  # ["a" * i for i in 1..12]: halo 12, K = 4 at C = 512
        m = compile_matcher(["a" * i for i in range(1, 13)] + ["ab", "ba"], "ac", True)
        runs = rng.integers(1, 30, size=200)
        text = "".join(("a" * int(r)) + str(rng.choice(list("b c"))) for r in runs)[:1900]
        chunk = 512
    else:
        raise KeyError(name)
    units = np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)
    return m, m.charmap[units], chunk


# The planes kernel's lanes per window (``scan_block.segments``) in each
# case: the segmented cases must split, halo 0 must not.
_SEGMENTS = {"demo": 2, "straddle": 4, "wide_segments": 4, "short_chunk": 2, "ragged": 4,
             "halo0": 1, "deep12": 4}
_HALO = {"halo0": 0}  # cases scanned with a halo other than the table's


def _port_scan(m, cls, chunk, halo=None):
    pd = port_matchers._DeviceTables(carry(m), "cpu").packed_dfa
    halo = pd.halo if halo is None else halo
    w = port_sb.chunk_classes(cls, chunk, halo, m.num_classes)
    if w.dtype == np.uint16:
        wt = torch.from_numpy(w.view(np.int16)).view(torch.uint16)
    else:
        wt = torch.from_numpy(w)
    count = int(scan_block.packed_scan_count(pd.table, wt, halo, pd.state_bits))
    planes = scan_block.packed_scan_planes(pd.table, wt, halo, pd.state_bits)
    return count, planes.numpy(), w.shape


def _jax_scan(engine, m, cls, chunk, halo=None):
    dev = jax_matchers._DeviceTables(m)
    if engine == "block":
        bd = dev.block_dfa
        halo = bd.halo if halo is None else halo
        w = jax_sb.chunk_classes(cls, chunk, halo)
        W = w.shape[1]
        wt = jnp.asarray(jax_block.regroup_windows(w))
        G = wt.shape[0] // (W * 8)
        args = (bd.table, wt, halo, bd.state_bits, bd.num_classes, bd.num_blocks, W, G)
        return int(jax_block.block_count(*args)), np.asarray(jax_block.block_emit_planes(*args))
    if engine == "rowdfa1":
        rd = dev.row_dfa1
        halo = rd.halo if halo is None else halo
        w = jnp.asarray(jax_sb.chunk_classes(cls, chunk, halo))
        args = (rd.table, w, halo, rd.state_bits, rd.num_classes)
        return int(scan_rowdfa.rowdfa1_count(*args)), np.asarray(scan_rowdfa.rowdfa1_emit_planes(*args))
    pd = dev.packed_dfa
    halo = pd.halo if halo is None else halo
    w = jnp.asarray(jax_sb.chunk_classes(cls, chunk, halo))
    count = int(jax_sb.batched_count(pd.table, w, halo, pd.state_bits))
    planes = np.asarray(jax_sb.batched_emit_planes(pd.table, w, halo, pd.state_bits, 1))
    return count, planes


@pytest.mark.parametrize(
    "name, engine",
    [(name, engine)
     for name in ("demo", "halo_gt_chunk", "wide", "quotient", "straddle", "wide_segments",
                  "short_chunk", "ragged", "halo0", "deep12")
     for engine in ("block", "rowdfa1", "batched")
     # The block kernel's interpret mode unrolls S*A/128 lookup rounds: the
     # wide table's ~1,400 rounds take minutes on the CPU.
     if (name, engine) not in (("wide", "block"), ("wide_segments", "block"))],
)
def test_twins_equal_jax_scans(name, engine):
    m, cls, chunk = _case(name)
    if engine == "block" and not jax_block.fits(m):
        pytest.fail(f"{name} must fit the block kernel")
    halo = _HALO.get(name)
    count, planes, (B, W) = _port_scan(m, cls, chunk, halo)
    want_count, want_planes = _jax_scan(engine, m, cls, chunk, halo)
    if name in _SEGMENTS:  # the twin takes the kernel's lane decomposition
        assert scan_block.segments(B, chunk, W - chunk)[0] == _SEGMENTS[name]
    assert planes.dtype == np.uint32 and planes.shape == (1, B * chunk)
    assert count == want_count > 0
    # The block kernel pads lanes to a multiple of 1024 windows; they trail
    # the text and never emit, so trim to the port's B*C.
    np.testing.assert_array_equal(planes, want_planes[:, : planes.shape[1]])
    assert not want_planes[:, planes.shape[1]:].any()
    assert int(np.bitwise_count(planes).sum()) == count


def test_cpu_tensors_take_the_twin_not_the_kernel():
    m, cls, chunk = _case("demo")
    before = dict(scan_block.launches)
    count, planes, _ = _port_scan(m, cls, chunk)
    assert scan_block.launches == before
    pd = port_matchers._DeviceTables(carry(m), "cpu").packed_dfa
    w = torch.from_numpy(port_sb.chunk_classes(cls, chunk, pd.halo, m.num_classes))
    assert int(scan_block.packed_scan_count_plain(pd.table, w, pd.halo, pd.state_bits)) == count
    np.testing.assert_array_equal(
        scan_block.packed_scan_planes_plain(pd.table, w, pd.halo, pd.state_bits).numpy(), planes)


@pytest.mark.parametrize("bad", ["int32_windows", "int32_table", "halo_ge_width",
                                 "strided_windows", "state_bits_too_small"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    m, cls, chunk = _case("demo")
    pd = port_matchers._DeviceTables(carry(m), "cpu").packed_dfa
    table, halo, state_bits = pd.table, pd.halo, pd.state_bits
    w = torch.from_numpy(port_sb.chunk_classes(cls, chunk, halo, m.num_classes))
    if bad == "int32_windows":
        w = w.to(torch.int32)
    elif bad == "int32_table":
        table = table.view(torch.int32)
    elif bad == "halo_ge_width":
        halo = w.shape[1]
    elif bad == "strided_windows":
        w = w[:, ::2]
    elif bad == "state_bits_too_small":
        state_bits = 1
    for fn in (scan_block.packed_scan_count, scan_block.packed_scan_planes):
        with pytest.raises((TypeError, ValueError)):
            fn(table, w, halo, state_bits)


@pytest.mark.parametrize("num_windows, body, halo, want", [
    (65_536, 512, 12, (1, 512)),  # the main path: one lane per window
    (32_768, 512, 12, (2, 256)),  # two lanes per window keep 65,536 lanes
    (8_192, 512, 12, (4, 128)),
    (8, 514, 12, (4, 132)),  # C not a multiple of K: the last lane takes 118
    (8, 127, 8, (4, 32)),  # the last lane takes 31
    (8, 100, 3, (2, 52)),  # C < 128: four lanes would be under one 32-step tile
    (8, 64, 12, (1, 64)),  # segments under four halos
    (8, 512, 0, (1, 512)),  # halo 0: nothing synchronizes
])
def test_planes_segments_rule(num_windows, body, halo, want):
    K, L = scan_block.segments(num_windows, body, halo)
    assert (K, L) == want
    assert num_windows * K <= max(scan_block.MAX_LANES, num_windows)
    assert (K - 1) * L < body <= K * L and (K == 1 or L % 4 == 0)


@pytest.mark.parametrize("num_windows, body, halo, want", [
    (65_536, 512, 12, (2, 256)),  # the main path: two lanes per window
    (131_072, 512, 12, (1, 512)),
    (32_768, 512, 12, (4, 128)),  # four lanes per window keep 131,072 lanes
    (8_192, 512, 12, (4, 128)),
    (8, 514, 12, (4, 132)),
    (8, 100, 3, (2, 52)),  # C < 128: four lanes would be under 32 steps
    (8, 64, 12, (1, 64)),  # segments under four halos
    (8, 512, 0, (1, 512)),  # halo 0: nothing synchronizes
])
def test_count_segments_rule(num_windows, body, halo, want):
    K, L = scan_block.segments(num_windows, body, halo, scan_block.COUNT_MAX_LANES)
    assert (K, L) == want
    assert num_windows * K <= max(scan_block.COUNT_MAX_LANES, num_windows)
    assert (K - 1) * L < body <= K * L and (K == 1 or L % 4 == 0)


# The count's lanes per window under caps of B, 2B and 4B lanes: every K that
# the segments allow at these windows.
_COUNT_KS = {"ragged": {1, 2, 4}, "halo0": {1}, "wide_segments": {1, 2, 4},
             "short_chunk": {1, 2}, "wide": {1}, "few_windows": {1, 2, 4}}


@pytest.mark.parametrize(
    "name, engine",
    [(name, engine) for name in _COUNT_KS for engine in ("block", "rowdfa1", "batched")
     if (name, engine) not in (("wide", "block"), ("wide_segments", "block"))],
)
def test_count_twin_in_lane_decomposition_equals_jax(name, engine, monkeypatch):
    """The count twin takes the kernel's K lanes per window (each warmed over
    the halo before its segment, the last one's padding counting nothing):
    at K = 1, 2 and 4 on the same windows it equals the JAX count."""
    m, cls, chunk = _case(name)
    halo = _HALO.get(name)
    want, _ = _jax_scan(engine, m, cls, chunk, halo)
    pd = port_matchers._DeviceTables(carry(m), "cpu").packed_dfa
    halo = pd.halo if halo is None else halo
    w = port_sb.classes_to_device(port_sb.chunk_classes(cls, chunk, halo, m.num_classes),
                                  m.num_classes, "cpu")
    B, C = w.shape[0], w.shape[1] - halo
    ks = set()
    for cap in (B, 2 * B, 4 * B):
        monkeypatch.setattr(scan_block, "COUNT_MAX_LANES", cap)
        ks.add(scan_block.segments(B, C, halo, cap)[0])
        assert int(scan_block.packed_scan_count(pd.table, w, halo, pd.state_bits)) == want > 0
    assert ks == _COUNT_KS[name]
