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
    else:
        raise KeyError(name)
    units = np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)
    return m, m.charmap[units], chunk


def _port_scan(m, cls, chunk):
    pd = port_matchers._DeviceTables(carry(m), "cpu").packed_dfa
    w = port_sb.chunk_classes(cls, chunk, pd.halo, m.num_classes)
    if w.dtype == np.uint16:
        wt = torch.from_numpy(w.view(np.int16)).view(torch.uint16)
    else:
        wt = torch.from_numpy(w)
    count = int(scan_block.packed_scan_count(pd.table, wt, pd.halo, pd.state_bits))
    planes = scan_block.packed_scan_planes(pd.table, wt, pd.halo, pd.state_bits)
    return count, planes.numpy(), w.shape


def _jax_scan(engine, m, cls, chunk):
    dev = jax_matchers._DeviceTables(m)
    if engine == "block":
        bd = dev.block_dfa
        w = jax_sb.chunk_classes(cls, chunk, bd.halo)
        W = w.shape[1]
        wt = jnp.asarray(jax_block.regroup_windows(w))
        G = wt.shape[0] // (W * 8)
        args = (bd.table, wt, bd.halo, bd.state_bits, bd.num_classes, bd.num_blocks, W, G)
        return int(jax_block.block_count(*args)), np.asarray(jax_block.block_emit_planes(*args))
    if engine == "rowdfa1":
        rd = dev.row_dfa1
        w = jnp.asarray(jax_sb.chunk_classes(cls, chunk, rd.halo))
        args = (rd.table, w, rd.halo, rd.state_bits, rd.num_classes)
        return int(scan_rowdfa.rowdfa1_count(*args)), np.asarray(scan_rowdfa.rowdfa1_emit_planes(*args))
    pd = dev.packed_dfa
    w = jnp.asarray(jax_sb.chunk_classes(cls, chunk, pd.halo))
    count = int(jax_sb.batched_count(pd.table, w, pd.halo, pd.state_bits))
    planes = np.asarray(jax_sb.batched_emit_planes(pd.table, w, pd.halo, pd.state_bits, 1))
    return count, planes


@pytest.mark.parametrize(
    "name, engine",
    [(name, engine)
     for name in ("demo", "halo_gt_chunk", "wide", "quotient")
     for engine in ("block", "rowdfa1", "batched")
     # The block kernel's interpret mode unrolls S*A/128 lookup rounds: the
     # wide table's ~1,400 rounds take minutes on the CPU.
     if (name, engine) != ("wide", "block")],
)
def test_twins_equal_jax_scans(name, engine):
    m, cls, chunk = _case(name)
    if engine == "block" and not jax_block.fits(m):
        pytest.fail(f"{name} must fit the block kernel")
    count, planes, (B, W) = _port_scan(m, cls, chunk)
    want_count, want_planes = _jax_scan(engine, m, cls, chunk)
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
