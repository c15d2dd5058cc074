"""The compaction and shortest-scan kernels' plain twins vs the JAX device
loops they replace: ``ops/scan_batched._compact_planes`` and
``ops/scan_dfa.shortest_states``, run on the CPU.  Positions, masks and
states are integers, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.models import matchers as jax_matchers
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu.ops import scan_dfa as jax_scan_dfa
from ahocorasick_tpu.ops import scan_pfac
from ahocorasick_tpu_torch.kernels import compact, scan_dfa
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from ahocorasick_tpu_torch.ops import scan_dfa as port_ops_dfa
from test_torch_host import carry


def _planes(name):
    """(uint32[P, N] planes, text length n) from a seed."""
    rng = np.random.default_rng(len(name))
    if name == "p1_sparse":
        bits = np.where(rng.random((1, 5000)) < 0.03,
                        rng.integers(1, 1 << 32, size=(1, 5000), dtype=np.uint64), 0)
        return bits.astype(np.uint32), 5000
    if name == "p2_sparse":  # some positions hot in plane 1 only
        bits = np.zeros((2, 4099), dtype=np.uint32)
        for p in range(2):
            hot = rng.choice(4099, size=150, replace=False)
            bits[p, hot] = rng.integers(1, 1 << 32, size=150, dtype=np.uint64).astype(np.uint32)
        return bits, 4099
    if name == "empty":
        return np.zeros((1, 3000), dtype=np.uint32), 3000
    if name == "all_hot":
        return rng.integers(1, 1 << 32, size=(2, 2049), dtype=np.uint64).astype(np.uint32), 2049
    if name == "tail_padded":  # window padding past n: zero planes
        bits = np.zeros((1, 4096), dtype=np.uint32)
        bits[0, [0, 7, 2047, 2048, 3999]] = [1, 0x80000000, 3, 4, 5]
        return bits, 4000
    raise KeyError(name)


def _tensor(bits):
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int32)).view(torch.uint32)


def _u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("name", ["p1_sparse", "p2_sparse", "empty", "all_hot", "tail_padded"])
def test_compaction_twin_equals_jax(name):
    bits, _ = _planes(name)
    P, N = bits.shape
    count, idx, masks = compact.compact_planes(_tensor(bits))
    want_cnt, want_idx, want_masks = jax_sb._compact_planes(jnp.asarray(bits), cap=N)
    k = int(want_cnt)
    assert int(count) == k == len(idx) and masks.shape == (k, P)
    assert idx.dtype == torch.int64 and masks.dtype == torch.uint32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx)[:k])
    np.testing.assert_array_equal(_u32(masks), np.asarray(want_masks)[:k])
    assert np.all(np.diff(idx.numpy()) > 0)


@pytest.mark.parametrize("name", ["p1_sparse", "p2_sparse", "tail_padded"])
def test_planes_to_sparse_equals_jax(monkeypatch, name):
    bits, n = _planes(name)
    for mod in (port_sb, jax_sb):
        monkeypatch.setattr(mod, "_SPARSE_ON_CPU", True)
        monkeypatch.setattr(mod, "_SPARSE_MIN_UNITS", 16)
    idx, masks = port_sb.planes_to_sparse(_tensor(bits), n)
    want_idx, want_masks = jax_sb.planes_to_sparse(jnp.asarray(bits), n)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(masks, want_masks)
    assert idx.max() < n


def test_compaction_limit_means_dense_download():
    bits, _ = _planes("p1_sparse")
    count, _, _ = compact.compact_planes(_tensor(bits))
    k = int(count)
    assert compact.compact_planes(_tensor(bits), limit=k - 1) is None
    assert int(compact.compact_planes(_tensor(bits), limit=k)[0]) == k


@pytest.mark.parametrize("bad", ["int32", "one_dim", "strided", "no_planes"])
def test_compaction_rejects_what_the_kernel_does_not_take(bad):
    t = _tensor(_planes("p2_sparse")[0])
    t = {"int32": t.view(torch.int32), "one_dim": t[0], "strided": t[:, ::2],
         "no_planes": t[:0]}[bad]
    with pytest.raises((TypeError, ValueError)):
        compact.compact_planes(t)


def test_cpu_tensors_take_the_twins_not_the_kernels():
    before = dict(launches)
    compact.compact_planes(_tensor(_planes("p1_sparse")[0]))
    m = compile_matcher(["ab", "b"], "shortest", True)
    dev = port_matchers._DeviceTables(carry(m), torch.device("cpu"))
    scan_dfa.shortest_states(dev.dfa_next, dev.match_len, torch.tensor([1, 2, 0], dtype=torch.uint8))
    assert launches == before


def _shortest_case(name):
    rng = np.random.default_rng(len(name) + 3)
    if name == "wide":  # > 256 classes: uint16 classes
        kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
        text = "".join(rng.choice(kws + ["x", chr(0x1FF)], size=400))
    else:
        alphabet = "abcd" if name == "fuzz" else "ab"
        kws = sorted({"".join(rng.choice(list(alphabet), size=int(rng.integers(1, 6))))
                      for _ in range(20)})
        text = "".join(rng.choice(list(alphabet + " "), size=700))
    m = compile_matcher(kws, "shortest", True)
    units = np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)
    return m, m.charmap[units]


@pytest.mark.parametrize("name", ["fuzz", "binary", "wide"])
def test_shortest_states_twin_equals_jax(name):
    m, cls = _shortest_case(name)
    jdev = jax_matchers._DeviceTables(m)
    pdev = port_matchers._DeviceTables(carry(m), torch.device("cpu"))
    # The padded tables are the JAX package's, byte for byte.
    np.testing.assert_array_equal(pdev.dfa_next.numpy(), np.asarray(jdev.dfa_next))
    np.testing.assert_array_equal(pdev.match_len.numpy(), np.asarray(jdev.match_len))
    cls_p = port_ops_dfa.pad_classes(cls, 0)
    want = np.asarray(jax_scan_dfa.shortest_states(
        jdev.dfa_next, jdev.match_len, jnp.asarray(cls_p.astype(np.int32))))
    narrow = port_sb.classes_to_device(cls_p, m.num_classes, "cpu")
    assert narrow.dtype == (torch.uint16 if name == "wide" else torch.uint8)
    for c in (narrow, torch.from_numpy(cls_p.astype(np.int32))):
        got = scan_dfa.shortest_states(pdev.dfa_next, pdev.match_len, c)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert (m.match_len[want] > 0).sum() > 10  # the restart branch is taken


@pytest.mark.parametrize("n, max_depth, bucket", [(0, 0, 1), (5, 3, 1), (100, 0, 64), (4096, 7, 4096)])
def test_pad_classes_equals_jax(n, max_depth, bucket):
    cls = np.arange(n, dtype=np.int32) % 5 + 1
    got = port_ops_dfa.pad_classes(cls, max_depth, bucket=bucket)
    want = scan_pfac.pad_classes(cls, max_depth, bucket=bucket)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", ["int64_table", "short_match_len", "int64_classes", "two_dim_classes"])
def test_shortest_states_rejects_what_the_kernel_does_not_take(bad):
    m, cls = _shortest_case("fuzz")
    dev = port_matchers._DeviceTables(carry(m), torch.device("cpu"))
    table, lens = dev.dfa_next, dev.match_len
    c = torch.from_numpy(cls.astype(np.int32))
    if bad == "int64_table":
        table = table.to(torch.int64)
    elif bad == "short_match_len":
        lens = lens[:-1]
    elif bad == "int64_classes":
        c = c.to(torch.int64)
    else:
        c = c.reshape(1, -1)
    with pytest.raises((TypeError, ValueError)):
        scan_dfa.shortest_states(table, lens, c)
