"""Port tables vs the JAX package's: packed tables, padded device tables and
chunk windows must be byte-identical (values and dtype)."""

import numpy as np
import pytest
import torch

from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.models import matchers as jax_matchers
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from test_torch_host import carry


class _NeverDense:
    def is_over_threshold(self, size, lo, hi):
        return False


def _fuzz_keywords(seed, alphabet, n, max_len):
    rng = np.random.default_rng(seed)
    return sorted({
        "".join(rng.choice(list(alphabet), size=int(rng.integers(1, max_len + 1))))
        for _ in range(n)
    })


def _dictionary(name):
    if name == "dense":
        return compile_matcher(_fuzz_keywords(3, "abcde", 60, 7), "ac", True)
    if name == "dense_folded":
        return compile_matcher(_fuzz_keywords(4, "aBcDe", 40, 6), "ac", False)
    if name == "quotient":
        m = compile_matcher(_fuzz_keywords(5, "abcd", 30, 5), "ac", True,
                            thresholder=_NeverDense())
        assert m.is_row_compressed
        return m
    if name == "wide":  # > 256 classes: uint16 windows
        kws = [chr(0x100 + i) + chr(0x100 + (7 * i) % 300) for i in range(300)]
        m = compile_matcher(kws, "ac", True)
        assert m.num_classes > 256
        return m
    if name == "split":  # emit masks overflow the packed-inline layout
        return compile_matcher(["a" * i for i in range(1, 40)] + ["the"], "ac", True)
    raise KeyError(name)


PACKED = ["dense", "dense_folded", "quotient", "wide"]


@pytest.mark.parametrize("name", PACKED + ["split"])
def test_build_packed_identical(name):
    m = _dictionary(name)
    want = jax_sb.build_packed(m)
    got = port_sb.build_packed(carry(m))
    assert got.table.dtype == want.table.dtype == np.uint32
    np.testing.assert_array_equal(got.table, want.table)
    assert (got.state_bits, got.halo) == (want.state_bits, want.halo)
    if want.emit_mask is None:
        assert got.emit_mask is None
    else:
        np.testing.assert_array_equal(got.emit_mask, want.emit_mask)


@pytest.mark.parametrize("name", PACKED + ["split"])
def test_inline_packable_agrees(name):
    m = _dictionary(name)
    assert port_sb.inline_packable(carry(m)) == jax_sb.inline_packable(m)
    assert port_sb.quotient_packable(carry(m)) == jax_sb.quotient_packable(m)
    assert port_sb.effective_rows(carry(m)) == jax_sb.effective_rows(m)
    assert port_sb.inline_packable(carry(m)) == (name != "split")
    assert port_sb.count_packable(carry(m)) == jax_sb.count_packable(m) == (name != "quotient")
    assert port_sb.hotstate_layout(carry(m)) == jax_sb.hotstate_layout(m) == (name == "split")


@pytest.mark.parametrize("name", ["dense", "wide", "split"])
def test_build_count_packed_identical(name):
    m = _dictionary(name)
    got, want = port_sb.build_count_packed(carry(m)), jax_sb.build_count_packed(m)
    assert got[0].dtype == want[0].dtype == np.uint32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    table, state_bits, halo = convert.count_packed_from_numpy(*want, "cpu")
    assert table.dtype == torch.uint32 and (state_bits, halo) == want[1:]
    np.testing.assert_array_equal(table.view(torch.int32).numpy().view(np.uint32), want[0])


@pytest.mark.parametrize("name", PACKED)
def test_padded_packed_dfa_identical(name):
    m = _dictionary(name)
    want = jax_matchers._DeviceTables(m).packed_dfa
    got = port_matchers._DeviceTables(carry(m), "cpu").packed_dfa
    assert got.table.dtype == torch.uint32
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    assert (got.state_bits, got.halo) == (want.state_bits, want.halo)
    # The JAX package's tables carry across unchanged, padded or not.
    for host in (np.asarray(want.table), jax_sb.build_packed(m).table):
        pd = convert.packed_from_numpy(host, want.state_bits, want.halo,
                                       m.num_classes, "cpu")
        np.testing.assert_array_equal(pd.table.numpy(), np.asarray(want.table))


@pytest.mark.parametrize(
    "n, chunk, halo, num_classes",
    [
        (0, 8, 3, 5),  # empty text: one all-PAD window
        (1000, 64, 7, 27),  # uint8, last chunk partial
        (50, 4, 11, 9),  # halo longer than the chunk
        (777, 16, 2, 300),  # uint16
        (512, 512, 12, None),  # int32 layout, exact fit
    ],
)
def test_chunk_classes_identical(n, chunk, halo, num_classes):
    rng = np.random.default_rng(n + chunk)
    cls = rng.integers(0, num_classes or 40, size=n).astype(np.int32)
    want = jax_sb.chunk_classes(cls, chunk, halo, num_classes)
    got = port_sb.chunk_classes(cls, chunk, halo, num_classes)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert port_sb.class_dtype(num_classes or 1) == jax_sb.class_dtype(num_classes or 1)
