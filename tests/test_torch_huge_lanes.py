"""The lane loops that the count and planes kernels share, through their plain
twins in the kernels' lane decompositions.

``csrc/tile.cuh`` ``count_lane`` runs the packed count and the count-packed
count, ``planes_lane`` the packed planes, the hotstate plane and the split
emit planes (P planes a step).  Each wrapper fixes K lanes per window
(``scan_block.segments`` under its own cap) and its twin scans the same
segments, each warmed over the halo before it, the last one's padding
masked.  The caps are patched so that a few windows take K = 1, 2 and 4.
The same windows go through the JAX package's loop; counts and planes are
integers, so every comparison is exact.  The packed count's twin at K = 1,
2 and 4 against the JAX block count is
``test_torch_scan.test_count_twin_in_lane_decomposition_equals_jax``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.models import matchers as jax_matchers
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.kernels import scan_batched as huge
from ahocorasick_tpu_torch.kernels import scan_block
from test_torch_huge import NAMES, _compiled, _text, _u32, _windows


def _ragged_chunk(halo: int, ragged: bool) -> int:
    """A body that K = 4 segments of at least four halos cover, a multiple of
    4 or 3 past one."""
    return 16 * halo + (3 if ragged else 8)


def _force_k(monkeypatch, cap_name: str, B: int, C: int, halo: int, K: int) -> None:
    monkeypatch.setattr(huge, cap_name, K * B)
    assert scan_block.segments(B, C, halo, getattr(huge, cap_name))[0] == K


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("ragged", [False, True], ids=["C%4==0", "C%4==3"])
@pytest.mark.parametrize("name", NAMES)
def test_packedcount_count_twin_in_lane_decomposition_equals_jax(name, ragged, K, monkeypatch):
    """The count-packed count twin (the count lane with the emit count as its
    value) at K lanes per window equals the JAX ``packedcount_count``, on
    uint8 windows and, for ``wide_deep``, uint16 ones."""
    m = _compiled(name)
    flat, state_bits, halo = jax_sb.build_count_packed(m)
    chunk = _ragged_chunk(halo, ragged)
    text = _text(name, 3 * chunk + 77, 0.4, seed=11)
    cls, w, wt = _windows(m, text, halo, chunk)
    assert wt.dtype == (torch.uint16 if name == "wide_deep" else torch.uint8)
    _force_k(monkeypatch, "PACKEDCOUNT_MAX_LANES", wt.shape[0], chunk, halo, K)
    table, _, _ = convert.count_packed_from_numpy(flat, state_bits, halo, "cpu")
    got = huge.packedcount_count(table, wt, halo, state_bits, m.num_classes)
    want = int(jax_sb.packedcount_count(jnp.asarray(flat), jnp.asarray(w), halo, state_bits,
                                        m.num_classes))
    assert got.dtype == torch.int64 and int(got) == want > 0


def _a_run_dictionary(depth: int):
    """``a``..``a * depth`` and a text of seeded runs of ``a`` up to a few
    past ``depth``, so that every plane of the split layout is hot."""
    m = compile_matcher(["a" * i for i in range(1, depth + 1)], "ac", True)
    rng = np.random.default_rng(depth)
    text = "".join("a" * int(r) + "b" for r in rng.integers(1, depth + 8, size=80))
    return m, text


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("ragged", [False, True], ids=["C%4==0", "C%4==3"])
@pytest.mark.parametrize("name", NAMES + ["a420"])
def test_split_planes_twin_in_lane_decomposition_equals_jax(name, ragged, K, monkeypatch):
    """The split planes twin (the planes lane with P values a step) at K lanes
    per window equals the JAX ``split_emit_planes`` bit for bit, for P = 2
    (``deep``, ``ab_long``), 4 (``a100``), 1 (``wide_deep``, uint16
    windows) and 14 (``a420``: more planes than a block of the kernel holds,
    two groups)."""
    if name == "a420":
        m, text = _a_run_dictionary(420)
    else:
        m, text = _compiled(name), None
    dfa_flat, emit_tab, halo = jax_matchers._DeviceTables(m).split_dfa
    P = emit_tab.shape[1]
    assert P == {"deep": 2, "a100": 4, "ab_long": 2, "wide_deep": 1, "a420": 14}[name]
    chunk = _ragged_chunk(halo, ragged)
    if text is None:
        text = _text(name, 3 * chunk + 77, 0.4, seed=12)
    cls, w, wt = _windows(m, text, halo, chunk)
    B = wt.shape[0]
    _force_k(monkeypatch, "SPLIT_PLANES_MAX_LANES", B, chunk, halo, K)
    pd, pe, _ = convert.split_from_numpy(np.asarray(dfa_flat), np.asarray(emit_tab), halo, "cpu")
    planes = huge.split_emit_planes(pd, pe, wt, halo, m.num_classes, P)
    want = np.asarray(jax_sb.split_emit_planes(dfa_flat, emit_tab, jnp.asarray(w), halo,
                                               m.num_classes, P))
    assert planes.dtype == torch.uint32 and tuple(planes.shape) == want.shape == (P, B * chunk)
    np.testing.assert_array_equal(_u32(planes), want)
    assert (want != 0).any(axis=1).all()  # every plane carries matches


@pytest.mark.parametrize("cap, num_windows, want", [
    ("PACKEDCOUNT_MAX_LANES", 65_536, 2),  # the 1M cell at 32 Mi units
    ("PACKEDCOUNT_MAX_LANES", 32_768, 4),
    ("PACKEDCOUNT_MAX_LANES", 8_192, 4),
    ("PACKEDCOUNT_MAX_LANES", 131_072, 1),
    ("SPLIT_PLANES_MAX_LANES", 65_536, 1),
    ("SPLIT_PLANES_MAX_LANES", 32_768, 2),
    ("SPLIT_PLANES_MAX_LANES", 8_192, 4),
])
def test_huge_lane_caps(cap, num_windows, want):
    """The K each wrapper passes at the A/B's window counts, 512 body
    classes behind a halo of 12."""
    K, L = scan_block.segments(num_windows, 512, 12, getattr(huge, cap))
    assert K == want and num_windows * K <= max(getattr(huge, cap), num_windows)
