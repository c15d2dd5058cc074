"""The split count and the stride-2 planes in their kernels' lane
decompositions, through their plain twins, against the JAX package.

``csrc/huge_scan.cu`` ``split_count`` runs ``tile.cuh``'s count lane with the
emit loads gathered after each tile, and ``csrc/rowdfa2_scan.cu``
``rowdfa2_planes`` its planes lane over the stride-2 table type (a pair of
classes a step).  Each wrapper fixes K lanes per window
(``scan_block.segments`` under ``SPLIT_COUNT_MAX_LANES`` /
``ROWDFA2_PLANES_MAX_LANES``) and its twin scans the same segments, each
warmed over the halo before it, the last one's padding masked or cut.  The
caps are patched so that a few windows take K = 1, 2 and 4.  The same
windows go through the JAX package's ``split_count`` and
``rowdfa_emit_planes``; counts and planes are integers, so every comparison
is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu as jax_pkg
from ahocorasick_tpu.models import matchers as jax_matchers
from ahocorasick_tpu.ops import scan_batched as jax_sb
from ahocorasick_tpu.ops import scan_rowdfa as jax_rowdfa
from ahocorasick_tpu_torch import convert
from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels import scan_batched as huge
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.kernels import scan_rowdfa as krow
from ahocorasick_tpu_torch.models import matchers as port_matchers
from ahocorasick_tpu_torch.ops import scan_batched as port_sb
from test_torch_host import carry
from test_torch_huge import NAMES, _compiled, _text, _u32, _windows
from test_torch_huge_lanes import _a_run_dictionary, _ragged_chunk
from test_torch_rowdfa import DICTS as ROW_DICTS
from test_torch_rowdfa import _classes as _row_classes
from test_torch_rowdfa import _compiled as _row_compiled
from test_torch_rowdfa import _text as _row_text


def _force_k(monkeypatch, module, cap_name: str, B: int, C: int, halo: int, K: int) -> None:
    monkeypatch.setattr(module, cap_name, K * B)
    assert scan_block.segments(B, C, halo, getattr(module, cap_name))[0] == K


# ------------------------------------------------------------- the split count

_JAX_COUNTS = {}  # (name, ragged): the JAX split count and its planes' bits


def _split_case(name: str, ragged: bool):
    """(compiled, JAX split tables, halo, P, chunk, text) of a dictionary."""
    if name == "a420":
        m, text = _a_run_dictionary(420)
    else:
        m, text = _compiled(name), None
    dfa_flat, emit_tab, halo = jax_matchers._DeviceTables(m).split_dfa
    chunk = _ragged_chunk(halo, ragged)
    if text is None:
        text = _text(name, 3 * chunk + 77, 0.4, seed=13)
    return m, dfa_flat, emit_tab, halo, emit_tab.shape[1], chunk, text


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("ragged", [False, True], ids=["C%4==0", "C%4==3"])
@pytest.mark.parametrize("name", NAMES + ["a420"])
def test_split_count_twin_in_lane_decomposition_equals_jax(name, ragged, K, monkeypatch):
    """The split count twin (the count lane, the popcounts of the P emit
    planes of each state as its value) at K lanes per window equals the JAX
    ``split_count``, on uint8 windows and, for ``wide_deep``, uint16 ones;
    P = 2 (``deep``, ``ab_long``), 4 (``a100``), 1 (``wide_deep``) and 14
    (``a420``)."""
    m, dfa_flat, emit_tab, halo, P, chunk, text = _split_case(name, ragged)
    assert P == {"deep": 2, "a100": 4, "ab_long": 2, "wide_deep": 1, "a420": 14}[name]
    cls, w, wt = _windows(m, text, halo, chunk)
    assert wt.dtype == (torch.uint16 if name == "wide_deep" else torch.uint8)
    _force_k(monkeypatch, huge, "SPLIT_COUNT_MAX_LANES", wt.shape[0], chunk, halo, K)
    pd, pe, _ = convert.split_from_numpy(np.asarray(dfa_flat), np.asarray(emit_tab), halo, "cpu")
    got = huge.split_count(pd, pe, wt, halo, m.num_classes, P)
    if (name, ragged) not in _JAX_COUNTS:
        args = (dfa_flat, emit_tab, jnp.asarray(w), halo, m.num_classes, P)
        _JAX_COUNTS[name, ragged] = (int(jax_sb.split_count(*args)), int(
            np.bitwise_count(np.asarray(jax_sb.split_emit_planes(*args))).sum()))
    want, bits = _JAX_COUNTS[name, ragged]
    assert got.dtype == torch.int64 and int(got) == want == bits > 0


# ---------------------------------------------------------- the stride-2 planes

_JAX_PLANES = {}


def _row_case(name: str, chunk: int):
    """(port stride-2 table, port windows, JAX planes) of a dictionary's
    seeded text of an odd length (the PAD_CLASS tail pair) in ``chunk``-class
    bodies."""
    m = _row_compiled(name)
    rd = port_matchers._DeviceTables(carry(m), "cpu").row_dfa
    cls = _row_classes(m, _row_text(name, 3 * max(chunk, 1400) + 77, seed=chunk))
    assert len(cls) % 2 == 1
    w = port_sb.classes_to_device(port_sb.chunk_classes(cls, chunk, rd.halo, m.num_classes),
                                  m.num_classes, "cpu")
    if (name, chunk) not in _JAX_PLANES:
        jrd = jax_pkg.models.matchers._DeviceTables(m).row_dfa
        jw = jnp.asarray(jax_rowdfa.chunk_classes2(cls, chunk, jrd.halo))
        _JAX_PLANES[name, chunk] = np.asarray(jax_rowdfa.rowdfa_emit_planes(
            jrd.table, jw, jrd.halo, jrd.state_bits, jrd.num_classes, 1))
    return rd, w, _JAX_PLANES[name, chunk]


def _pair_chunk(halo: int, odd: bool) -> int:
    """A body that K = 4 segments of at least four halos and 32 steps cover,
    with an even (C % 4 == 0) or odd (C % 4 == 2) number of pairs."""
    return 16 * max(halo, 8) + (6 if odd else 8)


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("odd", [False, True], ids=["pairs even", "pairs odd"])
@pytest.mark.parametrize("name", ROW_DICTS)
def test_rowdfa_emit_planes_twin_in_lane_decomposition_equals_jax(name, odd, K, monkeypatch):
    """The stride-2 planes twin at K lanes per window equals the JAX
    ``rowdfa_emit_planes`` bit for bit, on uint8 windows and, for ``wide``,
    uint16 ones; the ragged last segment holds an odd number of pairs where
    C % 4 == 2."""
    halo = port_matchers._DeviceTables(carry(_row_compiled(name)), "cpu").row_dfa.halo
    chunk = _pair_chunk(halo, odd)
    rd, w, want = _row_case(name, chunk)
    assert w.dtype == (torch.uint16 if name == "wide" else torch.uint8)
    B = w.shape[0]
    _force_k(monkeypatch, krow, "ROWDFA2_PLANES_MAX_LANES", B, chunk, rd.halo, K)
    planes = krow.rowdfa2_planes(rd.table, w, rd.halo, rd.state_bits, rd.num_classes)
    assert planes.dtype == torch.uint32 and tuple(planes.shape) == want.shape == (1, B * chunk)
    np.testing.assert_array_equal(_u32(planes), want)
    assert want.any()


@pytest.mark.parametrize("name", ROW_DICTS)
def test_rowdfa_emit_planes_twin_one_pair_chunks_equals_jax(name):
    """Bodies of one pair: one lane per window, whatever the cap."""
    rd, w, want = _row_case(name, 2)
    B = w.shape[0]
    assert scan_block.segments(B, 2, rd.halo, krow.ROWDFA2_PLANES_MAX_LANES) == (1, 2)
    planes = krow.rowdfa2_planes(rd.table, w, rd.halo, rd.state_bits, rd.num_classes)
    assert tuple(planes.shape) == want.shape == (1, 2 * B)
    np.testing.assert_array_equal(_u32(planes), want)


# ------------------------------------------------------------------ the caps


@pytest.mark.parametrize("module, cap, num_windows, want", [
    (huge, "SPLIT_COUNT_MAX_LANES", 65_536, 1),  # the 1M cell at 32 Mi units
    (huge, "SPLIT_COUNT_MAX_LANES", 32_768, 2),
    (huge, "SPLIT_COUNT_MAX_LANES", 8_192, 4),
    (krow, "ROWDFA2_PLANES_MAX_LANES", 65_536, 1),  # the 10k cell at 32 Mi units
    (krow, "ROWDFA2_PLANES_MAX_LANES", 32_768, 1),
    (krow, "ROWDFA2_PLANES_MAX_LANES", 16_384, 2),
    (krow, "ROWDFA2_PLANES_MAX_LANES", 8_192, 4),
], ids=lambda x: getattr(x, "__name__", x))
def test_lane_caps(module, cap, num_windows, want):
    """The K each wrapper passes at the A/B's window counts, 512 body
    classes behind a halo of 12."""
    K, L = scan_block.segments(num_windows, 512, 12, getattr(module, cap))
    assert K == want and num_windows * K <= max(getattr(module, cap), num_windows)
    assert L % 4 == 0 and (K - 1) * L < 512 <= K * L


# ------------------------------------------------------- CPU tensors, twins only


@pytest.mark.parametrize("kernel", ["split_count", "rowdfa2_planes"])
def test_cpu_tensors_launch_nothing(kernel, monkeypatch):
    """A CPU tensor takes the twin: no launch is counted and the kernel
    library is never asked for."""
    monkeypatch.setattr(build, "library", lambda: pytest.fail("the kernel library was loaded"))
    before = dict(build.launches)
    if kernel == "split_count":
        m, dfa_flat, emit_tab, halo, P, chunk, text = _split_case("deep", False)
        _, _, wt = _windows(m, text, halo, chunk)
        pd, pe, _ = convert.split_from_numpy(np.asarray(dfa_flat), np.asarray(emit_tab), halo,
                                             "cpu")
        assert int(huge.split_count(pd, pe, wt, halo, m.num_classes, P)) > 0
    else:
        rd, w, want = _row_case("dense", 64)
        planes = krow.rowdfa2_planes(rd.table, w, rd.halo, rd.state_bits, rd.num_classes)
        np.testing.assert_array_equal(_u32(planes), want)
    assert build.launches == before
