"""Engine plans for the AC-family device scan — the port of
``ahocorasick_tpu/ops/dispatch.py``.

A plan bundles the device tables, the chunker halo and a kernel closure over
``chunk_classes``-layout windows, so the matcher's count and planes paths
cannot drift apart.  Dictionaries that pack inline take the packed-scan
kernel family (``which="packed"``, the stride-1 row scan;
``scan_rowdfa.pick_engine`` gives the H100 timings behind that choice).
Dense dictionaries whose emit masks do not fit beside the state take the
JAX package's huge-dictionary layouts, with its ``which``: ``"packedcount"``
(counts) and ``"hotstate"`` (planes) over the count-packed table when the
emit counts fit beside the state, else ``"split"`` for both.  The TPU chooser's block engine,
stride-1 row gather and per-character cost constants do not carry over.

``force`` is the matchers' ``device_engine`` cross-check knob: ``"rowdfa2"``
(``"batched2"``) takes the stride-2 row kernels (``which="rowdfa2"``)
wherever ``scan_rowdfa.fits`` holds, else the plan picked without it; the
JAX package's ``(S*A*A, 2)`` stride-2 table is a TPU gather layout of the
same words, so the stride-2 row table serves it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

from ahocorasick_tpu_torch.kernels import scan_batched as huge
from ahocorasick_tpu_torch.kernels import scan_block, scan_rowdfa as rowdfa_kernels
from ahocorasick_tpu_torch.ops import scan_batched, scan_rowdfa


class EnginePlan(NamedTuple):
    which: str  # rowdfa2 | packed | packedcount | hotstate | split
    halo: int  # left-halo length for chunk_classes
    tables: Tuple  # device tensors; pass back as fn(tables, windows)
    fn: Callable  # fn(tables, windows) -> int64 count | uint32[P, N] planes


def _packed_plan(dev, kernel) -> EnginePlan:
    pd = dev.packed_dfa
    fn = lambda tables, w: kernel(tables[0], w, pd.halo, pd.state_bits)
    return EnginePlan("packed", pd.halo, (pd.table,), fn)


def _rowdfa2_plan(dev, kernel) -> EnginePlan:
    rd = dev.row_dfa
    fn = lambda tables, w: kernel(tables[0], w, rd.halo, rd.state_bits, rd.num_classes)
    return EnginePlan("rowdfa2", rd.halo, (rd.table,), fn)


def _stride2(compiled, force) -> bool:
    if force not in (None, "rowdfa2"):
        raise ValueError(f"unknown forced engine {force!r}")
    return force == "rowdfa2" and scan_rowdfa.fits(compiled)


def _count_packed_plan(compiled, dev, which, kernel) -> EnginePlan:
    flat, cp_bits, halo = dev.count_packed_dfa
    A = compiled.num_classes
    fn = lambda tables, w: kernel(tables[0], w, halo, cp_bits, A)
    return EnginePlan(which, halo, (flat,), fn)


def _split_plan(compiled, dev, kernel) -> EnginePlan:
    dfa_flat, emit_tab, halo = dev.split_dfa
    planes = (max(compiled.max_depth, 1) + 31) // 32
    fn = lambda tables, w: kernel(
        tables[0], tables[1], w, halo, compiled.num_classes, planes)
    return EnginePlan("split", halo, (dfa_flat, emit_tab), fn)


def count_plan(compiled, dev, force=None) -> EnginePlan:
    """Plan for the fused count kernels (match count summed on the device)."""
    if _stride2(compiled, force):
        return _rowdfa2_plan(dev, rowdfa_kernels.rowdfa2_count)
    if scan_batched.inline_packable(compiled):
        return _packed_plan(dev, scan_block.packed_scan_count)
    if scan_batched.count_packable(compiled):
        # One lookup per character: the emit count rides the packed entry
        # even when the per-length mask cannot.
        return _count_packed_plan(compiled, dev, "packedcount", huge.packedcount_count)
    return _split_plan(compiled, dev, huge.split_count)


def planes_plan(compiled, dev, force=None) -> EnginePlan:
    """Plan for the END-indexed planes kernels: emit planes ``uint32[P, N]``
    (``"rowdfa2"``, ``"packed"``, ``"split"``), or the packed (state, count) plane
    ``uint32[1, N]`` (``"hotstate"``, decoded by
    ``scan_batched.hotstate_sparse``)."""
    if _stride2(compiled, force):
        return _rowdfa2_plan(dev, rowdfa_kernels.rowdfa2_planes)
    if scan_batched.inline_packable(compiled):
        return _packed_plan(dev, scan_block.packed_scan_planes)
    if scan_batched.hotstate_layout(compiled):
        return _count_packed_plan(compiled, dev, "hotstate", huge.packedcount_hotstate_plane)
    return _split_plan(compiled, dev, huge.split_emit_planes)
