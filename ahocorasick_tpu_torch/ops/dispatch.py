"""Engine plans for the AC-family device scan — the port of
``ahocorasick_tpu/ops/dispatch.py``.

A plan bundles the device tables, the chunker halo and a kernel closure over
``chunk_classes``-layout windows, so the matcher's count and planes paths
cannot drift apart.  The TPU chooser (``scan_rowdfa.pick_engine``: per-char
cost constants, VMEM budgets, one-hot select, R-round permute) does not carry
over: on the H100 every dictionary that packs inline, dense or quotient,
takes the packed-scan kernel family (``which="packed"``).  Dense
dictionaries whose emit masks do not fit beside the state take the JAX
package's huge-dictionary layouts, with its ``which``: ``"packedcount"``
(counts) and ``"hotstate"`` (planes) over the count-packed table when the
emit counts fit beside the state, else ``"split"`` for both.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

from ahocorasick_tpu_torch.kernels import scan_batched as huge
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.ops import scan_batched


class EnginePlan(NamedTuple):
    which: str  # packed | packedcount | hotstate | split
    halo: int  # left-halo length for chunk_classes
    tables: Tuple  # device tensors; pass back as fn(tables, windows)
    fn: Callable  # fn(tables, windows) -> int64 count | uint32[P, N] planes


def _packed_plan(dev, kernel) -> EnginePlan:
    pd = dev.packed_dfa
    fn = lambda tables, w: kernel(tables[0], w, pd.halo, pd.state_bits)
    return EnginePlan("packed", pd.halo, (pd.table,), fn)


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


def count_plan(compiled, dev) -> EnginePlan:
    """Plan for the fused count kernels (match count summed on the device)."""
    if scan_batched.inline_packable(compiled):
        return _packed_plan(dev, scan_block.packed_scan_count)
    if scan_batched.count_packable(compiled):
        # One lookup per character: the emit count rides the packed entry
        # even when the per-length mask cannot.
        return _count_packed_plan(compiled, dev, "packedcount", huge.packedcount_count)
    return _split_plan(compiled, dev, huge.split_count)


def planes_plan(compiled, dev) -> EnginePlan:
    """Plan for the END-indexed planes kernels: emit planes ``uint32[P, N]``
    (``"packed"``, ``"split"``), or the packed (state, count) plane
    ``uint32[1, N]`` (``"hotstate"``, decoded by
    ``scan_batched.hotstate_sparse``)."""
    if scan_batched.inline_packable(compiled):
        return _packed_plan(dev, scan_block.packed_scan_planes)
    if scan_batched.hotstate_layout(compiled):
        return _count_packed_plan(compiled, dev, "hotstate", huge.packedcount_hotstate_plane)
    return _split_plan(compiled, dev, huge.split_emit_planes)
