"""Engine plans for the AC-family device scan — the port of
``ahocorasick_tpu/ops/dispatch.py``.

A plan bundles the device tables, the chunker halo and a kernel closure over
``chunk_classes``-layout windows, so the matcher's count and planes paths
cannot drift apart.  The TPU chooser (``scan_rowdfa.pick_engine``: per-char
cost constants, VMEM budgets, one-hot select, R-round permute) does not carry
over: on the H100 every dictionary that packs inline, dense or quotient,
takes the packed-scan kernel family (``which="packed"``).  Dictionaries
whose emit masks do not fit beside the state raise ``NotImplementedError``
here; the matchers never ask for them (``models/matchers._no_device_path``
sends them to gold under ``"auto"`` and refuses ``"device"``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.ops import scan_batched


class EnginePlan(NamedTuple):
    which: str  # "packed": the only device engine of the port so far
    halo: int  # left-halo length for chunk_classes
    tables: Tuple  # device tensors; pass back as fn(tables, windows)
    fn: Callable  # fn(tables, windows) -> int64 count | uint32[1, N] planes


def _packed_plan(compiled, dev, kernel) -> EnginePlan:
    if not scan_batched.inline_packable(compiled):
        raise NotImplementedError(
            "dictionary does not pack inline (state bits + max depth > 32); "
            "its count-packed, hotstate and split layouts are not ported yet "
            "(ROADMAP.md A6)")
    pd = dev.packed_dfa
    fn = lambda tables, w: kernel(tables[0], w, pd.halo, pd.state_bits)
    return EnginePlan("packed", pd.halo, (pd.table,), fn)


def count_plan(compiled, dev) -> EnginePlan:
    """Plan for the fused count kernel (popcount summed on the device)."""
    return _packed_plan(compiled, dev, scan_block.packed_scan_count)


def planes_plan(compiled, dev) -> EnginePlan:
    """Plan for the END-indexed emit-planes kernel (``uint32[1, N]`` bits)."""
    return _packed_plan(compiled, dev, scan_block.packed_scan_planes)
