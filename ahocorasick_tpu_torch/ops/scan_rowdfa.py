"""Stride-2 row DFA — the port of ``ahocorasick_tpu/ops/scan_rowdfa.py``.

Rows are indexed by ``(s, c0)``:

    row[(s, c0)] = [ state2 | emit2 << state_bits  for every c1 ] ++ [ emit1 ]

where state1 = delta(s, c0), state2 = delta(state1, c1), and the last column
carries emit1 = emit_mask(state1), a function of the row index only.  One
row lookup therefore gives the state after two characters and both
positions' emit masks: the scan's chain of dependent loads is half as long
as the packed scan's.  The table is ``S * A * (A + 1) * 4`` bytes (quotient
rows for row-compressed matchers), so it grows with the square of the
alphabet.  The kernels are ``kernels/scan_rowdfa.py`` (``rowdfa2_count``,
``rowdfa2_planes``, and their plain twins); semantics are those of the packed
scan (the same d-synchronizing halo, END-indexed emit masks in flat text
order), with an even halo and even chunks so that pairs are well formed.

The JAX module's stride-1 engine ``rowdfa1`` (one row gather and a one-hot
column select per character) has no counterpart here: on the card the
packed-scan kernel (``csrc/packed_scan.cu``) already is the stride-1 row
scan, one indexed load per character.  Nor do its TPU gates: the 16 MB VMEM
budgets, the 512-class one-hot select limit and the v5e per-character cost
constants.  On Hopper the column select is an indexed load, ``fits`` is a
byte budget set from the card's memory, and ``pick_engine`` keeps the packed
kernels, as measured on the card; the stride-2 kernels serve
``device_engine="batched2"`` and the benchmark harnesses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ahocorasick_tpu_torch.core.compiler import CompiledMatcher
from ahocorasick_tpu_torch.ops.scan_batched import build_packed, effective_rows, inline_packable

# Largest stride-2 table any path builds: 1 GiB, 1.3% of the H100's 80 GB,
# so that a forced stride-2 scan (device_engine="batched2") never crowds out
# the windows and planes of a large text.
_MAX_BYTES = 1 << 30


class RowDfa(NamedTuple):
    table: object  # uint32[S*A, A+1] numpy (builder) or torch tensor (device)
    state_bits: int
    halo: int  # even, >= max depth
    num_classes: int


def table_bytes(m: CompiledMatcher) -> int:
    """Bytes of ``build_rowdfa(m).table``."""
    S, A = effective_rows(m), m.num_classes
    return S * A * (A + 1) * 4


def fits(m: CompiledMatcher, max_bytes: int = _MAX_BYTES) -> bool:
    """The stride-2 layout applies: the emit mask packs beside the state
    (the packed-inline layout) and the table is within ``max_bytes``."""
    return inline_packable(m) and table_bytes(m) <= max_bytes


def pick_engine(m: CompiledMatcher) -> str:
    """The default kernel family for ``m``'s counts and planes: always
    ``"packed"`` (for a dictionary that does not pack inline the dispatcher
    then takes the huge-dictionary layouts).

    chip_smoke.py timed both families at 65,536 x 524 windows on an NVIDIA
    H100 80GB HBM3 at 700 W (PERF.md), on stride-2 tables of 2.2 MB
    to 152 MB: ``rowdfa2_count`` takes 1.5-2.0x ``packed_scan_count``'s
    time at every size, so counts gain nothing.  ``rowdfa2_planes`` takes
    0.61-0.70x ``packed_scan_planes``' time, but that is 0.23-0.29 ms per
    32 Mi units inside match calls of 0.3-0.4 s that the host bounds, while
    the stride-2 table is 28x the packed one and a second upload of the same
    automaton."""
    return "packed"


def build_rowdfa(m: CompiledMatcher) -> RowDfa:
    """The stride-2 table over ``build_packed``'s packed table; byte for byte
    the JAX package's ``build_rowdfa``."""
    pd = build_packed(m)
    if pd.emit_mask is not None:
        raise ValueError("the stride-2 layout needs the packed-inline layout")
    S, A = pd.table.shape  # quotient rows for row-compressed matchers
    sb = pd.state_bits
    smask = np.uint32((1 << sb) - 1)
    p1 = pd.table  # uint32[S, A] = state1 | emit(state1) << sb
    state1 = (p1 & smask).reshape(S * A)  # row index (s, c0) -> state1
    body = p1[state1]  # (S*A, A): state2 | emit2 << sb for every c1
    emit1 = (p1 >> np.uint32(sb)).reshape(S * A, 1)  # emit(state1)
    table = np.concatenate([body, emit1], axis=1)
    halo = pd.halo + (pd.halo % 2)
    return RowDfa(np.ascontiguousarray(table), sb, halo, A)
