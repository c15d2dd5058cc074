"""Tables and matchers carried across from the JAX package.

``packed_from_numpy`` takes a packed table as the JAX package builds it —
``ahocorasick_tpu.ops.scan_batched.build_packed(m).table`` or the padded
``_DeviceTables(m).packed_dfa.table`` (via ``np.asarray``) — and returns the
port's ``PackedDfa`` of tensors.  ``from_compiled`` wraps a
``CompiledMatcher`` (freshly compiled, or loaded from an npz either package
saved) in the port's matcher class for its kind.
"""

from __future__ import annotations

import numpy as np
import torch

from ahocorasick_tpu.core.compiler import SHORTEST
from ahocorasick_tpu.models.matchers import _bucket_up
from ahocorasick_tpu_torch.ops.scan_batched import PackedDfa


def packed_from_numpy(table, state_bits: int, halo: int, num_classes: int,
                      device) -> PackedDfa:
    """uint32[S, >=num_classes] packed table -> ``PackedDfa`` whose table is
    a contiguous ``torch.uint32`` tensor on ``device``.

    Class columns are padded to the power-of-two bucket the JAX package
    uses, and padded columns copy column 0 (a non-keyword class), so an
    already padded table comes through unchanged."""
    table = np.asarray(table)
    if table.dtype != np.uint32 or table.ndim != 2 or table.shape[1] < num_classes:
        raise ValueError(
            f"expected uint32[S, >={num_classes}], got {table.dtype}{table.shape}")
    host = np.empty((table.shape[0], _bucket_up(num_classes)), dtype=np.uint32)
    host[:, :num_classes] = table[:, :num_classes]
    host[:, num_classes:] = table[:, :1]
    # Upload through an int32 view: same bits, and every copy path has it.
    t = torch.from_numpy(host.view(np.int32)).to(device).view(torch.uint32)
    return PackedDfa(t, None, int(state_bits), int(halo))


def from_compiled(compiled, engine: str = "auto", device=None, ac_compiled=None):
    """The port's matcher for ``compiled`` (any kind but whole-word-longest,
    set or map).  ``ac_compiled`` is a shortest artifact's internal AC
    automaton, when it was saved with it."""
    from ahocorasick_tpu_torch.models.matchers import _CLASS_BY_KIND

    cls = _CLASS_BY_KIND.get((compiled.kind, compiled.values is not None))
    if cls is None:
        raise NotImplementedError(
            f"the port has no {compiled.kind!r} matcher yet (ROADMAP.md A4)")
    if compiled.kind == SHORTEST:
        return cls.from_compiled(compiled, engine=engine, device=device,
                                 ac_compiled=ac_compiled)
    return cls.from_compiled(compiled, engine=engine, device=device)
