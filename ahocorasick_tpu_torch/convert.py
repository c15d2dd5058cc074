"""Tables and matchers carried across from the JAX package.

``packed_from_numpy`` takes a packed table as the JAX package builds it —
``ahocorasick_tpu.ops.scan_batched.build_packed(m).table`` or the padded
``_DeviceTables(m).packed_dfa.table`` (via ``np.asarray``) — and returns the
port's ``PackedDfa`` of tensors.  ``count_packed_from_numpy`` and
``split_from_numpy`` do the same for the huge-dictionary layouts, and
``wwl_scan_from_numpy`` for the whole-word-longest scan tables.
``compiled_from_numpy`` carries a whole compiled automaton across: the fields
of the JAX package's ``CompiledMatcher`` as plain numpy arrays and Python
values (a ``RowTable`` as ``{"rows", "row_id"}``) become the port's own
``CompiledMatcher`` with the port's own ``RowTable``; npz artifacts are the
other carrier.  ``from_compiled`` wraps a port ``CompiledMatcher`` (freshly
compiled, carried across, or loaded from an npz either package saved) in the
port's matcher class for its kind.

This module imports nothing of the JAX package: callers hand it numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ahocorasick_tpu_torch.core.compiler import SHORTEST, CompiledMatcher, RowTable
from ahocorasick_tpu_torch.ops.scan_batched import PackedDfa
from ahocorasick_tpu_torch.ops.scan_wwl import WwlScan


def _bucket_up(n: int, minimum: int = 8) -> int:
    """The power-of-two bucket the JAX package pads state rows and class
    columns to (its ``models.matchers._bucket_up``)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def compiled_to_numpy(compiled) -> dict:
    """The fields of a ``CompiledMatcher`` of either package as the dict
    ``compiled_from_numpy`` takes: read by attribute name, a row-compressed
    table (anything with ``rows`` and ``row_id``) as ``{"rows", "row_id"}``."""
    out = {}
    for f in dataclasses.fields(CompiledMatcher):
        v = getattr(compiled, f.name)
        if hasattr(v, "rows") and hasattr(v, "row_id"):
            v = {"rows": np.asarray(v.rows), "row_id": np.asarray(v.row_id)}
        out[f.name] = v
    return out


def compiled_from_numpy(fields: dict) -> CompiledMatcher:
    """A compiled automaton from its fields as plain numpy arrays and Python
    values, keyed by the names of ``CompiledMatcher``'s dataclass fields.

    A row-compressed table (``trie_next`` / ``dfa_next`` of a wide-alphabet
    dictionary) is given as ``{"rows": int32[R, A], "row_id": int32[S]}`` and
    becomes the port's ``RowTable``.  Arrays are taken as they are (no copy);
    missing or unknown field names raise."""
    names = [f.name for f in dataclasses.fields(CompiledMatcher)]
    unknown = set(fields) - set(names)
    missing = set(names) - set(fields)
    if unknown or missing:
        raise ValueError(
            f"CompiledMatcher fields do not match: missing {sorted(missing)}, "
            f"unknown {sorted(unknown)}")
    out = {}
    for name in names:
        v = fields[name]
        if isinstance(v, dict):
            if set(v) != {"rows", "row_id"}:
                raise ValueError(f"{name}: expected {{'rows', 'row_id'}}, got {sorted(v)}")
            v = RowTable(np.asarray(v["rows"]), np.asarray(v["row_id"]))
        elif name == "values":
            v = None if v is None else list(v)
        elif isinstance(v, np.generic):
            v = v.item()
        elif v is not None and not isinstance(v, (str, bool, int)):
            v = np.asarray(v)
        out[name] = v
    return CompiledMatcher(**out)


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
    return PackedDfa(_uint32_tensor(host, device), None, int(state_bits), int(halo))


def _uint32_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy -> ``torch.uint32`` through an int32 view (same bits;
    every copy path has int32)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    if not arr.flags.writeable:  # e.g. a view of a JAX buffer: torch needs its own
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device).view(torch.uint32)


def count_packed_from_numpy(flat, state_bits: int, halo: int, device):
    """A count-packed table as the JAX package builds it
    (``ahocorasick_tpu.ops.scan_batched.build_count_packed(m)``, or
    ``np.asarray`` of ``_DeviceTables(m).count_packed_dfa[0]``) ->
    ``(table_flat, state_bits, halo)`` with a flat ``torch.uint32`` table on
    ``device``, the tuple of the port's ``_DeviceTables.count_packed_dfa``."""
    flat = np.asarray(flat)
    if flat.dtype != np.uint32 or flat.ndim != 1:
        raise ValueError(f"expected a flat uint32[S*A] table, got {flat.dtype}{flat.shape}")
    return _uint32_tensor(flat, device), int(state_bits), int(halo)


def split_from_numpy(dfa_flat, emit_tab, halo: int, device):
    """The split layout as the JAX package builds it (``build_packed(m)``
    of a dictionary that does not pack inline: ``table.reshape(-1)`` and
    ``emit_mask``, or ``np.asarray`` of ``_DeviceTables(m).split_dfa``) ->
    ``(dfa_flat, emit_tab, halo)``: flat ``uint32[S*A]`` next states and
    ``uint32[S, P]`` emit planes on ``device``."""
    dfa_flat = np.asarray(dfa_flat)
    emit_tab = np.asarray(emit_tab)
    if dfa_flat.dtype != np.uint32 or dfa_flat.ndim != 1:
        raise ValueError(f"expected a flat uint32[S*A] table, got {dfa_flat.dtype}{dfa_flat.shape}")
    if emit_tab.dtype != np.uint32 or emit_tab.ndim != 2:
        raise ValueError(f"expected uint32[S, P] emit planes, got {emit_tab.dtype}{emit_tab.shape}")
    return _uint32_tensor(dfa_flat, device), _uint32_tensor(emit_tab, device), int(halo)


def wwl_scan_from_numpy(sc, device) -> WwlScan:
    """A whole-word-longest scan table set as the JAX package builds it
    (``ahocorasick_tpu.ops.scan_wwl.build_wwl_scan`` /
    ``build_wwl_scan_mixed``, or ``_DeviceTables(m).wwl_scan_host``; numpy
    arrays) -> the port's ``WwlScan`` of tensors on ``device``."""
    table = np.asarray(sc.table)
    if table.dtype != np.uint32 or table.ndim != (2 if sc.row_layout else 1):
        raise ValueError(f"expected a uint32 {'row' if sc.row_layout else 'flat'} table, "
                         f"got {table.dtype}{table.shape}")
    rows_flat = None
    if sc.rows_flat is not None:
        rows_flat = torch.from_numpy(np.ascontiguousarray(sc.rows_flat, dtype=np.int32)).to(device)
    outrows = torch.from_numpy(np.ascontiguousarray(sc.outrows, dtype=np.int32)).to(device)
    return WwlScan(_uint32_tensor(table, device), rows_flat, outrows, int(sc.id_bits),
                   int(sc.depth_bits), int(sc.halo), int(sc.num_classes), bool(sc.row_layout),
                   bool(sc.quotient), bool(sc.has_cross))


def from_compiled(compiled, engine: str = "auto", device=None, ac_compiled=None):
    """The port's matcher for ``compiled``, of any kind, set or map.
    ``ac_compiled`` is a shortest artifact's internal AC automaton, when it
    was saved with it."""
    from ahocorasick_tpu_torch.models.matchers import _CLASS_BY_KIND

    cls = _CLASS_BY_KIND.get((compiled.kind, compiled.values is not None))
    if cls is None:
        raise ValueError(f"unknown matcher kind {compiled.kind!r}")
    if compiled.kind == SHORTEST:
        return cls.from_compiled(compiled, engine=engine, device=device,
                                 ac_compiled=ac_compiled)
    return cls.from_compiled(compiled, engine=engine, device=device)
