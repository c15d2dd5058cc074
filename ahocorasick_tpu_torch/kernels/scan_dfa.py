"""Sequential DFA scans: the Hopper kernels and their plain PyTorch twins.

``seq_states(table, row_id, cls, s0)`` returns the arrival states
``int32[N]`` of ``s = table[s, c]`` from the entry state ``s0``, over a dense
``int32[S, A]`` table (``row_id=None``) or a row-deduplicated one
(``s = rows[row_id[s], c]``: ``table`` is ``rows int32[R, A]``, ``row_id``
``int32[S]``), with ``int32[N]`` classes; the carry to the next feed is
``states[-1]``.  The kernel (``csrc/seq_scan.cu``) replaces the JAX package's
``core/stream.py`` ``_seqscan_jit`` runner (both table forms) and
``ops/scan_dfa.py`` ``dfa_states`` (the dense form).

``shortest_states(dfa_next, match_len, cls)`` returns the arrival states
``int32[N]`` of ``s = dfa_next[match_len[s] > 0 ? 0 : s, c]`` from the root,
over tables padded as the JAX package pads them (``dfa_next`` int32[S_pad,
A_pad], ``match_len`` int32[S_pad]) and classes ``uint8``, ``uint16`` or
``int32[N]``.

That kernel (``csrc/shortest_scan.cu``) replaces the JAX package's
``ops/scan_dfa.py`` ``shortest_states`` (one ``lax.scan``).  Both recurrences
are sequential, so each is one thread walking the chain; the source notes say
what that costs.

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches["seq_states"]`` and ``launches["shortest_states"]`` count
kernel launches only.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.kernels.scan_block import _widen

_CLASS_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}


def _check(dfa_next: torch.Tensor, match_len: torch.Tensor, cls: torch.Tensor):
    if dfa_next.dtype != torch.int32 or dfa_next.dim() != 2:
        raise TypeError(f"dfa_next must be int32[S, A], got {dfa_next.dtype}{tuple(dfa_next.shape)}")
    if match_len.dtype != torch.int32 or match_len.shape != dfa_next.shape[:1]:
        raise TypeError(
            f"match_len must be int32[{dfa_next.shape[0]}], got "
            f"{match_len.dtype}{tuple(match_len.shape)}")
    if cls.dtype not in _CLASS_BYTES or cls.dim() != 1:
        raise TypeError(f"classes must be uint8, uint16 or int32[N], got {cls.dtype}{tuple(cls.shape)}")
    if not dfa_next.device == match_len.device == cls.device:
        raise ValueError(
            f"dfa_next on {dfa_next.device}, match_len on {match_len.device}, "
            f"classes on {cls.device}")
    if not (dfa_next.is_contiguous() and match_len.is_contiguous() and cls.is_contiguous()):
        raise ValueError("tables and classes must be contiguous")
    if cls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cls.device}")


def shortest_states(dfa_next: torch.Tensor, match_len: torch.Tensor,
                    cls: torch.Tensor) -> torch.Tensor:
    """Arrival states ``int32[N]`` of the shortest matcher's restart loop."""
    _check(dfa_next, match_len, cls)
    if cls.device.type == "cpu":
        return shortest_states_plain(dfa_next, match_len, cls)
    dev = cls.device
    out = torch.empty(cls.shape[0], dtype=torch.int32, device=dev)
    if cls.shape[0] == 0:
        return out
    build.call(
        "shortest_states", dfa_next.data_ptr(), match_len.data_ptr(), cls.data_ptr(),
        _CLASS_BYTES[cls.dtype], cls.shape[0], dfa_next.shape[1], out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    launches["shortest_states"] += 1
    return out


def shortest_states_plain(dfa_next, match_len, cls) -> torch.Tensor:
    """The plain twin: a Python loop of torch indexing, one step per class."""
    flat = dfa_next.reshape(-1).to(torch.int64)
    A = dfa_next.shape[1]
    c = cls.to(torch.int64) if cls.dtype == torch.int32 else _widen(cls)
    out = torch.empty(cls.shape[0], dtype=torch.int64, device=cls.device)
    s = torch.zeros((), dtype=torch.int64, device=cls.device)
    for i in range(cls.shape[0]):
        row = torch.where(match_len[s] > 0, 0, s)
        s = flat[row * A + c[i]]
        out[i] = s
    return out.to(torch.int32)


def _check_seq(table: torch.Tensor, row_id, cls: torch.Tensor, s0: int):
    if table.dtype != torch.int32 or table.dim() != 2:
        raise TypeError(f"table must be int32[S, A], got {table.dtype}{tuple(table.shape)}")
    if row_id is not None and (row_id.dtype != torch.int32 or row_id.dim() != 1):
        raise TypeError(f"row_id must be int32[S], got {row_id.dtype}{tuple(row_id.shape)}")
    if cls.dtype != torch.int32 or cls.dim() != 1:
        raise TypeError(f"classes must be int32[N], got {cls.dtype}{tuple(cls.shape)}")
    tensors = [t for t in (table, row_id, cls) if t is not None]
    if any(t.device != cls.device for t in tensors):
        raise ValueError("table, row_id and classes must lie on one device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tables and classes must be contiguous")
    if cls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cls.device}")
    states = table.shape[0] if row_id is None else row_id.shape[0]
    if not 0 <= s0 < states:
        raise ValueError(f"entry state {s0} outside [0, {states})")


def seq_states(table: torch.Tensor, row_id, cls: torch.Tensor, s0: int = 0) -> torch.Tensor:
    """Arrival states ``int32[N]`` of the scan from ``s0``; ``row_id`` None
    for a dense table, else the state -> row map of a row-deduplicated one."""
    s0 = int(s0)
    _check_seq(table, row_id, cls, s0)
    if cls.device.type == "cpu":
        return seq_states_plain(table, row_id, cls, s0)
    dev = cls.device
    out = torch.empty(cls.shape[0], dtype=torch.int32, device=dev)
    if cls.shape[0] == 0:
        return out
    build.call(
        "seq_states", table.data_ptr(), None if row_id is None else row_id.data_ptr(),
        cls.data_ptr(), cls.shape[0], table.shape[1], s0, out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    launches["seq_states"] += 1
    return out


def seq_states_plain(table, row_id, cls, s0: int = 0) -> torch.Tensor:
    """The plain twin: a Python loop of ``table[s, c]`` (``rows[row_id[s],
    c]``), one indexing step per class."""
    flat = table.reshape(-1)
    A = table.shape[1]
    s = int(s0)
    out = []
    for c in cls.tolist():
        row = s if row_id is None else int(row_id[s])
        s = int(flat[row * A + c])
        out.append(s)
    return torch.tensor(out, dtype=torch.int32, device=cls.device)
