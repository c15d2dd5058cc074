"""Chunk stitching by state maps: the Hopper kernels and their plain PyTorch
twins.

Three steps over a dense ``int32[S, A]`` transition table and ``int32[C, K]``
chunked classes:

* ``state_maps(table, cls, sync_depth)`` returns ``sigma int32[C, S]``:
  ``sigma[c, s]`` is the state reached from ``s`` over chunk ``c``;
* ``entry_fold(sigma, s0)`` returns ``entry int32[C]``: ``entry[0] = s0``,
  ``entry[c] = sigma[c - 1][entry[c - 1]]``, the state in which the one
  sequential scan enters each chunk;
* ``rescan(table, cls, entry, sync_depth)`` returns ``states int32[C, K]``:
  chunk ``c`` walked from ``entry[c]``.

``sync_depth=None`` runs the first designs (``csrc/stitch.cu``
``state_maps_all``: S lanes of work per class; ``rescan_serial``: one serial
walk a chunk), the only correct forms for a table that does not synchronize
(the shortest matcher's restart table).  ``sync_depth=d`` (an int >= 1)
declares the table d-synchronizing from every state reachable from the root
(a goto closure, d = ``max(max_depth, 1)``; the entry state ``s0`` reachable
or a zero-filled padding row) and runs the synchronized forms:
``state_maps`` walks all S lanes over the first ``t = min(K, d + 1)``
classes, tests whether they agree, and then walks the one agreed state over
the last classes (at most d) or, where the lanes disagree, every lane over
the whole chunk, so sigma is exact for any table; ``rescan`` is
``csrc/seq_scan.cu``'s lane scan with one row a chunk (lanes of
``scan_dfa.sync_lane_len(C * K, d)`` positions inside a chunk, lane 0 from
the entry state, every other lane from the root warmed over the d classes
before it).  Both forms give the same outputs.

Together they replace the JAX package's ``ops/stitch.py``
(``chunk_state_maps``, ``entry_states``, ``stitched_states``) and the same
three loops inside ``parallel/sharding.py`` ``sharded_arrival_states``, where
each shard is the ``C = 1`` case.  ``rescan(table, cls, entry_fold(
state_maps(table, cls), s0))`` equals the sequential scan of the flattened
classes from ``s0`` bit for bit.  Every table row takes part, padding rows
included, as in the JAX functions.

A wrapper runs the plain twin of its form for tensors on the CPU, and
launches the kernel of its form for tensors on a CUDA device: there is no
fallback from one to the other, nor from one form to the other.
``launches`` (``kernels/build.py``) counts wrapper calls that launched, one
record per form: ``state_maps`` / ``state_maps_all``, ``entry_fold``,
``rescan`` / ``rescan_serial``.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import build, scan_dfa
from ahocorasick_tpu_torch.kernels.build import launches


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(name: str, t: torch.Tensor, dims: int) -> None:
    if t.dtype != torch.int32 or t.dim() != dims:
        raise TypeError(f"{name} must be int32 with {dims} dims, got {t.dtype}{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _one_device(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on several devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_table(table: torch.Tensor) -> None:
    _check("table", table, 2)
    if table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"empty table {tuple(table.shape)}")


def _depth(sync_depth):
    """``sync_depth`` checked: None, or an int >= 1."""
    if sync_depth is None:
        return None
    d = int(sync_depth)
    if d != sync_depth or d < 1:
        raise ValueError(f"sync_depth must be an int >= 1, got {sync_depth!r}")
    return d


def _walk(flat: torch.Tensor, A: int, v: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``v int64[R, S]`` walked over the columns of ``cols int64[R, n]``."""
    for k in range(cols.shape[1]):
        v = flat[v * A + cols[:, k : k + 1]]
    return v


# ------------------------------------------------------------ state maps (B15)


def state_maps(table: torch.Tensor, cls: torch.Tensor, sync_depth=None) -> torch.Tensor:
    """``sigma int32[C, S]`` of the chunks ``cls int32[C, K]``; ``sync_depth``
    None for the first design, else the depth d >= 1 at which the table
    synchronizes (the synchronized form)."""
    _check_table(table)
    _check("cls", cls, 2)
    sync_depth = _depth(sync_depth)
    dev = _one_device(table, cls)
    if dev.type == "cpu":
        return state_maps_plain(table, cls, sync_depth)
    C, K = cls.shape
    S, A = table.shape
    sigma = torch.empty((C, S), dtype=torch.int32, device=dev)
    if C == 0:
        return sigma
    if sync_depth is None:
        build.call("state_maps_all", table.data_ptr(), cls.data_ptr(), C, K, S, A,
                   sigma.data_ptr(), dev.index, _stream(dev))
        launches["state_maps_all"] += 1
    else:
        agree = torch.empty(2 * C, dtype=torch.int32, device=dev)  # set by the entry point
        build.call("state_maps", table.data_ptr(), cls.data_ptr(), C, K, S, A, sync_depth,
                   agree.data_ptr(), sigma.data_ptr(), dev.index, _stream(dev))
        launches["state_maps"] += 1
    return sigma


def state_maps_plain(table: torch.Tensor, cls: torch.Tensor, sync_depth=None) -> torch.Tensor:
    """The plain twin.  First design: a Python loop over the K columns, one
    batched gather over the ``[C, S]`` lanes per column.  Synchronized: the
    kernels' decomposition, phase 1 over the first ``min(K, d + 1)`` columns,
    the agreement test per chunk, then the agreed state over the last (at
    most d) columns, or every lane of a chunk that disagrees over all K."""
    C, K = cls.shape
    S, A = table.shape
    flat = table.reshape(-1).to(torch.int64)
    lanes = torch.arange(S, dtype=torch.int64, device=cls.device).repeat(C, 1)
    c = cls.to(torch.int64)
    if sync_depth is None:
        return _walk(flat, A, lanes, c).to(torch.int32)
    t = min(K, sync_depth + 1)
    v = _walk(flat, A, lanes, c[:, :t])
    lo, hi = v.min(dim=1).values, v.max(dim=1).values
    agreed = lo == hi
    sigma = torch.empty((C, S), dtype=torch.int64, device=cls.device)
    rows = agreed.nonzero().squeeze(1)
    if rows.numel():
        sigma[rows] = _walk(flat, A, lo[rows, None], c[rows, max(t, K - sync_depth):])
    rows = (~agreed).nonzero().squeeze(1)
    if rows.numel():
        sigma[rows] = _walk(flat, A, lanes[rows], c[rows])
    return sigma.to(torch.int32)


# ------------------------------------------------------------ entry fold (B15)


def entry_fold(sigma: torch.Tensor, s0: int = 0) -> torch.Tensor:
    """``entry int32[C]``: the state entering each chunk when chunk 0 is
    entered in ``s0``."""
    s0 = int(s0)
    _check("sigma", sigma, 2)
    C, S = sigma.shape
    if not 0 <= s0 < max(S, 1):
        raise ValueError(f"entry state {s0} outside [0, {S})")
    dev = _one_device(sigma)
    if dev.type == "cpu":
        return entry_fold_plain(sigma, s0)
    entry = torch.empty(C, dtype=torch.int32, device=dev)
    if C == 0:
        return entry
    build.call("entry_fold", sigma.data_ptr(), C, S, s0, entry.data_ptr(), dev.index,
               _stream(dev))
    launches["entry_fold"] += 1
    return entry


def entry_fold_plain(sigma: torch.Tensor, s0: int = 0) -> torch.Tensor:
    """The plain twin: a Python loop over the chunks."""
    s = int(s0)
    out = []
    for c in range(sigma.shape[0]):
        out.append(s)
        if c + 1 < sigma.shape[0]:
            s = int(sigma[c, s])
    return torch.tensor(out, dtype=torch.int32, device=sigma.device)


# ---------------------------------------------------------------- rescan (B15)


def rescan(table: torch.Tensor, cls: torch.Tensor, entry: torch.Tensor,
           sync_depth=None) -> torch.Tensor:
    """``states int32[C, K]``: the arrival states of each chunk of ``cls``
    walked from its ``entry`` state; ``sync_depth`` None for the serial walk
    of each chunk, else the depth d >= 1 at which the table synchronizes
    (the lane scan, one row a chunk)."""
    _check_table(table)
    _check("cls", cls, 2)
    _check("entry", entry, 1)
    sync_depth = _depth(sync_depth)
    C, K = cls.shape
    if entry.shape[0] != C:
        raise ValueError(f"{entry.shape[0]} entry states for {C} chunks")
    dev = _one_device(table, cls, entry)
    if dev.type == "cpu":
        return rescan_plain(table, cls, entry, sync_depth)
    out = torch.empty((C, K), dtype=torch.int32, device=dev)
    if C == 0 or K == 0:
        return out
    A = table.shape[1]
    if sync_depth is None:
        build.call("rescan_serial", table.data_ptr(), cls.data_ptr(), entry.data_ptr(), C, K, A,
                   out.data_ptr(), dev.index, _stream(dev))
        launches["rescan_serial"] += 1
    else:
        build.call("rescan", table.data_ptr(), cls.data_ptr(), entry.data_ptr(), C, K, A,
                   sync_depth, scan_dfa.sync_lane_len(C * K, sync_depth), out.data_ptr(),
                   dev.index, _stream(dev))
        launches["rescan"] += 1
    return out


def rescan_plain(table: torch.Tensor, cls: torch.Tensor, entry: torch.Tensor,
                 sync_depth=None) -> torch.Tensor:
    """The plain twin.  Serial: a Python loop over the K columns, one gather
    over the C chunks per column.  Synchronized: the kernel's
    decomposition, every lane of every chunk stepped together, one batched
    gather per warm-up class and per position of a lane."""
    C, K = cls.shape
    A = table.shape[1]
    flat = table.reshape(-1).to(torch.int64)
    c = cls.to(torch.int64)
    if sync_depth is None or C == 0 or K == 0:
        return scan_dfa.walk_rows(flat, None, A, entry.to(torch.int64), c).to(torch.int32)
    L = scan_dfa.sync_lane_len(C * K, sync_depth)
    per = -(-K // L)
    body = torch.zeros((C, per * L), dtype=torch.int64, device=cls.device)
    body[:, :K] = c
    s = torch.zeros((C, per), dtype=torch.int64, device=cls.device)
    s[:, 0] = entry.to(torch.int64)
    starts = torch.arange(1, per, device=cls.device) * L
    for t in range(sync_depth):  # lanes 1.. of each chunk warm up inside it
        s[:, 1:] = flat[s[:, 1:] * A + body[:, starts - sync_depth + t]]
    # a chunk's last lane's steps past K read class 0 and are cut
    out = scan_dfa.walk_rows(flat, None, A, s.reshape(-1), body.reshape(C * per, L))
    return out.reshape(C, per * L)[:, :K].to(torch.int32)
