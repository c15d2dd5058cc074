"""Chunk stitching by state maps: the Hopper kernels and their plain PyTorch
twins.

Three kernels (``csrc/stitch.cu``) over a dense ``int32[S, A]`` transition
table and ``int32[C, K]`` chunked classes:

* ``state_maps(table, cls)`` returns ``sigma int32[C, S]``: ``sigma[c, s]``
  is the state reached from ``s`` over chunk ``c`` (S lanes of work per
  class);
* ``entry_fold(sigma, s0)`` returns ``entry int32[C]``: ``entry[0] = s0``,
  ``entry[c] = sigma[c - 1][entry[c - 1]]``, the state in which the one
  sequential scan enters each chunk;
* ``rescan(table, cls, entry)`` returns ``states int32[C, K]``: chunk ``c``
  walked from ``entry[c]``.

Together they replace the JAX package's ``ops/stitch.py``
(``chunk_state_maps``, ``entry_states``, ``stitched_states``) and the same
three loops inside ``parallel/sharding.py`` ``sharded_arrival_states``, where
each shard is the ``C = 1`` case.  ``rescan(table, cls, entry_fold(
state_maps(table, cls), s0))`` equals the sequential scan of the flattened
classes from ``s0`` bit for bit.  Every table row takes part, padding rows
included, as in the JAX functions.

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import build
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


# ------------------------------------------------------------ state maps (B15)


def state_maps(table: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """``sigma int32[C, S]`` of the chunks ``cls int32[C, K]``."""
    _check_table(table)
    _check("cls", cls, 2)
    dev = _one_device(table, cls)
    if dev.type == "cpu":
        return state_maps_plain(table, cls)
    C, K = cls.shape
    S, A = table.shape
    sigma = torch.empty((C, S), dtype=torch.int32, device=dev)
    if C == 0:
        return sigma
    build.call("state_maps", table.data_ptr(), cls.data_ptr(), C, K, S, A, sigma.data_ptr(),
               dev.index, _stream(dev))
    launches["state_maps"] += 1
    return sigma


def state_maps_plain(table: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """The plain twin: a Python loop over the K columns, one batched gather
    over the ``[C, S]`` lanes per column."""
    C, K = cls.shape
    S, A = table.shape
    flat = table.reshape(-1)
    v = torch.arange(S, dtype=torch.int64, device=cls.device).repeat(C, 1)
    c = cls.to(torch.int64)
    for k in range(K):
        v = flat[v * A + c[:, k : k + 1]].to(torch.int64)
    return v.to(torch.int32)


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


def rescan(table: torch.Tensor, cls: torch.Tensor, entry: torch.Tensor) -> torch.Tensor:
    """``states int32[C, K]``: the arrival states of each chunk of ``cls``
    walked from its ``entry`` state."""
    _check_table(table)
    _check("cls", cls, 2)
    _check("entry", entry, 1)
    C, K = cls.shape
    if entry.shape[0] != C:
        raise ValueError(f"{entry.shape[0]} entry states for {C} chunks")
    dev = _one_device(table, cls, entry)
    if dev.type == "cpu":
        return rescan_plain(table, cls, entry)
    out = torch.empty((C, K), dtype=torch.int32, device=dev)
    if C == 0 or K == 0:
        return out
    build.call("rescan", table.data_ptr(), cls.data_ptr(), entry.data_ptr(), C, K,
               table.shape[1], out.data_ptr(), dev.index, _stream(dev))
    launches["rescan"] += 1
    return out


def rescan_plain(table: torch.Tensor, cls: torch.Tensor, entry: torch.Tensor) -> torch.Tensor:
    """The plain twin: a Python loop over the K columns, one gather over the
    C chunks per column."""
    C, K = cls.shape
    A = table.shape[1]
    flat = table.reshape(-1)
    s = entry.to(torch.int64)
    c = cls.to(torch.int64)
    out = torch.empty((C, K), dtype=torch.int32, device=cls.device)
    for k in range(K):
        nxt = flat[s * A + c[:, k]]
        out[:, k] = nxt
        s = nxt.to(torch.int64)
    return out
