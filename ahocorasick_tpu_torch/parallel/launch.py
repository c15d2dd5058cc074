"""Multi-process launch glue — the port of ``ahocorasick_tpu/parallel/launch.py``.

The reference is a single-JVM library; its only concurrency story is that
constructed matchers are immutable and may be shared across reader threads.
Here a corpus scan scales across processes with ``torch.distributed``: one
rank per process, each on its own device, handed to the ``group=`` form of
the functions of ``parallel/sharding.py``.  This module is the bring-up glue:

* ``initialize`` — idempotent ``torch.distributed`` set-up from the
  environment a launcher such as ``torchrun`` provides (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or from explicit
  arguments; a no-op for single-process runs.  Afterwards the group to pass
  as ``group=`` is ``torch.distributed.group.WORLD``.
* ``global_data_mesh`` — the 1-axis mesh of the devices this process drives
  (a list of devices, as everywhere in ``parallel/sharding.py``).  A
  multi-process job does not hold one mesh object: each process passes its
  group instead, and the ranks' order is the shards' order.
* ``prepare_process_local`` — the sharded class array from this process's
  local text shard, without the full corpus ever lying in one process.
  Global match offsets are recovered from the returned unit offset, as
  matches are shard-local once the halo fixes the entry states (the
  stream-mode invariant, ``AhoCorasickMap.java:208-275``).

After ``initialize``, ``group=torch.distributed.group.WORLD`` (or its 2-axis
layout, ``sharding.dp_tp_groups()``) drives both facades,
``sharding.ShardedScanner`` and ``sharding.TableShardedScanner``, on CPU
ranks and on CUDA ranks, each rank on its own device; the table-sharded one
runs the step kernel of ``kernels/table_sharded.py`` with an ``all_reduce`` a
character.  Run: gloo on CPU ranks, NCCL at world 1 and gloo with CUDA
tensors at worlds 2 and 4 on one card; NCCL at world > 1 is unverified.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ahocorasick_tpu_torch.parallel import sharding

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    **kwargs,
) -> bool:
    """Bring up ``torch.distributed`` if this looks like a multi-process job.

    Returns True when the default process group is (or already was)
    initialized in this process.  Explicit arguments win over the
    environment: ``coordinator_address`` is ``host:port`` (or a whole
    ``init_method`` URL such as ``file:///path``), ``num_processes`` the world
    size and ``process_id`` this rank; what is left out is read from
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  With no
    explicit argument and no such environment this is a no-op returning
    False, and touches no backend.  ``backend`` defaults to NCCL when CUDA is
    available, else gloo; further keyword arguments go to
    ``init_process_group``.  Calling twice is safe."""
    import torch.distributed as dist

    explicit = (
        coordinator_address is not None
        or num_processes not in (None, 1)
        or process_id is not None
    )
    env = all(os.environ.get(k) for k in _ENV)
    if not explicit and not env:
        return bool(dist.is_available() and dist.is_initialized())
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        if not addr:
            raise ValueError("no coordinator address: pass coordinator_address or set "
                             "MASTER_ADDR (and MASTER_PORT)")
        coordinator_address = f"{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    world = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kwargs)
    return True


def global_data_mesh(devices=None):
    """1-axis mesh over every device this process drives (default: every
    visible CUDA device)."""
    return sharding.data_mesh(devices)


def prepare_process_local(
    cls_local: np.ndarray,
    mesh,
    local_units: int,
    chunk: int = 512,
    *,
    num_classes: int,
    group=None,
    device=None,
) -> Tuple[dict, int]:
    """The sharded class array from this process's local shard, in the form
    the ``count`` of ``sharding.make_sharded_counter`` takes.

    Every process passes its own contiguous slice of the corpus (in class
    space, ``matcher._classes``), the common per-process capacity
    ``local_units`` (identical across processes and a multiple of
    ``chunk`` x the number of devices this process drives; shorter final
    shards are padded with the non-advancing class 0) and the dictionary's
    ``num_classes`` (the classes are uploaded in its narrow dtype).  Returns
    ``(shards, unit_offset)``: ``shards`` maps each rank this process drives
    to its classes on its device, and ``unit_offset`` is the global position
    of this process's first unit; add it to shard-local match positions.

    A single-process job passes its ``mesh`` (a list of devices) and gets
    every shard at offset 0, so the same launch code runs everywhere.  A
    multi-process job passes ``group=`` (and this rank's ``device``; None
    means CUDA): rank r holds the units from ``r * local_units`` on, and the
    ranks check that they were all given the same ``local_units``, since a
    rank with another capacity would shift every later rank's offsets."""
    from ahocorasick_tpu_torch.models.matchers import _resolve_device

    sh = sharding._Shards(mesh, group, None if group is None else _resolve_device(device))
    if group is not None:
        import torch.distributed as dist

        mine = torch.tensor([int(local_units)], dtype=torch.int64, device=sh.devices[sh.ranks[0]])
        every = [torch.zeros_like(mine) for _ in range(sh.world)]
        dist.all_gather(every, mine, group=group)
        if len({int(t) for t in every}) != 1:
            raise ValueError(
                f"local_units differs between ranks ({[int(t) for t in every]}); "
                "unit_offset would not match the shard placement")
    n_local = len(sh.ranks)
    if local_units % (chunk * n_local) != 0:
        raise ValueError(
            f"local_units ({local_units}) must be a multiple of chunk x "
            f"local device count ({chunk} x {n_local})")
    if len(cls_local) > local_units:
        raise ValueError("cls_local longer than local_units")
    padded = np.zeros(local_units, dtype=np.int32)
    padded[: len(cls_local)] = cls_local
    if group is None:
        return sh.scatter(padded, num_classes), 0
    rank = sh.ranks[0]
    shard = sharding.scan_batched.classes_to_device(padded, num_classes, sh.devices[rank])
    return {rank: shard}, rank * local_units
