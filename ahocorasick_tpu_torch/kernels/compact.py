"""Hot-position compaction of END-indexed emit planes: the Hopper kernel and
its plain PyTorch twin.

``compact_planes(bits, limit)`` takes planes ``uint32[P, N]`` and returns
``(count, idx, masks)``: the number of positions with any emit bit as an
int64 scalar tensor, their indices ascending (``int64[count]``) and their
masks hot-major (``uint32[count, P]``), all on the planes' device.  It
returns None when ``count`` exceeds ``limit``: the caller then downloads the
dense planes instead.

The kernel (``csrc/compact.cu``) replaces the JAX package's
``ops/scan_batched.py`` ``_compact_planes`` (``jnp.nonzero`` under XLA).  It
counts hot positions per block, scans the block counts into offsets, reads
the total on the host (the one synchronisation, which sizes the outputs and
applies ``limit``) and then writes each block's hot positions at its offset,
so the order is ascending by construction.

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches["compact_planes"]`` counts one per kernel run.
"""

from __future__ import annotations

from typing import Optional

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches


def _check(bits: torch.Tensor):
    if bits.dtype != torch.uint32 or bits.dim() != 2:
        raise TypeError(f"planes must be uint32[P, N], got {bits.dtype}{tuple(bits.shape)}")
    if not bits.is_contiguous():
        raise ValueError("planes must be contiguous")
    if bits.shape[0] < 1:
        raise ValueError("planes need P >= 1")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bits.device}")
    return bits.shape


def compact_planes(bits: torch.Tensor, limit: Optional[int] = None):
    """``(count, idx, masks)`` of the hot positions, or None above ``limit``."""
    P, N = _check(bits)
    if bits.device.type == "cpu":
        return compact_planes_plain(bits, limit)
    dev = bits.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    num_blocks = -(-N // build.library().compact_tile())
    block_counts = torch.empty(num_blocks, dtype=torch.int32, device=dev)
    offsets = torch.empty(num_blocks, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    build.call("compact_count", bits.data_ptr(), P, N, block_counts.data_ptr(),
               offsets.data_ptr(), total.data_ptr(), dev.index, stream)
    launches["compact_planes"] += 1
    count = int(total.item())  # the host read that sizes the outputs
    if limit is not None and count > limit:
        return None
    idx = torch.empty(count, dtype=torch.int64, device=dev)
    masks = torch.empty((count, P), dtype=torch.uint32, device=dev)
    if count:
        build.call("compact_write", bits.data_ptr(), P, N, offsets.data_ptr(),
                   idx.data_ptr(), masks.data_ptr(), dev.index, stream)
    return total[0], idx, masks


def compact_planes_plain(bits: torch.Tensor, limit: Optional[int] = None):
    """The plain twin: ``!= 0`` over the planes, ``nonzero``, a gather."""
    words = bits.view(torch.int32)  # same bits; int32 has every op needed
    hot = (words != 0).any(dim=0)
    count = hot.sum()
    if limit is not None and int(count) > limit:
        return None
    idx = torch.nonzero(hot).squeeze(1)
    masks = words[:, idx].T.contiguous().view(torch.uint32)
    return count, idx, masks
