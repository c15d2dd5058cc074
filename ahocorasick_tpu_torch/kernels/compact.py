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
is one launch of a single-pass scan with decoupled look-back: each tile of
positions reads its planes once, learns the hot positions of the tiles
before it from their published descriptors, and writes its own hot
positions at their ranks, so the order is ascending by construction.  The
wrapper sizes the outputs for ``min(limit, N)`` hot positions (``N`` when
``limit`` is None) before the launch and reads the total once after it (the
one synchronisation, as ``planes_to_sparse`` has in the JAX package).

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
    cap = N if limit is None else max(0, min(limit, N))
    num_tiles = max(1, -(-N // build.library().compact_tile()))
    # The tiles' descriptors, the tile counter and the total; the launcher
    # zeroes the first two.
    desc = torch.empty(num_tiles + 2, dtype=torch.int64, device=dev)
    idx = torch.empty(cap, dtype=torch.int64, device=dev)
    masks = torch.empty((cap, P), dtype=torch.uint32, device=dev)
    build.call("compact_planes", bits.data_ptr(), P, N, cap, desc.data_ptr(), idx.data_ptr(),
               masks.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    launches["compact_planes"] += 1
    total = desc[-1]
    count = int(total.item())  # the one host read
    if limit is not None and count > limit:
        return None
    return total, idx[:count], masks[:count]


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
