"""Lookup-primitive probes on the card — the port of ``tools/probes/``
(``probe.py``, ``probe2.py``, ``probe3.py``, ``probe6.py``): the same
function names, each timing one transition primitive on a hand-written
kernel of ``kernels/probes.py`` (``csrc/probes.cu``).

    python -m ahocorasick_tpu_torch.probes                  # on the card
    python -m ahocorasick_tpu_torch.probes --platform cpu   # the twins, small

On the TPU these probes chose between lane shuffles, VMEM loads and the MXU;
here they give the H100's lookup rate per table placement (warp registers,
shared memory, L2, device memory), the ceiling of the scan kernels' one
dependent load per character (``__main__.residency_sweep``).  Each probe
draws its inputs with the calls of its JAX counterpart from ``rng`` (a
``np.random.RandomState``, or a ``Generator`` where the JAX probe uses one),
so that a test seeding both sees the same arrays, and runs on ``device``
(None: CUDA, raising without it).  Timing is CUDA events on the card, the
host clock on the CPU (``bench._elapsed``): best of 3 after a warm-up
(``probe._timeit``), or the paired difference of two rep counts
(``probe3.timeit2``, ``bench._best_pair``).
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 0


def resolve(rng, device):
    """``(rng, device)``: a seeded ``RandomState`` for None, and CUDA for
    None (raising without it)."""
    from ahocorasick_tpu_torch.models.matchers import _resolve_device

    return (np.random.RandomState(SEED) if rng is None else rng), _resolve_device(device)


def draw(rng, low: int, high: int, shape, dtype=None) -> np.ndarray:
    """``rng.randint`` (RandomState, as ``np.random.randint``) or
    ``rng.integers`` (Generator), with the JAX probes' arguments."""
    if hasattr(rng, "randint"):
        return rng.randint(low, high, shape) if dtype is None else rng.randint(low, high, shape,
                                                                               dtype)
    return rng.integers(low, high, size=shape) if dtype is None else rng.integers(
        low, high, size=shape, dtype=dtype)


def tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` (uint32 through an int32 view)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).to(device).view(torch.uint32)
    return torch.from_numpy(arr).to(device)
