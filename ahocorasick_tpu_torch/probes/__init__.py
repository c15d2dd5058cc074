"""Lookup-primitive probes on the card — the port of ``tools/probes/``
(``probe.py`` to ``probe10_tp.py``): the same function names, each timing
one transition primitive on a hand-written kernel of ``kernels/probes.py``
(``csrc/probes.cu``), or (``probe7``'s part A, ``probe9_scaling``,
``probe10_tp``) the port's scan kernels; ``probe8_minimize`` is host numpy.

    python -m ahocorasick_tpu_torch.probes                  # on the card
    python -m ahocorasick_tpu_torch.probes --platform cpu   # the twins, small
    python -m ahocorasick_tpu_torch.probes --widths         # probe6's row widths
    python -m ahocorasick_tpu_torch.probes.probe4           # likewise probe5, probe7,
                                                            # probe8_minimize, probe9_scaling,
                                                            # probe10_tp

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
(``probe3.timeit2``, ``bench._best_pair``); ``card_seconds`` times the card
alone, for calls whose launches take the host longer than the card.
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 0
HOLD_CYCLES = 20_000_000  # about 10 ms of the card's clock: the host's enqueue fits in it


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


def sum32(t: torch.Tensor) -> torch.Tensor:
    """The int32 sum of an integer tensor, wrapping as ``jnp.sum`` of int32
    does (a scalar tensor on ``t``'s device)."""
    x = t.to(torch.int64).sum() & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def card_seconds(run, device) -> float:
    """Seconds of one ``run()`` on the card alone: queued behind a spin of
    ``HOLD_CYCLES`` while the host enqueues it, so that CUDA events see its
    launches back to back and no host time.  A paired difference of rep
    counts needs this where the smaller call takes the host longer to launch
    than the card to run: the host's time then hides the card's.  The host
    clock on the CPU."""
    from ahocorasick_tpu_torch.bench import _elapsed

    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda._sleep(HOLD_CYCLES)
    return _elapsed(run, 1, device)
