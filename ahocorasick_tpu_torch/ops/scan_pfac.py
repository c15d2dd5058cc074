"""Failureless parallel trie scan, v1 — the port of
``ahocorasick_tpu/ops/scan_pfac.py``.

Every text position is an independent lane that walks the pure trie (no fail
links) until it dies; every keyword occurrence starting at position ``i``
lies on the trie path spelled by ``text[i:]``, so the union of the lanes'
emissions is the all-matches output.  Emissions are START-indexed depth
bitplanes: bit ``k`` of plane word ``p`` at position ``i`` means a keyword of
length ``32*p + k + 1`` starts at ``i`` (``ops/emit.ac_matches`` turns them
into triples).

Inputs are alphabet classes padded on the right with ``PAD_CLASS`` (class 0:
no trie edge carries it, so padding kills every lane without emitting).  The
walk is ``csrc/pfac_scan.cu``'s v1 mode (``kernels/scan_pfac.pfac1_planes``);
the JAX package calls it only from its tests, as the reference the v2 walk
(``ops/scan_pfac2.py``) is held to.
"""

from __future__ import annotations

import numpy as np
import torch

from ahocorasick_tpu_torch.kernels import scan_pfac as kernels

PAD_CLASS = 0


def pad_classes(cls, max_depth: int, bucket: int = 1) -> np.ndarray:
    """Right-pad a class array so every lane can read ``max_depth`` chars,
    the lane count rounded up to ``bucket`` (padded lanes die on
    ``PAD_CLASS`` and emit nothing)."""
    cls = np.asarray(cls)
    n = len(cls)
    n_pad = -(-max(n, 1) // bucket) * bucket
    return np.pad(cls, (0, n_pad - n + max_depth), constant_values=PAD_CLASS)


def pfac_bitplanes(trie_next: torch.Tensor, is_match: torch.Tensor, cls_padded: torch.Tensor,
                   max_depth: int, num_planes: int, dead_state: int) -> torch.Tensor:
    """``uint32[num_planes, N]`` match bitplanes, ``N = len(cls_padded) -
    max_depth``; ``trie_next`` ``[S, A]``, ``is_match`` ``bool[S]``.  Lanes
    stop at ``dead_state``, an absorbing non-match state (the padded table's
    last row)."""
    return kernels.pfac1_planes(trie_next, is_match, cls_padded, max_depth, num_planes,
                                dead_state)
