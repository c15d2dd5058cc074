"""PFAC v2, the gather-minimized failureless scan — the port of
``ahocorasick_tpu/ops/scan_pfac2.py``, the ``device_engine="pfac2"``
cross-check engine.

* **Match-contiguous renumbering** — state ids are permuted so that the root
  is 0 and all own-match states form the tail range ``[match_threshold, S)``:
  ``is_match[s]`` becomes ``s >= threshold``, a compare, not a lookup.
* **Prefix-k jump table** — the first ``k`` depth steps from the root are
  precomputed for every k-gram of alphabet classes: ``prefix[(c0*A+c1)...]``
  packs the arrival state with the depth-1..k match bits in the top bits of a
  uint32.  ``k`` adapts to the alphabet so the table stays small.

Work per lane for max depth d: ``1 + max(d - k, 0)`` dependent loads (v1:
``d`` and as many ``is_match`` lookups), on ``csrc/pfac_scan.cu``
(``kernels/scan_pfac``).  The output equals v1's bit for bit; padding uses
``PAD_CLASS`` exactly as v1 (the pad class has no trie edge, so prefix
entries through it land at DEAD and carry no match bits).  The table
builders are numpy, byte for byte the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ahocorasick_tpu_torch.core.compiler import CompiledMatcher
from ahocorasick_tpu_torch.kernels import scan_pfac as kernels
from ahocorasick_tpu_torch.ops.scan_pfac import PAD_CLASS, pad_classes  # noqa: F401 — ONE padding contract

_STATE_BITS = kernels.STATE_BITS
_STATE_MASK = (1 << _STATE_BITS) - 1  # low bits: ranked state id
_MAX_PREFIX_ENTRIES = 1 << 20


class RankedTables(NamedTuple):
    """Layout of the v2 engine: numpy from ``build_ranked``, tensors on the
    device in ``_DeviceTables.ranked``."""

    trie_next: np.ndarray  # uint32[S+1, A] ranked ids (row order ranked too)
    prefix: np.ndarray  # uint32[A^k] packed (state | match bits << _STATE_BITS)
    prefix_k: int
    match_threshold: int  # ranked id of the first own-match state
    num_states: int  # S+1 rows
    dead_state: int  # ranked id of the absorbing DEAD state


def rank_states(m: CompiledMatcher) -> np.ndarray:
    """Permutation old_id -> ranked_id: root 0, non-match (incl. DEAD) next,
    own-match states contiguous at the top."""
    S = m.num_states
    is_match = m.own_len[: S + 1] > 0  # includes DEAD row (False)
    ranked = np.empty(S + 1, dtype=np.int64)
    ids = np.arange(S + 1)
    order = np.concatenate([ids[~is_match], ids[is_match]])  # root stays first
    ranked[order] = np.arange(S + 1)
    assert ranked[0] == 0  # root is state 0 and never a match
    return ranked


def build_ranked(m: CompiledMatcher, max_entries: int = _MAX_PREFIX_ENTRIES) -> RankedTables:
    S, A = m.num_states, m.num_classes
    ranked = rank_states(m)
    threshold = int(S + 1 - int((m.own_len[: S + 1] > 0).sum()))

    # Row-permuted, value-mapped transition table.
    inv = np.empty(S + 1, dtype=np.int64)
    inv[ranked] = np.arange(S + 1)
    trie_ranked = ranked[m.trie_next[inv]].astype(np.uint32)

    # Prefix-k jump table over alphabet k-grams (walked on the trie).
    k = 1
    while k < 3 and (A ** (k + 1)) <= max_entries and k + 1 <= max(m.max_depth, 1):
        k += 1
    states = trie_ranked[0]  # depth-1 states for each class, shape (A,)
    packed = states | (states >= threshold).astype(np.uint32) << np.uint32(_STATE_BITS)
    for depth in range(2, k + 1):
        nxt = trie_ranked[packed & _STATE_MASK]  # (A^(depth-1), A)
        bits = (packed >> np.uint32(_STATE_BITS)) << np.uint32(1)  # shift history
        packed = (
            nxt
            | (bits[:, None] << np.uint32(_STATE_BITS))
            | (nxt >= threshold).astype(np.uint32) << np.uint32(_STATE_BITS)
        ).reshape(-1)
    # Bit layout after k steps: bit (_STATE_BITS + j) == match at depth k - j.
    return RankedTables(
        trie_next=trie_ranked,
        prefix=packed.astype(np.uint32),
        prefix_k=k,
        match_threshold=threshold,
        num_states=S + 1,
        dead_state=int(ranked[S]),
    )


def pfac2_bitplanes(trie_next: torch.Tensor, prefix: torch.Tensor, threshold: int,
                    cls_padded: torch.Tensor, max_depth: int, num_planes: int, prefix_k: int,
                    num_classes: int, dead_state: int) -> torch.Tensor:
    """``uint32[num_planes, N]`` match bitplanes, identical to v1's output;
    lanes stop at ``dead_state`` (``RankedTables.dead_state``).  Raises ``ValueError``
    for ``max_depth < prefix_k`` (the k-gram entry would be the wrong
    gram's, silently dropping every match)."""
    return kernels.pfac2_planes(trie_next, prefix, threshold, cls_padded, max_depth, num_planes,
                                prefix_k, num_classes, dead_state)


def pfac2_count(trie_next: torch.Tensor, prefix: torch.Tensor, threshold: int,
                cls_padded: torch.Tensor, max_depth: int, prefix_k: int, num_classes: int,
                dead_state: int) -> torch.Tensor:
    """Total match count (the empty-listener analog), an int64 scalar tensor."""
    return kernels.pfac2_count(trie_next, prefix, threshold, cls_padded, max_depth, prefix_k,
                               num_classes, dead_state)
