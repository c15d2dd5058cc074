"""Chunk stitching via state maps — the port of ``ahocorasick_tpu/ops/stitch.py``.

The reference's stream mode proves that automaton state across a buffer
boundary is a single node pointer (``AhoCorasickMap.java:208-275``).  Split
the text into C chunks, compute for every chunk the state map
``sigma_c : S -> S`` ("entered in state s, this chunk leaves in
``sigma_c[s]``") by scanning all S lanes at once, fold the maps into each
chunk's true entry state, and re-scan every chunk from its entry state: the
arrival states equal the one sequential scan's bit for bit.

The JAX module composes whole maps with ``associative_scan`` to get the entry
states in log depth; the contract is only the entry vector, which the port's
``entry_fold`` kernel walks as one serial chain (``kernels/stitch.py``).

Cost: the map pass does S lanes of work per character, so this suits small
automata or validation.  It works for any total transition function over a
dense ``int32[S, A]`` table, the shortest matcher's padded ``dfa_next``
included.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import stitch as kernels


def chunk_state_maps(dfa_next: torch.Tensor, cls_chunks: torch.Tensor) -> torch.Tensor:
    """sigma maps for each chunk: (C, K) classes -> (C, S) exit states."""
    return kernels.state_maps(dfa_next, cls_chunks)


def entry_states(sigma: torch.Tensor, s0: int = 0) -> torch.Tensor:
    """Entry state of each chunk given the per-chunk maps.

    ``s0``: the automaton state entering chunk 0 (root by default; a carried
    stream-cursor state when stitching mid-stream buffers)."""
    return kernels.entry_fold(sigma, s0)


def stitched_states(dfa_next: torch.Tensor, cls_chunks: torch.Tensor,
                    entry: torch.Tensor) -> torch.Tensor:
    """Re-scan each chunk from its true entry state: (C, K) arrival states."""
    return kernels.rescan(dfa_next, cls_chunks, entry)


def stitched_scan(dfa_next: torch.Tensor, cls_chunks: torch.Tensor, s0: int = 0) -> torch.Tensor:
    """Full pipeline: chunked classes (C, K) -> exact arrival states (C, K)."""
    if cls_chunks.shape[0] == 0:
        return torch.zeros_like(cls_chunks, dtype=torch.int32)
    sigma = chunk_state_maps(dfa_next, cls_chunks)
    entry = entry_states(sigma, s0)
    return stitched_states(dfa_next, cls_chunks, entry)
