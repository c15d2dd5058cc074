"""Chunk stitching via state maps — the port of ``ahocorasick_tpu/ops/stitch.py``.

The reference's stream mode proves that automaton state across a buffer
boundary is a single node pointer (``AhoCorasickMap.java:208-275``).  Split
the text into C chunks, compute for every chunk the state map
``sigma_c : S -> S`` ("entered in state s, this chunk leaves in
``sigma_c[s]``"), fold the maps into each chunk's true entry state, and
re-scan every chunk from its entry state: the arrival states equal the one
sequential scan's bit for bit.

The JAX module composes whole maps with ``associative_scan`` to get the entry
states in log depth; the contract is only the entry vector, which the port's
``entry_fold`` kernel folds by speculate and repair in one block
(``kernels/stitch.py``): each lane folds a run of chunks from the guess that
the map before it is constant, then the lanes whose guess was wrong are
re-folded in order until they meet their records.

Cost.  ``sync_depth=None`` runs the forms for any total transition function
over a dense ``int32[S, A]`` table, the shortest matcher's padded restart
table included: the rescan is speculate and repair with one row a chunk
(each chunk's sub-chunks walked in parallel, then repaired in order where
their true entry differs), and the map pass walks each chunk's run from the
root the same way and then each of the S lanes only until it meets that
run, after which it leaves as the run does: on a goto closure within d + 1
characters, on the restart table a few characters past the next match, the
whole chunk only for a lane that never meets it (a sink).  ``sync_depth=d``
declares the table d-synchronizing from every state reachable from the root
(a goto closure, d = ``max(max_depth, 1)``; ``s0`` reachable or a
zero-filled padding row): the maps then cost S·(d + 1) + d lookups a chunk,
since every lane agrees after d + 1 characters, and the rescan is the lane
scan of ``seq_states`` with one row a chunk.  The outputs are the same
either way.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import stitch as kernels


def chunk_state_maps(dfa_next: torch.Tensor, cls_chunks: torch.Tensor,
                     sync_depth=None) -> torch.Tensor:
    """sigma maps for each chunk: (C, K) classes -> (C, S) exit states."""
    return kernels.state_maps(dfa_next, cls_chunks, sync_depth)


def entry_states(sigma: torch.Tensor, s0: int = 0) -> torch.Tensor:
    """Entry state of each chunk given the per-chunk maps.

    ``s0``: the automaton state entering chunk 0 (root by default; a carried
    stream-cursor state when stitching mid-stream buffers)."""
    return kernels.entry_fold(sigma, s0)


def stitched_states(dfa_next: torch.Tensor, cls_chunks: torch.Tensor,
                    entry: torch.Tensor, sync_depth=None) -> torch.Tensor:
    """Re-scan each chunk from its true entry state: (C, K) arrival states."""
    return kernels.rescan(dfa_next, cls_chunks, entry, sync_depth)


def stitched_scan(dfa_next: torch.Tensor, cls_chunks: torch.Tensor, s0: int = 0,
                  sync_depth=None) -> torch.Tensor:
    """Full pipeline: chunked classes (C, K) -> exact arrival states (C, K)."""
    if cls_chunks.shape[0] == 0:
        return torch.zeros_like(cls_chunks, dtype=torch.int32)
    sigma = chunk_state_maps(dfa_next, cls_chunks, sync_depth)
    entry = entry_states(sigma, s0)
    return stitched_states(dfa_next, cls_chunks, entry, sync_depth)
