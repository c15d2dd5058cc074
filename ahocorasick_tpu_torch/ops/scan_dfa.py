"""Sequential DFA scans — the port of ``ahocorasick_tpu/ops/scan_dfa.py``:
``dfa_states`` (arrival states from an entry state, the dense case of
``kernels/scan_dfa.seq_states``) and the ``shortest_states`` path of the
leftmost-shortest matcher.

The reference's lagged restart (``ShortestMatchSet.java:182-260``) makes the
state depend on where earlier matches ended, so the scan is one sequential
walk (``kernels/scan_dfa.shortest_states``).  The shortest matcher runs it
only for artifacts loaded without their internal AC automaton; with one, it
takes the parallel planes scan and a host resolve instead.
"""

from __future__ import annotations

import numpy as np

from ahocorasick_tpu_torch.kernels import scan_dfa as kernels
from ahocorasick_tpu_torch.ops import emit, scan_batched
from ahocorasick_tpu_torch.ops.scan_pfac import pad_classes


def dfa_states(dfa_next, cls, s0: int = 0):
    """Arrival states ``s_1 .. s_N`` for one stream (int32[N]) over a dense
    ``int32[S, A]`` table, from the entry state ``s0``."""
    return kernels.seq_states(dfa_next, None, cls, s0)


def shortest_triples(m, dev, cls: np.ndarray):
    """Shortest-match ``(starts, ends, vals)`` of ``cls`` from the arrival
    states of the restart-loop scan over ``dev``'s padded tables."""
    n = len(cls)
    cls_d = scan_batched.classes_to_device(pad_classes(cls, 0), m.num_classes, dev.device)
    states = kernels.shortest_states(dev.dfa_next, dev.match_len, cls_d)
    return emit.states_to_shortest_matches(m, states[:n].cpu().numpy())
