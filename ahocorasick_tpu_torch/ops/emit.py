"""END-indexed emit planes -> resolved non-overlapping triples — the port of
``ahocorasick_tpu/ops/emit.py``'s ``resolve_end_planes``, for the
``"planes"`` and ``"hotstate"`` layouts.

The JAX function imports the JAX ``scan_batched`` for its compaction, so the
port keeps its own copy of the steps over the port's compaction
(``ops/scan_batched.planes_to_sparse`` / ``hotstate_sparse``); the rest of
that module is host code and is imported as it is.
"""

from __future__ import annotations

import numpy as np

from ahocorasick_tpu.core.compiler import CompiledMatcher
from ahocorasick_tpu.native import lib as native_lib
from ahocorasick_tpu.resolve.queue import resolve_longest, resolve_shortest
from ahocorasick_tpu_torch.ops import scan_batched


def resolve_end_planes(m: CompiledMatcher, cls: np.ndarray, bits, mode: str,
                       layout: str = "planes"):
    """``(starts, ends, vals)`` of the leftmost-longest (``mode="longest"``)
    or leftmost-shortest (``"shortest"``) matches from ``bits`` (a device
    tensor from a planes kernel, or a host array): END-indexed emit planes
    (``layout="planes"``) or the packed (state, count) plane of the hotstate
    kernel (``"hotstate"``).

    With the native library, extraction and the greedy resolve are fused in
    C over the compacted hot positions (only they are downloaded), or over
    the dense planes when compaction does not pay; values are then re-walked
    over just the accepted spans.  Without it, all candidates are extracted
    and resolved in numpy."""
    n = len(cls)
    if native_lib.available():
        if layout == "hotstate":
            sp = scan_batched.hotstate_sparse(m, bits, n)
        else:
            sp = scan_batched.planes_to_sparse(bits, n)
        if sp is not None:
            starts, ends = native_lib.extract_resolve_sparse(sp[0], sp[1], n, m.max_depth, mode)
        else:
            starts, ends = native_lib.extract_resolve(
                scan_batched.to_host(bits), n, m.max_depth, mode)
        return starts, ends, scan_batched._ac_vals(m, cls, starts, ends)
    trip = scan_batched.ac_matches_batched(m, cls, bits, layout=layout)
    return (resolve_longest if mode == "longest" else resolve_shortest)(*trip)
