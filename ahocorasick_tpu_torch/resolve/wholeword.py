"""Chain resolution for the whole-word-longest engine (the port's copy of
``ahocorasick_tpu/resolve/wholeword.py``).

Given per-lane walk outcomes from ``ops/scan_wwl.py``, reproduce the
sequential restart chain: the reference resumes after the word containing
the die position (``WholeWordLongestMatchSet.java:91-99``), which for every
die position ``p`` is simply the first word start strictly greater than
``p`` — both die-on-word (skip rest of word, then separators) and
die-on-non-word (skip separators) land there.

The chain follower is a tight integer loop over at most one step per
executed walk; a C++ implementation backs it for large corpora with a
pure-Python fallback.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def word_starts(is_word: np.ndarray) -> np.ndarray:
    """Positions where a maximal word run begins."""
    if len(is_word) == 0:
        return np.zeros(0, dtype=np.int64)
    prev = np.concatenate([[False], is_word[:-1]])
    return np.nonzero(is_word & ~prev)[0].astype(np.int64)


def boundary_filter(class_is_word, cls: np.ndarray, starts, ends, vals):
    """Keep the AC candidates flanked by non-word chars or text edges — the
    whole-word equivalence for pure-word-char keywords (one candidate per
    maximal word run, ``WholeWordMatchSet.java:47-132`` semantics);
    the ONE filter shared by the matcher device path and the sharded/TP
    scanners."""
    is_word = np.asarray(class_is_word)[cls]
    n = len(cls)
    left_ok = (starts == 0) | ~is_word[np.maximum(starts - 1, 0)]
    right_ok = (ends == n) | ~is_word[np.minimum(ends, n - 1)]
    keep = left_ok & right_ok
    return starts[keep], ends[keep], vals[keep]


def follow_chain(
    die_pos: np.ndarray,
    has: np.ndarray,
    m_start: np.ndarray,
    m_end: np.ndarray,
    m_val: np.ndarray,
    ws: np.ndarray,
    n: int,
) -> List[Tuple[int, int, int]]:
    """Walk the restart chain from position 0, collecting emitted matches."""
    try:
        from ahocorasick_tpu_torch.native import lib as native_lib
    except Exception:
        native_lib = None
    if native_lib is not None and native_lib.available():
        return native_lib.follow_chain(die_pos, has, m_start, m_end, m_val, ws, n)
    out: List[Tuple[int, int, int]] = []
    i = 0
    while i < n:
        if has[i]:
            out.append((int(m_start[i]), int(m_end[i]), int(m_val[i])))
        p = int(die_pos[i])
        j = int(np.searchsorted(ws, p, side="right"))
        if j >= len(ws):
            break
        i = int(ws[j])
    return out
