"""Sequential gold-model engines: the executable semantic spec (the port's
copy of ``ahocorasick_tpu/core/gold.py``).

Each function mirrors one reference match loop statement-for-statement in
plain Python over the compiled tables, and returns the full ordered list of
``(start, end, value_id)`` triples (UTF-16 unit offsets, ``end`` exclusive,
``value_id`` is -1 for set matchers).  Device engines (the CUDA
kernels and their plain twins) are conformance-tested against these outputs byte-for-byte.

Reference loops mirrored here:

* ``gold_ac``                  — ``AhoCorasickSet.match``            (AhoCorasickSet.java:193-252)
* ``gold_longest``             — ``LongestMatchSet.match``           (LongestMatchSet.java:192-265)
* ``gold_shortest``            — ``ShortestMatchSet.match``          (ShortestMatchSet.java:182-260)
* ``gold_whole_word``          — ``WholeWordMatchSet.match``         (WholeWordMatchSet.java:47-132)
* ``gold_whole_word_longest``  — ``WholeWordLongestMatchSet.match``  (WholeWordLongestMatchSet.java:47-178)

Because the tables already carry the goto closure (``dfa_next``), the
fail-transition inner loops of the reference collapse to a single gather;
the *flush-on-fail-transition* bookkeeping of the longest matcher is not
reproduced here because flush timing provably cannot change the output
sequence (see ``resolve/queue.py`` docstring for the invariant argument).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ahocorasick_tpu_torch.core.compiler import AC, LONGEST, SHORTEST, WHOLE_WORD, WHOLE_WORD_LONGEST, CompiledMatcher
from ahocorasick_tpu_torch.resolve.queue import MatchQueue
from ahocorasick_tpu_torch.utils import chartables

Match = Tuple[int, int, int]  # (start, end, value_id)


def _classes(m: CompiledMatcher, text: str) -> np.ndarray:
    units = chartables.to_utf16_units(text)
    return m.charmap[units]


def gold_ac(m: CompiledMatcher, text: str) -> List[Match]:
    """All overlapping matches, suffix-chain order at each end position."""
    assert m.kind == AC
    cls = _classes(m, text)
    dfa = m.dfa_next
    emit_start, emit_count = m.emit_start, m.emit_count
    emit_len, emit_val = m.emit_len, m.emit_val
    out: List[Match] = []
    s = 0
    for i in range(len(cls)):
        s = int(dfa[s, cls[i]])
        n = int(emit_count[s])
        if n:
            st = int(emit_start[s])
            end = i + 1
            for k in range(st, st + n):
                out.append((end - int(emit_len[k]), end, int(emit_val[k])))
    return out


def gold_longest(m: CompiledMatcher, text: str) -> List[Match]:
    """Leftmost-longest non-overlapping matches."""
    assert m.kind == LONGEST
    cls = _classes(m, text)
    dfa = m.dfa_next
    emit_start, emit_count = m.emit_start, m.emit_count
    emit_len, emit_val = m.emit_len, m.emit_val
    queue = MatchQueue()
    s = 0
    for i in range(len(cls)):
        s = int(dfa[s, cls[i]])
        n = int(emit_count[s])
        if n:
            st = int(emit_start[s])
            end = i + 1
            # Offer the full suffix chain; the queue's accept/reject rules
            # make offering past the first acceptance a no-op
            # (LongestMatchSet.java:535-551).
            for k in range(st, st + n):
                queue.push(end - int(emit_len[k]), end, int(emit_val[k]))
    return queue.drain()


def gold_shortest(m: CompiledMatcher, text: str) -> List[Match]:
    """Leftmost-shortest non-overlapping matches (lagged emission loop)."""
    assert m.kind == SHORTEST
    cls = _classes(m, text)
    dfa = m.dfa_next
    match_len, match_val = m.match_len, m.match_val
    out: List[Match] = []
    s = 0
    for i in range(len(cls)):
        # A match state restarts the automaton at the root for the next char
        # (ShortestMatchSet.java:200-216): the pruned automaton's match nodes
        # are leaves whose closure rows equal the root's.
        if match_len[s] != 0:
            s = int(dfa[0, cls[i]])
        else:
            s = int(dfa[s, cls[i]])
        if match_len[s] != 0:
            end = i + 1
            out.append((end - int(match_len[s]), end, int(match_val[s])))
    return out


def gold_whole_word(m: CompiledMatcher, text: str) -> List[Match]:
    """Whole-word-only matches: boundary-restart scanning, no fail links."""
    assert m.kind == WHOLE_WORD
    cls = _classes(m, text)
    trie = m.trie_next
    is_word = m.class_is_word
    own_len, own_val = m.own_len, m.own_val
    DEAD = m.dead_state
    out: List[Match] = []
    n = len(cls)
    s = 0
    i = 0
    while i < n:
        c = cls[i]
        nxt = int(trie[s, c])
        if nxt == DEAD:
            if not is_word[c]:
                # Dead end at a non-word char: report the pending whole-word
                # match, if any (WholeWordMatchSet.java:63-72).
                if own_len[s] != 0:
                    out.append((i - int(own_len[s]), i, int(own_val[s])))
            else:
                # Dead end inside a word: the word cannot match, skip to its
                # end (WholeWordMatchSet.java:73-79).
                i += 1
                while i < n and is_word[cls[i]]:
                    i += 1
            # Skip separators to the next word start (:81-83).
            i += 1
            while i < n and not is_word[cls[i]]:
                i += 1
            s = 0
        else:
            i += 1
            s = nxt
    if own_len[s] != 0:
        out.append((i - int(own_len[s]), i, int(own_val[s])))
    return out


def gold_whole_word_longest(m: CompiledMatcher, text: str) -> List[Match]:
    """Whole-word matches that may span separators, leftmost-longest."""
    assert m.kind == WHOLE_WORD_LONGEST
    cls = _classes(m, text)
    trie = m.trie_next
    is_word = m.class_is_word
    own_len, own_val = m.own_len, m.own_val
    fail_len, fail_off, fail_val = m.fail_len, m.fail_off, m.fail_val
    DEAD = m.dead_state
    out: List[Match] = []
    n = len(cls)
    s = 0
    i = 0
    while i < n:
        c = cls[i]
        nxt = int(trie[s, c])
        if nxt == DEAD:
            if not is_word[c]:
                # Dead end at a non-word char: own match wins, else the
                # carried fail match (WholeWordLongestMatchSet.java:65-81).
                if own_len[s] != 0:
                    out.append((i - int(own_len[s]), i, int(own_val[s])))
                elif fail_len[s] != 0:
                    fme = i - int(fail_off[s])
                    out.append((fme - int(fail_len[s]), fme, int(fail_val[s])))
            else:
                # Dead end on a word char: only the fail match can be
                # reported; then skip to the end of the word (:82-94).
                if fail_len[s] != 0:
                    fme = i - int(fail_off[s])
                    out.append((fme - int(fail_len[s]), fme, int(fail_val[s])))
                i += 1
                while i < n and is_word[cls[i]]:
                    i += 1
            i += 1
            while i < n and not is_word[cls[i]]:
                i += 1
            s = 0
        else:
            i += 1
            s = nxt
    if own_len[s] != 0:
        out.append((i - int(own_len[s]), i, int(own_val[s])))
    elif fail_len[s] != 0:
        fme = i - int(fail_off[s])
        out.append((fme - int(fail_len[s]), fme, int(fail_val[s])))
    return out


GOLD_BY_KIND = {
    AC: gold_ac,
    LONGEST: gold_longest,
    SHORTEST: gold_shortest,
    WHOLE_WORD: gold_whole_word,
    WHOLE_WORD_LONGEST: gold_whole_word_longest,
}


def gold_match(m: CompiledMatcher, text: str) -> List[Match]:
    return GOLD_BY_KIND[m.kind](m, text)
