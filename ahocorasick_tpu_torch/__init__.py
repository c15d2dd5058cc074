"""ahocorasick_tpu_torch — the PyTorch/CUDA port of ahocorasick_tpu.

Multi-pattern string matching (Aho-Corasick all-matches, leftmost-longest,
whole-word, leftmost-shortest and whole-word-longest, as sets and maps) with
the scans, the hot-position compaction and the whole-word-longest walks run
by hand-written CUDA kernels on an NVIDIA H100 (``csrc/``), and by their
plain PyTorch twins on the CPU.  The host
compiler, gold model, artifact format, resolvers and native extractor are
shared with ``ahocorasick_tpu`` by import; this package never imports JAX.

``launches`` counts kernel launches by name (``reset_launches()`` zeroes
them), so a run can show that its work went through the kernels.
"""

from ahocorasick_tpu_torch.kernels.build import launches, reset_launches
from ahocorasick_tpu_torch.models.matchers import (
    AhoCorasickMap,
    AhoCorasickSet,
    LongestMatchMap,
    LongestMatchSet,
    ShortestMatchMap,
    ShortestMatchSet,
    WholeWordLongestMatchMap,
    WholeWordLongestMatchSet,
    WholeWordMatchMap,
    WholeWordMatchSet,
    load_matcher,
)

__all__ = [
    "AhoCorasickSet",
    "AhoCorasickMap",
    "LongestMatchSet",
    "LongestMatchMap",
    "WholeWordMatchSet",
    "WholeWordMatchMap",
    "WholeWordLongestMatchSet",
    "WholeWordLongestMatchMap",
    "ShortestMatchSet",
    "ShortestMatchMap",
    "load_matcher",
    "launches",
    "reset_launches",
]
