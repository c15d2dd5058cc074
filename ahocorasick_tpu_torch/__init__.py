"""ahocorasick_tpu_torch — the PyTorch/CUDA port of ahocorasick_tpu.

Multi-pattern string matching (Aho-Corasick all-matches, leftmost-longest,
whole-word, leftmost-shortest and whole-word-longest, as sets and maps) with
the scans, the hot-position compaction and the whole-word-longest walks run
by hand-written CUDA kernels on an NVIDIA H100 (``csrc/``), and by their
plain PyTorch twins on the CPU.  Batch ``match``, ``match_stream`` /
``stream()`` / ``match_readable`` over unbounded inputs, and listener scans
that stop on ``False`` all run on the matcher's ``device=``.  The host
compiler, gold model, artifact format, resolvers and native extractor are
this package's own copies of the JAX package's, under the same module names;
this package imports neither JAX nor anything of ``ahocorasick_tpu``.

``launches`` counts kernel launches by name (``reset_launches()`` zeroes
them), so a run can show that its work went through the kernels.
"""

from ahocorasick_tpu_torch.core.compiler import CompiledMatcher, compile_matcher
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
from ahocorasick_tpu_torch.utils import chartables
from ahocorasick_tpu_torch.utils.chartables import default_word_chars
from ahocorasick_tpu_torch.utils.thresholds import RangeNodeThreshold, Thresholder

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
    "CompiledMatcher",
    "compile_matcher",
    "chartables",
    "default_word_chars",
    "Thresholder",
    "RangeNodeThreshold",
    "load_matcher",
    "launches",
    "reset_launches",
]
