"""ahocorasick_tpu_torch — the PyTorch/CUDA port of ahocorasick_tpu.

Multi-pattern string matching (Aho-Corasick all-matches) with the scan run
by hand-written CUDA kernels on an NVIDIA H100 (``csrc/packed_scan.cu``),
and by their plain PyTorch twins on the CPU.  The host compiler, gold model,
artifact format and native extractor are shared with ``ahocorasick_tpu``
by import; this package never imports JAX.

``launches`` counts kernel launches by name (``reset_launches()`` zeroes
them), so a run can show that its work went through the kernels.
"""

from ahocorasick_tpu_torch.kernels.scan_block import launches, reset_launches
from ahocorasick_tpu_torch.models.matchers import (
    AhoCorasickMap,
    AhoCorasickSet,
    load_matcher,
)

__all__ = [
    "AhoCorasickSet",
    "AhoCorasickMap",
    "load_matcher",
    "launches",
    "reset_launches",
]
