"""Dense/sparse table policy — the reference's ``Thresholder`` SPI, wired
into this framework's real memory/speed trade.

The reference exposes ``Thresholder`` (``threshold/Thresholder.java:3-5``)
to decide when a sparse hashmap trie node should be converted to a dense
range node, with ``RangeNodeThreshold`` (``threshold/RangeNodeThreshold.java``)
as the default cost model.  Here the analogous trade is made once per
automaton instead of once per node: the compiler either materializes dense
``(S+1) x A`` transition arrays (fast host paths, direct device upload) or
keeps the hash-consed row-deduplicated ``RowTable`` (linear in *distinct*
rows; device engines then scan the packed quotient DFA).

``compile_matcher`` consults the policy with the whole automaton as the one
"node": ``node_size`` = total stored trie edges (the reference's per-node
entry count, summed), ``node_level`` = 0 (the root decides), and
``key_interval_size`` = ``(S+1) * A`` (the dense tables' slot count).  True
means "materialize dense" — exactly the reference's True = "convert to
RangeNode".  A hard memory cap (``core.compiler._DENSE_LIMIT``) still bounds
dense materialization regardless of the policy, so a permissive thresholder
cannot ask for a 16 GB table (the testFullNode extreme).
"""

from __future__ import annotations


class Thresholder:
    """SPI: decide if a node's transitions should be stored densely."""

    def is_over_threshold(self, node_size: int, node_level: int, key_interval_size: int) -> bool:
        raise NotImplementedError


class RangeNodeThreshold(Thresholder):
    """Default cost model (``RangeNodeThreshold.java:7-29``).

    Always dense when the key interval is at most 8; otherwise dense when
    ``size + size/4 + 3 > interval * (max - linear / (constant + level)**exponent)``.
    """

    def __init__(
        self,
        exponent: float = 1.0,
        linear_factor: float = 1.0,
        max_value: float = 0.65,
        constant_factor: float = 2.0,
    ) -> None:
        self.exponent = exponent
        self.linear_factor = linear_factor
        self.max_value = max_value
        self.constant_factor = constant_factor

    def is_over_threshold(self, node_size: int, node_level: int, key_interval_size: int) -> bool:
        if key_interval_size <= 8:
            return True
        fill = self.max_value - self.linear_factor / (
            (self.constant_factor + node_level) ** self.exponent
        )
        return node_size + (node_size // 4) + 3 > key_interval_size * fill


class DenseTableBudget(Thresholder):
    """The framework's default policy: dense whenever the table fits the
    entry budget.

    Alphabet compaction already shrinks the interval to the classes that
    occur in the dictionary, so — unlike the reference's per-node fill-ratio
    economics — dense is the right call whenever it is *affordable*: every
    scan engine is faster over a materialized array than over the
    row-indirected form.  Sparseness is therefore purely a memory decision
    here, which is what this budget expresses.
    """

    def __init__(self, max_entries: int = 1 << 29) -> None:
        self.max_entries = max_entries

    def is_over_threshold(self, node_size: int, node_level: int, key_interval_size: int) -> bool:
        return key_interval_size <= self.max_entries
