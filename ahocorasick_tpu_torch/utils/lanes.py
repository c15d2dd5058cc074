"""Lane/depth bucketing policy shared by the engine layers (the port's copy
of ``ahocorasick_tpu/utils/lanes.py``).

The JAX package rounds walk depths and lane counts to coarse buckets to keep
its set of compiled executables small.  The port keeps the same buckets so
that its padded shapes, tables and walk depths equal the JAX package's; extra
padded lanes or depth steps only walk already-dead state and emit nothing.
"""

LANE_BUCKET = 1 << 12  # lane-count rounding for per-start engines


def bucket_depth(d: int) -> int:
    """Walk depth padded to x4 (the JAX package's bucket; extra steps
    only walk dead lanes).  THE single source for matcher/bench/stream and
    the ops engines."""
    return max(-(-d // 4) * 4, 4)
