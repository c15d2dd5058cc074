"""Large-array allocation tuned for slow-first-touch hosts (the port's copy
of ``ahocorasick_tpu/utils/alloc.py``).

On some virtualized hosts, faulting in fresh
anonymous pages costs tens of microseconds per 4 KiB page, so allocating
multi-GB automaton tables is dominated by first-touch, not compute.
``big_empty`` requests transparent huge pages (2 MiB) via
``madvise(MADV_HUGEPAGE)``, cutting fault count ~512x where THP is in
``madvise`` mode; elsewhere it is a plain ``np.empty``.
"""

from __future__ import annotations

import mmap

import numpy as np

_THRESHOLD_BYTES = 1 << 24  # 16 MiB: below this, plain np.empty is fine


def big_empty(shape, dtype) -> np.ndarray:
    """np.empty that backs large arrays with MADV_HUGEPAGE mmap memory."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if nbytes < _THRESHOLD_BYTES or not hasattr(mmap, "MADV_HUGEPAGE"):
        return np.empty(shape, dtype)
    buf = mmap.mmap(-1, nbytes)
    try:
        buf.madvise(mmap.MADV_HUGEPAGE)
    except Exception:
        pass
    return np.frombuffer(buf, dtype=dtype).reshape(shape)
