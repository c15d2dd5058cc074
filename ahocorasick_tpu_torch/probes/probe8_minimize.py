"""How much does full DFA minimization shrink the big configs' scan tables?
— the port of ``tools/probes/probe8_minimize.py``.

The compiler's one-pass row hash-consing is not a minimization.  This probe
runs Moore partition refinement over the goto-closure DFA, starting from
the emit signature: (a) the emit count (``count``: what the count kernels
read) and (b) the full emit mask (``mask``: the planes path), on the
baseline-3 dictionary (100,000 english-like keywords plus ``a`` .. ``a *
8``, longest) and the baseline-5 one (1,000,000, AC).  The question on the
H100: the 1M dictionary's 470 MB count-packed table is past the 50 MB L2,
where a dependent lookup runs about a third of the L2 rate; only a ~9.4x
cut would bring it under.

Host numpy over the port's compiler (``core/compiler.compile_matcher``,
``bench/__main__.english_like_keywords``, ``ops/scan_batched.
_state_emit_planes``): nothing runs on a device.  ``moore_minimize`` is the
JAX file's, its hash and convergence test unchanged.  Left out: the JAX
file's platform pin and its ``sys.path`` line (it ran beside a TPU client).

    python -m ahocorasick_tpu_torch.probes.probe8_minimize [--config 3,5]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ahocorasick_tpu_torch.bench.__main__ import english_like_keywords
from ahocorasick_tpu_torch.core.compiler import compile_matcher
from ahocorasick_tpu_torch.ops.scan_batched import _state_emit_planes

SIZES = {"3": 100_000, "5": 1_000_000}  # keywords of each config


def moore_minimize(dfa_next: np.ndarray, init_ids: np.ndarray, max_iter=64):
    """Iterated partition refinement; returns ``(ids, n_classes per
    iteration)``."""
    S, A = dfa_next.shape
    _, ids = np.unique(init_ids, return_inverse=True)
    history = [int(ids.max()) + 1]
    for it in range(max_iter):
        sig = np.concatenate([ids[:, None], ids[dfa_next]], axis=1)
        # Hash rows to 128-bit-ish keys for speed: two independent dot hashes.
        h1 = sig.astype(np.uint64) @ np.arange(1, A + 2, dtype=np.uint64) ** 3
        h2 = sig.astype(np.uint64) @ (
            np.uint64(0x9E3779B97F4A7C15)
            ** np.arange(1, A + 2, dtype=np.uint64)
        )
        key = h1 ^ (h2 << np.uint64(1))
        _, ids_new = np.unique(key, return_inverse=True)
        n = int(ids_new.max()) + 1
        history.append(n)
        if n == history[-2]:
            # Verify no hash collision merged distinct signatures: group
            # check on a sample would be ideal; trust two-hash xor here
            # (collision odds ~ S^2 / 2^64).
            return ids_new, history
        ids = ids_new
    return ids, history


def build_config(which: str, n: int = None):
    """The config's compiled dictionary; ``n`` replaces its keyword count
    (the tests' small builds)."""
    rng = np.random.default_rng(0)
    count = SIZES[which] if n is None else n
    if which == "3":
        kws = english_like_keywords(rng, count)
        kws = kws + ["a" * i for i in range(1, 9)]
        return compile_matcher(kws, "longest", True)
    kws = english_like_keywords(rng, count)
    return compile_matcher(kws, "ac", True)


def signatures(m) -> dict:
    """``{"count": emit counts, "mask": emit masks as uint64}`` a state."""
    S = m.num_states
    planes = _state_emit_planes(m)
    if planes.shape[1] > 1:
        sig_mask = (planes[:, 0].astype(np.uint64)
                    | (planes[:, 1].astype(np.uint64) << np.uint64(32)))
    else:
        sig_mask = planes[:, 0].astype(np.uint64)
    return {"count": m.emit_count[:S], "mask": sig_mask}


def run_config(which: str, n: int = None) -> list:
    """One record a signature, printed as a JSON line each: the JAX file's
    keys, unrounded."""
    t0 = time.perf_counter()
    m = build_config(which, n)
    compile_s = time.perf_counter() - t0
    S, A = m.num_states, m.num_classes
    out = []
    for name, init in signatures(m).items():
        t0 = time.perf_counter()
        ids, hist = moore_minimize(m.dfa_next, init)
        dt = time.perf_counter() - t0
        k = hist[-1]
        rec = {
            "config": which, "signature": name,
            "states": S, "classes": A,
            "min_states": k, "ratio": S / k,
            "table_mb": S * A * 4 / 2**20,
            "min_table_mb": k * A * 4 / 2**20,
            "iters": len(hist) - 1, "seconds": dt,
            "compile_s": compile_s,
        }
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(prog="python -m ahocorasick_tpu_torch.probes.probe8_minimize")
    p.add_argument("--config", default="3,5")
    args = p.parse_args(argv)
    return [rec for which in args.config.split(",") for rec in run_config(which)]


if __name__ == "__main__":
    main()
