"""Run the lookup probes, then the residency sweep; or probe6's row-width
probes alone.

    python -m ahocorasick_tpu_torch.probes [--platform gpu|cpu] [--no-sweep]
    python -m ahocorasick_tpu_torch.probes --widths [--platform gpu|cpu]

Prints one line per probe of the four JAX files' ``main`` (``ms``, M lookups
per second, the table's placement), then the residency sweep: the lookup
rate of one dependent load per step at the main path's shape (65,536 chains
x 524 steps, the count kernel's windows and their length) for tables from
128 entries to the 1M dictionary's 470 MB, in every placement that holds
them: warp registers, shared memory (up to 227 KB), global memory (through
L1 and the 50 MB L2, or from device memory); the row read of the stride-2
table (``row_chain``, 28 words: its 112-byte row); and the same chain as
eager torch indexing, the library yardstick.  Every result of the sweep is
held against the kernels' plain twins.  ``--platform cpu`` runs the
kernels' plain twins at small sizes under the host clock (no device
figures).  ``--widths`` runs ``probe6.widths`` instead: the dependent row
read against row width, from a 51,200-row table in cache (8-256 words) and
a 470,000-row one in device memory (32-1,024 words).
"""

from __future__ import annotations

import argparse

import torch

from ahocorasick_tpu_torch.bench import _elapsed
from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.models.matchers import _resolve_device
from ahocorasick_tpu_torch.probes import probe, probe2, probe3, probe6

# Table sizes in entries: a warp's registers, 16 KB, just under the 227 KB
# of shared memory, the 10k dictionary's padded packed table (50,353 x 32
# words), 32 MB and 64 MB (either side of the 50 MB L2), and the 1M
# dictionary's count-packed table (4,356,756 states x 27 classes, 470 MB).
SWEEP_SIZES = (128, 4096, 57344, 1_611_296, 8 << 20, 16 << 20, 117_632_412)
SWEEP_CHAINS = 65536  # the main path's windows
SWEEP_STEPS = 524  # halo 12 + body 512
ROW_WORDS = 28  # a stride-2 row of the 10k dictionary: 27 classes + emit1
SEED = 0


def cycle_table(n: int, device, gen: torch.Generator) -> torch.Tensor:
    """int32[n] holding one random cycle through all n entries (s <- tab[s]
    visits every entry before it repeats, so no chain settles in a cache)."""
    perm = torch.randperm(n, generator=gen, device=device)
    tab = torch.empty(n, dtype=torch.int32, device=device)
    tab[perm] = perm.roll(-1).to(torch.int32)
    return tab


def residency_sweep(device, sizes=SWEEP_SIZES, chains=SWEEP_CHAINS, steps=SWEEP_STEPS,
                    reps=3, calls=10) -> list:
    """One record per (table size, placement): ``{"entries", "bytes",
    "placement", "ms", "rate", "max_abs_err"}`` (lookups per second),
    ``placement`` one of ``kernels.probes.PLACEMENTS``, ``"row_chain"``
    (``entries // 28`` rows of 28 words) or ``"torch"``.  Each time is per
    call, the best of ``reps`` timings of ``calls`` calls in a row after a
    warm-up: back-to-back launches keep the host's launch time out of the
    kernel's.  ``max_abs_err`` holds the warm-up's result against the plain
    twin's on the same inputs (``chain_gather_plain`` / ``row_chain_plain``)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    lookups = chains * steps
    records = []

    def timed(label, n, nbytes, fn, want):
        got = fn()
        err = int((got.long() - want.long()).abs().max()) if got.shape == want.shape else -1
        ms = min(_elapsed(fn, calls, device) for _ in range(reps)) / calls * 1e3
        records.append({"entries": n, "bytes": nbytes, "placement": label, "ms": ms,
                        "rate": lookups / (ms * 1e-3), "max_abs_err": err})

    for n in sizes:
        first = len(records)
        tab = cycle_table(n, device, gen)
        start = torch.randint(0, n, (chains,), generator=gen, device=device, dtype=torch.int32)
        want = kp.chain_gather_plain(tab, start, steps, "load")
        for p in kp.PLACEMENTS:
            if (p == "shfl" and n > 128) or (p == "shared" and 4 * n > kp.SHARED_BYTES):
                continue
            timed(p, n, 4 * n, lambda p=p: kp.chain_gather(tab, start, steps, "load", placement=p),
                  want)
        rows = max(n // ROW_WORDS, 1)
        row_tab = torch.zeros((rows, ROW_WORDS), dtype=torch.int32, device=device)
        row_tab[:, 0] = cycle_table(rows, device, gen)
        row_start = start % rows
        timed("row_chain", n, row_tab.nbytes,
              lambda: kp.row_chain(row_tab, row_start, steps, "max", rows),
              kp.row_chain_plain(row_tab, row_start, steps, "max", rows))
        s64 = start.long()

        def eager(s=s64):
            for _ in range(steps):
                s = tab[s].long()
            return s

        timed("torch", n, 4 * n, eager, want)
        del tab, row_tab
        print(f"sweep {n} entries ({4 * n} B), {chains} chains x {steps} steps: "
              + "; ".join(f"{r['placement']} {r['ms']} ms ({r['rate'] / 1e9} G lookups/s, "
                          f"max_abs_err {r['max_abs_err']})" for r in records[first:])
              + f" [{device}]")
    return records


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ahocorasick_tpu_torch.probes")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--no-sweep", action="store_true", help="skip the residency sweep")
    ap.add_argument("--widths", action="store_true",
                    help="run probe6's two row-width probes instead")
    args = ap.parse_args(argv)
    device = _resolve_device("cpu" if args.platform == "cpu" else None)
    small = device.type == "cpu"
    if args.widths:
        return {"widths": probe6.widths(device, small=small)}
    out = {}
    for name, mod in (("probe", probe), ("probe2", probe2), ("probe3", probe3),
                      ("probe6", probe6)):
        print(f"== {name} ==")
        out[name] = mod.main(device, small=small)
    if not args.no_sweep:
        print("== residency sweep ==")
        out["sweep"] = (residency_sweep(device, sizes=(128, 4096, 57344), chains=256, steps=16)
                        if small else residency_sweep(device))
    return out


if __name__ == "__main__":
    main()
