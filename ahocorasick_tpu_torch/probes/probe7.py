"""Big-table gather locality, and the scan rate against table size — the
port of ``tools/probes/probe7.py``.

Three parts, on tables built on the device from the JAX file's hash
(``_hash``: ``(i * 2654435761) ^ (i >> 13)`` in 32-bit arithmetic, computed
here in int64 and masked, in slices of ``SLICE`` entries so that no int64
temporary holds a whole 512 MB table):

* **A** — the scan rate against table size, either side of the 50 MB L2:
  the hashed packed table ``nxt | emit << sb`` (S = (mb << 20) // 128 rows
  of 32 columns, 27 live classes) scanned by the port's count kernel,
  ``kernels/scan_block.packed_scan_count``, which replaced the JAX file's
  ``rowdfa1_count``.  That kernel splits each window into K lanes
  (``scan_block.segments``: K = 4 at 8,192 windows of 512), each warmed
  over the halo from the root, which is exact only on a halo-synchronizing
  automaton.  The hashed table is not one, so its count differs from the
  JAX file's single walk a window; the rate is still the scan kernel's rate
  at that table size, the question this part asks.  (At a body where
  ``segments`` gives K = 1 the two counts agree; a test holds them there.)
* **B** — one chain a window over a 512 MB table whose next states are
  confined to [0, n), the knob that emulates hot-state renumbering:
  ``window_chain`` (``kernels/probes.py``), a thread a window.  The JAX
  file's ``flat`` (``table[s * AP + c]``) and ``2d`` (``table[s, c]``)
  gathers are the same load on this card; both labels run the kernel, the
  first on the flat table and the second on its (rows, 32) view, which
  clamps each index as XLA does.
* **C** — the same flat chain against table size, full-range next states.

Timing is ``timeit_traced``: CUDA events on the card alone, best of 3 calls of ``reps_lo`` and
of ``reps_hi`` reps after a warm-up of each, the rate from their
difference.  A call runs its reps as launches on the same windows (the JAX
file rolled them inside one jit to defeat XLA's CSE; eager launches have
none, and the sum over windows does not depend on their order), and the
tables are built once a size (the JAX ``fn`` rebuilt them inside each call,
a cost the difference cancelled).  Left out: ``--vmem-kib`` and its
``compiler_options`` (the TPU's scoped VMEM).  Records print unrounded.

    python -m ahocorasick_tpu_torch.probes.probe7 [--part ABC] [--mb 8,16,32,64,96]
        [--rows 4194304] [--crows 262144,1048576,2097152] [--platform gpu|cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.kernels import scan_block
from ahocorasick_tpu_torch.models.matchers import _resolve_device
from ahocorasick_tpu_torch.probes import card_seconds, sum32

AP = 32  # padded class count (baseline-3 geometry)
A = 27  # live classes
B_LANES = 8192
CHUNK = 512
HALO = 12
SLICE = 1 << 24  # table entries hashed at a time
MASK = 0xFFFFFFFF
GOLDEN = 2654435761


def _hash(i: torch.Tensor) -> torch.Tensor:
    """``(i * 2654435761) ^ (i >> 13)`` modulo 2**32, for int64 ``i`` in
    [0, 2**32): the product taken in 16-bit halves so that nothing
    overflows int64."""
    lo, hi = i & 0xFFFF, i >> 16
    prod = (lo * GOLDEN + (((hi * GOLDEN) & 0xFFFF) << 16)) & MASK
    return prod ^ (i >> 13)


def _windows(key_shift: int, device) -> torch.Tensor:
    """int32[B_LANES, HALO + CHUNK] pseudo-random classes in [0, A), on
    ``device``."""
    n = B_LANES * (HALO + CHUNK)
    i = (torch.arange(n, dtype=torch.int64, device=device) + key_shift) & MASK
    return (_hash(i) % A).to(torch.int32).reshape(B_LANES, HALO + CHUNK)


def _table(entries: int, value, device) -> torch.Tensor:
    """uint32[entries]: ``value(i)`` (int64 in [0, 2**32)) of every index,
    built ``SLICE`` entries at a time."""
    out = torch.empty(entries, dtype=torch.int32, device=device)
    for a in range(0, entries, SLICE):
        i = torch.arange(a, min(a + SLICE, entries), dtype=torch.int64, device=device)
        v = value(i)
        out[a: a + len(i)] = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return out.view(torch.uint32)


def part_a_table(mb: int, shift: int, device) -> tuple:
    """``(table uint32[S, AP], S, sb)`` of part A at ``mb`` MB: ``nxt |
    emit << sb``, ``nxt = _hash(i + shift) % S``, ``emit = _hash(i ^
    0x9E3779B9) & 1``, i the flat index."""
    S = (mb << 20) // (AP * 4)
    sb = max(int(S - 1).bit_length(), 1)
    tab = _table(S * AP, lambda i: (_hash((i + shift) & MASK) % S)
                 | ((_hash(i ^ 0x9E3779B9) & 1) << sb), device)
    return tab.reshape(S, AP), S, sb


def chain_table(s_rows: int, n: int, device) -> torch.Tensor:
    """uint32[s_rows * AP] of parts B and C: ``_hash(i) % n``."""
    return _table(s_rows * AP, lambda i: _hash(i) % n, device)


def timeit_traced(fn, args_lo, args_hi, chars_per_rep, reps_lo, reps_hi, label) -> dict:
    """The JAX harness on the card: ``fn(*args)`` returns a tensor; a warm-up
    of each rep count, then the best of 3 timings of each (``card_seconds``:
    CUDA events on the card alone, the host clock on the CPU); the record, printed as one JSON
    line."""
    dev = fn(*args_lo).device
    int(fn(*args_hi))

    def best(args):
        return min(card_seconds(lambda: fn(*args), dev) for _ in range(3))

    t_lo, t_hi = best(args_lo), best(args_hi)
    dt = t_hi - t_lo
    if dt <= 0:
        rec = {"label": label, "degenerate": [t_lo, t_hi]}
    else:
        rate = (reps_hi - reps_lo) * chars_per_rep / dt
        rec = {"label": label, "mchars_per_s": rate / 1e6, "gbps_utf16": rate * 2 / 1e9,
               "t_lo_ms": t_lo * 1e3, "t_hi_ms": t_hi * 1e3}
    print(json.dumps(rec), flush=True)
    return rec


def _reps_sum(one, reps: int, device) -> torch.Tensor:
    """The int32 sum of ``reps`` calls of ``one()`` (0 for none)."""
    if reps == 0:
        return torch.zeros((), dtype=torch.int32, device=device)
    return sum32(torch.stack([one() for _ in range(reps)]))


# -- Part A: the count kernel's rate vs table size ---------------------------

def part_a(mbs, *, device=None) -> list:
    dev = _resolve_device(device)
    out = []
    for mb in mbs:
        w = _windows(1, dev).to(torch.uint8)
        tables = {}

        def fn(reps, shift, _mb=mb, _w=w, _tables=tables):
            if shift not in _tables:
                _tables.clear()
                _tables[shift] = part_a_table(_mb, shift, dev)
            table, _, sb = _tables[shift]
            return _reps_sum(lambda: scan_block.packed_scan_count(table, _w, HALO, sb), reps, dev)

        S = (mb << 20) // (AP * 4)
        sb = max(int(S - 1).bit_length(), 1)
        K = scan_block.segments(B_LANES, CHUNK, HALO, scan_block.COUNT_MAX_LANES)[0]
        lo, hi = 4, 20
        out.append(timeit_traced(fn, (lo, 1), (hi, 1), B_LANES * CHUNK, lo, hi,
                                 f"A:packed_scan_count {mb}MB S={S} bits={sb} K={K}"))
    return out


# -- Part B: the chain's rate vs index concentration on a big table ----------

def part_b(flavor: str, s_rows: int, *, device=None) -> list:
    """flavor 'flat': the flat table, ``table[s*AP+c]``; '2d': its (s_rows,
    AP) view, ``table[s, c]``.  The table is s_rows x AP uint32 (s_rows = 4M
    -> 512 MB); next states confined to [0, n)."""
    dev = _resolve_device(device)
    w = _windows(7, dev)
    tables = {}

    def fn(reps, n):
        if n not in tables:
            tables.clear()
            flat = chain_table(s_rows, n, dev)
            tables[n] = flat if flavor == "flat" else flat.reshape(s_rows, AP)
        return _reps_sum(lambda: kp.window_chain(tables[n], w, AP), reps, dev)

    out = []
    lo, hi = 2, 8
    for n in (1, 4096, 65536, 1 << 20, s_rows):
        out.append(timeit_traced(fn, (lo, n), (hi, n), B_LANES * (HALO + CHUNK), lo, hi,
                                 f"B:{flavor} {s_rows * AP * 4 >> 20}MB n={n} [window_chain]"))
    tables.clear()
    return out


def part_c(rows_list, *, device=None) -> list:
    """The flat chain's rate vs operand size (uniform full-range indices)."""
    dev = _resolve_device(device)
    w = _windows(7, dev)
    out = []
    for s_rows in rows_list:
        sb = max(int(s_rows - 1).bit_length(), 1)
        table = chain_table(s_rows, s_rows, dev)

        def fn(reps, _t=table):
            return _reps_sum(lambda: kp.window_chain(_t, w, AP), reps, dev)

        lo, hi = 2, 8
        out.append(timeit_traced(fn, (lo,), (hi,), B_LANES * (HALO + CHUNK), lo, hi,
                                 f"C:flat {s_rows * AP * 4 >> 20}MB bits={sb} [window_chain]"))
        del table
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m ahocorasick_tpu_torch.probes.probe7")
    p.add_argument("--part", default="AB")
    p.add_argument("--mb", default="8,16,32,64,96")
    p.add_argument("--rows", type=int, default=1 << 22)
    p.add_argument("--crows", default="262144,1048576,2097152")
    p.add_argument("--platform", choices=("auto", "gpu", "cpu"), default="auto")
    args = p.parse_args(argv)
    dev = _resolve_device("cpu" if args.platform == "cpu" else None)
    print(f"devices: [{dev}]", flush=True)
    out = {}
    if "A" in args.part:
        out["A"] = part_a([int(x) for x in args.mb.split(",")], device=dev)
    if "B" in args.part:
        out["B"] = part_b("flat", args.rows, device=dev) + part_b("2d", args.rows, device=dev)
    if "C" in args.part:
        out["C"] = part_c([int(x) for x in args.crows.split(",")], device=dev)
    return out


if __name__ == "__main__":
    main()
