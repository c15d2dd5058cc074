"""Lookup-primitive probes: the Hopper kernels and their plain PyTorch twins.

Four entry points (``csrc/probes.cu``), the counterparts of the v5e Pallas
probes of ``tools/probes/`` (the source note in the ``.cu`` file lists every
``pl.pallas_call`` site each one replaces and what bounds it on the H100):

* ``chain_gather(tab, idx, reps, op, placement=, mod=, sum_out=)`` —
  independent chains, one per element of ``idx``: ``op="add"``
  ``i <- (i + tab[i & (T-1)]) & (T-1)``, ``"add_r"`` the same plus the step
  number, ``"load"`` ``i <- tab[i]``, ``"load_mod"`` ``i <- tab[i] % mod``;
  the table in ``placement`` ``"shfl"`` (T <= 128, warp registers: lane l
  holds the steering bytes of entries l, l + 32, l + 64, l + 96 in one
  word, so a step is one shuffle), ``"shared"`` (T * 4 B within 227 KB:
  ``shared_copies(T)`` interleaved copies, so a warp's loads spread over
  the banks) or ``"global"``;
* ``row_chain(tab, s0, reps, reduce, mod)`` — ``s <- reduce(tab[s, :]) % mod``
  with ``reduce`` ``"max"`` or ``"col0"``; in the max form a chain runs on
  ``row_group(width)`` lanes, each reading 16-byte words of the row where it
  is 16-byte aligned;
* ``onehot_mma(onehot_table(tab), idx, reps)`` — ``g = onehot(idx[:, 0]) @
  tab`` on the tensor cores (``wgmma``, a warpgroup a 64-row tile over a
  slab of 16 columns; ``onehot_slab(T, ncols, B)`` gives the launch),
  ``idx <- (idx + int(g)) & (T-1)``; ``tab`` float32 holding integers in [0, 2048), exact in fp16
  (``onehot_table`` checks them and converts the table once);
* ``gather2d(tab, idx, reps, mode, mask=, sum_out=)`` — on an (8, 128)
  table: ``"sublane"`` ``tab[idx & 7, j]`` once, ``"sublane_chain"``
  ``s <- (tab[s & 7, j] + s) & 7``, and the sublane-then-lane gather
  ``idx <- (idx + tab[sub[i, L], L] [+ r]) & mask`` (``L = idx & 127``,
  ``sub = (idx >> 7) & 7`` of the same row) on the first 8-row tile
  (``"gather2d_first"``, rows past it only masked) or on every tile with the
  step number added (``"gather2d_all"``); one warp a row, four indices a
  lane (``csrc/gather2d.cuh``; ``gather2d_shape(rows)`` gives the launch).

Tables and indices are int32 or uint32 and read as unsigned words; the
results are int32 (``sum_out``: their sum modulo 2**32, an int32 scalar), as
the JAX probes return them.  The load ops clamp an index to the table and the
add ops mask it, as XLA clamps a gather, so no input reads out of bounds.

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.kernels.scan_block import _to_uint32, _widen

OPS = ("add", "add_r", "load", "load_mod")
PLACEMENTS = ("shfl", "shared", "global")
REDUCES = ("max", "col0")
ROW_GROUPS = (1, 2, 4, 8)  # lanes a chain of row_chain's max form
G2_MODES = ("sublane", "sublane_chain", "gather2d_first", "gather2d_all")
G2_MAX_WARPS = 8  # rows a gather2d block: csrc/gather2d.cuh kMaxWarps
SM_COUNT = 132  # the H100's SMs, which gather2d_shape fills
SHARED_BYTES = 232448  # the shared memory one block can use on sm_90 (227 KB)
MMA_EXACT = 2048  # integers below this are exact in fp16
MMA_COLS = 32  # onehot_mma takes a multiple of this many columns
ONEHOT_SLAB = 16  # the columns of a onehot_mma block
_WORDS = (torch.int32, torch.uint32)


def default_placement(T: int) -> str:
    """The fastest placement a T-entry table fits: shared memory up to
    ``SHARED_BYTES``, else global memory.  At the residency sweep's shape
    (65,536 chains x 524 steps of the load op; card time, ``python -m
    ahocorasick_tpu_torch.bench.scan_variants --against``; ms, NVIDIA H100
    80GB HBM3, 700 W) at 128 entries: shared 0.0099, registers 0.0133,
    global 0.0176; at 4,096: shared 0.0185, global 0.0448; at 57,344: shared
    0.0237, global 0.0575.  Warp registers are never the fastest: a
    shuffle's latency is above a conflict-free shared load's."""
    return "shared" if 4 * T <= SHARED_BYTES else "global"


def shared_copies(T: int) -> int:
    """The copies of a T-entry table that the shared placement stages,
    interleaved (word ``x R + lane % R`` holds entry x): the largest power of
    two up to 32 whose copies fit ``SHARED_BYTES``.  At R = 32 the lanes of a
    warp read 32 banks (no conflict), up to 1,816 entries."""
    r = 32
    while r > 1 and r * 4 * T > SHARED_BYTES:
        r //= 2
    return r


def onehot_shared(T: int, wgs: int) -> int:
    """The shared memory of a ``onehot_mma`` block with ``wgs`` warpgroups:
    its slab of ``ONEHOT_SLAB`` columns in fp16, column 0 of the table as T
    words, and with two warpgroups two buffers of the second one's sums."""
    return T * (2 * ONEHOT_SLAB + 4) + (512 * ONEHOT_SLAB if wgs == 2 else 0)


def onehot_slab(T: int, ncols: int, B: int) -> tuple:
    """``(warpgroups, group, blocks)`` of a ``onehot_mma`` launch: blocks of
    64 rows over a slab of ``ONEHOT_SLAB`` columns, ``ceil(B / 64) x ncols /
    16`` of them; two warpgroups splitting the T / 16 k-tiles wherever there
    are two; a warpgroup's k-tiles issued 16 to a group where it has 16 or
    more, else one at a time.  At T = 2,048, B = 1,024 and 128 columns: (2,
    16, 128), so 128 of the 132 SMs are busy."""
    wgs = 2 if T >= 32 else 1
    group = 16 if T // 16 // wgs >= 16 else 1
    return wgs, group, -(-B // 64) * (ncols // ONEHOT_SLAB)


def _words(t: torch.Tensor) -> torch.Tensor:
    """int32 or uint32 words as int64, read unsigned."""
    return t.to(torch.int64) & 0xFFFFFFFF if t.dtype == torch.int32 else _widen(t)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32, the same bits."""
    return _to_uint32(x & 0xFFFFFFFF).view(torch.int32)


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _check_words(name: str, **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if t.dtype not in _WORDS:
            raise TypeError(f"{name}: {key} must be int32 or uint32, got {t.dtype}")


def _launch(name: str, dev: torch.device, *args) -> None:
    build.call(name, *args, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    launches[name] += 1


def _sum_out(dev: torch.device) -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int32, device=dev)


# ------------------------------------------------------------- chain_gather


def chain_gather(tab: torch.Tensor, idx: torch.Tensor, reps: int, op: str, *,
                 placement: str = None, mod: int = None, sum_out: bool = False) -> torch.Tensor:
    """The chains' final values, int32 of ``idx``'s shape, or with
    ``sum_out`` their int32 sum (a scalar tensor)."""
    _check_words("chain_gather", tab=tab, idx=idx)
    dev = _check("chain_gather", tab, idx)
    if tab.dim() != 1 or tab.numel() < 1 or idx.numel() < 1 or reps < 0:
        raise ValueError(f"chain_gather: need a 1-D table, chains and reps >= 0; got "
                         f"{tuple(tab.shape)}, {tuple(idx.shape)}, reps={reps}")
    T = tab.numel()
    if op not in OPS:
        raise ValueError(f"chain_gather: op {op!r} is not one of {OPS}")
    if op in ("add", "add_r") and T & (T - 1):
        raise ValueError(f"chain_gather: op {op!r} masks with T - 1, so T={T} must be a power of two")
    if op == "load_mod" and (mod is None or not 1 <= mod <= T):
        raise ValueError(f"chain_gather: load_mod needs 1 <= mod <= T={T}, got {mod}")
    placement = default_placement(T) if placement is None else placement
    if placement not in PLACEMENTS:
        raise ValueError(f"chain_gather: placement {placement!r} is not one of {PLACEMENTS}")
    if placement == "shfl" and T > 128:
        raise ValueError(f"chain_gather: 'shfl' holds at most 128 entries, not {T}")
    if placement == "shared" and 4 * T > SHARED_BYTES:
        raise ValueError(f"chain_gather: a {4 * T} B table does not fit the {SHARED_BYTES} B of "
                         f"shared memory a block can use; use placement='global'")
    if dev.type == "cpu":
        return chain_gather_plain(tab, idx, reps, op, mod=mod, sum_out=sum_out)
    out = _sum_out(dev) if sum_out else torch.empty_like(idx, dtype=torch.int32)
    _launch("chain_gather", dev, tab.data_ptr(), T, idx.data_ptr(), idx.numel(), reps,
            OPS.index(op), PLACEMENTS.index(placement), mod or 0, int(sum_out), out.data_ptr())
    return out[0] if sum_out else out


def chain_gather_plain(tab, idx, reps, op, *, mod=None, sum_out=False) -> torch.Tensor:
    tf = _words(tab)
    last = tf.numel() - 1
    i = _words(idx).reshape(-1)
    for r in range(reps):
        v = tf[i & last] if op in ("add", "add_r") else tf[i.clamp(max=last)]
        if op == "add":
            i = (i + v) & last
        elif op == "add_r":
            i = (i + v + r) & last
        elif op == "load":
            i = v
        else:
            i = v % mod
    if sum_out:
        return _as_int32(i.sum().reshape(1))[0]
    return _as_int32(i).reshape(idx.shape)


# ---------------------------------------------------------------- row_chain


def row_group(width: int) -> int:
    """The lanes a chain of ``row_chain``'s max form takes for rows of
    ``width`` words: at most two 16-byte words a lane, at most 8 lanes.  Set
    from the A/B of every group size (``bench/scan_variants.row_ab``, 65,536
    chains x 524 steps; ms, NVIDIA H100 80GB HBM3, 700 W): at width 28, G = 1,
    2, 4, 8 took 1.006, 0.787, 0.538, 0.911 (the first design, a warp a
    chain, 2.613); at width 128, 4.458, 3.427, 1.941, 1.588 (first 4.064)."""
    words = -(-width // 4)
    g = 1
    while g < 8 and g * 2 < words:
        g *= 2
    return g


def row_chain(tab: torch.Tensor, s0: torch.Tensor, reps: int, reduce: str, mod: int, *,
              group: int = None) -> torch.Tensor:
    """K chains ``s <- reduce(tab[s, :]) % mod``, one per element of ``s0``:
    the final states, int32 of ``s0``'s shape.  ``group``: the lanes a chain
    of the max form (``ROW_GROUPS``; ``row_group(width)`` when None); the
    column-0 form runs one lane a chain."""
    _check_words("row_chain", tab=tab, s0=s0)
    dev = _check("row_chain", tab, s0)
    if tab.dim() != 2 or tab.numel() < 1 or s0.numel() < 1 or reps < 0:
        raise ValueError(f"row_chain: need a 2-D table, chains and reps >= 0; got "
                         f"{tuple(tab.shape)}, {tuple(s0.shape)}, reps={reps}")
    if reduce not in REDUCES:
        raise ValueError(f"row_chain: reduce {reduce!r} is not one of {REDUCES}")
    if not 1 <= mod < 1 << 32:
        raise ValueError(f"row_chain: mod must lie in [1, 2**32), got {mod}")
    if reduce == "col0":
        group = 1 if group is None else group
        if group != 1:
            raise ValueError(f"row_chain: the column-0 form runs one lane a chain, not {group}")
    group = row_group(tab.shape[1]) if group is None else group
    if group not in ROW_GROUPS:
        raise ValueError(f"row_chain: group {group} is not one of {ROW_GROUPS}")
    if dev.type == "cpu":
        return row_chain_plain(tab, s0, reps, reduce, mod)
    out = torch.empty_like(s0, dtype=torch.int32)
    _launch("row_chain", dev, tab.data_ptr(), tab.shape[0], tab.shape[1], s0.data_ptr(),
            s0.numel(), reps, REDUCES.index(reduce), mod, group, out.data_ptr())
    return out


def row_chain_plain(tab, s0, reps, reduce, mod) -> torch.Tensor:
    tf = _words(tab)
    last = tf.shape[0] - 1
    s = _words(s0).reshape(-1)
    for _ in range(reps):
        rows = tf[s.clamp(max=last)]
        v = rows.max(dim=1).values if reduce == "max" else rows[:, 0]
        s = v % mod
    return _as_int32(s).reshape(s0.shape)


# --------------------------------------------------------------- onehot_mma


def onehot_table(tab: torch.Tensor) -> torch.Tensor:
    """The table as ``onehot_mma`` takes it: ``tab`` float32[T, ncols] of
    integers in [0, 2048), which fp16 holds exactly (anything else raises),
    transposed to float16[ncols, T].  One check and conversion, made before
    the chain is launched or timed."""
    if tab.dtype != torch.float32 or tab.dim() != 2:
        raise TypeError(f"onehot_table: tab must be float32[T, ncols], got {tab.dtype}"
                        f"{tuple(tab.shape)}")
    if bool(((tab < 0) | (tab >= MMA_EXACT) | (tab != tab.floor())).any()):
        raise ValueError(f"onehot_table: the table must hold integers in [0, {MMA_EXACT}), the "
                         f"values fp16 holds exactly")
    return tab.t().contiguous().to(torch.float16)


def onehot_mma(tab_h: torch.Tensor, idx: torch.Tensor, reps: int) -> torch.Tensor:
    """``reps`` steps of ``idx <- (idx + int(onehot(idx[:, 0]) @ tab)) &
    (T-1)``: int32[B, ncols], ``tab_h`` being ``onehot_table(tab)``."""
    if tab_h.dtype != torch.float16 or tab_h.dim() != 2:
        raise TypeError(f"onehot_mma: the table must be onehot_table's float16[ncols, T], got "
                        f"{tab_h.dtype}{tuple(tab_h.shape)}")
    _check_words("onehot_mma", idx=idx)
    dev = _check("onehot_mma", tab_h, idx)
    ncols, T = tab_h.shape
    if idx.dim() != 2 or idx.shape[1] != ncols or idx.shape[0] < 1 or reps < 0:
        raise ValueError(f"onehot_mma: idx {tuple(idx.shape)} does not match {ncols} columns")
    if T < 16 or T & (T - 1):
        raise ValueError(f"onehot_mma: T={T} must be a power of two of at least 16")
    wgs = onehot_slab(T, ncols, idx.shape[0])[0]
    if ncols % MMA_COLS or onehot_shared(T, wgs) > SHARED_BYTES:
        raise ValueError(f"onehot_mma: the kernel takes a multiple of {MMA_COLS} columns and a T "
                         f"whose 16-column slab fits shared memory; got T={T}, ncols={ncols}")
    if dev.type == "cpu":
        return onehot_mma_plain(tab_h, idx, reps)
    out = torch.empty_like(idx, dtype=torch.int32)
    _launch("onehot_mma", dev, tab_h.data_ptr(), T, ncols, idx.data_ptr(), idx.shape[0], reps,
            out.data_ptr())
    return out


def onehot_mma_plain(tab_h, idx, reps) -> torch.Tensor:
    T = tab_h.shape[1]
    t = tab_h.t().to(torch.int64)
    i = _words(idx)
    for _ in range(reps):
        sel = i[:, 0]
        g = torch.where((sel < T)[:, None], t[sel.clamp(max=T - 1)], 0)
        i = (i + g) & (T - 1)
    return _as_int32(i)


# ----------------------------------------------------------------- gather2d


def gather2d_shape(rows: int, mode: str = "gather2d_all", sms: int = SM_COUNT) -> tuple:
    """``(warps, blocks)`` of a ``gather2d`` launch over ``rows`` rows:
    ``warps`` rows a block, a warp a row.  The single sublane gather runs a
    thread an index, ``G2_MAX_WARPS`` rows a block, so that a block of
    1,024 threads stages its shared copy of the table one word a thread;
    the chains take the most rows a block (a power of two up to
    ``G2_MAX_WARPS``) that still makes a block for each of the ``sms`` SMs,
    one row a block where the rows are fewer than the SMs.  At 512 rows: 2
    rows a block, 256 blocks."""
    warps = G2_MAX_WARPS
    while mode != "sublane" and warps > 1 and -(-rows // warps) < sms:
        warps //= 2
    return warps, -(-rows // warps)


def gather2d(tab: torch.Tensor, idx: torch.Tensor, reps: int, mode: str, *, mask: int = 0,
             sum_out: bool = False) -> torch.Tensor:
    """The sublane and the sublane-then-lane gathers of an (8, 128) table
    over ``idx`` (``uint32[8 k, 128]``): int32 of ``idx``'s shape, or with
    ``sum_out`` its int32 sum.  ``mask`` is the 2-D gather's ``T - 1``."""
    _check_words("gather2d", tab=tab, idx=idx)
    dev = _check("gather2d", tab, idx)
    if tuple(tab.shape) != (8, 128):
        raise ValueError(f"gather2d: the table is (8, 128), got {tuple(tab.shape)}")
    if idx.dim() != 2 or idx.shape[1] != 128 or idx.shape[0] < 8 or idx.shape[0] % 8 or reps < 0:
        raise ValueError(f"gather2d: idx must be (8 k, 128) and reps >= 0, got {tuple(idx.shape)}")
    if mode not in G2_MODES:
        raise ValueError(f"gather2d: mode {mode!r} is not one of {G2_MODES}")
    if not 0 <= mask < 1 << 32:
        raise ValueError(f"gather2d: mask must lie in [0, 2**32), got {mask}")
    if dev.type == "cpu":
        return gather2d_plain(tab, idx, reps, mode, mask=mask, sum_out=sum_out)
    out = _sum_out(dev) if sum_out else torch.empty_like(idx, dtype=torch.int32)
    _launch("gather2d", dev, tab.data_ptr(), idx.data_ptr(), idx.shape[0], reps, mask,
            G2_MODES.index(mode), int(sum_out), *gather2d_shape(idx.shape[0], mode), out.data_ptr())
    return out[0] if sum_out else out


def gather2d_plain(tab, idx, reps, mode, *, mask=0, sum_out=False) -> torch.Tensor:
    t = _words(tab)
    x = _words(idx)
    lanes = torch.arange(128, device=x.device)
    if mode == "sublane":
        x = t[x & 7, lanes]
    elif mode == "sublane_chain":
        x = x & 7
        for _ in range(reps):
            x = (t[x, lanes] + x) & 7
    else:
        every = mode == "gather2d_all"
        rows = x.shape[0] if every else 8
        for r in range(reps):
            blk = x[:rows].reshape(-1, 8, 128)
            lane = blk & 127
            sub = (torch.gather(blk, 2, lane) >> 7) & 7  # idx[i, L] of the same row
            add = torch.zeros_like(x)
            add[:rows] = t[sub, lane].reshape(rows, 128)
            x = (x + add + (r if every else 0)) & mask
    if sum_out:
        return _as_int32(x.sum().reshape(1))[0]
    return _as_int32(x)
