"""The probes' chain a window (``kernels/probes.window_chain``) in its staged
form (``csrc/window_chain.cuh``), on the CPU.

What each test compares:

* the tile plan, ``kernels.probes.window_plan`` (the ``.cu``'s choice,
  mirrored): at class widths of 1, 2 and 4 bytes, every width of 0-4,096
  classes and 1-8,192 windows, the staged form exactly where a row is
  16-byte aligned; its tiles cover each byte of a row once, in order, each a
  whole number of 16-byte vectors; a block's two buffers a warp stay within
  the 232,448 bytes a block can use; the blocks hold
  every window and no block is empty; and the 16-byte vectors a warp reads
  at one vector position of a tile (lane x stride + 16 j, either buffer)
  fall, a quarter-warp at a time, on 32 distinct banks;
* a numpy model of the staged walk (each warp's 32 windows, those past the
  last window not copied and their lanes' sums dropped, the tiles copied
  into the two buffers at the plan's strides, each vector decoded as the
  kernel decodes it, little-end class first) against
  ``window_chain_plain`` and the JAX chain, the step
  of ``tools/probes/probe7.py`` (``table[s * AP + c]`` in uint32, or
  ``table[s, c]``, under ``lax.scan``; XLA clamps a gather's indices);
* ``window_chain`` on CPU tensors (its twin) against the same two at the
  edge shapes of ``chip_smoke.check_window_kernels``, scaled down: uint8,
  uint16 and int32 windows of 0, 1, 3 and 25 classes and of rows of 16, 272
  and 784 bytes, 1, 33 and 65 windows, the window tensor on and one class
  off its base, flat strides 1, 32 and 33 and a 2-D table, full-range words
  and words below the table's size.  JAX is asked only where every index
  stays below 2**31, as probe7's do: it reads a larger uint32 index as a
  negative int32 one, which the kernel's unsigned clamp (PR 28's
  semantics, held to the twin) does not.

Every value is an integer: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ahocorasick_tpu_torch.kernels import probes as kp

M = 0xFFFFFFFF
DTYPES = {1: (np.uint8, torch.uint8), 2: (np.uint16, torch.uint16), 4: (np.int32, torch.int32)}
EDGE_W = (0, 1, 3, 25)
EDGE_ROW_BYTES = (16, 272, 784)
EDGE_B = (1, 33, 65)
BANKS = 32


def _staged_plans(cb, n):
    for width in range(4097):
        plan = kp.window_plan(cb, width, n)
        if plan["form"] == "staged":
            yield width, plan


@pytest.mark.parametrize("cb", (1, 2, 4))
def test_plan_form_and_tiles(cb):
    for width in range(4097):
        row = width * cb
        plan = kp.window_plan(cb, width, 8192)
        assert plan["form"] == ("staged" if row % 16 == 0 else "direct"), (cb, width)
        assert kp.window_plan(cb, width, 8192, base=cb)["form"] == "direct"
        if plan["form"] == "direct":
            continue
        tb = plan["tile_bytes"]
        assert tb == min(row, kp.WINDOW_TILE_BYTES)
        covered = np.zeros(row, np.int64)
        end = 0
        for off, nbytes in plan["tiles"]:
            assert off == end and 0 < nbytes <= tb and nbytes % 16 == 0, (cb, width, off)
            covered[off: off + nbytes] += 1
            end = off + nbytes
        assert end == row and (covered == 1).all(), (cb, width)
        assert len(plan["tiles"]) == -(-row // tb) if row else plan["tiles"] == []
        # the classes: each once, and a vector never splits one
        assert sum(b for _, b in plan["tiles"]) // cb == width


@pytest.mark.parametrize("cb", (1, 2, 4))
def test_plan_shared_bytes_and_blocks(cb):
    for width, plan in _staged_plans(cb, 8192):
        assert plan["stride"] % 16 == 0 and (plan["stride"] // 16) % 2 == 1
        assert plan["stride"] >= plan["tile_bytes"]
        assert plan["shared_bytes"] == plan["warps"] * 2 * 32 * plan["stride"]
        assert plan["shared_bytes"] <= kp.SHARED_BYTES, (cb, width)
    for width in (0, 16 // cb, 2096 // cb, 4096 - 4096 % (16 // cb)):
        for n in range(1, 8193):
            plan = kp.window_plan(cb, width, n)
            per = 32 * plan["warps"]
            assert plan["blocks"] * per >= n > (plan["blocks"] - 1) * per, (cb, width, n)


@pytest.mark.parametrize("cb", (1, 2, 4))
def test_plan_banks(cb):
    """A warp's vector reads at one position: lane l reads the 4 words at
    (buffer x 32 x stride + l x stride + 16 j) / 4; each quarter-warp
    (one shared wavefront of 16-byte reads) covers 32 distinct banks."""
    lanes = np.arange(32)
    for width, plan in _staged_plans(cb, 8192):
        st, tb = plan["stride"], plan["tile_bytes"]
        for buf in (0, 1):
            for j in range(tb // 16):
                byte = buf * 32 * st + lanes * st + 16 * j
                words = (byte[:, None] // 4 + np.arange(4)[None, :]) % BANKS
                for q in range(4):
                    assert len(set(words[8 * q: 8 * q + 8].ravel())) == BANKS, (cb, width, j)


def _words_np(tab: torch.Tensor) -> np.ndarray:
    return tab.view(torch.int32).numpy().view(np.uint32)


def staged_model(tab: torch.Tensor, w: np.ndarray, stride: int) -> int:
    """The staged walk's int32 sum, in numpy: the plan's tiles copied, warp
    by warp, into two buffers at lane x stride, each 16-byte vector decoded
    little-end class first, a step per class."""
    n, width = w.shape
    cb = w.dtype.itemsize
    plan = kp.window_plan(cb, width, n)
    assert plan["form"] == "staged"
    flat = _words_np(tab).reshape(-1).astype(np.int64)
    rows = tab.shape[0] if tab.dim() == 2 else 0
    raw = np.ascontiguousarray(w).view(np.uint8).reshape(n, width * cb)
    st = plan["stride"]
    total = 0
    for first in range(0, plan["blocks"] * plan["warps"] * 32, 32):
        if first >= n:
            continue
        valid = min(n - first, 32)
        area = np.zeros(2 * 32 * st, np.uint8)
        s = np.zeros(32, np.int64)
        for t, (off, nbytes) in enumerate(plan["tiles"]):
            base = (t & 1) * 32 * st
            for lane in range(valid):
                area[base + lane * st: base + lane * st + nbytes] = raw[first + lane,
                                                                        off: off + nbytes]
            for j in range(nbytes // 16):
                at = base + np.arange(32)[:, None] * st + 16 * j + np.arange(16)[None, :]
                vec = area[at].copy().view(w.dtype.newbyteorder("<")).astype(np.int64) & M
                for c in vec.T:
                    if rows:
                        i = np.minimum(s, rows - 1) * stride + np.minimum(c, stride - 1)
                    else:
                        i = np.minimum((s * stride + c) & M, flat.size - 1)
                    s = flat[i]
        total += int(s[:valid].sum())
    return total & M


def jax_chain(tab: torch.Tensor, w: np.ndarray, stride: int) -> int:
    """probe7's step under ``lax.scan``, from s = 0: the int32 sum of the
    final states, read as uint32."""
    t = jnp.asarray(_words_np(tab))
    if tab.dim() == 2:
        def step(s, c):
            return t[s, c], None
    else:
        def step(s, c):
            return t[s * jnp.uint32(stride) + c.astype(jnp.uint32)], None
    s0 = jnp.zeros(w.shape[0], jnp.uint32)
    s_fin, _ = lax.scan(step, s0, jnp.asarray(w).T)
    return int(np.asarray(s_fin).astype(np.uint64).sum()) & M


def _tables(gen):
    full = gen.integers(-(1 << 31), 1 << 31, 600 * 33).astype(np.int32)
    small = gen.integers(0, 700, 600 * 33).astype(np.int32)
    return {"full-range": torch.from_numpy(full), "below 700": torch.from_numpy(small)}


def _forms(words):
    for stride in (1, 32, 33):
        yield f"flat stride {stride}", words, stride
    yield "600 x 33", words.view(600, 33), 33


@pytest.mark.parametrize("cb", (1, 2, 4))
@pytest.mark.parametrize("row_bytes", EDGE_ROW_BYTES)
def test_staged_model_vs_twin_and_jax(cb, row_bytes):
    gen = np.random.default_rng(29 * cb + row_bytes)
    np_dt, _ = DTYPES[cb]
    for B in EDGE_B:
        w = gen.integers(0, 40, (B, row_bytes // cb)).astype(np_dt)
        for tname, words in _tables(gen).items():
            for label, tab, stride in _forms(words):
                want = int(kp.window_chain_plain(tab, torch.from_numpy(w), stride)) & M
                assert staged_model(tab, w, stride) == want, (cb, row_bytes, B, tname, label)
                if B == 33 and tname == "below 700":
                    assert jax_chain(tab, w, stride) == want, (cb, row_bytes, label)


@pytest.mark.parametrize("cb", (1, 2, 4))
def test_window_chain_cpu_edges(cb):
    """``window_chain`` on CPU tensors (the twin) at the smoke's edge shapes,
    scaled down, against the twin called directly and the JAX chain (at 33
    windows)."""
    gen = np.random.default_rng(290 + cb)
    np_dt, t_dt = DTYPES[cb]
    tables = _tables(gen)
    for W in sorted({*EDGE_W, *(b // cb for b in EDGE_ROW_BYTES)}):
        raw = gen.integers(0, 40, max(EDGE_B) * W + 1).astype(np_dt)
        for off in (0, 1):
            for B in EDGE_B:
                w_np = raw[off: off + B * W].reshape(B, W)
                w = torch.from_numpy(raw).view(t_dt)[off: off + B * W].view(B, W)
                for tname, words in tables.items():
                    for label, tab, stride in _forms(words):
                        got = int(kp.window_chain(tab, w, None if tab.dim() == 2 else stride))
                        want = int(kp.window_chain_plain(tab, w, stride))
                        assert got == want, (cb, W, off, B, tname, label)
                        if B == 33 and off == 0 and tname == "below 700":
                            assert got & M == jax_chain(tab, w_np, stride), (cb, W, label)
