"""The probes' row read (``row_chain``, B19) on the CPU: the plain twin that
the wrapper runs for CPU tensors against a numpy statement of the chain, and
the rule that gives the kernel's lanes a chain (``row_group``).

The kernel reads a row with a group of G lanes (16-byte words where the row
is 16-byte aligned, else 4-byte words); the twin is what the card's kernel
is held to bit for bit.  The edges here are the ones the card is checked at:
widths 1, 27, 28, 33 and 128, starts past the last row (the clamp), ``mod``
1 and 2**32 - 1, full-range words read as int32 and as uint32, both reduce
forms.  Everything compared is an integer: exact equality.
"""

import numpy as np
import pytest
import torch

from ahocorasick_tpu_torch.kernels import probes as kp
from ahocorasick_tpu_torch.kernels.build import launches

WIDTHS = (1, 27, 28, 33, 128)
MODS = {"1": 1, "rows": None, "2**32-1": (1 << 32) - 1}


def _table(width: int, rows: int = 61, seed: int = 5) -> np.ndarray:
    """uint32[rows, width] of full-range words, 0xFFFFFFFF and 0 among them."""
    rng = np.random.default_rng(seed + width)
    t = rng.integers(0, 1 << 32, (rows, width), dtype=np.uint64).astype(np.uint32)
    t.reshape(-1)[::7] = 0xFFFFFFFF
    t.reshape(-1)[3::11] = 0
    return t


def _numpy_chain(tab: np.ndarray, s0: np.ndarray, reps: int, reduce: str, mod: int):
    t = tab.astype(np.int64)
    s = s0.astype(np.int64) & 0xFFFFFFFF
    for _ in range(reps):
        rows = t[np.minimum(s, t.shape[0] - 1)]
        s = (rows.max(axis=1) if reduce == "max" else rows[:, 0]) % mod
    return s


@pytest.mark.parametrize("words", ["int32", "uint32"])
@pytest.mark.parametrize("mod", list(MODS))
@pytest.mark.parametrize("reduce", kp.REDUCES)
@pytest.mark.parametrize("width", WIDTHS)
def test_row_chain_twin_against_numpy(width, reduce, mod, words):
    tab = _table(width)
    rows = tab.shape[0]
    m = rows if MODS[mod] is None else MODS[mod]
    rng = np.random.default_rng(width)
    s0 = rng.integers(0, 3 * rows, 50).astype(np.int32)  # a third of them past the last row
    s0[:3] = (rows - 1, rows, 2 * rows)
    want = _numpy_chain(tab, s0, 9, reduce, m)
    t = torch.from_numpy(tab)
    t = t if words == "uint32" else t.view(torch.int32)
    before = launches["row_chain"]
    got = kp.row_chain(t, torch.from_numpy(s0), 9, reduce, m)
    assert got.dtype == torch.int32 and got.shape == (50,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32).astype(np.int64), want)
    assert launches["row_chain"] == before  # CPU tensors launch nothing


def test_row_chain_keeps_the_shape_of_its_starts():
    tab = torch.from_numpy(_table(28).view(np.int32))
    s0 = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    got = kp.row_chain(tab, s0, 4, "max", 61)
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                  kp.row_chain_plain(tab, s0.reshape(-1), 4, "max", 61).numpy())


@pytest.mark.parametrize("width,group", [(1, 1), (4, 1), (8, 1), (9, 2), (16, 2), (17, 4),
                                         (27, 4), (28, 4), (32, 4), (33, 8), (128, 8), (512, 8)])
def test_row_group_rule(width, group):
    """At most two 16-byte words a lane, at most 8 lanes a chain: the A/B's
    best at widths 28 (G = 4) and 128 (G = 8)."""
    assert kp.row_group(width) == group


def test_row_group_rule_is_monotone_and_bounded():
    last = 1
    for width in range(1, 1025):
        g = kp.row_group(width)
        assert g in kp.ROW_GROUPS and g >= last
        words = -(-width // 4)
        assert g == 8 or -(-words // g) <= 2  # at most two 16-byte words a lane
        assert g == 1 or -(-words // (g // 2)) > 2  # no fewer lanes would do
        last = g


@pytest.mark.parametrize("group", kp.ROW_GROUPS)
def test_row_chain_takes_every_group_size(group):
    """The twin is the same for every group size the A/B times."""
    tab = torch.from_numpy(_table(28).view(np.int32))
    s0 = torch.arange(0, 90, 3, dtype=torch.int32)
    np.testing.assert_array_equal(kp.row_chain(tab, s0, 5, "max", 61, group=group).numpy(),
                                  kp.row_chain_plain(tab, s0, 5, "max", 61).numpy())


def test_row_chain_refuses_what_the_kernel_cannot_take():
    tab = torch.zeros((8, 28), dtype=torch.int32)
    s0 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="group 3"):
        kp.row_chain(tab, s0, 1, "max", 8, group=3)
    with pytest.raises(ValueError, match="one lane a chain"):
        kp.row_chain(tab, s0, 1, "col0", 8, group=2)
    with pytest.raises(ValueError, match="mod"):
        kp.row_chain(tab, s0, 1, "max", 1 << 32)
    with pytest.raises(ValueError, match="reduce"):
        kp.row_chain(tab, s0, 1, "min", 8)
    assert kp.row_chain(tab, s0, 1, "col0", 8, group=1).shape == (4,)
