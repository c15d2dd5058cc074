"""Failureless parallel trie walk (PFAC): the Hopper kernel and its plain
PyTorch twins.

One walk kernel in three modes (``csrc/pfac_scan.cu``), replacing the JAX
package's cross-check loops ``ahocorasick_tpu/ops/scan_pfac2.py``
``pfac2_bitplanes`` / ``pfac2_count`` and ``ops/scan_pfac.py``
``pfac_bitplanes``:

* ``pfac2_planes(trie, prefix, threshold, cls, depth, num_planes, prefix_k,
  num_classes, dead_state)`` — START-indexed depth bitplanes
  ``uint32[num_planes, n]`` over the ranked tables of
  ``ops/scan_pfac2.build_ranked``: bit ``(L-1) % 32`` of plane ``(L-1) // 32``
  at column i means a keyword of length L starts at i;
* ``pfac2_count(...)`` — the total of those bits, an int64 scalar tensor;
* ``pfac1_planes(trie, is_match, cls, depth, num_planes, dead_state)`` — the
  same planes from the unranked trie and an ``is_match`` lookup per depth.

``cls`` holds the ``pad_classes``-padded class ids (``uint8``, ``uint16`` or
``int32``): ``n = len(cls) - depth`` lanes, one per start.  ``trie`` is
``uint32`` (or ``int32``) ``[S, stride]``.  A lane stops at ``dead_state``,
which must absorb and emit nothing, as the ranked tables' dead state
(``RankedTables.dead_state``) and the padded trie's last row do.  The source
note in the ``.cu`` file says what bounds the kernel on the H100.

A wrapper runs the plain twin for tensors on the CPU, and launches the
kernel for tensors on a CUDA device: there is no fallback from one to the
other.  ``launches`` (``kernels/build.py``) counts kernel launches only.
"""

from __future__ import annotations

import torch

from ahocorasick_tpu_torch.kernels import build
from ahocorasick_tpu_torch.kernels.build import launches
from ahocorasick_tpu_torch.kernels.scan_batched import _to_uint32
from ahocorasick_tpu_torch.kernels.scan_block import _popcount32, _widen
from ahocorasick_tpu_torch.kernels.scan_wwl import _index

STATE_BITS = 28  # ops/scan_pfac2._STATE_BITS: packed prefix entries
_CLASS_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}


def _check(name, trie, cls, depth, num_planes, *tables):
    if trie.dtype not in (torch.int32, torch.uint32) or trie.dim() != 2:
        raise TypeError(f"{name}: trie must be uint32 or int32[S, stride], got {trie.dtype}"
                        f"{tuple(trie.shape)}")
    if cls.dtype not in _CLASS_BYTES or cls.dim() != 1:
        raise TypeError(f"{name}: classes must be uint8, uint16 or int32[n + depth], got "
                        f"{cls.dtype}{tuple(cls.shape)}")
    for t in (trie, *tables):
        if t.device != cls.device:
            raise ValueError(f"{name}: table on {t.device}, classes on {cls.device}")
    if not all(t.is_contiguous() for t in (trie, cls, *tables)):
        raise ValueError(f"{name}: tables and classes must be contiguous")
    if cls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {cls.device}")
    n = cls.numel() - depth
    if depth < 1 or n < 1 or num_planes < -(-depth // 32):
        raise ValueError(f"{name}: need depth >= 1, a lane and {-(-depth // 32)} planes; got "
                         f"depth={depth}, {cls.numel()} classes, {num_planes} planes")
    return n


def _check_v2(name, trie, prefix, cls, depth, num_planes, prefix_k, num_classes):
    if prefix.dtype != torch.uint32 or prefix.dim() != 1:
        raise TypeError(f"{name}: prefix must be uint32[A^k], got {prefix.dtype}")
    # The k-gram entries index the A^k table: a depth below k would read the
    # wrong gram's entry and silently drop every match.
    if not 1 <= prefix_k <= depth:
        raise ValueError(f"{name}: max_depth {depth} must be >= prefix_k {prefix_k} >= 1")
    if prefix.numel() != num_classes ** prefix_k:
        raise ValueError(f"{name}: prefix has {prefix.numel()} entries, not "
                         f"{num_classes}^{prefix_k}")
    return _check(name, trie, cls, depth, num_planes, prefix)


def _stream(dev):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def pfac2_planes(trie, prefix, threshold: int, cls, depth: int, num_planes: int, prefix_k: int,
                 num_classes: int, dead_state: int) -> torch.Tensor:
    """START-indexed depth bitplanes ``uint32[num_planes, n]``."""
    n = _check_v2("pfac2_planes", trie, prefix, cls, depth, num_planes, prefix_k, num_classes)
    if cls.device.type == "cpu":
        return pfac2_planes_plain(trie, prefix, threshold, cls, depth, num_planes, prefix_k,
                                  num_classes)
    out = torch.empty((num_planes, n), dtype=torch.uint32, device=cls.device)
    build.call("pfac2_planes", trie.data_ptr(), trie.shape[1], prefix.data_ptr(), threshold,
               int(dead_state), cls.data_ptr(), _CLASS_BYTES[cls.dtype], n, depth, prefix_k,
               num_classes, num_planes, out.data_ptr(), *_stream(cls.device))
    launches["pfac2_planes"] += 1
    return out


def pfac2_count(trie, prefix, threshold: int, cls, depth: int, prefix_k: int, num_classes: int,
                dead_state: int) -> torch.Tensor:
    """The total match count of the walk, an int64 scalar tensor."""
    _check_v2("pfac2_count", trie, prefix, cls, depth, -(-depth // 32), prefix_k, num_classes)
    if cls.device.type == "cpu":
        return pfac2_count_plain(trie, prefix, threshold, cls, depth, prefix_k, num_classes)
    out = torch.zeros(1, dtype=torch.int64, device=cls.device)
    build.call("pfac2_count", trie.data_ptr(), trie.shape[1], prefix.data_ptr(), threshold,
               int(dead_state), cls.data_ptr(), _CLASS_BYTES[cls.dtype], cls.numel() - depth,
               depth, prefix_k, num_classes, out.data_ptr(), *_stream(cls.device))
    launches["pfac2_count"] += 1
    return out[0]


def pfac1_planes(trie, is_match, cls, depth: int, num_planes: int,
                 dead_state: int) -> torch.Tensor:
    """The v1 walk's START-indexed bitplanes ``uint32[num_planes, n]``."""
    if is_match.dtype != torch.bool or is_match.dim() != 1 or is_match.numel() < trie.shape[0]:
        raise TypeError(f"pfac1_planes: is_match must be bool[S >= {trie.shape[0]}], got "
                        f"{is_match.dtype}{tuple(is_match.shape)}")
    n = _check("pfac1_planes", trie, cls, depth, num_planes, is_match)
    if cls.device.type == "cpu":
        return pfac1_planes_plain(trie, is_match, cls, depth, num_planes)
    out = torch.empty((num_planes, n), dtype=torch.uint32, device=cls.device)
    build.call("pfac1_planes", trie.data_ptr(), trie.shape[1], is_match.data_ptr(),
               int(dead_state), cls.data_ptr(), _CLASS_BYTES[cls.dtype], n, depth, num_planes,
               out.data_ptr(), *_stream(cls.device))
    launches["pfac1_planes"] += 1
    return out


# ---------------------------------------------------------------- plain twins
#
# The JAX loops' algorithm: one batched lookup over the n lanes per depth,
# on int64 copies (torch has no uint32 shift), every depth walked.


def _gram_index(cls_padded: torch.Tensor, n: int, k: int, A: int) -> torch.Tensor:
    """The k-gram of classes starting at each of the n lanes, int64."""
    c = _index(cls_padded)
    idx = c[:n]
    for j in range(1, k):
        idx = idx * A + c[j: j + n]
    return idx


def _prefix_walk(trie, prefix, threshold, cls, depth, prefix_k, num_classes, hit):
    """``hit(kk, bits)`` per depth kk in [k, depth) after the prefix lookup;
    returns the prefix's match bits (bit d - 1: a match at depth d <= k)."""
    n = cls.numel() - depth
    c = _index(cls)
    packed = _widen(prefix)[_gram_index(cls, n, prefix_k, num_classes)]
    st = packed & ((1 << STATE_BITS) - 1)
    hist = packed >> STATE_BITS  # bit j: a match at depth k - j
    first = torch.zeros_like(st)
    for d in range(1, prefix_k + 1):
        first |= ((hist >> (prefix_k - d)) & 1) << (d - 1)
    tf = _index(trie).reshape(-1)
    stride = trie.shape[1]
    for kk in range(prefix_k, depth):
        st = tf[st * stride + c[kk: kk + n]]
        hit(kk, (st >= threshold).to(torch.int64))
    return first


def pfac2_planes_plain(trie, prefix, threshold, cls, depth, num_planes, prefix_k, num_classes):
    n = cls.numel() - depth
    planes = torch.zeros((num_planes, n), dtype=torch.int64, device=cls.device)

    def hit(kk, bits):
        planes[kk // 32] |= bits << (kk % 32)

    planes[0] |= _prefix_walk(trie, prefix, threshold, cls, depth, prefix_k, num_classes, hit)
    return _to_uint32(planes)


def pfac2_count_plain(trie, prefix, threshold, cls, depth, prefix_k, num_classes):
    total = torch.zeros((), dtype=torch.int64, device=cls.device)

    def hit(_kk, bits):
        total.add_(bits.sum())

    first = _prefix_walk(trie, prefix, threshold, cls, depth, prefix_k, num_classes, hit)
    return total + _popcount32(first).sum()


def pfac1_planes_plain(trie, is_match, cls, depth, num_planes):
    n = cls.numel() - depth
    c = _index(cls)
    tf = _index(trie).reshape(-1)
    stride = trie.shape[1]
    m = is_match.to(torch.int64)
    planes = torch.zeros((num_planes, n), dtype=torch.int64, device=cls.device)
    st = tf[c[:n]]  # row 0: the root
    planes[0] = m[st]
    for kk in range(1, depth):
        st = tf[st * stride + c[kk: kk + n]]
        planes[kk // 32] |= m[st] << (kk % 32)
    return _to_uint32(planes)
