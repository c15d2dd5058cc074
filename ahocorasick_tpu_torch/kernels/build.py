"""Build the CUDA kernels of ``csrc/`` with nvcc into one plain-C shared
library, and load it with ctypes.

The library is built at first use, from the package's own sources, into
``ahocorasick_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited kernel is never served from a stale build.  Each
source compiles to an object in its own nvcc process, all started together,
and one more nvcc call links the objects.  A temporary file plus
``os.replace`` keeps concurrent build processes from loading a half-written
library.  The headers the sources include (``HEADERS``) count in the hash.
Building needs ``nvcc`` (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``
or ``PATH``); the ptxas report (registers, shared memory, spills) is kept
beside the library as ``<name>.log``.

``launches`` counts kernel launches by wrapper name; each wrapper adds one
where it launches its kernel, and nowhere else.  A wrapper whose call makes
more than one launch (the synchronized ``state_maps``: two kernels) still
adds one a call, so that launches x time stays per call.  The sequential
scan's speculate-and-repair kernels (a lane a chunk, then the repair warps)
count under the wrapper that called them: ``seq_states_serial`` or
``shortest_states`` (``seq_states_spec``, one row), ``rescan_serial`` (one
row a stitch chunk) and ``state_maps_all`` (the reference runs, then the
meet kernel: three launches a call).

    python -m ahocorasick_tpu_torch.kernels.build
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(
    os.path.join(_PKG, "csrc", name)
    for name in ("packed_scan.cu", "compact.cu", "wwl_scan.cu", "wwl_walk.cu", "huge_scan.cu",
                 "seq_scan.cu", "stitch.cu", "table_sharded.cu", "rowdfa2_scan.cu", "probes.cu",
                 "pfac_scan.cu", "pfac1_scan.cu")
)
# Included by the sources; hashed with them, so an edited header rebuilds too.
HEADERS = tuple(os.path.join(_PKG, "csrc", name)
                for name in ("tile.cuh", "sweep.cuh", "pfac_walk.cuh", "gather2d.cuh",
                             "pfac1_walk.cuh", "window_chain.cuh"))
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = {
    "packed_scan_count": 0,
    "packed_scan_planes": 0,
    "compact_planes": 0,
    "shortest_states": 0,
    "wwl_scan_plane": 0,
    "wwl_sweep_at": 0,
    "wwl_walks_at": 0,
    "packedcount_count": 0,
    "packedcount_hotstate_plane": 0,
    "split_count": 0,
    "split_emit_planes": 0,
    "seq_states": 0,
    "seq_states_serial": 0,
    "wwl_sweep_all": 0,
    "state_maps": 0,
    "state_maps_all": 0,
    "entry_fold": 0,
    "rescan": 0,
    "rescan_serial": 0,
    "table_sharded_scan": 0,
    "table_sharded_step": 0,
    "table_sharded_classes": 0,
    "rowdfa2_count": 0,
    "rowdfa2_planes": 0,
    "chain_gather": 0,
    "row_chain": 0,
    "onehot_mma": 0,
    "gather2d": 0,
    "row_select": 0,
    "window_chain": 0,
    "pfac2_planes": 0,
    "pfac2_count": 0,
    "pfac1_planes": 0,
    "wwl_scan_fused": 0,
}


# The units that the sequential scan's launches scanned, by kernel: the lane
# scan ("seq_states") and the speculate-and-repair form ("seq_states_serial").
seq_units = {"seq_states": 0, "seq_states_serial": 0}


def reset_launches() -> None:
    for counts in (launches, seq_units):
        for name in counts:
            counts[name] = 0


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (table, windows, window_bytes, num_windows, width, halo, num_classes,
#  state_bits, out, device, stream)
_SCAN_ARGS = [_P, _P, _I, _I64, _I, _I, _I, _I, _P, _I, _P]
# _SCAN_ARGS with (segments, seg_len) before out
_SEGMENTED_ARGS = [*_SCAN_ARGS[:8], _I, _I, *_SCAN_ARGS[8:]]
# (dfa_flat, emit_tab, windows, window_bytes, num_windows, width, halo,
#  num_classes, num_planes, segments, seg_len, out, device, stream)
_SPLIT_SEGMENTED_ARGS = [_P, *_SEGMENTED_ARGS]
ARGTYPES = {
    "packed_scan_count": _SEGMENTED_ARGS,
    "packed_scan_planes": _SEGMENTED_ARGS,
    "packedcount_count": _SEGMENTED_ARGS,
    "packedcount_hotstate_plane": _SEGMENTED_ARGS,
    "rowdfa2_count": _SEGMENTED_ARGS,
    "rowdfa2_planes": _SEGMENTED_ARGS,
    "split_count": _SPLIT_SEGMENTED_ARGS,
    "split_emit_planes": _SPLIT_SEGMENTED_ARGS,
    "compact_tile": [],
    # (bits, planes, n, cap, desc, idx, masks, device, stream)
    "compact_planes": [_P, _I, _I64, _I64, _P, _P, _P, _I, _P],
    # (table, windows, class_bytes, num_windows, width, halo, stride,
    #  num_classes, id_bits, segments, seg_len, plane, entry, device, stream)
    "wwl_scan_plane": [_P, _P, _I, _I64, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    # (table, windows, class_bytes, num_windows, width, halo, stride, d,
    #  id_bits, depth_bits, cross, segments, seg_len, starts, num_starts,
    #  lane_slots, outrows, meta, die_pos, has, m_start, m_end, m_val, cont,
    #  device, stream)
    "wwl_scan_fused": [_P, _P, _I, _I64, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I64, _I64,
                       _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # (plane, entry, rows_flat, outrows, starts, num_starts, live, d, id_bits,
    #  depth_bits, cross, die_pos, has, m_start, m_end, m_val, cont, device,
    #  stream)
    "wwl_sweep_at": [_P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I,
                     _P, _P, _P, _P, _P, _P, _I, _P],
    # (trie_next, prefix, rows, class_is_word, num_states, stride, prefix_k,
    #  cls, cls_bytes, num_cls, starts, num_starts, max_depth, die_pos, has,
    #  m_start, m_end, m_val, device, stream)
    "wwl_walks_at": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I64, _P, _I64, _I,
                     _P, _P, _P, _P, _P, _I, _P],
    # (table, row_id or null, cls, cls_bytes, n, num_classes, s0, chunk_len,
    #  out, repair or null, device, stream)
    "seq_states_spec": [_P, _P, _P, _I, _I64, _I, _I, _I64, _P, _P, _I, _P],
    # (table, row_id or null, cls, n, num_classes, s0, depth, lane_len, out,
    #  device, stream)
    "seq_states_sync": [_P, _P, _P, _I64, _I, _I, _I, _I, _P, _I, _P],
    # (plane, entry, rows_flat, outrows, n_keep, live, d, id_bits, depth_bits,
    #  cross, die_pos, has, m_start, m_end, m_val, cont, device, stream)
    "wwl_sweep_all": [_P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P, _I, _P],
    # (table, cls, num_chunks, chunk_len, num_states, num_classes, sub_len,
    #  run scratch, sigma, meet or null, device, stream)
    "state_maps_all": [_P, _P, _I64, _I64, _I64, _I, _I64, _P, _P, _P, _I, _P],
    # (table, cls, num_chunks, chunk_len, num_states, num_classes, depth,
    #  agree, sigma, device, stream)
    "state_maps": [_P, _P, _I64, _I64, _I64, _I, _I, _P, _P, _I, _P],
    # (sigma, num_chunks, num_states, s0, lanes, entry, repair or null, device,
    #  stream)
    "entry_fold": [_P, _I64, _I64, _I, _I, _P, _P, _I, _P],
    # (table, cls, entry or null, num_chunks, chunk_len, num_classes, sub_len,
    #  out, repair or null, device, stream)
    "rescan_serial": [_P, _P, _P, _I64, _I64, _I, _I64, _P, _P, _I, _P],
    # (table, cls, entry, num_chunks, chunk_len, num_classes, depth, lane_len,
    #  out, device, stream)
    "rescan": [_P, _P, _P, _I64, _I64, _I, _I, _I, _P, _I, _P],
    # (shard pointers, owners (host int array), n_model, rows_per, stride,
    #  magic, add, shift, windows, window_bytes, num_windows, width, halo,
    #  state_bits, mode, segments, seg_len, out, device, stream)
    "table_sharded_scan": [_P, _P, _I, _I64, _I, _I64, _I64, _I, _P, _I, _I64, _I, _I, _I, _I,
                           _I, _I, _P, _I, _P],
    # (shard, rows_per, stride, lo, classes (class-major), window_bytes,
    #  num_windows, width, halo, state_bits, mode, segments, seg_len, t, words,
    #  out, total or null, device, stream)
    "table_sharded_step": [_P, _I64, _I, _I64, _P, _I, _I64, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P, _I, _P],
    # (windows, window_bytes, num_windows, width, halo, segments, seg_len,
    #  out, device, stream)
    "table_sharded_classes": [_P, _I, _I64, _I, _I, _I, _I, _P, _I, _P],
    # (tab, T, idx, n, reps, op, placement, mod, sum_out, out, device, stream)
    "chain_gather": [_P, _I64, _P, _I64, _I, _I, _I, _I64, _I, _P, _I, _P],
    # (tab, rows, width, s0, n, reps, reduce, mod, group, out, device, stream)
    "row_chain": [_P, _I64, _I, _P, _I64, _I, _I, _I64, _I, _P, _I, _P],
    # (fp16 tab transposed, T, ncols, idx, B, reps, out, device, stream)
    "onehot_mma": [_P, _I, _I, _P, _I, _I, _P, _I, _P],
    # (tab, idx, rows, reps, mask, mode, sum_out, warps, blocks, out, device,
    #  stream)
    "gather2d": [_P, _P, _I64, _I, _I64, _I, _I, _I, _I64, _P, _I, _P],
    # (tab, rows, width, s0, cols, R, n, reps, how, mod, add_r, is_signed,
    #  group, out, device, stream)
    "row_select": [_P, _I64, _I, _P, _P, _I, _I64, _I, _I, _I64, _I, _I, _I, _P, _I, _P],
    # (tab, numel, rows (0: flat), stride, windows, window_bytes, num_windows,
    #  width, out, device, stream)
    "window_chain": [_P, _I64, _I64, _I64, _P, _I, _I64, _I, _P, _I, _P],
    # (trie, stride, prefix, threshold, dead, cls, cls_bytes, n, depth, k,
    #  num_classes, num_planes, grid, span, prefix_shared, out, device, stream)
    "pfac2_planes": [_P, _I, _P, _I64, _I64, _P, _I, _I64, _I, _I, _I, _I, _I, _I64, _I, _P,
                     _I, _P],
    # the same without num_planes; out is one int64 count
    "pfac2_count": [_P, _I, _P, _I64, _I64, _P, _I, _I64, _I, _I, _I, _I, _I64, _I, _P, _I,
                    _P],
    # (trie, stride, states, is_match, dead, cls, cls_bytes, n, depth,
    #  num_planes, grid, two_level, out, device, stream)
    "pfac1_planes": [_P, _I, _I64, _P, _I64, _P, _I, _I64, _I, _I, _I, _I, _P, _I, _P],
}

_lib = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(sources=SOURCES, stem: str = "libac_kernels") -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in (*sources, *HEADERS):
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build(sources=SOURCES, stem: str = "libac_kernels") -> str:
    """Compile ``sources`` into one library unless a build of these exact
    sources exists; returns the library path."""
    out = library_path(sources, stem)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{out}.tmp.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    procs = [
        subprocess.Popen([nvcc, *FLAGS, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(sources, objs)
    ]
    logs = []
    try:
        for src, proc in zip(sources, procs):
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {os.path.basename(src)} ({proc.returncode}):\n{stderr}")
            logs.append(stdout + stderr)
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(out[: -len(".so")] + ".log", "w") as fh:
        fh.write("".join(logs))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, args in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Call a launcher of the library and raise on a CUDA error code."""
    rc = getattr(library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


if __name__ == "__main__":
    print(build())
