"""NetClone fingerprint filter (paper §3.5) — CUDA kernel B1 and its wrapper.

Port of the TPU kernel ``repro.kernels.fingerprint_filter`` with the config
axis native: ``tables (G, n_tables, n_slots)``, lanes ``(G, K)``, all
int32.  The kernel (``csrc/fingerprint_filter.cu``) gives each config a
warp, resolves its lanes 32 at a time in parallel (``csrc/
filter_common.cuh``; :func:`emulate_warps` mirrors it on the CPU) with the
lane-sequential semantics of the reference, and updates ``tables`` **in
place** in device memory.  On a CPU tensor the wrapper runs the plain
version (:func:`repro_torch.kernels.ref.fingerprint_filter_ref`) instead;
on a CUDA tensor it launches the kernel or raises.

The launch path is lean and can be captured in a CUDA graph: one pass of
checks (dtype, device, contiguity, the shapes that size the grid), the
current stream's raw handle, the device context entered only when another
device is current, an optional preallocated ``drop`` (``out=``), and no
host synchronisation.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.tables import fingerprint_hash
from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_I32 = torch.int32
#: lanes one warp resolves in a pass (``kWarp`` in filter_common.cuh)
WARP = 32
#: the launchers' code for sizes they refuse (``kBadSizes``)
_BAD_SIZES = -1


def check_filter_args(tables, lanes, out=None) -> None:
    """One pass of the checks that protect memory, shared by the wrappers:
    int32, one device, contiguous, ``tables (G, n_tables, n_slots)`` and
    every lane ``(G, K)``; ``out``, when given, a contiguous bool ``(G,
    K)`` on the same device."""
    dev = tables.get_device()
    for t in (tables, *lanes):
        if t.dtype is not _I32:
            raise TypeError(f"expected int32 tensors, got {t.dtype}")
        if t.get_device() != dev:
            raise ValueError("all tensors must be on one device, got "
                             f"{t.device} and {tables.device}")
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    shape = lanes[0].shape
    if (tables.dim() != 3 or len(shape) != 2 or shape[0] != tables.shape[0]
            or any(t.shape != shape for t in lanes)):
        raise ValueError(f"tables must be (G, n_tables, n_slots) and lanes "
                         f"(G, K), got {tuple(tables.shape)} and "
                         f"{[tuple(x.shape) for x in lanes]}")
    check_out(out, shape, dev)


def check_out(out, shape, dev: int) -> None:
    """``out`` (when given): a contiguous bool tensor of ``shape`` on
    device index ``dev`` (``get_device()``'s numbering)."""
    if out is not None and (out.dtype is not torch.bool
                            or out.shape != shape or out.get_device() != dev
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous bool {tuple(shape)} "
                         f"tensor on the tables' device")


def raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as a raw handle, without
    building a ``torch.cuda.Stream`` (under graph capture: the capturing
    stream)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch_on(index: int, fn, *args) -> int:
    """``fn(*args, stream)`` with device ``index`` current, entering its
    context only when another device is current; returns the C code."""
    if torch.cuda.current_device() == index:
        return fn(*args, raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, raw_stream(index))


def raise_on(err: int, what: str) -> None:
    if err == _BAD_SIZES:
        raise ValueError(f"{what}: the launcher refused the sizes")
    if err:
        raise RuntimeError(f"{what} launch failed: cudaGetLastError() = "
                           f"{err}")


@functools.cache
def _lib():
    lib = build.load("fingerprint_filter")
    for fn in (lib.fingerprint_filter_launch, lib.filter_noop_launch):
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def _filter(entry: str, tables, req_id, idx, clo, out):
    check_filter_args(tables, (req_id, idx, clo), out)
    if not tables.is_cuda:
        _, drop = ref.fingerprint_filter_ref(tables, req_id, idx, clo)
        return drop if out is None else out.copy_(drop)
    g, n_tables, n_slots = tables.shape
    drop = torch.empty(req_id.shape, dtype=torch.bool,
                       device=tables.device) if out is None else out
    raise_on(launch_on(tables.get_device(), getattr(_lib(), entry),
                       tables.data_ptr(), req_id.data_ptr(), idx.data_ptr(),
                       clo.data_ptr(), drop.data_ptr(), g, n_tables, n_slots,
                       req_id.shape[1]), entry)
    return drop


def fingerprint_filter(tables, req_id, idx, clo, *, out=None):
    """Returns ``(tables, drop)``: ``tables`` updated in place, ``drop``
    ``(G, K)`` bool (written into ``out`` when given)."""
    drop = _filter("fingerprint_filter_launch", tables, req_id, idx, clo,
                   out)
    if tables.is_cuda:
        fingerprint_filter.launches += 1
    return tables, drop


fingerprint_filter.launches = 0


def filter_floor(tables, req_id, idx, clo, *, out=None):
    """An empty kernel on B1's grid, launched through B1's whole path
    (checks, ctypes, stream): the floor a launch of B1 cannot go below.
    Needs CUDA tensors; touches nothing."""
    if not tables.is_cuda:
        raise ValueError("filter_floor launches an empty CUDA kernel; it "
                         "needs CUDA tensors")
    return _filter("filter_noop_launch", tables, req_id, idx, clo, out)


# ---------------------------------------------------- the kernel's plan ----
def match_any(keys) -> list[int]:
    """``__match_any_sync`` over one pass: for each lane, the bitmask of
    the lanes whose key equals its own."""
    return [sum(1 << j for j, other in enumerate(keys) if other == key)
            for key in keys]


def emulate_warps(tables, rid, idx, clo, server_state=None, sid=None,
                  qlen=None) -> np.ndarray:
    """The CUDA kernels' warp schedule on numpy arrays, step for step
    (``filter_pass`` and ``state_pass`` in ``csrc/filter_common.cuh``):
    each config's lanes in passes of :data:`WARP`; in a pass, the StateT
    write by the highest lane of each in-range sid (with ``server_state``,
    B2), then the filter: each lane keyed by the table entry it touches
    (or a key of its own), the lanes grouped by key, and each group's
    lowest lane walking its members in lane order against one read and
    one write of the entry.  Updates ``tables`` (and ``server_state``) in
    place and returns ``drop``; the CPU tests hold it to the plain versions
    and to the reference's Pallas kernels."""
    g, n_tables, n_slots = tables.shape
    flat = tables.reshape(g, n_tables * n_slots)
    k = rid.shape[1]
    drop = np.zeros((g, k), dtype=bool)
    for c in range(g):
        for base in range(0, k, WARP):
            lanes = range(base, base + WARP)
            live = [i < k for i in lanes]
            if server_state is not None:
                n_servers = server_state.shape[1]
                s = [int(sid[c, i]) if ok else n_servers
                     for i, ok in zip(lanes, live)]
                writes = [0 <= x < n_servers for x in s]
                keys = [x if w else ("own", j)
                        for j, (x, w) in enumerate(zip(s, writes))]
                for j, group in enumerate(match_any(keys)):
                    if writes[j] and j == group.bit_length() - 1:
                        server_state[c, s[j]] = qlen[c, base + j]
            r = [int(rid[c, i]) if ok else 0 for i, ok in zip(lanes, live)]
            touches = [ok and clo[c, i] > 0 and 0 <= idx[c, i] < n_tables
                       for i, ok in zip(lanes, live)]
            pos = [int(idx[c, base + j]) * n_slots
                   + fingerprint_hash(r[j], n_slots) if t else None
                   for j, t in enumerate(touches)]
            keys = [p if t else ("own", j)
                    for j, (p, t) in enumerate(zip(pos, touches))]
            for j, group in enumerate(match_any(keys)):
                if not touches[j] or group & -group != 1 << j:
                    continue                 # not the group's leader
                entry = int(flat[c, pos[j]])
                for m in range(WARP):
                    if group >> m & 1:
                        hit = entry == r[m]
                        entry = 0 if hit else r[m]
                        drop[c, base + m] = hit
                flat[c, pos[j]] = entry
    return drop
