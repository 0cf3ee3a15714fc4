"""The fused switch response path (StateT write + fingerprint filter) —
CUDA kernel B2 and its wrappers.

Port of the TPU kernel ``repro.kernels.tickfuse`` with the config axis
native: ``server_state (G, n_servers)``, ``tables (G, n_tables, n_slots)``,
lanes ``(G, K)``.  The kernel (``csrc/tickfuse.cu``) gives each config a
warp and resolves its lanes 32 at a time in parallel (``csrc/
filter_common.cuh``; :func:`~repro_torch.kernels.fingerprint_filter.
emulate_warps` mirrors it on the CPU) with the reference's lane-sequential
semantics, and updates both tables **in place** in device memory.  Two
entry points launch it:

- :func:`tickfuse_response_path`, the reference's: int32 lanes, inactive
  lanes neutralised by the caller (``sid = n_servers``, ``clo = 0``);
- :func:`tickfuse_masked`, the staged engine's: ``active`` (bool), ``idx``
  and ``sid`` (int64), ``rid``, ``clo`` and ``qlen`` (int32), read in place
  with their strides, the inactive lanes neutralised inside the kernel.

On CPU tensors each runs its plain version (:func:`repro_torch.kernels.ref.
tickfuse_ref`, :func:`~repro_torch.kernels.ref.tickfuse_masked_ref`); on
CUDA tensors it launches the kernel or raises.  Both launch paths are
lean and can be captured in a CUDA graph, as B1's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fingerprint_filter import check_filter_args, \
    check_out, launch_on, raise_on

_P = ctypes.c_void_p
_I = ctypes.c_int
_I32, _I64 = torch.int32, torch.int64


@functools.cache
def _lib():
    lib = build.load("tickfuse")
    lib.tickfuse_launch.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.tickfuse_launch.restype = _I
    lib.tickfuse_masked_launch.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    lib.tickfuse_masked_launch.restype = _I
    return lib


def check_state(server_state, tables) -> None:
    if (server_state.dtype is not _I32 or server_state.dim() != 2
            or server_state.shape[0] != tables.shape[0]
            or server_state.get_device() != tables.get_device()
            or not server_state.is_contiguous()):
        raise ValueError("server_state must be a contiguous int32 "
                         "(G, n_servers) tensor on the tables' device")


def tickfuse_response_path(server_state, tables, req_id, idx, clo, sid,
                           qlen, *, out=None):
    """Returns ``(server_state, tables, drop)``: both tables updated in
    place, ``drop`` ``(G, K)`` bool (written into ``out`` when given)."""
    check_filter_args(tables, (req_id, idx, clo, sid, qlen), out)
    check_state(server_state, tables)
    if not tables.is_cuda:
        _, _, drop = ref.tickfuse_ref(server_state, tables, req_id, idx, clo,
                                      sid, qlen)
        return server_state, tables, (drop if out is None
                                      else out.copy_(drop))
    g, n_tables, n_slots = tables.shape
    drop = torch.empty(req_id.shape, dtype=torch.bool,
                       device=tables.device) if out is None else out
    raise_on(launch_on(
        tables.get_device(), _lib().tickfuse_launch, server_state.data_ptr(),
        tables.data_ptr(), req_id.data_ptr(), idx.data_ptr(), clo.data_ptr(),
        sid.data_ptr(), qlen.data_ptr(), drop.data_ptr(), g,
        server_state.shape[1], n_tables, n_slots, req_id.shape[1]),
        "tickfuse_response_path")
    tickfuse_response_path.launches += 1
    return server_state, tables, drop


tickfuse_response_path.launches = 0


@functools.lru_cache(maxsize=64)
def _strides(st: tuple):
    return (ctypes.c_int64 * 12)(*st)


def tickfuse_masked(server_state, tables, rid, idx, clo, sid, qlen, active,
                    *, out=None):
    """B2 on the staged engine's lanes: ``active`` ``(G, K)`` bool, ``idx``
    and ``sid`` int64, ``rid``, ``clo`` and ``qlen`` int32, any strides.
    An inactive lane counts as ``clo = 0, sid = n_servers``; ``idx`` and
    ``sid`` are cast to int32 as the staged path cast them.  Returns
    ``(server_state, tables, drop)`` as :func:`tickfuse_response_path`,
    whose launch count it adds to (the same kernel)."""
    lanes = (active, rid, idx, clo, sid, qlen)
    dev = tables.get_device()
    for t, dtype in zip(lanes, (torch.bool, _I32, _I64, _I32, _I64, _I32)):
        if t.dtype is not dtype:
            raise TypeError(f"active, rid, idx, clo, sid, qlen must be bool, "
                            f"int32, int64, int32, int64, int32; got "
                            f"{[x.dtype for x in lanes]}")
        if t.get_device() != dev:
            raise ValueError("all tensors must be on one device")
    shape = active.shape
    if (tables.dim() != 3 or tables.dtype is not _I32
            or not tables.is_contiguous() or len(shape) != 2
            or shape[0] != tables.shape[0]
            or any(t.shape != shape for t in lanes)):
        raise ValueError(f"tables must be a contiguous int32 (G, n_tables, "
                         f"n_slots) tensor and the lanes (G, K), got "
                         f"{tuple(tables.shape)} and "
                         f"{[tuple(x.shape) for x in lanes]}")
    check_state(server_state, tables)
    check_out(out, shape, dev)
    if not tables.is_cuda:
        _, _, drop = ref.tickfuse_masked_ref(server_state, tables, rid, idx,
                                             clo, sid, qlen, active)
        return server_state, tables, (drop if out is None
                                      else out.copy_(drop))
    g, n_tables, n_slots = tables.shape
    drop = torch.empty(shape, dtype=torch.bool, device=tables.device) \
        if out is None else out
    raise_on(launch_on(
        tables.get_device(), _lib().tickfuse_masked_launch,
        server_state.data_ptr(), tables.data_ptr(), active.data_ptr(),
        rid.data_ptr(), idx.data_ptr(), clo.data_ptr(), sid.data_ptr(),
        qlen.data_ptr(), _strides(sum((t.stride() for t in lanes), ())),
        drop.data_ptr(), g, server_state.shape[1], n_tables, n_slots,
        shape[1]), "tickfuse_masked")
    tickfuse_response_path.launches += 1
    tickfuse_masked.launches += 1
    return server_state, tables, drop


tickfuse_masked.launches = 0
