"""The fused switch response path (StateT write + fingerprint filter) —
CUDA kernel and its wrapper.

Port of the TPU kernel ``repro.kernels.tickfuse`` with the config axis
native: ``server_state (G, n_servers)``, ``tables (G, n_tables, n_slots)``,
lanes ``(G, K)``, all int32.  Inactive lanes arrive neutralised
(``sid = n_servers``, ``clo = 0``).  The kernel (``csrc/tickfuse.cu``)
walks each config's lanes in order, configs in parallel, and updates both
tables **in place** in device memory.  On CPU tensors the wrapper runs the
plain version (:func:`repro_torch.kernels.ref.tickfuse_ref`); on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fingerprint_filter import check_filter_args, \
    stream_of

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("tickfuse")
    lib.tickfuse_launch.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.tickfuse_launch.restype = _I
    return lib


def tickfuse_response_path(server_state, tables, req_id, idx, clo, sid,
                           qlen):
    """Returns ``(server_state, tables, drop)``: both tables updated in
    place, ``drop`` ``(G, K)`` bool."""
    check_filter_args(tables, (req_id, idx, clo, sid, qlen))
    if (server_state.dtype != torch.int32 or server_state.dim() != 2
            or server_state.shape[0] != tables.shape[0]
            or server_state.device != tables.device
            or not server_state.is_contiguous()):
        raise ValueError("server_state must be a contiguous int32 "
                         "(G, n_servers) tensor on the tables' device")
    if tables.device.type == "cpu":
        return ref.tickfuse_ref(server_state, tables, req_id, idx, clo, sid,
                                qlen)
    lib = _lib()
    g, n_tables, n_slots = tables.shape
    drop = torch.empty(req_id.shape, dtype=torch.bool, device=tables.device)
    with torch.cuda.device(tables.device):
        err = lib.tickfuse_launch(
            server_state.data_ptr(), tables.data_ptr(), req_id.data_ptr(),
            idx.data_ptr(), clo.data_ptr(), sid.data_ptr(), qlen.data_ptr(),
            drop.data_ptr(), g, server_state.shape[1], n_tables, n_slots,
            req_id.shape[1], stream_of(tables.device))
    if err:
        raise RuntimeError(f"tickfuse_response_path launch failed: "
                           f"cudaGetLastError() = {err}")
    tickfuse_response_path.launches += 1
    return server_state, tables, drop


tickfuse_response_path.launches = 0
