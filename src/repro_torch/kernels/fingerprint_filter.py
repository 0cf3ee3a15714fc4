"""NetClone fingerprint filter (paper §3.5) — CUDA kernel and its wrapper.

Port of the TPU kernel ``repro.kernels.fingerprint_filter`` with the config
axis native: ``tables (G, n_tables, n_slots)``, lanes ``(G, K)``, all
int32.  The kernel (``csrc/fingerprint_filter.cu``) walks each config's
lanes in order, configs in parallel, and updates ``tables`` **in place** in
device memory.  On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.fingerprint_filter_ref`) instead; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_filter_args(tables, lanes) -> None:
    """Device, dtype, shape and contiguity checks shared by both wrappers."""
    if tables.dim() != 3:
        raise ValueError(f"tables must be (G, n_tables, n_slots), got "
                         f"{tuple(tables.shape)}")
    for t in (tables, *lanes):
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 tensors, got {t.dtype}")
        if t.device != tables.device:
            raise ValueError("all tensors must be on one device, got "
                             f"{t.device} and {tables.device}")
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    g = tables.shape[0]
    shape = lanes[0].shape
    for t in lanes:
        if t.dim() != 2 or t.shape[0] != g or t.shape != shape:
            raise ValueError(f"lanes must all be (G={g}, K), got "
                             f"{[tuple(x.shape) for x in lanes]}")
    if tables.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tables.device}")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def _lib():
    lib = build.load("fingerprint_filter")
    lib.fingerprint_filter_launch.argtypes = [_P, _P, _P, _P, _P,
                                              _I, _I, _I, _I, _P]
    lib.fingerprint_filter_launch.restype = _I
    return lib


def fingerprint_filter(tables, req_id, idx, clo):
    """Returns ``(tables, drop)``: ``tables`` updated in place, ``drop``
    ``(G, K)`` bool."""
    check_filter_args(tables, (req_id, idx, clo))
    if tables.device.type == "cpu":
        return ref.fingerprint_filter_ref(tables, req_id, idx, clo)
    lib = _lib()
    g, n_tables, n_slots = tables.shape
    drop = torch.empty(req_id.shape, dtype=torch.bool, device=tables.device)
    with torch.cuda.device(tables.device):
        err = lib.fingerprint_filter_launch(
            tables.data_ptr(), req_id.data_ptr(), idx.data_ptr(),
            clo.data_ptr(), drop.data_ptr(), g, n_tables, n_slots,
            req_id.shape[1], stream_of(tables.device))
    if err:
        raise RuntimeError(f"fingerprint_filter launch failed: "
                           f"cudaGetLastError() = {err}")
    fingerprint_filter.launches += 1
    return tables, drop


fingerprint_filter.launches = 0
