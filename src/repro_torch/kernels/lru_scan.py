"""The RG-LRU diagonal recurrence — CUDA kernel B5 and its wrapper.

Port of the TPU kernel ``repro.kernels.lru_scan``: ``h_t = a_t ⊙ h_{t-1} +
x_t`` in float32 from ``h0`` (zeros when absent), ``y`` in x's dtype and
the final state in float32.  The kernel (``csrc/lru_scan.cu``) gives each
thread one (batch, channel) pair and walks the sequence with its loads
issued ahead of the dependent FMA.  On a CPU tensor the wrapper runs the
plain version (:func:`repro_torch.kernels.ref.lru_scan_ref`); on a CUDA
tensor it launches the kernel or raises.

Length contract: any ``S, D >= 1``, as the reference's model path takes
them off a TPU, where ``impl="auto"`` resolves to its XLA path.  (The
reference's Pallas kernel also needs ``S`` divisible by ``min(256, S)``
and ``D`` by ``min(128, D)``, its default chunk and channel block; the
CUDA kernel guards ``t < S`` and ``d < D`` instead, ROADMAP C6.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = build.load("lru_scan")
    lib.lru_scan_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                                    _P]
    lib.lru_scan_launch.restype = _I
    return lib


def check_lru_args(x, a, h0) -> None:
    """Shapes, dtypes and devices; raises on what the kernel does not
    take."""
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"x and a must be one (B, S, D) shape, got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    bsz, s, d = x.shape
    if h0 is not None and h0.shape != (bsz, d):
        raise ValueError(f"h0 must be (B, D) = {(bsz, d)}, got "
                         f"{tuple(h0.shape)}")
    if x.dtype not in _DTYPE_CODE or a.dtype != x.dtype:
        raise TypeError(f"x and a must share one dtype of "
                        f"{list(_DTYPE_CODE)}, got {x.dtype} and {a.dtype}")
    if a.device != x.device or (h0 is not None and h0.device != x.device):
        raise ValueError("x, a and h0 must be on one device")
    if s == 0 or d == 0:
        raise ValueError(f"empty scan: S={s}, D={d}")


def lru_scan(x, a, h0=None):
    """x, a ``(B, S, D)`` float32 or bfloat16 (unit stride on D or they are
    copied), optional h0 ``(B, D)``.  Returns ``(y (B, S, D) in x's dtype,
    final state (B, D) float32)``."""
    check_lru_args(x, a, h0)
    if x.device.type == "cpu":
        return ref.lru_scan_ref(x, a, h0)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a, h0)):
        raise NotImplementedError(
            "lru_scan has no backward kernel yet: its CUDA path cannot "
            "carry a gradient (ROADMAP.md queue B, B5-bwd); run it under "
            "torch.no_grad() or with inputs that do not require grad")
    bsz, s, d = x.shape
    x, a = (t if t.stride(2) == 1 else t.contiguous() for t in (x, a))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    y = torch.empty((bsz, s, d), dtype=x.dtype, device=x.device)
    h_t = torch.empty((bsz, d), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 4)(x.stride(0), x.stride(1), a.stride(0),
                                   a.stride(1))
    with torch.cuda.device(x.device):
        err = _lib().lru_scan_launch(
            x.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_t.data_ptr(), _DTYPE_CODE[x.dtype], bsz, s, d,
            ctypes.cast(strides, ctypes.c_void_p),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"lru_scan launch failed: cudaGetLastError() = "
                           f"{err}")
    lru_scan.launches += 1
    return y, h_t


lru_scan.launches = 0
