"""mamba2's SSD scan — CUDA kernel B4 and its wrapper.

Port of the TPU kernel ``repro.kernels.ssd_scan``: per head, ``H_t = a_t·
H_{t-1} + x_t ⊗ b_t`` and ``y_t = H_t·c_t`` with the ``P × N`` state in
float32, the decay clamped at 1e-37 and the final state returned.  The
kernel (``csrc/ssd_scan.cu``) gives each CTA a block of state rows of one
(batch, head) and walks the sequence step by step on the CUDA cores.  On a
CPU tensor the wrapper runs the plain version (:func:`repro_torch.kernels.
ref.ssd_scan_ref`, the chunked form); on a CUDA tensor it launches the
kernel or raises.

Length contract: the reference's Pallas kernel needs ``S`` divisible by
``min(chunk, S)`` and its XLA path (which always chunks at 128) by
``min(128, S)``; this wrapper raises on both devices unless both hold, so
it accepts exactly what both of the reference's paths accept (ROADMAP C5).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int

#: the chunk the reference's XLA path always uses (``ref.ssd_scan_ref``)
XLA_CHUNK = 128
#: state widths N the kernel is built for (16 state columns a thread; the
#: N / 16 threads of a row pair within one warp)
STATE_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _P, _P]
    lib.ssd_scan_launch.restype = _I
    return lib


def check_ssd_args(x, a, b_mat, c_mat, h0, chunk: int) -> None:
    """Shapes, dtypes, devices and the length contract; raises on what the
    kernel (or either of the reference's paths) does not take."""
    if x.dim() != 4:
        raise ValueError("x must be (B, S, H, P)")
    bsz, s, h, p = x.shape
    if a.shape != (bsz, s, h):
        raise ValueError(f"a must be (B, S, H) = {(bsz, s, h)}, got "
                         f"{tuple(a.shape)}")
    if b_mat.dim() != 4 or b_mat.shape[:3] != (bsz, s, h) \
            or c_mat.shape != b_mat.shape:
        raise ValueError(f"b and c must be (B, S, H, N) with (B, S, H) = "
                         f"{(bsz, s, h)}, got {tuple(b_mat.shape)} and "
                         f"{tuple(c_mat.shape)}")
    n = b_mat.shape[3]
    if h0 is not None and h0.shape != (bsz, h, p, n):
        raise ValueError(f"h0 must be (B, H, P, N) = {(bsz, h, p, n)}, got "
                         f"{tuple(h0.shape)}")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for t in (a, b_mat, c_mat)):
        raise TypeError(f"x, a, b, c must share one dtype of "
                        f"{list(_DTYPE_CODE)}, got {x.dtype}, {a.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}")
    if any(t is not None and t.device != x.device
           for t in (a, b_mat, c_mat, h0)):
        raise ValueError("x, a, b, c and h0 must be on one device")
    if s == 0 or s % min(chunk, s) or s % min(XLA_CHUNK, s):
        raise ValueError(f"seq_len must be divisible by chunk: S={s} needs "
                         f"min({chunk}, S) and min({XLA_CHUNK}, S) to divide "
                         "it (the reference's Pallas and XLA paths)")


def ssd_scan(x, a, b_mat, c_mat, h0=None, *, chunk: int = 128):
    """x ``(B, S, H, P)``, a ``(B, S, H)``, b/c ``(B, S, H, N)`` (any
    strides: the model passes b and c broadcast over heads), optional h0
    ``(B, H, P, N)``; float32 or bfloat16.  Returns ``(y (B, S, H, P) in
    x's dtype, final state (B, H, P, N) float32)``."""
    check_ssd_args(x, a, b_mat, c_mat, h0, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, a, b_mat, c_mat, h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    if n not in STATE_DIMS:
        raise ValueError(f"state width N={n} not built; the kernel takes "
                         f"{STATE_DIMS}")
    x, b_mat, c_mat = (t if t.stride(3) == 1 else t.contiguous()
                       for t in (x, b_mat, c_mat))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    h_t = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (x, a, b_mat,
                                                            c_mat)
                                      for i in range(3)))
    with torch.cuda.device(x.device):
        err = _lib().ssd_scan_launch(
            x.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_t.data_ptr(), _DTYPE_CODE[x.dtype], bsz, s, h, p, n,
            ctypes.cast(strides, ctypes.c_void_p),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: cudaGetLastError() = "
                           f"{err}")
    ssd_scan.launches += 1
    return y, h_t


ssd_scan.launches = 0
