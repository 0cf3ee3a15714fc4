"""Flash attention (prefill) — CUDA kernel B3 and its wrapper.

Port of the TPU kernel ``repro.kernels.flash_attention``: blocked
online-softmax attention with causal and/or sliding-window masks and GQA by
index.  The kernel (``csrc/flash_attention.cu``) gives each CTA 64 query
rows of one (batch, head) and loops over the kv tiles inside the band: on
the tensor cores for bf16 at head dims 64 and 128 (prefill), with scalar
FMAs for float32 and the other head dims.  On a CPU tensor the wrapper
runs the plain version (:func:`repro_torch.kernels.ref.attention_ref`); on
a CUDA tensor it launches the kernel or raises.

The wrapper keeps the reference kernel's contract, so both packages accept
the same inputs: ``Sq`` and ``Skv`` divisible by ``min(256, S)`` (its
default blocks), and causal or windowed attention only with ``Sq == Skv``
— the Pallas kernel aligns causal rows at the start, ``attention_ref`` at
the end, and the two agree only there (ROADMAP C2).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int

#: the reference kernel's default block size, which fixes its contract
BLOCK = 256
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
#: bf16 at these head dims runs on the tensor cores (``mma.sync``); every
#: other input on the scalar-FMA kernel
MMA_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _vector_aligned(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts on a 16-byte boundary."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * size % 16 == 0 for i in range(3))


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float,
        _I, _I, _P]
    lib.flash_attention_launch.restype = _I
    return lib


def check_attention_args(q, k, v, causal: bool, window) -> None:
    """Shapes, dtypes, devices and the block contract; raises on what the
    kernel (and the reference's kernel) does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B={b}, Hkv, Skv, D={d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError("q_heads must be a multiple of kv_heads")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{list(_DTYPE_CODE)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if sq % min(BLOCK, sq) or skv % min(BLOCK, skv):
        raise ValueError("sequence lengths must be divisible by block sizes "
                         f"(min({BLOCK}, S)); got Sq={sq}, Skv={skv}")
    if (causal or window is not None) and sq != skv:
        raise ValueError(
            f"causal or windowed attention needs Sq == Skv (got {sq} and "
            f"{skv}): the kernel aligns causal rows at the start, "
            "attention_ref at the end (ROADMAP C2)")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q ``(B, H, Sq, D)``, k/v ``(B, Hkv, Skv, D)``, float32 or bfloat16
    → ``(B, H, Sq, D)`` in q's dtype.  Any strides with a unit head-dim
    stride (the model passes ``(B, S, H, D)`` tensors transposed)."""
    check_attention_args(q, k, v, causal, window)
    b, h, sq, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16 and d in MMA_HEAD_DIMS:
        # the tensor-core kernel reads k and v in 16-byte vectors
        k, v = (t if _vector_aligned(t)
                else t.clone(memory_format=torch.contiguous_format)
                for t in (k, v))
    lib = _lib()
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*(t.stride(i) for t in (q, k, v)
                                     for i in range(3)))
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, k.shape[1], sq, k.shape[2], d,
            ctypes.cast(strides, ctypes.c_void_p), float(sm_scale),
            int(causal), -1 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"cudaGetLastError() = {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
