"""Flash attention (prefill) — CUDA kernel B3 and its wrapper.

Port of the TPU kernel ``repro.kernels.flash_attention``: blocked
online-softmax attention with causal and/or sliding-window masks and GQA by
index.  ``csrc/flash_attention.cu`` holds two kernels, and
:func:`kernel_for` says which one takes an input: bf16 at head dims 64, 128
and 256 (every prefill of the port) runs on the Hopper kernel, which loads
tiles with TMA and multiplies with ``wgmma`` on the tensor cores (128 query
rows a CTA, its kv tiles as :func:`tile_schedule` lists them); float32,
and bf16 at the other head dims, run on the scalar-FMA kernel.  On a CPU
tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.attention_ref`); on a CUDA tensor it
launches the kernel or raises.

The wrapper takes every length the reference's model path takes off a
TPU, where ``impl="auto"`` resolves to its XLA oracle: both kernels clip
their last query tile at ``Sq`` and zero-fill keys past ``Skv``, so ``Sq``
and ``Skv`` need not divide by the Pallas kernel's 256-row blocks.  It
keeps one rule of the reference's kernel: causal or windowed attention
only with ``Sq == Skv`` — the Pallas kernel aligns causal rows at the
start, ``attention_ref`` at the end, and the two agree only there
(ROADMAP C2).

Gradients: on a CUDA tensor with grad mode on and an input that requires
grad, the wrapper runs as a ``torch.autograd.Function`` whose forward is
the same kernel launch and whose backward is :func:`flash_attention_bwd`
(``csrc/flash_attention_bwd.cu``, head dims :data:`BWD_HEAD_DIMS`): what
``jax.grad`` of the reference's XLA attention computes, since the
reference has no Pallas backward.  Without grad the wrapper launches the
forward alone, as before, and records nothing for autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
#: head dims the backward kernel is built for (whisper-tiny's 64 and
#: qwen2.5-3b's 128, the two that train on the card)
BWD_HEAD_DIMS = (64, 128)
#: bf16 at these head dims runs on the TMA + ``wgmma`` kernel; every other
#: input on the scalar-FMA kernel
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the Hopper kernel's blocks: query rows per consumer warpgroup, two
#: warpgroups a CTA
WG_ROWS = 64
CTA_ROWS = 2 * WG_ROWS
#: error codes of the C interface beyond ``cudaError_t``'s
_NO_ENCODER, _ENCODE_FAILED = 199999, 200000


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel that takes ``dtype`` inputs at head dim ``d``:
    ``"wgmma"`` (TMA + ``wgmma`` on the tensor cores) or ``"scalar"``
    (scalar FMAs; float32, which the tensor cores would round, and bf16 at
    the head dims the Hopper kernel is not built for)."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "scalar"


def block_k(d: int) -> int:
    """Keys per kv tile of the Hopper kernel at head dim ``d``: 128, or 64
    at head dim 256, where O takes 128 registers a thread and K and V
    tiles 32 KB each."""
    return 64 if d == 256 else 128


def tma_ready(t: torch.Tensor) -> bool:
    """TMA can read ``t`` in place: a 16-byte-aligned base, and every
    (batch, head, seq) stride of a dim longer than 1 a positive multiple of
    16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.shape[i] == 1 or (t.stride(i) > 0 and t.stride(i) * size % 16 == 0)
        for i in range(3))


def tile_schedule(sq: int, skv: int, d: int, causal: bool,
                  window: int | None) -> list[dict]:
    """The Hopper kernel's schedule, as ``flash_attention_wgmma_kernel`` and
    ``wgmma_consumer`` compute it: for each CTA (query block ``qb`` of
    :data:`CTA_ROWS` rows) the kv tiles ``[kb_lo, kb_hi)`` its producer
    loads, and for each of its two consumer warpgroups (:data:`WG_ROWS`
    rows each) the tiles it computes, as ``(kb, masked)``: a tile wholly
    outside the warpgroup's band is skipped, one wholly inside it (and
    before Skv) runs without the mask."""
    bk = block_k(d)
    w = -1 if window is None else window
    out = []
    for qb in range(-(-sq // CTA_ROWS)):
        q0 = qb * CTA_ROWS
        kb_lo, kb_hi = 0, -(-skv // bk)
        if causal:
            kb_hi = min(kb_hi, (q0 + CTA_ROWS - 1) // bk + 1)
        if w >= 0 and q0 - w > 0:
            kb_lo = (q0 - w) // bk
        groups = []
        for wg in range(2):
            r_lo = q0 + wg * WG_ROWS
            r_hi = r_lo + WG_ROWS - 1
            tiles = []
            for kb in range(kb_lo, kb_hi):
                k0 = kb * bk
                outside = ((causal and k0 > r_hi)
                           or (w >= 0 and k0 + bk - 1 < r_lo - w))
                inside = (k0 + bk <= skv
                          and (not causal or k0 + bk - 1 <= r_lo)
                          and (w < 0 or k0 >= r_hi - w))
                if not outside:
                    tiles.append((kb, not inside))
            groups.append(tiles)
        out.append({"qb": qb, "kb_lo": kb_lo, "kb_hi": kb_hi,
                    "warpgroups": groups})
    return out


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float,
        _I, _I, _P]
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_wgmma_attributes.argtypes = [_I, _P]
    lib.flash_attention_wgmma_attributes.restype = _I
    return lib


@functools.cache
def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    lib.flash_attention_bwd_launch.argtypes = [_P] * 10 + [_I] * 7 + [
        _P, ctypes.c_float, _I, _I, _P]
    lib.flash_attention_bwd_launch.restype = _I
    return lib


def wgmma_attributes(d: int) -> dict:
    """The TMA + ``wgmma`` kernel's build at head dim ``d`` (64, 128 or
    256), from ``cudaFuncGetAttributes``: registers a thread, static and
    dynamic shared memory, local (spill) bytes a thread, max threads a
    block.  Needs a card."""
    lib = _lib()
    attrs = (ctypes.c_int * 5)()
    err = lib.flash_attention_wgmma_attributes(d, attrs)
    if err:
        raise RuntimeError(f"flash_attention_wgmma_attributes({d}) failed: "
                           f"cudaError_t {err}")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "local_bytes", "max_threads"), attrs))


def check_attention_args(q, k, v, causal: bool, window) -> None:
    """Shapes, dtypes, devices and the C2 rule; raises on what the kernel
    does not take."""
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
    if sq == 0 or skv == 0:
        raise ValueError(f"empty sequence: Sq={sq}, Skv={skv}")
    if (causal or window is not None) and sq != skv:
        raise ValueError(
            f"causal or windowed attention needs Sq == Skv (got {sq} and "
            f"{skv}): the kernel aligns causal rows at the start, "
            "attention_ref at the end (ROADMAP C2)")


def _launch(q, k, v, causal: bool, window, sm_scale: float):
    """One launch of the forward kernel on CUDA tensors that
    :func:`check_attention_args` accepted."""
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    if kernel_for(q.dtype, d) == "wgmma":
        # TMA reads q, k and v in place only where they are aligned
        q, k, v = (t if tma_ready(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
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
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - _ENCODE_FAILED})")
    if err == _NO_ENCODER:
        raise RuntimeError("flash_attention: no cuTensorMapEncodeTiled "
                           "entry point (CUDA 12.0 or later is needed)")
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"cudaGetLastError() = {err}")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """B3 with its backward kernel: the forward launches :func:`_launch`,
    the backward :func:`flash_attention_bwd` on the saved inputs and
    output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        out = _launch(q, k, v, causal, window, sm_scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = (causal, window, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        causal, window, sm_scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                         window=window, sm_scale=sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q ``(B, H, Sq, D)``, k/v ``(B, Hkv, Skv, D)``, float32 or bfloat16
    → ``(B, H, Sq, D)`` in q's dtype.  Any strides with a unit head-dim
    stride (the model passes ``(B, S, H, D)`` tensors transposed).  On a
    CUDA tensor that needs a gradient (grad mode on, an input requiring
    grad) the result carries B3's backward; that needs a head dim of
    :data:`BWD_HEAD_DIMS`."""
    check_attention_args(q, k, v, causal, window)
    d = q.shape[3]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if d not in BWD_HEAD_DIMS:
            raise NotImplementedError(
                f"flash_attention's backward kernel is built for head dims "
                f"{BWD_HEAD_DIMS}, not {d}")
        return _FlashAttention.apply(q, k, v, causal, window, sm_scale)
    return _launch(q, k, v, causal, window, sm_scale)


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                        window: int | None = None,
                        sm_scale: float | None = None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` at q, k, v
    (its output ``out``) for the incoming gradient ``dout`` (both ``(B, H,
    Sq, D)``), in the inputs' dtype.  On CUDA tensors: one call of
    ``csrc/flash_attention_bwd.cu`` (three kernels: row statistics, dK and
    dV, dQ), counted once in ``flash_attention_bwd.launches``; on CPU
    tensors the plain version, autograd through
    :func:`~repro_torch.kernels.ref.attention_ref`."""
    check_attention_args(q, k, v, causal, window)
    b, h, sq, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return ref.attention_bwd_ref(q, k, v, dout, causal=causal,
                                     window=window, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {d}: the backward kernel takes "
                         f"{BWD_HEAD_DIMS}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    out = out.to(q.dtype).contiguous()
    dout = dout.to(q.dtype).contiguous()
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_int64 * 9)(*(t.stride(i) for t in (q, k, v)
                                     for i in range(3)))
    with torch.cuda.device(q.device):
        err = _bwd_lib().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _DTYPE_CODE[q.dtype], b, h,
            k.shape[1], sq, k.shape[2], d,
            ctypes.cast(strides, ctypes.c_void_p), float(sm_scale),
            int(causal), -1 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: "
                           f"cudaGetLastError() = {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
