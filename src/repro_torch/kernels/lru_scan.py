"""The RG-LRU diagonal recurrence — CUDA kernel B5 and its wrapper.

Port of the TPU kernel ``repro.kernels.lru_scan``: ``h_t = a_t ⊙ h_{t-1} +
x_t`` in float32 from ``h0`` (zeros when absent), ``y`` in x's dtype and
the final state in float32.  The kernel (``csrc/lru_scan.cu``, shared code
in ``csrc/lru_chunked.cuh``) splits the sequence into :data:`CHUNK`-step
chunks across CTAs: each CTA sums its chunk up as (Π a, end state from
zero) from 16-byte loads held in registers, and the chunks of one (batch,
tile of channels) are joined in chunk order, each CTA passing the next
chunk's start state through a 64-bit link (value and tag in one word, in
a zeroed buffer; chunks taken by an atomic ticket, so two calls give the
same bits).  Under grad it keeps those start states, float32 ``(B,
⌈S/CHUNK⌉, D)``, for the backward to start from.  Its plain version
with the same chunks, carries and rounding points is
:func:`repro_torch.kernels.ref.lru_scan_chunked_ref`.  On a CPU tensor the
wrapper runs the plain version (:func:`repro_torch.kernels.ref.
lru_scan_ref`); on a CUDA tensor it launches the kernel or raises.

Length contract: any ``S, D >= 1``, as the reference's model path takes
them off a TPU, where ``impl="auto"`` resolves to its XLA path.  (The
reference's Pallas kernel also needs ``S`` divisible by ``min(256, S)``
and ``D`` by ``min(128, D)``, its default chunk and channel block; the
CUDA kernel pads the last chunk and tile instead, ROADMAP C6.)

Gradients: on a CUDA tensor with grad mode on and an input that requires
grad, the wrapper runs as a ``torch.autograd.Function`` whose forward is
the same kernel launch, keeping the chunk starts, and whose backward is
:func:`lru_scan_bwd` (``csrc/lru_scan_bwd.cu``, B5-bwd) from them: what
``jax.grad`` of the reference's XLA ``lru_scan_ref`` computes, since the
reference has no Pallas backward.  Without grad the wrapper launches the
forward alone, keeps nothing and records nothing for autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


#: steps a chunk of both kernels (``kL`` in csrc/lru_chunked.cuh): the
#: forward keeps the float32 state entering each
CHUNK = 128
#: steps a thread sums up before the sub-chunks of a chunk are folded: in
#: the forward and in the backward
SUB_STEPS, BWD_SUB_STEPS = 8, 4
_I64 = ctypes.c_int64


@functools.cache
def _lib():
    lib = build.load("lru_scan")
    lib.lru_scan_launch.argtypes = [_P] * 7 + [_I64] + [_I] * 4 + [_P, _P]
    lib.lru_scan_launch.restype = _I
    lib.lru_scan_attributes.argtypes = [_I, _P]
    lib.lru_scan_attributes.restype = _I
    lib.lru_scan_chunk.argtypes, lib.lru_scan_chunk.restype = [], _I
    if lib.lru_scan_chunk() != CHUNK:
        raise RuntimeError(f"csrc/lru_chunked.cuh's chunk "
                           f"{lib.lru_scan_chunk()} is not CHUNK {CHUNK}")
    return lib


@functools.cache
def _bwd_lib():
    _lib()  # checks the chunk both kernels share
    lib = build.load("lru_scan_bwd")
    lib.lru_scan_bwd_launch.argtypes = ([_P] * 11 + [_I64] + [_I] * 4
                                        + [_P, _P])
    lib.lru_scan_bwd_launch.restype = _I
    lib.lru_scan_bwd_attributes.argtypes = [_I, _P]
    lib.lru_scan_bwd_attributes.restype = _I
    return lib


_ATTRIBUTE_NAMES = ("registers", "static_smem", "dynamic_smem", "local_bytes",
                    "max_threads")


def _attributes(fn, dtype, what) -> dict:
    attrs = (ctypes.c_int * 5)()
    err = fn(_DTYPE_CODE[dtype], attrs)
    if err:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
    return dict(zip(_ATTRIBUTE_NAMES, attrs))


def attributes(dtype: torch.dtype) -> dict:
    """The forward kernel as built for ``dtype`` (float32 or bfloat16),
    from ``cudaFuncGetAttributes``: registers a thread, static shared
    memory, local (spill) bytes a thread.  Needs a card."""
    return _attributes(_lib().lru_scan_attributes, dtype,
                       "lru_scan_attributes")


def bwd_attributes(dtype: torch.dtype) -> dict:
    """The backward kernel as built for ``dtype``, as :func:`attributes`.
    Needs a card."""
    return _attributes(_bwd_lib().lru_scan_bwd_attributes, dtype,
                       "lru_scan_bwd_attributes")


def n_chunks(s: int) -> int:
    """Chunks of :data:`CHUNK` steps in a sequence of ``s`` (the last may
    be ragged)."""
    return -(-s // CHUNK)


def _chain(bsz, s, d, device, passes=1):
    """The zeroed chain buffers of ``passes`` launches: a ticket counter
    and a 64-bit link a (batch, chunk, channel) each."""
    return torch.zeros(passes * (1 + bsz * n_chunks(s) * d),
                       dtype=torch.int64, device=device)


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


def _launch(x, a, h0, keep_starts=False):
    """One launch of the forward kernel on CUDA tensors that
    :func:`check_lru_args` accepted, counted in ``lru_scan.launches``.
    Returns ``(y, final state, chunk starts)``, the starts None unless
    ``keep_starts``."""
    bsz, s, d = x.shape
    x, a = (t if t.stride(2) == 1 else t.contiguous() for t in (x, a))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    y = torch.empty((bsz, s, d), dtype=x.dtype, device=x.device)
    h_t = torch.empty((bsz, d), dtype=torch.float32, device=x.device)
    starts = torch.empty((bsz, n_chunks(s), d), dtype=torch.float32,
                         device=x.device) if keep_starts else None
    chain = _chain(bsz, s, d, x.device)
    strides = (ctypes.c_int64 * 4)(x.stride(0), x.stride(1), a.stride(0),
                                   a.stride(1))
    with torch.cuda.device(x.device):
        err = _lib().lru_scan_launch(
            x.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_t.data_ptr(),
            None if starts is None else starts.data_ptr(), chain.data_ptr(),
            chain.numel(), _DTYPE_CODE[x.dtype], bsz, s, d,
            ctypes.cast(strides, ctypes.c_void_p),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"lru_scan launch failed: cudaGetLastError() = "
                           f"{err}")
    lru_scan.launches += 1
    return y, h_t, starts


class _LRUScan(torch.autograd.Function):
    """B5 with its backward kernel: the forward is :func:`_launch`, which
    keeps the chunk starts, the backward :func:`lru_scan_bwd` on the saved
    inputs from them (an incoming gradient of ``None`` is zeros)."""

    @staticmethod
    def forward(ctx, x, a, h0):
        ctx.set_materialize_grads(False)
        y, h_t, starts = _launch(x, a, h0, keep_starts=True)
        ctx.save_for_backward(x, a, h0, starts)
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dhT):
        x, a, h0, starts = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return lru_scan_bwd(x, a, dy, h0, dhT, starts=starts)


def lru_scan(x, a, h0=None):
    """x, a ``(B, S, D)`` float32 or bfloat16 (unit stride on D or they are
    copied), optional h0 ``(B, D)``.  Returns ``(y (B, S, D) in x's dtype,
    final state (B, D) float32)``.  On a CUDA tensor that needs a gradient
    (grad mode on, an input requiring grad) the result carries B5's
    backward kernel (:func:`lru_scan_bwd`)."""
    check_lru_args(x, a, h0)
    if x.device.type == "cpu":
        return ref.lru_scan_ref(x, a, h0)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a, h0)):
        return _LRUScan.apply(x, a, h0)
    return _launch(x, a, h0)[:2]


lru_scan.launches = 0


def lru_scan_bwd(x, a, dy, h0=None, dhT=None, starts=None):
    """The gradients ``(dx, da, dh0)`` of :func:`lru_scan` at x, a, h0 for
    the incoming gradients ``dy`` ``(B, S, D)`` of y and ``dhT`` ``(B, D)``
    of the final state (None: zeros); dx and da in x's dtype, dh0 in h0's
    (None without h0).  ``starts``: the forward kernel's float32 chunk
    starts ``(B, ⌈S/CHUNK⌉, D)`` at these x, a and h0, as ``_LRUScan``
    keeps them; without them the call has the forward kernel rebuild them
    first (a second kernel, in the same call).  On CUDA tensors one call of
    ``csrc/lru_scan_bwd.cu``, counted in ``lru_scan_bwd.launches``; on CPU
    tensors the plain version (:func:`~repro_torch.kernels.ref.
    lru_scan_bwd_ref`), which needs no starts."""
    check_lru_args(x, a, h0)
    bsz, s, d = x.shape
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    if dhT is not None and dhT.shape != (bsz, d):
        raise ValueError(f"dhT must be (B, D) = {(bsz, d)}, got "
                         f"{tuple(dhT.shape)}")
    if dy.device != x.device or any(
            t is not None and t.device != x.device for t in (dhT, starts)):
        raise ValueError("dy, dhT and starts must be on x's device")
    if starts is not None and (starts.shape != (bsz, n_chunks(s), d)
                               or starts.dtype != torch.float32):
        raise ValueError(f"starts must be float32 (B, ⌈S/{CHUNK}⌉, D) = "
                         f"{(bsz, n_chunks(s), d)}, got {starts.dtype} "
                         f"{tuple(starts.shape)}")
    if x.device.type == "cpu":
        return ref.lru_scan_bwd_ref(x, a, dy, h0, dhT)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, a, dy = (t if t.stride(2) == 1 else t.contiguous()
                for t in (x, a, dy.to(x.dtype)))
    h0f, dhT = (None if t is None else t.to(torch.float32).contiguous()
                for t in (h0, dhT))
    dx = torch.empty((bsz, s, d), dtype=x.dtype, device=x.device)
    da = torch.empty_like(dx)
    dh0 = None if h0 is None else torch.empty((bsz, d), dtype=torch.float32,
                                              device=x.device)
    if starts is None:
        built = torch.empty((bsz, n_chunks(s), d), dtype=torch.float32,
                            device=x.device)
        chain = _chain(bsz, s, d, x.device, passes=2)
    else:
        starts, built = starts.contiguous(), None
        chain = _chain(bsz, s, d, x.device)
    strides = (ctypes.c_int64 * 6)(x.stride(0), x.stride(1), a.stride(0),
                                   a.stride(1), dy.stride(0), dy.stride(1))

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = _bwd_lib().lru_scan_bwd_launch(
            x.data_ptr(), a.data_ptr(), dy.data_ptr(), ptr(h0f), ptr(dhT),
            ptr(starts), dx.data_ptr(), da.data_ptr(), ptr(dh0), ptr(built),
            chain.data_ptr(), chain.numel(), _DTYPE_CODE[x.dtype], bsz, s, d,
            ctypes.cast(strides, ctypes.c_void_p),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"lru_scan_bwd launch failed: cudaGetLastError() "
                           f"= {err}")
    lru_scan_bwd.launches += 1
    return dx, da, None if dh0 is None else dh0.to(h0.dtype)


lru_scan_bwd.launches = 0
