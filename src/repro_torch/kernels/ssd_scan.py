"""mamba2's SSD scan — CUDA kernel B4 and its wrapper.

Port of the TPU kernel ``repro.kernels.ssd_scan``: per head, ``H_t = a_t·
H_{t-1} + x_t ⊗ b_t`` and ``y_t = H_t·c_t`` with the ``P × N`` state in
float32, the decay clamped at 1e-37 and the final state returned.
``csrc/ssd_scan.cu`` holds two kernels, and :func:`kernel_for` says which
one takes an input, from its dtype and shape alone: bf16 at ``P = 64`` and
``N`` 64 or 128 (mamba2-370m's prefill) runs on the chunked Hopper kernel,
which loads :data:`CHUNK`-step chunks (as :func:`chunk_plan` lists them)
with TMA and computes the chunked (SSD) form with ``wgmma`` on the tensor
cores; float32, and bf16 at other widths, run on the step kernel, which
walks the sequence step by step on the CUDA cores.  On a CPU tensor the
wrapper runs the plain version (:func:`repro_torch.kernels.ref.
ssd_scan_ref`, the chunked form); on a CUDA tensor it launches the kernel
or raises.

Length contract: the reference's Pallas kernel needs ``S`` divisible by
``min(chunk, S)`` and its XLA path (which always chunks at 128) by
``min(128, S)``; this wrapper raises on both devices unless both hold, so
it accepts exactly what both of the reference's paths accept (ROADMAP C5).
The chunked kernel's own chunk length is its design choice: the sums
differ from the plain version's 128-step chunks by rounding only.
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
#: state widths N the kernels are built for (the step kernel: 16 state
#: columns a thread; the N / 16 threads of a row pair within one warp)
STATE_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: bf16 at head dim P = CHUNKED_P and these state widths runs on the
#: chunked kernel (TMA + ``wgmma``); every other input on the step kernel
CHUNKED_P = 64
CHUNKED_STATE_DIMS = (64, 128)
#: steps a chunk of the chunked kernel (``kChunk`` in csrc/ssd_scan.cu)
CHUNK = 64
#: error codes of the C interface beyond ``cudaError_t``'s
_NO_ENCODER, _ENCODE_FAILED = 199999, 200000


def kernel_for(dtype: torch.dtype, p: int, n: int) -> str:
    """The CUDA kernel that takes ``dtype`` inputs at head dim ``p`` and
    state width ``n``: ``"chunked"`` (TMA + ``wgmma`` on the tensor cores)
    or ``"step"`` (step by step on the CUDA cores: float32, which the
    tensor cores would round, and bf16 at the widths the chunked kernel is
    not built for).  Raises for a state width neither kernel is built
    for."""
    if n not in STATE_DIMS:
        raise ValueError(f"state width N={n} not built; the kernels take "
                         f"{STATE_DIMS}")
    if dtype == torch.bfloat16 and p == CHUNKED_P \
            and n in CHUNKED_STATE_DIMS:
        return "chunked"
    return "step"


def chunk_plan(s: int) -> list[tuple[int, int, int]]:
    """The chunked kernel's chunks of a length-``s`` sequence, in the order
    its CTA walks them: ``(start, stop, padded)`` with steps ``[start,
    stop)`` and ``padded`` rows past ``s`` that TMA reads as zeros and the
    kernel counts as decay 1, so the chunk's decay is taken at its last
    valid step ``stop - 1``."""
    return [(t, min(t + CHUNK, s), max(t + CHUNK - s, 0))
            for t in range(0, s, CHUNK)]


def tma_ready(t: torch.Tensor) -> bool:
    """TMA can read the ``(B, S, H, W)`` tensor ``t`` in place: a 16-byte-
    aligned base, a unit inner stride, and each (batch, seq, head) stride of
    a dim longer than 1 a positive multiple of 16 bytes, or 0 for the head
    (b and c broadcast over heads)."""
    size = t.element_size()
    if t.data_ptr() % 16 or t.stride(3) != 1:
        return False
    return all(t.shape[i] == 1 or (i == 2 and t.stride(i) == 0)
               or (t.stride(i) > 0 and t.stride(i) * size % 16 == 0)
               for i in range(3))


@functools.cache
def _lib():
    lib = build.load("ssd_scan")
    for fn in (lib.ssd_scan_launch, lib.ssd_scan_chunked_launch):
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P]
        fn.restype = _I
    lib.ssd_scan_chunked_attributes.argtypes = [_I, _P]
    lib.ssd_scan_chunked_attributes.restype = _I
    return lib


def chunked_attributes(n: int) -> dict:
    """The chunked kernel's build at state width ``n`` (64 or 128), from
    ``cudaFuncGetAttributes``: registers a thread, static and dynamic
    shared memory, local (spill) bytes a thread, max threads a block.
    Needs a card."""
    attrs = (ctypes.c_int * 5)()
    err = _lib().ssd_scan_chunked_attributes(n, attrs)
    if err:
        raise RuntimeError(f"ssd_scan_chunked_attributes({n}) failed: "
                           f"cudaError_t {err}")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "local_bytes", "max_threads"), attrs))


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


def _launch(kernel: str, x, a, b_mat, c_mat, h0):
    """One launch of ``kernel`` (``"chunked"`` or ``"step"``) on CUDA
    tensors that :func:`check_ssd_args` accepted; returns ``(y, final
    state)``.  The wrapper's route is :func:`kernel_for`'s; this entry
    also lets a benchmark time the step kernel where the chunked one
    runs."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    if kernel not in ("chunked", "step"):
        raise ValueError(f"unknown SSD kernel {kernel!r}")
    if kernel == "chunked" and kernel_for(x.dtype, p, n) != "chunked":
        raise ValueError(f"the chunked kernel takes bf16 at P={CHUNKED_P}, "
                         f"N in {CHUNKED_STATE_DIMS}; got {x.dtype}, P={p}, "
                         f"N={n}")
    x, b_mat, c_mat = (t if t.stride(3) == 1 else t.contiguous()
                       for t in (x, b_mat, c_mat))
    if kernel == "chunked":
        # TMA reads x, b and c in place only where they are aligned
        x, b_mat, c_mat = (t if tma_ready(t) else t.contiguous()
                           for t in (x, b_mat, c_mat))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    h_t = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (x, a, b_mat,
                                                            c_mat)
                                      for i in range(3)))
    lib = _lib()
    fn = lib.ssd_scan_chunked_launch if kernel == "chunked" \
        else lib.ssd_scan_launch
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                 c_mat.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h_t.data_ptr(), _DTYPE_CODE[x.dtype], bsz, s,
                 h, p, n, ctypes.cast(strides, ctypes.c_void_p),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"ssd_scan: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - _ENCODE_FAILED})")
    if err == _NO_ENCODER:
        raise RuntimeError("ssd_scan: no cuTensorMapEncodeTiled entry point "
                           "(CUDA 12.0 or later is needed)")
    if err:
        raise RuntimeError(f"ssd_scan ({kernel} kernel) launch failed: "
                           f"cudaGetLastError() = {err}")
    return y, h_t


def _forward(x, a, b_mat, c_mat, h0):
    """:func:`kernel_for`'s kernel, counted in ``ssd_scan.launches`` (and
    ``ssd_scan.chunked_launches``)."""
    kernel = kernel_for(x.dtype, x.shape[3], b_mat.shape[3])
    out = _launch(kernel, x, a, b_mat, c_mat, h0)
    ssd_scan.launches += 1
    ssd_scan.chunked_launches += kernel == "chunked"
    return out


class _SSDScan(torch.autograd.Function):
    """B4 with its backward kernel: the forward is :func:`_forward`, the
    backward :func:`ssd_scan_bwd` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, a, b_mat, c_mat, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, a, b_mat, c_mat, h0)
        return _forward(x, a, b_mat, c_mat, h0)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, a, b_mat, c_mat, h0 = ctx.saved_tensors
        dx, da, db, dc, dh0 = ssd_scan_bwd(x, a, b_mat, c_mat, dy, h0,
                                           dstate)
        return dx, da, db, dc, dh0


def ssd_scan(x, a, b_mat, c_mat, h0=None, *, chunk: int = 128):
    """x ``(B, S, H, P)``, a ``(B, S, H)``, b/c ``(B, S, H, N)`` (any
    strides: the model passes b and c broadcast over heads), optional h0
    ``(B, H, P, N)``; float32 or bfloat16.  Returns ``(y (B, S, H, P) in
    x's dtype, final state (B, H, P, N) float32)``.  ``ssd_scan.launches``
    counts the kernel launches, ``ssd_scan.chunked_launches`` those that
    took the chunked kernel.  On a CUDA tensor that needs a gradient (grad
    mode on, an input requiring grad) the result carries the backward
    kernel (:func:`ssd_scan_bwd`), which takes ``P <=``
    :data:`BWD_MAX_P`."""
    check_ssd_args(x, a, b_mat, c_mat, h0, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, a, b_mat, c_mat, h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, a, b_mat, c_mat, h0)):
        _check_bwd_width(x.shape[3])
        return _SSDScan.apply(x, a, b_mat, c_mat, h0)
    return _forward(x, a, b_mat, c_mat, h0)


ssd_scan.launches = 0
ssd_scan.chunked_launches = 0

#: head dims P the backward kernel takes (one CTA holds all P state rows)
BWD_MAX_P = 64


def _check_bwd_width(p: int) -> None:
    if p > BWD_MAX_P:
        raise ValueError(f"head dim P={p}: the backward kernel takes P <= "
                         f"{BWD_MAX_P}")


@functools.cache
def _bwd_lib():
    lib = build.load("ssd_scan_bwd")
    lib.ssd_scan_bwd_launch.argtypes = [_P] * 13 + [_I] * 6 + [_P, _P]
    lib.ssd_scan_bwd_launch.restype = _I
    lib.ssd_scan_bwd_scratch.argtypes = [_I] * 5
    lib.ssd_scan_bwd_scratch.restype = ctypes.c_int64
    lib.ssd_scan_bwd_attributes.argtypes = [_I, _P]
    lib.ssd_scan_bwd_attributes.restype = _I
    return lib


def bwd_attributes(dtype: torch.dtype) -> dict:
    """The backward's main kernel as built for ``dtype`` (float32 or
    bfloat16), from ``cudaFuncGetAttributes``: registers a thread, static
    shared memory, local (spill) bytes a thread.  Needs a card."""
    attrs = (ctypes.c_int * 5)()
    err = _bwd_lib().ssd_scan_bwd_attributes(_DTYPE_CODE[dtype], attrs)
    if err:
        raise RuntimeError(f"ssd_scan_bwd_attributes failed: cudaError_t "
                           f"{err}")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "local_bytes", "max_threads"), attrs))


def ssd_scan_bwd(x, a, b_mat, c_mat, dy, h0=None, dstate=None):
    """The gradients ``(dx, da, db, dc, dh0)`` of :func:`ssd_scan` at its
    inputs for the incoming ``dy`` (of y) and ``dstate`` (of the final
    state; ``None`` is zero), each in its input's dtype; ``db`` and ``dc``
    are per head ``(B, S, H, N)`` (for broadcast b and c, autograd sums
    them), ``dh0`` is ``None`` without ``h0``.  On CUDA tensors one call of
    ``csrc/ssd_scan_bwd.cu`` (its main kernel and the pass that adds the
    column blocks' partial sums), counted once in
    ``ssd_scan_bwd.launches``; on CPU tensors the plain version, autograd
    through :func:`~repro_torch.kernels.ref.ssd_scan_ref`."""
    check_ssd_args(x, a, b_mat, c_mat, h0, chunk=x.shape[1])
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    if dstate is not None and dstate.shape != (bsz, h, p, n):
        raise ValueError(f"dstate must be {(bsz, h, p, n)}, got "
                         f"{tuple(dstate.shape)}")
    if x.device.type == "cpu":
        return ref.ssd_scan_bwd_ref(x, a, b_mat, c_mat, dy, h0, dstate)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_bwd_width(p)
    if dy is None:
        dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    dy = dy.to(x.dtype).contiguous()
    x, b_mat, c_mat = (t if t.stride(3) == 1 else t.contiguous()
                       for t in (x, b_mat, c_mat))
    h0f = None if h0 is None else h0.to(torch.float32).contiguous()
    dsf = None if dstate is None else dstate.to(torch.float32).contiguous()
    lib = _bwd_lib()
    scratch = torch.empty(lib.ssd_scan_bwd_scratch(bsz, s, h, p, n),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    da = torch.empty((bsz, s, h), dtype=x.dtype, device=x.device)
    db = torch.empty((bsz, s, h, n), dtype=x.dtype, device=x.device)
    dc = torch.empty_like(db)
    dh0 = None if h0 is None else torch.empty(
        (bsz, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (x, a, b_mat,
                                                            c_mat)
                                      for i in range(3)))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd_launch(
            x.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            dy.data_ptr(), ptr(h0f), ptr(dsf), dx.data_ptr(), da.data_ptr(),
            db.data_ptr(), dc.data_ptr(), ptr(dh0), scratch.data_ptr(),
            _DTYPE_CODE[x.dtype], bsz, s, h, p, n,
            ctypes.cast(strides, ctypes.c_void_p),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd launch failed: cudaGetLastError() "
                           f"= {err}")
    ssd_scan_bwd.launches += 1
    if dh0 is not None:
        dh0 = dh0.to(h0.dtype)
    return dx, da, db, dc, dh0


ssd_scan_bwd.launches = 0
