"""Flash attention (prefill) — CUDA kernel B3 and its wrapper.

Port of the TPU kernel ``repro.kernels.flash_attention``: blocked
online-softmax attention with causal and/or sliding-window masks and GQA by
index.  ``csrc/flash_attention.cu`` holds two kernels, and
:func:`kernel_for` says which one takes an input: bf16 at head dims 64, 96,
128 and 256 (every prefill of the port) runs on the Hopper kernel, which
loads tiles with TMA and multiplies with ``wgmma`` on the tensor cores (128
query rows a CTA, its kv tiles as :func:`tile_schedule` lists them; at head
dim 96 the tiles are 64-byte-swizzled slabs of 32 columns, three a row);
float32 at every head dim, and bf16 at 16 and 32, run on the scalar-FMA
kernel.  On a CPU
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
reference has no Pallas backward.  :func:`bwd_kernel_for` says which
backward takes an input: bf16 runs on the tensor cores (TMA + ``wgmma``,
a dK/dV pass and a dQ pass as :func:`bwd_tile_schedule` lists their
tiles), from the row log-sum-exp that the Hopper forward writes under
grad; float32 on scalar FMAs.  Without grad the wrapper launches the
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
#: head dims the backward kernel is built for (whisper-tiny's 64,
#: phi3-mini's 96, qwen2.5-3b's 128, recurrentgemma-9b's and gemma-7b's 256)
BWD_HEAD_DIMS = (64, 96, 128, 256)
#: bf16 at these head dims runs on the TMA + ``wgmma`` kernel; every other
#: input on the scalar-FMA kernel
WGMMA_HEAD_DIMS = (64, 96, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the Hopper kernel's blocks: query rows per consumer warpgroup, two
#: warpgroups a CTA
WG_ROWS = 64
CTA_ROWS = 2 * WG_ROWS
#: error codes of the C interface beyond ``cudaError_t``'s
_NO_ENCODER, _ENCODE_FAILED = 199999, 200000
#: the backward's tensor-core kernels: 64 x 64 tiles; a dK/dV CTA owns 64
#: keys and deals the ring's (Q, dO) tiles to its two consumer warpgroups
#: in turn; a dQ CTA owns 128 query rows, 64 a warpgroup, over (K, V)
#: tiles of 64 keys.  At head dim BWD_SPLIT_D both passes split otherwise
#: (:func:`bwd_tile_schedule`)
BWD_TILE = 64
BWD_DQ_ROWS = 2 * BWD_TILE
BWD_DKDV_WARPGROUPS = 2
BWD_SPLIT_D = 256
#: the row statistics' buffers are padded to this many rows a head
BWD_PAD_ROWS = 128


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel that takes ``dtype`` inputs at head dim ``d``:
    ``"wgmma"`` (TMA + ``wgmma`` on the tensor cores) or ``"scalar"``
    (scalar FMAs; float32, which the tensor cores would round, and bf16 at
    the head dims the Hopper kernel is not built for)."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "scalar"


def bwd_kernel_for(dtype: torch.dtype, d: int) -> str:
    """The backward kernels that take ``dtype`` inputs at head dim ``d``:
    ``"wgmma"`` (bf16: TMA + ``wgmma`` on the tensor cores) or
    ``"scalar"`` (float32, which the tensor cores would round); raises
    ``NotImplementedError`` at a head dim outside :data:`BWD_HEAD_DIMS`."""
    if d not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention's backward kernel is built for head dims "
            f"{BWD_HEAD_DIMS} (every full-width arch's), not {d}; a model "
            f"this narrow trains through the plain version on the CPU")
    return "wgmma" if dtype == torch.bfloat16 else "scalar"


def block_k(d: int) -> int:
    """Keys per kv tile of the Hopper kernel at head dim ``d``: 128 (at
    64, 96 and 128), or 64 at head dim 256, where O takes 128 registers a
    thread and K and V tiles 32 KB each."""
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


def _bwd_band(q0: int, k0: int, causal: bool, w: int) -> tuple[bool, bool]:
    """(outside, inside) of the 64 x 64 tile of query rows from ``q0`` and
    keys from ``k0``, as ``Band`` in ``csrc/flash_attention_bwd.cu``: no
    pair visible, every pair visible (rows past Sq and keys past Skv do
    not count: their tiles are zero-filled)."""
    t = BWD_TILE - 1
    outside = (causal and k0 > q0 + t) or (w >= 0 and k0 + t < q0 - w)
    inside = (not causal or k0 + t <= q0) and (w < 0 or k0 >= q0 + t - w)
    return outside, inside


def bwd_dq_rows(d: int) -> int:
    """Query rows a dQ CTA of the tensor-core backward owns at head dim
    ``d``: :data:`BWD_DQ_ROWS`, or one tile at :data:`BWD_SPLIT_D`, where
    Q and dO of 128 rows (128 KB) leave room for one 64 KB (K, V) stage."""
    return BWD_TILE if d == BWD_SPLIT_D else BWD_DQ_ROWS


def bwd_tile_schedule(sq: int, skv: int, d: int, causal: bool,
                      window: int | None, group: int) -> dict:
    """The tensor-core backward's schedule, as ``fa_bwd_dkdv_wgmma`` and
    ``fa_bwd_dq_wgmma`` compute it, in launch order.  Head dims 64, 96 and
    128 share one schedule; at :data:`BWD_SPLIT_D` the warpgroups split the
    work otherwise (``SPLIT`` in ``csrc/flash_attention_bwd.cu``).

    ``"dkdv"``: a CTA a key block ``kb`` of :data:`BWD_TILE` keys (of one
    batch and kv head); ``"items"`` the ring's (query head ``g`` of the
    group, query tile ``qt``) in the order the producer loads them (every
    one meets the band); for each of its :data:`BWD_DKDV_WARPGROUPS`
    consumer warpgroups the items it computes as ``(g, qt, masked)``, and
    ``"columns"`` the ``[c0, c1)`` of dK and dV it sums: the items dealt in
    turn, every column (64, 96, 128), or every item, half the columns each
    (256).  ``"dq"``: a CTA a query block ``qb`` of :func:`bwd_dq_rows`
    rows, its key tiles ``[kb_lo, kb_hi)``, and for each of its two
    warpgroups its ``"rows"`` ``[r0, r1)`` and the tiles it computes as
    ``(kb, masked)``: 64 rows a warpgroup over every tile of its band (64,
    96, 128), or the CTA's 64 rows over the tiles dealt in turn, the two sums
    added (256).  A tile wholly outside the band is skipped; one wholly
    inside it runs without the mask."""
    w = -1 if window is None else window
    t = BWD_TILE
    nwg = BWD_DKDV_WARPGROUPS
    split = d == BWD_SPLIT_D
    nq, nk = -(-sq // t), -(-skv // t)
    dkdv = []
    for kb in range(nk):
        k0 = kb * t
        qt_lo = k0 // t if causal else 0
        qt_hi = nq if w < 0 else min(nq, (k0 + t - 1 + w) // t + 1)
        items = [(g, qt) for g in range(group) for qt in range(qt_lo, qt_hi)]
        tiles = [(g, qt, not _bwd_band(qt * t, k0, causal, w)[1])
                 for g, qt in items]
        if split:
            mine = [tiles] * nwg
            columns = [(wg * d // nwg, (wg + 1) * d // nwg)
                       for wg in range(nwg)]
        else:
            mine = [tiles[wg::nwg] for wg in range(nwg)]
            columns = [(0, d)] * nwg
        dkdv.append({"kb": kb, "items": items, "warpgroups": mine,
                     "columns": columns})
    rows = bwd_dq_rows(d)
    dq = []
    for qb in reversed(range(-(-sq // rows))):
        q0 = qb * rows
        kb_lo, kb_hi = 0, nk
        if causal:
            kb_hi = min(nk, (q0 + rows - 1) // t + 1)
        if w >= 0 and q0 - w > 0:
            kb_lo = (q0 - w) // t
        groups, spans = [], []
        for wg in range(2):
            r_lo = q0 if split else q0 + wg * t
            dealt = (range(kb_lo + wg, kb_hi, 2) if split
                     else range(kb_lo, kb_hi))
            tiles = []
            for kb in dealt:
                outside, inside = _bwd_band(r_lo, kb * t, causal, w)
                if r_lo < sq and not outside:
                    tiles.append((kb, not inside))
            groups.append(tiles)
            spans.append((r_lo, r_lo + t))
        dq.append({"qb": qb, "kb_lo": kb_lo, "kb_hi": kb_hi,
                   "warpgroups": groups, "rows": spans})
    return {"dkdv": dkdv, "dq": dq}


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float,
        _I, _I, _P]
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_wgmma_attributes.argtypes = [_I, _P]
    lib.flash_attention_wgmma_attributes.restype = _I
    lib.flash_attention_wgmma_launches.argtypes = []
    lib.flash_attention_wgmma_launches.restype = ctypes.c_longlong
    return lib


def wgmma_launches() -> int:
    """Launches of the TMA + ``wgmma`` forward kernel since its library
    was loaded, as ``flash_attention_launch``'s C dispatch counts them:
    the route the card took, which :func:`kernel_for` only predicts.
    Builds the kernels on first use (the card only)."""
    return _lib().flash_attention_wgmma_launches()


@functools.cache
def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    lib.flash_attention_bwd_launch.argtypes = [_P] * 10 + [_I] * 7 + [
        _P, ctypes.c_float, _I, _I, _P]
    lib.flash_attention_bwd_launch.restype = _I
    lib.flash_attention_bwd_attributes.argtypes = [_I, _I, _P]
    lib.flash_attention_bwd_attributes.restype = _I
    return lib


_ATTRIBUTE_NAMES = ("registers", "static_smem", "dynamic_smem", "local_bytes",
                    "max_threads")


def wgmma_attributes(d: int) -> dict:
    """The TMA + ``wgmma`` kernel's build at head dim ``d`` (64, 96, 128
    or 256), from ``cudaFuncGetAttributes``: registers a thread, static and
    dynamic shared memory, local (spill) bytes a thread, max threads a
    block.  Needs a card."""
    lib = _lib()
    attrs = (ctypes.c_int * 5)()
    err = lib.flash_attention_wgmma_attributes(d, attrs)
    if err:
        raise RuntimeError(f"flash_attention_wgmma_attributes({d}) failed: "
                           f"cudaError_t {err}")
    return dict(zip(_ATTRIBUTE_NAMES, attrs))


def bwd_wgmma_attributes(d: int) -> dict:
    """The backward's tensor-core kernels at head dim ``d`` (64, 96, 128
    or 256), as :func:`wgmma_attributes` reports them: ``"dkdv"`` and
    ``"dq"``.  Needs a card."""
    lib = _bwd_lib()
    out = {}
    for which, name in enumerate(("dkdv", "dq")):
        attrs = (ctypes.c_int * 5)()
        err = lib.flash_attention_bwd_attributes(d, which, attrs)
        if err:
            raise RuntimeError(f"flash_attention_bwd_attributes({d}, "
                               f"{which}) failed: cudaError_t {err}")
        out[name] = dict(zip(_ATTRIBUTE_NAMES, attrs))
    return out


def _raise_on(err: int, what: str) -> None:
    """Raise on a C interface's error code (0 is success)."""
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - _ENCODE_FAILED})")
    if err == _NO_ENCODER:
        raise RuntimeError(f"{what}: no cuTensorMapEncodeTiled entry point "
                           "(CUDA 12.0 or later is needed)")
    if err:
        raise RuntimeError(f"{what} launch failed: cudaGetLastError() = "
                           f"{err}")


def _tma_inputs(q, k, v):
    """q, k, v with a unit head-dim stride, copied where TMA cannot read
    them in place."""
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    return tuple(t if tma_ready(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (q, k, v))


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


def _forward(q, k, v, causal: bool, window, sm_scale: float, lse=None):
    """One launch of the forward kernel on CUDA tensors that
    :func:`check_attention_args` accepted; ``lse``, a ``(B, H, Sq)``
    float32 tensor, gets each row's log-sum-exp (the TMA + ``wgmma``
    kernel only).  Counts nothing."""
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if kernel_for(q.dtype, d) == "wgmma":
        q, k, v = _tma_inputs(q, k, v)
    elif lse is not None:
        raise ValueError("only the TMA + wgmma kernel (bf16 at head dims "
                         f"{WGMMA_HEAD_DIMS}) writes the log-sum-exp")
    else:
        q, k, v = (t if t.stride(3) == 1 else t.contiguous()
                   for t in (q, k, v))
    lib = _lib()
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*(t.stride(i) for t in (q, k, v)
                                     for i in range(3)))
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, k.shape[1], sq, k.shape[2], d,
            ctypes.cast(strides, ctypes.c_void_p), float(sm_scale),
            int(causal), -1 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention")
    return out


def _launch(q, k, v, causal: bool, window, sm_scale: float, lse=None):
    """:func:`_forward`, counted in ``flash_attention.launches``."""
    out = _forward(q, k, v, causal, window, sm_scale, lse)
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """B3 with its backward kernel: the forward launches :func:`_launch`,
    the backward :func:`flash_attention_bwd` on the saved inputs and
    output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        lse = None
        if bwd_kernel_for(q.dtype, q.shape[3]) == "wgmma":
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
        out = _launch(q, k, v, causal, window, sm_scale, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, sm_scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                         window=window, sm_scale=sm_scale,
                                         lse=lse)
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
        bwd_kernel_for(q.dtype, d)  # raises at a head dim it is not built for
        return _FlashAttention.apply(q, k, v, causal, window, sm_scale)
    return _launch(q, k, v, causal, window, sm_scale)


flash_attention.launches = 0


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             window: int | None = None,
                             sm_scale: float | None = None):
    """:func:`flash_attention`'s output and each row's log-sum-exp of its
    scaled, masked scores, ``(B, H, Sq)`` float32: what the backward reads.
    On CUDA tensors one launch of the TMA + ``wgmma`` kernel (bf16 at head
    dims :data:`WGMMA_HEAD_DIMS`), counted in ``flash_attention.launches``;
    on CPU tensors the plain versions."""
    check_attention_args(q, k, v, causal, window)
    b, h, sq, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return (ref.attention_ref(q, k, v, causal=causal, window=window,
                                  sm_scale=sm_scale),
                ref.attention_lse_ref(q, k, v, causal=causal, window=window,
                                      sm_scale=sm_scale))
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window, sm_scale, lse), lse


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                        window: int | None = None,
                        sm_scale: float | None = None, lse=None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` at q, k, v
    (its output ``out``) for the incoming gradient ``dout`` (both ``(B, H,
    Sq, D)``), in the inputs' dtype.  On CUDA tensors: one call of
    ``csrc/flash_attention_bwd.cu``, counted once in
    ``flash_attention_bwd.launches``.  bf16 (:func:`bwd_kernel_for`) runs
    the tensor-core kernels (D and the statistics, dK and dV, dQ) from
    ``lse``, the forward's row log-sum-exp (:func:`flash_attention_with_lse`;
    without it this call runs the forward once more to get it); float32
    the scalar kernels (row statistics, dK and dV, dQ), which ignore
    ``lse``.  On CPU tensors the plain version, autograd through
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
    kernel = bwd_kernel_for(q.dtype, d)  # raises at a head dim not built
    out = out.to(q.dtype).contiguous()
    dout = dout.to(q.dtype).contiguous()
    if kernel == "wgmma":
        q, k, v = _tma_inputs(q, k, v)
        if lse is None:
            lse = torch.empty((b, h, sq), dtype=torch.float32,
                              device=q.device)
            _forward(q, k, v, causal, window, sm_scale, lse)
        elif lse.shape != (b, h, sq) or lse.dtype != torch.float32:
            raise ValueError(f"lse must be ({b}, {h}, {sq}) float32, got "
                             f"{tuple(lse.shape)} {lse.dtype}")
        lse = lse.contiguous()
        sq_pad = -(-sq // BWD_PAD_ROWS) * BWD_PAD_ROWS
        scratch = torch.empty((2, b, h, sq_pad), dtype=torch.float32,
                              device=q.device)
    else:
        q, k, v = (t if t.stride(3) == 1 else t.contiguous()
                   for t in (q, k, v))
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        scratch = torch.empty_like(lse)
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*(t.stride(i) for t in (q, k, v)
                                     for i in range(3)))
    with torch.cuda.device(q.device):
        err = _bwd_lib().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), _DTYPE_CODE[q.dtype], b, h,
            k.shape[1], sq, k.shape[2], d,
            ctypes.cast(strides, ctypes.c_void_p), float(sm_scale),
            int(causal), -1 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
