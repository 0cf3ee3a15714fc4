"""The port's SSD scan (B4) and its backward against the JAX reference.

The port's two plain scans (``repro_torch.kernels.ref``) are held to the
reference's oracles (``repro.kernels.ref``) and to its Pallas kernel in
interpret mode (its default off a TPU), at the reference's own test shapes
(``tests/test_kernels.py``), with and without h0, in float32 and bfloat16;
the SSD wrapper and ``ops`` keep the reference's length contracts.  The
plain chunked backward (``ssd_scan_bwd_chunked_ref``) is held to
``jax.vjp`` of the reference's ``ssd_scan_ref``.  The reference's oracles
are jitted once a shape (eager jax costs several times the compile).  The
RG-LRU scan (B5) is in ``test_torch_lru.py``.
The CUDA cases need a card (marker ``cuda``) and skip without one; the
reference is imported only by the tests that use it, so on a machine with
a card and no ``jax``

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_scans.py

runs the kernel cases alone.

Tolerances: the reference's own, 2e-3 for SSD (its chunked form and the
step form sum in different orders), in float32.  In bfloat16 both sides
compute in float32 from the same rounded inputs and round y once, so
they differ by at most about one bfloat16 step where a float32 sum
straddles a rounding boundary: held to 1e-2 of max |y|.  The
chunked SSD kernel (bf16 on the tensor cores) also rounds S⊙M, X⊙w and
its operand copy of the state to bf16; a CPU emulation of exactly those
rounding points is held to the step-by-step oracle at the same 1e-2.
The backward is held as max |diff| / max |grad| of each gradient (B3's
backward gates): 1e-4 in float32 (the same function, summed in another
order), 2e-2 in bf16 (the kernel's rounding points against exact float32
arithmetic on the same rounded values).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ssd_scan import ssd_scan
from test_torch_common import (_card, _jax,  # noqa: F401
                               _one_torch_thread, _round, _torch,
                               close_scans)


#: the reference's SSD kernel tests: b, s, h, p, n, chunk
SSD_CASES = [(1, 256, 2, 64, 64, 64), (2, 128, 1, 32, 128, 128),
             (1, 512, 3, 16, 32, 128)]
TOL = {"ssd": 2e-3}
BF16_RTOL = 1e-2


def _ssd_inputs(b, s, h, p, n, seed=0, dtype="float32", h0=True,
                decay_lo=0.2):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, h, p)),
            rng.uniform(decay_lo, 1.0, (b, s, h)),
            rng.standard_normal((b, s, h, n)) * 0.3,
            rng.standard_normal((b, s, h, n)) * 0.3]
    arrs = [_round(a.astype(np.float32), dtype) for a in arrs]
    state = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32) \
        if h0 else None
    return arrs, state


@functools.cache
def _jref():
    """The reference's two SSD oracles, jitted (chunk static), and its
    Pallas kernel (jitted by the reference)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_scan as jssd
    return (jax.jit(jref.ssd_scan_naive),
            jax.jit(jref.ssd_scan_ref, static_argnames="chunk"), jssd)


def _close(got, want, dtype, kind):
    """y and the final state of one scan against another's."""
    close_scans(got, want, dtype, TOL[kind], BF16_RTOL)


# ================================================================ SSD scan ===
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_plain_matches_reference(b, s, h, p, n, chunk, h0, dtype):
    """The port's naive and chunked SSD against the reference's two
    oracles and its Pallas kernel (interpret mode), on the same inputs."""
    jnaive, jchunked, jssd = _jref()
    arrs, state = _ssd_inputs(b, s, h, p, n, seed=s + n, dtype=dtype, h0=h0)
    ts, t0 = _torch(arrs, state, dtype)
    js, j0 = _jax(arrs, state, dtype)
    naive = ref.ssd_scan_naive(*ts, t0)
    chunked = ref.ssd_scan_ref(*ts, t0, chunk=chunk)
    assert naive[0].dtype == ts[0].dtype and naive[1].dtype == torch.float32
    assert chunked[1].shape == (b, h, p, n)
    want_naive = jnaive(*js, j0)
    _close(naive, want_naive, dtype, "ssd")
    _close(chunked, jchunked(*js, j0, chunk=chunk), dtype, "ssd")
    _close(chunked, want_naive, dtype, "ssd")
    _close(chunked, jssd(*js, j0, chunk=chunk), dtype, "ssd")


def test_ssd_chunked_ref_matches_naive_as_the_reference_tests_it():
    """The reference's own check of its chunked form (64-step chunks)."""
    arrs, _ = _ssd_inputs(2, 256, 2, 32, 64, seed=2, h0=False)
    ts, _ = _torch(arrs, None, "float32")
    _close(ref.ssd_scan_ref(*ts, chunk=64), ref.ssd_scan_naive(*ts),
           "float32", "ssd")


def test_ssd_decay_is_clamped_like_the_kernel():
    """A zero decay is clamped at 1e-37 in the log, so the state restarts
    from x ⊗ b instead of turning into NaN."""
    arrs, state = _ssd_inputs(1, 64, 2, 16, 16, seed=3)
    arrs[1][:, 10] = 0.0
    ts, t0 = _torch(arrs, state, "float32")
    got = ref.ssd_scan_ref(*ts, t0, chunk=32)
    assert all(torch.isfinite(t).all() for t in got)
    _close(got, ref.ssd_scan_naive(*ts, t0), "float32", "ssd")


def test_ssd_wrapper_keeps_both_length_contracts():
    """S must be divisible by min(chunk, S) (the Pallas kernel) and by
    min(128, S) (the XLA path); the wrapper and ops raise otherwise, on
    the CPU too, and launch nothing for a CPU tensor."""
    before = ssd_scan.launches
    for s, chunk, ok in ((160, 32, False),    # Pallas takes it, XLA not
                         (128, 96, False),    # XLA takes it, Pallas not
                         (200, 64, False),    # neither
                         (128, 32, True), (8, 32, True), (40, 128, True)):
        arrs, state = _ssd_inputs(1, s, 2, 16, 16, seed=s)
        ts, t0 = _torch(arrs, state, "float32")
        for fn in (lambda: ssd_scan(*ts, t0, chunk=chunk),
                   lambda: ops.ssd_scan(*ts, t0, chunk=chunk, impl="xla"),
                   lambda: ops.ssd_scan(*ts, t0, chunk=chunk)):
            if ok:
                y, h_t = fn()
                assert y.shape == ts[0].shape and h_t.shape == (1, 2, 16, 16)
            else:
                with pytest.raises(ValueError, match="divisible"):
                    fn()
    assert ssd_scan.launches == before


def test_ssd_wrapper_checks_its_inputs():
    arrs, state = _ssd_inputs(1, 64, 2, 16, 16)
    ts, t0 = _torch(arrs, state, "float32")
    with pytest.raises(TypeError):
        ssd_scan(ts[0].double(), *ts[1:], t0)
    with pytest.raises(TypeError):
        ssd_scan(ts[0], ts[1].bfloat16(), *ts[2:], t0)
    with pytest.raises(ValueError):
        ssd_scan(ts[0], ts[1][:, :, :1], *ts[2:], t0)
    with pytest.raises(ValueError):
        ssd_scan(*ts, t0[:, :1])
    with pytest.raises(ValueError, match="impl"):
        ops.ssd_scan(*ts, t0, impl="triton")


def test_ssd_ops_impls_agree_on_cpu():
    """``auto``/``pallas`` (the wrapper's plain version on a CPU tensor)
    and ``xla`` give the same result, b and c given as a broadcast view
    over heads as the model gives them."""
    rng = np.random.default_rng(4)
    b, s, h, p, n = 2, 64, 4, 16, 16
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(
        np.float32))
    a = torch.from_numpy(rng.uniform(0.3, 1, (b, s, h)).astype(np.float32))
    bc = torch.from_numpy(rng.standard_normal((b, s, 2 * n)).astype(
        np.float32))
    bm = bc[..., :n][:, :, None, :].expand(b, s, h, n)
    cm = bc[..., n:][:, :, None, :].expand(b, s, h, n)
    outs = [ops.ssd_scan(x, a, bm, cm, chunk=32, impl=i)
            for i in ("auto", "pallas", "xla")]
    for o in outs[1:]:
        assert all(torch.equal(u, v) for u, v in zip(o, outs[0]))
    _close(outs[0], ref.ssd_scan_naive(x, a, bm.contiguous(),
                                       cm.contiguous()), "float32", "ssd")


@pytest.mark.parametrize("dtype,p,n,want", [
    (torch.bfloat16, 64, 128, "chunked"),   # mamba2-370m's prefill
    (torch.bfloat16, 64, 64, "chunked"),
    (torch.float32, 64, 128, "step"),       # the tensor cores would round
    (torch.float32, 64, 64, "step"),
    (torch.bfloat16, 64, 16, "step"),
    (torch.bfloat16, 64, 256, "step"),
    (torch.bfloat16, 32, 128, "step"),
    (torch.bfloat16, 16, 32, "step"),
    (torch.bfloat16, 3, 16, "step"),
])
def test_ssd_kernel_routing(dtype, p, n, want):
    """The kernel an input takes depends on its dtype and shape alone."""
    assert ssd_mod.kernel_for(dtype, p, n) == want


@pytest.mark.parametrize("n", [8, 48, 512])
def test_ssd_routing_raises_outside_the_built_state_widths(n):
    """No kernel is built for N outside STATE_DIMS: the wrapper's route
    raises for a CUDA tensor instead of picking one."""
    assert n not in ssd_mod.STATE_DIMS
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="not built"):
            ssd_mod.kernel_for(dtype, 64, n)


@pytest.mark.parametrize("s", [8, 72, 100, 128, 32768])
def test_ssd_chunk_plan(s):
    """The chunked kernel's chunks cover [0, S) in order, 64 steps each;
    only the last may be ragged, and its padded rows end it, so its last
    valid step is S - 1."""
    plan = ssd_mod.chunk_plan(s)
    assert len(plan) == -(-s // ssd_mod.CHUNK)
    assert plan[0][0] == 0 and plan[-1][1] == s
    for (start, stop, padded), nxt in zip(plan, plan[1:] + [None]):
        assert stop - start + padded == ssd_mod.CHUNK
        if nxt is not None:
            assert nxt[0] == stop and padded == 0
    assert plan[-1][2] == (-s) % ssd_mod.CHUNK
    assert plan[-1][1] - 1 == s - 1


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _emulate_chunked(x, a, b_mat, c_mat, h0=None, chunk=ssd_mod.CHUNK):
    """The chunked kernel's arithmetic on the CPU: chunks of ``chunk``
    steps (a ragged tail padded with zeros and decay 1), cum in log2,
    everything in float32 except the three operands the kernel rounds to
    bf16: S⊙M, X⊙w and the copy of the carried state in C·H_prevᵀ."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, chunk, h, p)
    bc = F.pad(b_mat.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, chunk,
                                                            h, n)
    cc = F.pad(c_mat.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, chunk,
                                                            h, n)
    ac = F.pad(a.float(), (0, 0, 0, pad), value=1.0).reshape(bsz, nc, chunk,
                                                            h)
    cum = torch.cumsum(torch.log2(torch.clamp(ac, min=1e-37)), dim=2)
    state = (torch.zeros((bsz, h, p, n)) if h0 is None else h0.float())
    below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    ys = []
    for c in range(nc):
        cu = cum[:, c].transpose(1, 2)                    # (B, H, L)
        xq, bq, cq = (t[:, c].transpose(1, 2) for t in (xc, bc, cc))
        sc = cq @ bq.transpose(-1, -2)                    # (B, H, L, L)
        expo = torch.where(below, cu[..., :, None] - cu[..., None, :],
                           -torch.inf)
        y = _bf16(sc * torch.exp2(expo)) @ xq
        y = y + torch.exp2(cu)[..., None] * (cq @ _bf16(state).transpose(
            -1, -2))
        ys.append(y.transpose(1, 2))                      # (B, L, H, P)
        last = cu[..., -1:]
        w = torch.exp2(last - cu)[..., None]              # (B, H, L, 1)
        state = (torch.exp2(last)[..., None] * state
                 + _bf16(xq * w).transpose(-1, -2) @ bq)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), state


#: the emulation's cases: the reference's SSD shapes, mamba2's P and N at
#: ragged lengths and at S = 4,096 (with the reference tests' decays and
#: with slow decays, whose long-lived state leans hardest on the bf16 copy
#: of H): b, s, h, p, n, lowest decay
EMULATION_CASES = [c[:5] + (0.2,) for c in SSD_CASES] + [
    (1, 72, 2, 64, 128, 0.2), (2, 100, 2, 64, 128, 0.2),
    (1, 4096, 2, 64, 128, 0.2), (1, 4096, 2, 64, 128, 0.95)]


@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("b,s,h,p,n,decay_lo", EMULATION_CASES)
def test_ssd_chunked_rounding_plan_meets_the_bf16_tolerance(b, s, h, p, n,
                                                            decay_lo, h0):
    """The precision plan of the chunked kernel, before any card: its
    rounding points on bf16 inputs stay within 1e-2 of max |value| of the
    step-by-step oracle, for y and the final state."""
    arrs, state = _ssd_inputs(b, s, h, p, n, seed=s + p + n,
                              dtype="bfloat16", h0=h0, decay_lo=decay_lo)
    ts, t0 = _torch(arrs, state, "bfloat16")
    got = _emulate_chunked(*ts, t0)
    assert got[0].dtype == torch.bfloat16 and got[1].shape == (b, h, p, n)
    _close(got, ref.ssd_scan_naive(*ts, t0), "bfloat16", "ssd")


def test_ssd_chunked_rounding_plan_with_a_zero_decay():
    """A zero decay mid-chunk restarts the state (the 1e-37 clamp), and
    the emulated kernel stays finite and within tolerance."""
    arrs, state = _ssd_inputs(1, 256, 2, 64, 128, seed=6, dtype="bfloat16")
    arrs[1][:, 100] = 0.0
    arrs[1][:, 37, 1] = 0.0
    ts, t0 = _torch(arrs, state, "bfloat16")
    got = _emulate_chunked(*ts, t0)
    assert all(torch.isfinite(t).all() for t in got)
    _close(got, ref.ssd_scan_naive(*ts, t0), "bfloat16", "ssd")


# ============================================================ on the card ===
SSD_CUDA_CASES = [c + (dt,) for c in SSD_CASES + [(2, 8, 8, 16, 16, 32),
                                                  (1, 256, 2, 16, 256, 128),
                                                  (1, 100, 1, 3, 16, 128)]
                  for dt in ("float32", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", SSD_CUDA_CASES)
def test_cuda_ssd_scan_matches_plain_version(b, s, h, p, n, chunk, dtype,
                                             h0):
    """The reference's shapes, mamba2's smoke shape, the widest state the
    kernel takes, and a ragged length with an odd P."""
    _card()
    arrs, state = _ssd_inputs(b, s, h, p, n, seed=s + p, dtype=dtype, h0=h0)
    ts, t0 = _torch(arrs, state, dtype, "cuda")
    before = ssd_scan.launches
    got = ssd_scan(*ts, t0, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert got[0].dtype == ts[0].dtype and got[1].dtype == torch.float32
    _close(got, ref.ssd_scan_naive(*ts, t0), dtype, "ssd")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_reads_a_broadcast_view(dtype):
    """b and c as the model hands them: one (B, S, N) slice broadcast over
    the heads (stride 0), read in place."""
    _card()
    b, s, h, p, n = 2, 256, 8, 64, 128
    g = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(dt)
    a = (0.2 + 0.8 * torch.rand((b, s, h), generator=g,
                                device="cuda")).to(dt)
    bc = (0.3 * torch.randn((b, s, 2 * n), generator=g,
                            device="cuda")).to(dt)
    bm = bc[..., :n][:, :, None, :].expand(b, s, h, n)
    cm = bc[..., n:][:, :, None, :].expand(b, s, h, n)
    assert bm.stride(2) == 0
    got = ssd_scan(x, a, bm, cm, chunk=128)
    _close(got, ref.ssd_scan_ref(x, a, bm, cm, chunk=128), dtype, "ssd")


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("s", [72, 100])
def test_cuda_ssd_chunked_kernel_at_ragged_lengths(s, h0):
    """Lengths the C5 contract admits that are no multiple of the chunked
    kernel's 64 steps: TMA zero-fills the last chunk past S, whose steps
    count as decay 1, so the final state is taken at the last valid
    step."""
    _card()
    arrs, state = _ssd_inputs(2, s, 3, 64, 128, seed=s, dtype="bfloat16",
                              h0=h0)
    ts, t0 = _torch(arrs, state, "bfloat16", "cuda")
    before = ssd_scan.chunked_launches
    got = ssd_scan(*ts, t0)
    torch.cuda.synchronize()
    assert ssd_scan.chunked_launches == before + 1
    _close(got, ref.ssd_scan_naive(*ts, t0), "bfloat16", "ssd")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
def test_cuda_ssd_chunked_kernel_with_a_zero_decay(n):
    """A zero decay mid-chunk: the clamped log-decay restarts the state,
    and every value stays finite on the card."""
    _card()
    arrs, state = _ssd_inputs(1, 256, 2, 64, n, seed=7, dtype="bfloat16")
    arrs[1][:, 100] = 0.0
    arrs[1][:, 37, 1] = 0.0
    ts, t0 = _torch(arrs, state, "bfloat16", "cuda")
    got = ssd_scan(*ts, t0)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in got)
    _close(got, ref.ssd_scan_naive(*ts, t0), "bfloat16", "ssd")


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
def test_cuda_ssd_chunked_kernel_reads_the_models_conv_slices(h0):
    """b and c as mamba2_forward hands them: column slices of one conv_out
    tensor (B, S, d_inner + 2N), broadcast over heads with stride 0, read
    in place by TMA."""
    _card()
    b, s, h, p, n = 2, 256, 4, 64, 128
    d_inner = h * p
    g = torch.Generator(device="cuda").manual_seed(8)
    conv_out = (0.3 * torch.randn((b, s, d_inner + 2 * n), generator=g,
                                  device="cuda")).to(torch.bfloat16)
    x = torch.randn((b, s, h, p), generator=g,
                    device="cuda").to(torch.bfloat16)
    a = (0.2 + 0.8 * torch.rand((b, s, h), generator=g,
                                device="cuda")).to(torch.bfloat16)
    bm = conv_out[..., d_inner:d_inner + n][:, :, None, :].expand(b, s, h, n)
    cm = conv_out[..., d_inner + n:][:, :, None, :].expand(b, s, h, n)
    assert bm.stride(2) == 0 and ssd_mod.tma_ready(bm) \
        and ssd_mod.tma_ready(cm)
    state = 0.1 * torch.randn((b, h, p, n), generator=g, device="cuda") \
        if h0 else None
    before = ssd_scan.chunked_launches
    got = ssd_scan(x, a, bm, cm, state)
    torch.cuda.synchronize()
    assert ssd_scan.chunked_launches == before + 1
    _close(got, ref.ssd_scan_naive(x, a, bm.contiguous(), cm.contiguous(),
                                   state), "bfloat16", "ssd")


@pytest.mark.cuda
def test_cuda_ssd_scan_raises_outside_the_built_state_widths():
    _card()
    arrs, state = _ssd_inputs(1, 64, 2, 16, 48, dtype="bfloat16")
    ts, t0 = _torch(arrs, state, "bfloat16", "cuda")
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="not built"):
        ssd_scan(*ts, t0)
    assert ssd_scan.launches == before


@pytest.mark.cuda
def test_cuda_ssd_scan_carries_a_gradient():
    """B4 has its backward kernel: under grad on the card the result
    carries it (one backward launch), and without grad it carries
    nothing."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, 64, 2, 16), generator=g, device="cuda")
    a = torch.rand((1, 64, 2), generator=g, device="cuda")
    bm = torch.randn((1, 64, 2, 16), generator=g, device="cuda")
    before = ssd_mod.ssd_scan_bwd.launches
    y, _ = ssd_scan(x.requires_grad_(), a, bm, bm, chunk=64)
    y.sum().backward()
    assert x.grad is not None and ssd_mod.ssd_scan_bwd.launches == before + 1
    with torch.no_grad():
        y, _ = ssd_scan(x, a, bm, bm, chunk=64)
    assert y.grad_fn is None


# the backward kernel's cases (small sizes of chip_smoke.py phase 21's):
# b, s, h, p, n, dtype, h0 and a final-state gradient, zero decay mid-chunk
SSD_BWD_CASES = [(1, 256, 2, 64, 64, "float32", True, False),
                 (2, 128, 1, 32, 128, "float32", True, False),
                 (1, 512, 3, 16, 32, "float32", True, False),
                 (1, 128, 2, 16, 16, "float32", True, False),
                 (1, 256, 2, 64, 128, "bfloat16", False, True),
                 (2, 100, 3, 64, 128, "bfloat16", True, False),
                 (2, 100, 3, 64, 128, "float32", True, True),
                 (2, 512, 4, 64, 128, "bfloat16", False, False)]
SSD_BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _bwd_inputs(b, s, h, p, n, dtype, h0, zero, seed, device):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=device).to(dt)
    a = torch.empty((b, s, h), device=device).uniform_(
        0.6, 1.0, generator=g).to(dt)
    if zero:
        a[:, s // 2 + 3] = 0
    bm = (torch.randn((b, s, 1, n), generator=g, device=device)
          * n ** -0.5).to(dt).expand(b, s, h, n)
    cm = (torch.randn((b, s, 1, n), generator=g, device=device)
          * n ** -0.5).to(dt).expand(b, s, h, n)
    hh = torch.randn((b, h, p, n), generator=g, device=device) if h0 \
        else None
    dy = torch.randn((b, s, h, p), generator=g, device=device).to(dt)
    ds = torch.randn((b, h, p, n), generator=g, device=device) if h0 \
        else None
    return x, a, bm, cm, dy, hh, ds


def test_ssd_bwd_plain_version_carries_the_naive_gradient():
    """The plain backward (autograd through the chunked plain scan) equals
    autograd through the step-by-step oracle, float32, with h0 and a
    final-state gradient, b and c broadcast over heads (where no decay is
    clamped the two are the same function)."""
    for s in (100,):
        x, a, bm, cm, dy, hh, ds = _bwd_inputs(2, s, 2, 16, 32, "float32",
                                               True, False, seed=s,
                                               device="cpu")
        got = ref.ssd_scan_bwd_ref(x, a, bm, cm, dy, hh, ds)
        ins = [t.detach().requires_grad_() for t in (x, a, bm, cm, hh)]
        y, state = ref.ssd_scan_naive(*ins)
        want = torch.autograd.grad([y, state], ins, [dy, ds])
        for name, gv, wv in zip(("dx", "da", "db", "dc", "dh0"), got, want):
            assert gv.shape == wv.shape, name
            torch.testing.assert_close(gv, wv, rtol=1e-4, atol=1e-4,
                                       msg=name)
    # the wrapper takes the plain version on the CPU, h0 absent
    x, a, bm, cm, dy, _, _ = _bwd_inputs(1, 64, 2, 16, 16, "float32", False,
                                         False, seed=3, device="cpu")
    got = ssd_mod.ssd_scan_bwd(x, a, bm, cm, dy)
    assert got[4] is None
    for gv, wv in zip(got[:4], ref.ssd_scan_bwd_ref(x, a, bm, cm, dy)):
        assert torch.equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,dtype,h0,zero", SSD_BWD_CASES)
def test_cuda_ssd_scan_bwd_matches_plain_version(b, s, h, p, n, dtype, h0,
                                                 zero):
    """B4's backward kernel against autograd through the plain scan
    (``ssd_scan_bwd_ref``), as max |diff| / max |grad| per gradient (B3's
    backward gates), and two calls bit-equal."""
    _card()
    ins = _bwd_inputs(b, s, h, p, n, dtype, h0, zero, seed=s + n,
                      device="cuda")
    before = ssd_mod.ssd_scan_bwd.launches
    got = ssd_mod.ssd_scan_bwd(*ins)
    again = ssd_mod.ssd_scan_bwd(*ins)
    torch.cuda.synchronize()
    assert ssd_mod.ssd_scan_bwd.launches == before + 2
    want = ref.ssd_scan_bwd_ref(*ins)
    for name, gv, av, wv in zip(("dx", "da", "db", "dc", "dh0"), got, again,
                                want):
        if wv is None:
            assert gv is None
            continue
        assert torch.equal(gv, av), name
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
        rel = ((gv.float() - wv.float()).abs().max()
               / wv.float().abs().max()).item()
        assert rel <= SSD_BWD_RTOL[dtype], (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_gradient_through_a_broadcast_view(dtype):
    """The model's b and c, one head's columns broadcast over the heads:
    autograd's expand backward sums the kernel's per-head gradients, held
    to autograd through the plain scan."""
    _card()
    b, s, h, p, n = 2, 256, 4, 64, 128
    x, a, bm, cm, dy, _, _ = _bwd_inputs(b, s, h, p, n, dtype, False, False,
                                         seed=9, device="cuda")
    grads = []
    for fn in (ssd_scan, ref.ssd_scan_ref):
        leaves = [t.detach().clone().requires_grad_() for t in
                  (x, a, bm[:, :, :1].contiguous(), cm[:, :, :1].contiguous())]
        y, _ = fn(leaves[0], leaves[1], leaves[2].expand(b, s, h, n),
                  leaves[3].expand(b, s, h, n))
        y.backward(dy)
        grads.append([t.grad for t in leaves])
    for gv, wv in zip(*grads):
        rel = ((gv.float() - wv.float()).abs().max()
               / wv.float().abs().max()).item()
        assert rel <= SSD_BWD_RTOL[dtype], rel


# ================================================ the chunked backward ===
@pytest.mark.parametrize("dtype,p,n,want", [
    (torch.bfloat16, 64, 128, "chunked"),   # mamba2-370m's training
    (torch.bfloat16, 64, 64, "chunked"),
    (torch.float32, 64, 128, "step"),       # the tensor cores would round
    (torch.float32, 64, 64, "step"),
    (torch.float32, 16, 32, "step"),
    (torch.bfloat16, 64, 16, "step"),
    (torch.bfloat16, 64, 32, "step"),
    (torch.bfloat16, 64, 256, "step"),
    (torch.bfloat16, 64, 48, "step"),       # a width no forward is built for
    (torch.bfloat16, 32, 128, "step"),
    (torch.bfloat16, 16, 32, "step"),
    (torch.bfloat16, 3, 16, "step"),
])
def test_ssd_bwd_kernel_routing(dtype, p, n, want):
    """The backward's kernel depends on dtype and shape alone, as the
    forward's: bf16 at P 64 and N 64 or 128 on the chunked kernel, every
    other input on the step kernel."""
    assert ssd_mod.bwd_kernel_for(dtype, p, n) == want


def _bwd_numpy(b, s, h, p, n, dtype, seed, zero=False):
    """The backward's inputs from numpy, rounded to ``dtype``: x, a, b and
    c one head's columns broadcast over the heads (the model's views), dy,
    h0 and the final state's gradient (float32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    a = rng.uniform(0.6, 1.0, (b, s, h))
    if zero:
        a[:, s // 2 + 3] = 0.0
    bm, cm = (np.broadcast_to(rng.standard_normal((b, s, 1, n)) * n ** -0.5,
                              (b, s, h, n)) for _ in range(2))
    dy = rng.standard_normal((b, s, h, p))
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return ([_round(np.ascontiguousarray(t, np.float32), dtype)
             for t in (x, a, bm, cm, dy)], h0, ds)


@functools.cache
def _jax_bwd():
    """``jax.vjp`` of the reference's ``ssd_scan_ref`` at (y, final state),
    jitted (chunk static): ``(dx, da, db, dc, dh0)``."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref

    def vjp(x, a, b_mat, c_mat, h0, dy, ds, chunk):
        _, pull = jax.vjp(lambda *ins: jref.ssd_scan_ref(*ins, chunk=chunk),
                          x, a, b_mat, c_mat, h0)
        return pull((dy, ds))
    return jax.jit(vjp, static_argnames="chunk")


#: b, s, h, p, n, dtype, zero decay mid-chunk: the reference's scan shapes
#: in float32, mamba2's P and N in bf16, a zero decay, a length under 128
#: that is no multiple of the kernel's 64-step chunks
SSD_BWD_CHUNKED_CASES = [(1, 256, 2, 64, 64, "float32", False),
                         (2, 128, 1, 32, 128, "float32", False),
                         (1, 512, 3, 16, 32, "float32", False),
                         (2, 256, 2, 64, 128, "bfloat16", False),
                         (1, 256, 2, 64, 128, "bfloat16", True),
                         (2, 100, 3, 64, 128, "bfloat16", False),
                         (2, 100, 3, 64, 128, "float32", True)]


@pytest.mark.parametrize("b,s,h,p,n,dtype,zero", SSD_BWD_CHUNKED_CASES)
def test_ssd_bwd_chunked_plain_matches_jax_grad(b, s, h, p, n, dtype, zero):
    """The chunked backward's plain version, with the kernel's rounding
    points in bf16, against ``jax.vjp`` of the reference's XLA scan on the
    same numpy-seeded values (float32 arithmetic, h0 and a final-state
    gradient) and against autograd through the port's plain scan
    (``ssd_scan_bwd_ref``), each gradient as max |diff| / max |grad|."""
    arrs, h0, ds = _bwd_numpy(b, s, h, p, n, dtype, seed=s + n + zero,
                              zero=zero)
    dt = getattr(torch, dtype)
    x, a, bm, cm, dy = (torch.from_numpy(t).to(dt) for t in arrs)
    th0, tds = torch.from_numpy(h0), torch.from_numpy(ds)
    got = ref.ssd_scan_bwd_chunked_ref(x, a, bm, cm, dy, th0, tds)
    want = _jax_bwd()(*arrs[:4], h0, arrs[4], ds, chunk=min(128, s))
    port = ref.ssd_scan_bwd_ref(x, a, bm, cm, dy, th0, tds)
    for name, gv, wv, pv in zip(("dx", "da", "db", "dc", "dh0"), got, want,
                                port):
        wv = np.asarray(wv, np.float32)
        assert gv.shape == wv.shape and gv.dtype == pv.dtype, name
        assert torch.isfinite(gv).all(), name
        gf = gv.float().numpy()
        rel = np.abs(gf - wv).max() / np.abs(wv).max()
        assert rel <= SSD_BWD_RTOL[dtype], (name, rel)
        rel = ((gv.float() - pv.float()).abs().max()
               / pv.float().abs().max()).item()
        assert rel <= SSD_BWD_RTOL[dtype], (name, rel)
    # where the forward clamped the decay its gradient is 0
    if zero:
        assert (got[1][:, s // 2 + 3] == 0).all()


def test_ssd_bwd_chunked_plain_without_h0_or_a_final_gradient():
    """No h0 and no final-state gradient: dh0 is None and the rest equal
    the same call with zeros for both."""
    arrs, h0, ds = _bwd_numpy(1, 128, 2, 64, 64, "bfloat16", seed=5)
    x, a, bm, cm, dy = (torch.from_numpy(t).to(torch.bfloat16)
                        for t in arrs)
    got = ref.ssd_scan_bwd_chunked_ref(x, a, bm, cm, dy)
    zeros = torch.zeros(h0.shape)
    want = ref.ssd_scan_bwd_chunked_ref(x, a, bm, cm, dy, zeros, zeros)
    assert got[4] is None and want[4] is not None
    for gv, wv in zip(got[:4], want[:4]):
        assert torch.equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,dtype,h0,zero",
                         [c for c in SSD_BWD_CASES if c[5] == "bfloat16"]
                         + [(1, 256, 2, 64, 64, "bfloat16", True, False),
                            (1, 8, 2, 64, 128, "bfloat16", True, False),
                            (2, 4096, 32, 64, 128, "bfloat16", False,
                             False)])
def test_cuda_ssd_scan_bwd_chunked_kernel(b, s, h, p, n, dtype, h0, zero):
    """The chunked backward kernel (the route of bf16 at P 64, N 64/128)
    against autograd through the plain scan, at the bf16 cases, N 64, a
    sequence shorter than one chunk and mamba2-370m's training shape: one
    chunked launch a call, two calls
    bit-equal, every gradient finite and within 2e-2 of its max |grad|."""
    _card()
    ins = _bwd_inputs(b, s, h, p, n, dtype, h0, zero, seed=s + n,
                      device="cuda")
    before = ssd_mod.ssd_scan_bwd_chunked.launches
    step = ssd_mod.ssd_scan_bwd_step.launches
    got = ssd_mod.ssd_scan_bwd(*ins)
    again = ssd_mod.ssd_scan_bwd(*ins)
    torch.cuda.synchronize()
    assert ssd_mod.ssd_scan_bwd_chunked.launches == before + 2
    assert ssd_mod.ssd_scan_bwd_step.launches == step
    want = ref.ssd_scan_bwd_ref(*ins)
    for name, gv, av, wv in zip(("dx", "da", "db", "dc", "dh0"), got, again,
                                want):
        if wv is None:
            assert gv is None
            continue
        assert torch.equal(gv, av), name
        assert torch.isfinite(gv).all(), name
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
        rel = ((gv.float() - wv.float()).abs().max()
               / wv.float().abs().max()).item()
        assert rel <= SSD_BWD_RTOL[dtype], (name, rel)


@pytest.mark.cuda
def test_cuda_ssd_scan_bwd_chunked_kernel_follows_its_plain_version():
    """The kernel against its own plain version (the same rounding
    points) at mamba2's P and N with h0, a final-state gradient and a zero
    decay: the two differ by float32 summation order and the bf16
    roundings that order moves, far inside the gate."""
    _card()
    ins = _bwd_inputs(2, 512, 4, 64, 128, "bfloat16", True, True, seed=11,
                      device="cuda")
    got = ssd_mod.ssd_scan_bwd(*ins)
    want = ref.ssd_scan_bwd_chunked_ref(*ins)
    for name, gv, wv in zip(("dx", "da", "db", "dc", "dh0"), got, want):
        rel = ((gv.float() - wv.float()).abs().max()
               / wv.float().abs().max()).item()
        assert rel <= SSD_BWD_RTOL["bfloat16"] / 4, (name, rel)


@pytest.mark.cuda
def test_cuda_ssd_scan_bwd_step_kernel_still_takes_bf16():
    """The step kernel, the route of bf16 at the widths the chunked
    kernel is not built for, called directly at mamba2's widths, holds the
    same gate."""
    _card()
    ins = _bwd_inputs(2, 100, 3, 64, 128, "bfloat16", True, False, seed=3,
                      device="cuda")
    got = ssd_mod.ssd_scan_bwd_step(*ins[:4], ins[4].contiguous(), *ins[5:])
    want = ref.ssd_scan_bwd_ref(*ins)
    for name, gv, wv in zip(("dx", "da", "db", "dc", "dh0"), got, want):
        rel = ((gv.float() - wv.float()).abs().max()
               / wv.float().abs().max()).item()
        assert rel <= SSD_BWD_RTOL["bfloat16"], (name, rel)
