"""The port's SSD (B4) and RG-LRU (B5) scans against the JAX reference.

The port's four plain scans (``repro_torch.kernels.ref``) are held to the
reference's oracles (``repro.kernels.ref``) and to its Pallas kernels in
interpret mode (their default off a TPU), at the reference's own test
shapes (``tests/test_kernels.py``), with and without h0, in float32 and
bfloat16; the SSD wrapper and ``ops`` keep the reference's length
contracts, the LRU wrapper takes any length, as the reference's XLA path
does.
The CUDA cases need a card (marker ``cuda``) and skip without one; the
reference is imported only by the tests that use it, so on a machine with
a card and no ``jax``

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_scans.py

runs the kernel cases alone.

Tolerances: the reference's own, 2e-3 for SSD (its chunked form and the
step form sum in different orders) and 1e-4 for LRU, in float32.  In
bfloat16 both sides compute in float32 from the same rounded inputs and
round y once, so they differ by at most about one bfloat16 step where a
float32 sum straddles a rounding boundary: held to 1e-2 of max |y|.  The
chunked SSD kernel (bf16 on the tensor cores) also rounds S⊙M, X⊙w and
its operand copy of the state to bf16; a CPU emulation of exactly those
rounding points is held to the step-by-step oracle at the same 1e-2.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.lru_scan import lru_scan
from repro_torch.kernels.ssd_scan import ssd_scan

#: the reference's SSD kernel tests: b, s, h, p, n, chunk
SSD_CASES = [(1, 256, 2, 64, 64, 64), (2, 128, 1, 32, 128, 128),
             (1, 512, 3, 16, 32, 128)]
#: the reference's LRU kernel tests: b, s, d, chunk, block_d
LRU_CASES = [(2, 256, 256, 128, 128), (1, 512, 128, 256, 128),
             (1, 128, 384, 64, 128)]
TOL = {"ssd": 2e-3, "lru": 1e-4}
BF16_RTOL = 1e-2


def _round(a, dtype):
    """``a`` rounded to ``dtype`` and back to float32 numpy (exact both
    ways), so both packages see the same values."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


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


def _lru_inputs(b, s, d, seed=1, dtype="float32", h0=True):
    rng = np.random.default_rng(seed)
    arrs = [_round(rng.standard_normal((b, s, d)).astype(np.float32), dtype),
            _round(rng.uniform(0.5, 1.0, (b, s, d)).astype(np.float32),
                   dtype)]
    state = (rng.standard_normal((b, d)) * 0.1).astype(np.float32) \
        if h0 else None
    return arrs, state


def _torch(arrs, state, dtype, device="cpu"):
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)).to(device)
          for a in arrs]
    return ts, None if state is None else torch.from_numpy(state).to(device)


def _jax(arrs, state, dtype):
    jnp = pytest.importorskip("jax.numpy")
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            None if state is None else jnp.asarray(state))


def _close(got, want, dtype, kind):
    """y and the final state of one scan against another's."""
    for g, w in zip(got, want):
        g = g.detach().float().cpu().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g, np.float32)
        w = w.detach().float().cpu().numpy() if isinstance(w, torch.Tensor) \
            else np.asarray(w, np.float32)
        assert g.shape == w.shape
        tol = TOL[kind] if dtype == "float32" \
            else BF16_RTOL * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)


# ================================================================ SSD scan ===
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_plain_matches_reference(b, s, h, p, n, chunk, h0, dtype):
    """The port's naive and chunked SSD against the reference's two
    oracles and its Pallas kernel (interpret mode), on the same inputs."""
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_scan as jssd
    arrs, state = _ssd_inputs(b, s, h, p, n, seed=s + n, dtype=dtype, h0=h0)
    ts, t0 = _torch(arrs, state, dtype)
    js, j0 = _jax(arrs, state, dtype)
    naive = ref.ssd_scan_naive(*ts, t0)
    chunked = ref.ssd_scan_ref(*ts, t0, chunk=chunk)
    assert naive[0].dtype == ts[0].dtype and naive[1].dtype == torch.float32
    assert chunked[1].shape == (b, h, p, n)
    want_naive = jref.ssd_scan_naive(*js, j0)
    _close(naive, want_naive, dtype, "ssd")
    _close(chunked, jref.ssd_scan_ref(*js, j0, chunk=chunk), dtype, "ssd")
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


# ================================================================ LRU scan ===
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("b,s,d,chunk,bd", LRU_CASES)
def test_lru_plain_matches_reference(b, s, d, chunk, bd, h0, dtype):
    """The port's naive and log-depth LRU scans against the reference's
    two oracles and its Pallas kernel (interpret mode)."""
    from repro.kernels import ref as jref
    from repro.kernels.lru_scan import lru_scan as jlru
    arrs, state = _lru_inputs(b, s, d, seed=s + d, dtype=dtype, h0=h0)
    ts, t0 = _torch(arrs, state, dtype)
    js, j0 = _jax(arrs, state, dtype)
    naive = ref.lru_scan_naive(*ts, t0)
    logd = ref.lru_scan_ref(*ts, t0)
    assert logd[0].dtype == ts[0].dtype and logd[1].dtype == torch.float32
    _close(naive, jref.lru_scan_naive(*js, j0), dtype, "lru")
    _close(logd, jref.lru_scan_ref(*js, j0), dtype, "lru")
    _close(logd, naive, dtype, "lru")
    _close(logd, jlru(*js, j0, chunk=chunk, block_d=bd), dtype, "lru")


def test_lru_log_depth_matches_naive_at_an_odd_length():
    """The reference's own check at S = 333 (no power of two)."""
    arrs, _ = _lru_inputs(2, 333, 32, seed=3, h0=False)
    ts, _ = _torch(arrs, None, "float32")
    _close(ref.lru_scan_ref(*ts), ref.lru_scan_naive(*ts), "float32", "lru")


def test_lru_wrapper_keeps_the_pallas_contract():
    """The contract of the reference's model path off a TPU, where
    ``impl="auto"`` resolves to its XLA path (ROADMAP C6): any S, D >= 1.
    Lengths and widths the Pallas kernel's blocks reject (S 333, D 192)
    run through the wrapper and both ``ops`` impls and match the
    reference's ``lru_scan_ref``; an empty scan raises."""
    from repro.kernels import ref as jref
    before = lru_scan.launches
    for b, s, d in ((1, 333, 32), (1, 512, 192), (2, 333, 192),
                    (1, 255, 64), (1, 512, 384)):
        arrs, state = _lru_inputs(b, s, d, seed=s)
        ts, t0 = _torch(arrs, state, "float32")
        js, j0 = _jax(arrs, state, "float32")
        want = jref.lru_scan_ref(*js, j0)
        for fn in (lambda: lru_scan(*ts, t0),
                   lambda: ops.lru_scan(*ts, t0, impl="xla"),
                   lambda: ops.lru_scan(*ts, t0)):
            y, h_t = fn()
            assert y.shape == (b, s, d) and h_t.shape == (b, d)
            _close((y, h_t), want, "float32", "lru")
    with pytest.raises(ValueError, match="empty"):
        lru_scan(ts[0][:, :0], ts[1][:, :0])
    with pytest.raises(TypeError):
        lru_scan(ts[0], ts[1].double())
    with pytest.raises(ValueError):
        lru_scan(ts[0], ts[1], t0[:, :5])
    assert lru_scan.launches == before


# ============================================================ on the card ===
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False


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
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("b,s,d,dtype", [c[:3] + (dt,) for c in LRU_CASES
                                         + [(2, 255, 64, 0, 0),
                                            (2, 40, 100, 0, 0),
                                            (2, 333, 192, 0, 0)]
                                         for dt in ("float32", "bfloat16")])
def test_cuda_lru_scan_matches_plain_version(b, s, d, dtype, h0):
    """The reference's shapes, a length that is no multiple of the
    kernel's 32-step look-ahead, a width that is no multiple of its
    64-thread blocks, and a length and width the Pallas kernel's blocks
    reject (ROADMAP C6)."""
    _card()
    arrs, state = _lru_inputs(b, s, d, seed=s + d, dtype=dtype, h0=h0)
    ts, t0 = _torch(arrs, state, dtype, "cuda")
    before = lru_scan.launches
    got = lru_scan(*ts, t0)
    torch.cuda.synchronize()
    assert lru_scan.launches == before + 1
    _close(got, ref.lru_scan_naive(*ts, t0), dtype, "lru")


def test_lru_plain_version_carries_the_naive_gradient():
    """Autograd through the log-depth plain scan equals autograd through
    the step-by-step one: each doubling reads its operands as they were
    (training differentiates the plain version on the CPU)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 37, 8), generator=g, requires_grad=True)
    a = torch.rand((2, 37, 8), generator=g).requires_grad_()
    h0 = torch.randn((2, 8), generator=g, requires_grad=True)
    w = torch.randn((2, 37, 8), generator=g)
    grads = []
    for fn in (ref.lru_scan_ref, ref.lru_scan_naive):
        y, h_t = fn(x, a, h0)
        grads.append(torch.autograd.grad((y * w).sum() + h_t.sum(),
                                         (x, a, h0)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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


@pytest.mark.cuda
def test_cuda_lru_scan_raises_under_grad():
    """B5 has no backward kernel yet: on the card it raises when a gradient
    is needed, and runs as before without one."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    xl = torch.randn((1, 64, 32), generator=g, device="cuda")
    al = torch.rand((1, 64, 32), generator=g, device="cuda")
    with pytest.raises(NotImplementedError, match="B5-bwd"):
        lru_scan(xl, al.requires_grad_())
    y, _ = lru_scan(xl, al.detach())
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
