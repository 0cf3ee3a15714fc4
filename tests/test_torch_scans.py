"""The port's SSD (B4) and RG-LRU (B5) scans against the JAX reference.

The port's four plain scans (``repro_torch.kernels.ref``) are held to the
reference's oracles (``repro.kernels.ref``) and to its Pallas kernels in
interpret mode (their default off a TPU), at the reference's own test
shapes (``tests/test_kernels.py``), with and without h0, in float32 and
bfloat16; the wrappers and ``ops`` keep the reference's length contracts.
The CUDA cases need a card (marker ``cuda``) and skip without one; the
reference is imported only by the tests that use it, so on a machine with
a card and no ``jax``

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_scans.py

runs the kernel cases alone.

Tolerances: the reference's own, 2e-3 for SSD (its chunked form and the
step form sum in different orders) and 1e-4 for LRU, in float32.  In
bfloat16 both sides compute in float32 from the same rounded inputs and
round y once, so they differ by at most about one bfloat16 step where a
float32 sum straddles a rounding boundary: held to 1e-2 of max |y|.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
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


def _ssd_inputs(b, s, h, p, n, seed=0, dtype="float32", h0=True):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, h, p)),
            rng.uniform(0.2, 1.0, (b, s, h)),
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
    """S by min(256, S) and D by min(128, D), as the Pallas kernel needs;
    the XLA path takes any length, but ops and the wrapper raise for what
    either path rejects, on the CPU too."""
    before = lru_scan.launches
    for s, d, ok in ((333, 32, False), (512, 192, False), (255, 64, True),
                     (512, 384, True)):
        arrs, state = _lru_inputs(1, s, d, seed=s)
        ts, t0 = _torch(arrs, state, "float32")
        for fn in (lambda: lru_scan(*ts, t0),
                   lambda: ops.lru_scan(*ts, t0, impl="xla"),
                   lambda: ops.lru_scan(*ts, t0)):
            if ok:
                y, h_t = fn()
                assert y.shape == (1, s, d) and h_t.shape == (1, d)
            else:
                with pytest.raises(ValueError, match="divide"):
                    fn()
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
@pytest.mark.parametrize("b,s,d,dtype", [c[:3] + (dt,) for c in LRU_CASES
                                         + [(2, 255, 64, 0, 0),
                                            (2, 40, 100, 0, 0)]
                                         for dt in ("float32", "bfloat16")])
def test_cuda_lru_scan_matches_plain_version(b, s, d, dtype, h0):
    """The reference's shapes, a length that is no multiple of the
    kernel's 32-step look-ahead, and a width that is no multiple of its
    64-thread blocks."""
    _card()
    arrs, state = _lru_inputs(b, s, d, seed=s + d, dtype=dtype, h0=h0)
    ts, t0 = _torch(arrs, state, dtype, "cuda")
    before = lru_scan.launches
    got = lru_scan(*ts, t0)
    torch.cuda.synchronize()
    assert lru_scan.launches == before + 1
    _close(got, ref.lru_scan_naive(*ts, t0), dtype, "lru")
