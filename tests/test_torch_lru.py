"""The port's RG-LRU scan (B5) against the JAX reference.

The port's two plain scans (``repro_torch.kernels.ref``) are held to the
reference's oracles (``repro.kernels.ref``) and to its Pallas kernel in
interpret mode (its default off a TPU), at the reference's own test shapes
(``tests/test_kernels.py``), with and without h0, in float32 and bfloat16;
the LRU wrapper takes any length, as the reference's XLA path does.  The
reference's oracles are jitted once a shape (eager jax dispatches its
associative scan op by op, several times the compile).  The CUDA cases
need a card (marker ``cuda``) and skip without one; the reference is
imported only by the tests that use it, so on a machine with a card and
no ``jax``

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lru.py

runs the kernel cases alone.

Tolerances: the reference's own, 1e-4 in float32.  In bfloat16 both sides
compute in float32 from the same rounded inputs and round once, so they
differ by at most about one bfloat16 step: held to 1e-2 of max |h|.

The backward (B5-bwd): the port's plain version ``ref.lru_scan_bwd_ref``
against ``jax.vjp`` of the reference's ``lru_scan_ref``, each gradient
within 1e-4 (float32) or 2e-2 (bfloat16, rounded once from float32 sums
in another order) of its max |value|; on the card the kernel against the
plain version at the same tolerances.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.lru_scan import lru_scan, lru_scan_bwd
from test_torch_common import (_card, _jax,  # noqa: F401
                               _one_torch_thread, _round, _torch,
                               close_scans)


#: the reference's LRU kernel tests: b, s, d, chunk, block_d
LRU_CASES = [(2, 256, 256, 128, 128), (1, 512, 128, 256, 128),
             (1, 128, 384, 64, 128)]
TOL = 1e-4
BF16_RTOL = 1e-2
#: the backward's gradients: max |diff| / max |grad| (chip_smoke's gate)
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _lru_inputs(b, s, d, seed=1, dtype="float32", h0=True):
    rng = np.random.default_rng(seed)
    arrs = [_round(rng.standard_normal((b, s, d)).astype(np.float32), dtype),
            _round(rng.uniform(0.5, 1.0, (b, s, d)).astype(np.float32),
                   dtype)]
    state = (rng.standard_normal((b, d)) * 0.1).astype(np.float32) \
        if h0 else None
    return arrs, state


@functools.cache
def _jvjp():
    """``jax.vjp`` of the reference's ``lru_scan_ref``, jitted: (x, a, h0,
    dy, dhT) -> (dx, da, dh0)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref

    def grads(x, a, h0, dy, dht):
        _, vjp = jax.vjp(jref.lru_scan_ref, x, a, h0)
        return vjp((dy, dht))
    return jax.jit(grads)


@functools.cache
def _jref():
    """The reference's two LRU oracles, jitted, and its Pallas kernel
    (jitted by the reference)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.kernels.lru_scan import lru_scan as jlru
    return jax.jit(jref.lru_scan_naive), jax.jit(jref.lru_scan_ref), jlru


def _close(got, want, dtype):
    """h and the final state of one scan against another's."""
    close_scans(got, want, dtype, TOL, BF16_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("b,s,d,chunk,bd", LRU_CASES)
def test_lru_plain_matches_reference(b, s, d, chunk, bd, h0, dtype):
    """The port's naive and log-depth LRU scans against the reference's
    two oracles and its Pallas kernel (interpret mode)."""
    jnaive, jlog, jlru = _jref()
    arrs, state = _lru_inputs(b, s, d, seed=s + d, dtype=dtype, h0=h0)
    ts, t0 = _torch(arrs, state, dtype)
    js, j0 = _jax(arrs, state, dtype)
    naive = ref.lru_scan_naive(*ts, t0)
    logd = ref.lru_scan_ref(*ts, t0)
    assert logd[0].dtype == ts[0].dtype and logd[1].dtype == torch.float32
    _close(naive, jnaive(*js, j0), dtype)
    _close(logd, jlog(*js, j0), dtype)
    _close(logd, naive, dtype)
    _close(logd, jlru(*js, j0, chunk=chunk, block_d=bd), dtype)


def test_lru_log_depth_matches_naive_at_an_odd_length():
    """The reference's own check at S = 333 (no power of two)."""
    arrs, _ = _lru_inputs(2, 333, 32, seed=3, h0=False)
    ts, _ = _torch(arrs, None, "float32")
    _close(ref.lru_scan_ref(*ts), ref.lru_scan_naive(*ts), "float32")


def test_lru_wrapper_keeps_the_pallas_contract():
    """The contract of the reference's model path off a TPU, where
    ``impl="auto"`` resolves to its XLA path (ROADMAP C6): any S, D >= 1.
    Lengths and widths the Pallas kernel's blocks reject (S 333, D 192)
    run through the wrapper and both ``ops`` impls and match the
    reference's ``lru_scan_ref``; an empty scan raises."""
    _, jlog, _ = _jref()
    before = lru_scan.launches
    for b, s, d in ((1, 333, 32), (1, 512, 192), (2, 333, 192),
                    (1, 255, 64), (1, 512, 384)):
        arrs, state = _lru_inputs(b, s, d, seed=s)
        ts, t0 = _torch(arrs, state, "float32")
        js, j0 = _jax(arrs, state, "float32")
        want = jlog(*js, j0)
        for fn in (lambda: lru_scan(*ts, t0),
                   lambda: ops.lru_scan(*ts, t0, impl="xla"),
                   lambda: ops.lru_scan(*ts, t0)):
            y, h_t = fn()
            assert y.shape == (b, s, d) and h_t.shape == (b, d)
            _close((y, h_t), want, "float32")
    with pytest.raises(ValueError, match="empty"):
        lru_scan(ts[0][:, :0], ts[1][:, :0])
    with pytest.raises(TypeError):
        lru_scan(ts[0], ts[1].double())
    with pytest.raises(ValueError):
        lru_scan(ts[0], ts[1], t0[:, :5])
    assert lru_scan.launches == before


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


#: the backward's cases: b, s, d, with h0 and a final-state gradient,
#: channels with a = 0 and a = 1; a length and a width no multiple of the
#: kernel's 128-step chunks and its tiles of channels, S = 1
LRU_BWD_CASES = [(2, 64, 32, True, True), (1, 333, 192, True, False),
                 (2, 37, 5, False, True), (1, 1, 16, True, False),
                 (2, 100, 64, False, False)]


def _lru_bwd_inputs(b, s, d, h0, edges, dtype, seed):
    """x, a (a = 0 on channel 0 and a = 1 on channel 1 with ``edges``), dy
    and, with ``h0``, h0 and dhT: numpy float32 rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    x = _round(rng.standard_normal((b, s, d)).astype(np.float32), dtype)
    a = rng.uniform(0.5, 1.0, (b, s, d)).astype(np.float32)
    if edges:
        a[..., 0] = 0.0
        a[..., 1] = 1.0
    a = _round(a, dtype)
    dy = _round(rng.standard_normal((b, s, d)).astype(np.float32), dtype)
    state = ((rng.standard_normal((b, d)) * 0.1).astype(np.float32),
             rng.standard_normal((b, d)).astype(np.float32)) if h0 else None
    return x, a, dy, state


def _close_grads(got, want, dtype):
    """Each gradient within BWD_RTOL[dtype] of its max |value|."""
    for g, w in zip(got, want):
        g = np.asarray(g.detach().float().cpu() if isinstance(g, torch.Tensor)
                       else g, np.float32)
        w = np.asarray(w.detach().float().cpu() if isinstance(w, torch.Tensor)
                       else w, np.float32)
        assert g.shape == w.shape
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= BWD_RTOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,h0,edges", LRU_BWD_CASES)
def test_lru_bwd_plain_matches_jax_vjp(b, s, d, h0, edges, dtype):
    """``ref.lru_scan_bwd_ref`` (the explicit reverse recurrence) against
    ``jax.vjp`` of the reference's ``lru_scan_ref`` on the same inputs:
    h0 and a final-state gradient or neither, a = 0 and a = 1 channels,
    ragged lengths and widths, S = 1; the wrapper on CPU tensors is the
    plain version and launches nothing."""
    jnp = pytest.importorskip("jax.numpy")
    x, a, dy, state = _lru_bwd_inputs(b, s, d, h0, edges, dtype,
                                      seed=s + d)
    jd = getattr(jnp, dtype)
    h0_np = state[0] if h0 else np.zeros((b, d), np.float32)
    dht_np = state[1] if h0 else np.zeros((b, d), np.float32)
    want = _jvjp()(jnp.asarray(x, jd), jnp.asarray(a, jd),
                   jnp.asarray(h0_np), jnp.asarray(dy, jd),
                   jnp.asarray(dht_np))
    dt = getattr(torch, dtype)
    ts = [torch.from_numpy(v).to(dt) for v in (x, a, dy)]
    h0_t, dht_t = ((torch.from_numpy(state[0]), torch.from_numpy(state[1]))
                   if h0 else (None, None))
    before = lru_scan_bwd.launches
    got = lru_scan_bwd(*ts[:2], ts[2], h0_t, dht_t)
    assert lru_scan_bwd.launches == before
    assert got[0].dtype == dt and got[1].dtype == dt
    assert (got[2] is None) == (not h0)
    _close_grads(got[:2], want[:2], dtype)
    if h0:
        assert got[2].dtype == torch.float32
        _close_grads(got[2:], want[2:], dtype)
    plain = ref.lru_scan_bwd_ref(*ts[:2], ts[2], h0_t, dht_t)
    for g, p in zip(got, plain):
        assert (g is None and p is None) or torch.equal(g, p)


def test_lru_bwd_checks_its_inputs():
    """Shapes of dy and dhT are checked as the forward's are."""
    x, a, dy, state = _lru_bwd_inputs(1, 8, 4, True, False, "float32", 0)
    x, a, dy = (torch.from_numpy(v) for v in (x, a, dy))
    h0, dht = (torch.from_numpy(v) for v in state)
    with pytest.raises(ValueError, match="dy"):
        lru_scan_bwd(x, a, dy[:, :4], h0, dht)
    with pytest.raises(ValueError, match="dhT"):
        lru_scan_bwd(x, a, dy, h0, dht[:, :2])
    with pytest.raises(ValueError, match="h0"):
        lru_scan_bwd(x, a, dy, h0[:, :2], dht)


# ============================================================ on the card ===
@pytest.mark.cuda
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("b,s,d,dtype", [c[:3] + (dt,) for c in LRU_CASES
                                         + [(2, 255, 64, 0, 0),
                                            (2, 40, 100, 0, 0),
                                            (2, 333, 192, 0, 0)]
                                         for dt in ("float32", "bfloat16")])
def test_cuda_lru_scan_matches_plain_version(b, s, d, dtype, h0):
    """The reference's shapes, a length that is no multiple of the
    kernel's 128-step chunks, a width that is no multiple of its tiles
    (64 bf16 or 32 float32 channels), and a length and width the Pallas
    kernel's blocks reject (ROADMAP C6)."""
    _card()
    arrs, state = _lru_inputs(b, s, d, seed=s + d, dtype=dtype, h0=h0)
    ts, t0 = _torch(arrs, state, dtype, "cuda")
    before = lru_scan.launches
    got = lru_scan(*ts, t0)
    torch.cuda.synchronize()
    assert lru_scan.launches == before + 1
    _close(got, ref.lru_scan_naive(*ts, t0), dtype)


@pytest.mark.cuda
def test_cuda_lru_scan_carries_a_gradient():
    """Under grad on the card B5 runs as an autograd Function whose
    backward is B5-bwd (one launch of each, from the chunk starts the
    forward kept), its gradients those of the plain version; also under
    ``torch.utils.checkpoint``'s recompute, as the train step runs it.
    Without grad it records nothing."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    xl = torch.randn((2, 70, 96), generator=g, device="cuda")
    al = 0.5 + 0.5 * torch.rand((2, 70, 96), generator=g, device="cuda")
    w = torch.randn((2, 70, 96), generator=g, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (xl, al)]
    y, h_t = ref.lru_scan_ref(*leaves)
    want = torch.autograd.grad((y * w).sum() + h_t.sum(), leaves)
    before = (lru_scan.launches, lru_scan_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in (xl, al)]
    y, h_t = lru_scan(*leaves)
    assert y.grad_fn is not None
    ((y * w).sum() + h_t.sum()).backward()
    assert (lru_scan.launches, lru_scan_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    _close_grads([t.grad for t in leaves], want, "float32")
    from torch.utils.checkpoint import checkpoint
    leaves = [t.clone().requires_grad_() for t in (xl, al)]
    y, h_t = checkpoint(lru_scan, *leaves, use_reentrant=False)
    ((y * w).sum() + h_t.sum()).backward()
    _close_grads([t.grad for t in leaves], want, "float32")
    y, _ = lru_scan(xl, al)
    assert y.grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,h0,edges", LRU_BWD_CASES
                         + [(2, 4096, 256, False, False)])
def test_cuda_lru_scan_bwd_matches_plain_version(b, s, d, h0, edges, dtype):
    """B5-bwd (``csrc/lru_scan_bwd.cu``) against its plain version on the
    backward's cases and a long sequence (32 of its 128-step chunks); two
    calls give the same bits."""
    _card()
    x, a, dy, state = _lru_bwd_inputs(b, s, d, h0, edges, dtype, seed=s + d)
    dt = getattr(torch, dtype)
    ts = [torch.from_numpy(v).to(dt).cuda() for v in (x, a, dy)]
    extra = ([torch.from_numpy(v).cuda() for v in state] if h0
             else [None, None])
    before = lru_scan_bwd.launches
    got = lru_scan_bwd(*ts, *extra)
    again = lru_scan_bwd(*ts, *extra)
    torch.cuda.synchronize()
    assert lru_scan_bwd.launches == before + 2
    want = ref.lru_scan_bwd_ref(*ts, *extra)
    assert (got[2] is None) == (not h0)
    for u, v in zip(got, again):
        assert u is None or torch.equal(u, v)
    _close_grads([t for t in got if t is not None],
                 [t for t in want if t is not None], dtype)
