"""B5 and B5-bwd in their chunked form: the plain versions
``ref.lru_scan_chunked_ref`` and ``ref.lru_scan_bwd_chunked_ref`` (the
kernels' chunks of ``lru_scan.CHUNK`` steps, their sub-chunks, carry order
and rounding points) against the JAX reference's ``lru_scan_ref`` and
``jax.vjp`` of it, on the CPU; on the card (marker ``cuda``) each kernel
against its chunked plain version, two calls bit-equal, and the starts the
forward keeps under grad against the plain version's.

Cases: S a multiple of the chunk, ragged, shorter than a chunk and S = 1;
channels at a = 0 and a = 1; with and without h0 and a final-state
gradient; float32 and bfloat16.  Tolerances are ``test_torch_lru.py``'s:
``TOL`` (1e-4) and ``BF16_RTOL`` (1e-2 of max |value|) for the forward,
``BWD_RTOL`` for each gradient.  On the card the kernels and their chunked
versions do the same float32 operations in the same order (each ``fmaf``
rounded once, :func:`repro_torch.kernels.ref._fma32`), so they are held to
the same tolerances and their largest difference is reported.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lru_chunked.py

runs the card cases alone (the reference is imported only by the CPU
cases that use it).
"""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import lru_scan as lru_mod
from repro_torch.kernels import ref
from test_torch_common import (_card, _one_torch_thread,  # noqa: F401
                               close_scans)
from test_torch_lru import (BF16_RTOL, BWD_RTOL, TOL, _close_grads, _jref,
                            _jvjp, _lru_bwd_inputs)

L = lru_mod.CHUNK
#: b, s, d, h0 and final-state gradient, a = 0 / 1 channels: two whole
#: chunks, ragged (three chunks, the last 77 steps), shorter than a chunk,
#: S = 1, and a width no multiple of a tile
CHUNK_CASES = [(2, 2 * L, 16, True, True), (1, 3 * L - 51, 24, False, True),
               (2, 37, 8, True, False), (2, 1, 8, False, False),
               (1, L + 5, 70, True, True)]


def _inputs(case, dtype, seed, device="cpu"):
    b, s, d, h0, edges = case
    x, a, dy, state = _lru_bwd_inputs(b, s, d, h0, edges, dtype, seed)
    dt = getattr(torch, dtype)
    ts = [torch.from_numpy(v).to(dt).to(device) for v in (x, a, dy)]
    extra = ([torch.from_numpy(v).to(device) for v in state] if h0
             else [None, None])
    return ts, extra


def _jax_args(ts, extra, dtype):
    jnp = pytest.importorskip("jax.numpy")
    jd = getattr(jnp, dtype)
    b, _, d = ts[0].shape
    js = [jnp.asarray(t.float().numpy(), jd) for t in ts]
    h0, dht = (jnp.asarray(t.numpy()) if t is not None
               else jnp.zeros((b, d), jnp.float32) for t in extra)
    return js, h0, dht


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CHUNK_CASES, ids=str)
def test_lru_chunked_plain_matches_reference(case, dtype):
    """``lru_scan_chunked_ref`` against the reference's ``lru_scan_ref``:
    y and the final state; its starts are the state entering each chunk
    (h0 first) and equal the log-depth scan's states there."""
    _, jlog, _ = _jref()
    ts, (h0, _) = _inputs(case, dtype, seed=sum(case[:3]))
    js, j0, _ = _jax_args(ts, (h0, None), dtype)
    y, h_t, starts = ref.lru_scan_chunked_ref(ts[0], ts[1], h0,
                                              return_starts=True)
    assert y.dtype == ts[0].dtype and h_t.dtype == torch.float32
    close_scans((y, h_t), jlog(*js[:2], j0), dtype, TOL, BF16_RTOL)
    b, s, d = ts[0].shape
    assert starts.shape == (b, lru_mod.n_chunks(s), d)
    hs = ref.lru_scan_ref(ts[0].float(), ts[1].float(), h0)[0]
    first = torch.zeros((b, d)) if h0 is None else h0
    want = torch.cat([first[:, None], hs[:, L - 1:-1:L]], dim=1)
    torch.testing.assert_close(starts, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CHUNK_CASES, ids=str)
def test_lru_bwd_chunked_plain_matches_jax_vjp(case, dtype):
    """``lru_scan_bwd_chunked_ref`` against ``jax.vjp`` of the reference's
    ``lru_scan_ref``, within BWD_RTOL; given the forward's starts it gives
    the same bits as rebuilding them."""
    ts, extra = _inputs(case, dtype, seed=7 * sum(case[:3]))
    js, jh0, jdht = _jax_args(ts, extra, dtype)
    want = _jvjp()(*js[:2], jh0, js[2], jdht)
    got = ref.lru_scan_bwd_chunked_ref(*ts, *extra)
    assert got[0].dtype == ts[0].dtype and got[1].dtype == ts[0].dtype
    assert (got[2] is None) == (extra[0] is None)
    _close_grads([g for g in got if g is not None],
                 list(want[:2]) + ([want[2]] if extra[0] is not None
                                   else []), dtype)
    starts = ref.lru_scan_chunked_ref(ts[0], ts[1], extra[0],
                                      return_starts=True)[2]
    again = ref.lru_scan_bwd_chunked_ref(*ts, *extra, starts=starts)
    for u, v in zip(got, again):
        assert (u is None and v is None) or torch.equal(u, v)


def test_lru_bwd_checks_its_starts():
    """Starts of another shape or dtype, or on another device, raise; the
    CPU path (the plain version) takes right ones and ignores them."""
    ts, extra = _inputs((2, 300, 8, True, False), "float32", seed=1)
    starts = ref.lru_scan_chunked_ref(ts[0], ts[1], extra[0],
                                      return_starts=True)[2]
    assert starts.shape == (2, 3, 8)
    with pytest.raises(ValueError, match="starts"):
        lru_mod.lru_scan_bwd(*ts, *extra, starts=starts[:, :2])
    with pytest.raises(ValueError, match="starts"):
        lru_mod.lru_scan_bwd(*ts, *extra, starts=starts.double())
    with pytest.raises(ValueError, match="starts"):
        lru_mod.lru_scan_bwd(*ts, *extra, starts=starts.to("meta"))
    got = lru_mod.lru_scan_bwd(*ts, *extra, starts=starts)
    for u, v in zip(got, ref.lru_scan_bwd_ref(*ts, *extra)):
        assert torch.equal(u, v)


# ============================================================ on the card ===
def _worst(got, want):
    return max(((u.float() - v.float()).abs().max()
                / v.float().abs().max().clamp_min(1e-30)).item()
               for u, v in zip(got, want) if v is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CHUNK_CASES + [(2, 4096, 256, True, False)],
                         ids=str)
def test_cuda_lru_scan_matches_chunked_version(case, dtype):
    """B5 (``csrc/lru_scan.cu``) against ``lru_scan_chunked_ref``; two calls
    give the same bits; under grad it keeps the plain version's starts."""
    _card()
    ts, (h0, _) = _inputs(case, dtype, seed=sum(case[:3]), device="cuda")
    before = lru_mod.lru_scan.launches
    got, again = (lru_mod.lru_scan(ts[0], ts[1], h0) for _ in range(2))
    torch.cuda.synchronize()
    assert lru_mod.lru_scan.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    y, h_t, starts = ref.lru_scan_chunked_ref(ts[0], ts[1], h0,
                                              return_starts=True)
    close_scans(got, (y, h_t), dtype, TOL, BF16_RTOL)
    leaves = [t.clone().requires_grad_() for t in ts[:2]]
    out = lru_mod.lru_scan(*leaves, h0)
    kept = out[0].grad_fn.saved_tensors[3]
    assert kept.shape == starts.shape and kept.dtype == torch.float32
    torch.testing.assert_close(kept, starts, rtol=0, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CHUNK_CASES + [(2, 4096, 256, True, True)],
                         ids=str)
def test_cuda_lru_scan_bwd_matches_chunked_version(case, dtype):
    """B5-bwd (``csrc/lru_scan_bwd.cu``) against
    ``lru_scan_bwd_chunked_ref``, from the forward kernel's starts and
    without them (the call rebuilds them): the same bits both ways and in
    two calls."""
    _card()
    ts, extra = _inputs(case, dtype, seed=7 * sum(case[:3]), device="cuda")
    starts = lru_mod._launch(ts[0], ts[1], extra[0], keep_starts=True)[2]
    before = lru_mod.lru_scan_bwd.launches
    got = lru_mod.lru_scan_bwd(*ts, *extra, starts=starts)
    rebuilt = lru_mod.lru_scan_bwd(*ts, *extra)
    again = lru_mod.lru_scan_bwd(*ts, *extra)
    torch.cuda.synchronize()
    assert lru_mod.lru_scan_bwd.launches == before + 3
    for u, v, w in zip(got, rebuilt, again):
        assert u is None or (torch.equal(u, v) and torch.equal(v, w))
    want = ref.lru_scan_bwd_chunked_ref(*ts, *extra)
    assert (got[2] is None) == (extra[0] is None)
    _close_grads([t for t in got if t is not None],
                 [t for t in want if t is not None], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_lru_scans_read_strided_and_unaligned_rows(dtype):
    """Views the 16-byte loads cannot take (a row offset of one element, a
    sequence stride no multiple of the vector) go through the scalar path,
    and give what contiguous copies give."""
    _card()
    ts, extra = _inputs((2, 300, 41, True, True), dtype, seed=3,
                        device="cuda")
    views = [torch.cat([t[..., :1], t, t[..., :5]], dim=-1)[..., 1:42]
             for t in ts]
    assert views[0].stride(1) == 47 and views[0].data_ptr() % 16
    want_ts = [v.contiguous() for v in views]
    fwd = lru_mod.lru_scan(views[0], views[1], extra[0])
    fwd_want = lru_mod.lru_scan(want_ts[0], want_ts[1], extra[0])
    bwd = lru_mod.lru_scan_bwd(*views, *extra)
    bwd_want = lru_mod.lru_scan_bwd(*want_ts, *extra)
    torch.cuda.synchronize()
    for u, v in zip(list(fwd) + list(bwd), list(fwd_want) + list(bwd_want)):
        assert torch.equal(u, v)
    _close_grads(bwd, ref.lru_scan_bwd_chunked_ref(*want_ts, *extra), dtype)
    assert _worst(fwd, ref.lru_scan_chunked_ref(*want_ts[:2], extra[0])) \
        <= (TOL if dtype == "float32" else BF16_RTOL)


def test_chunk_geometry_matches_the_sources():
    """The Python side's chunk and sub-chunk sizes, which the plain chunked
    versions take, are the CUDA sources' constants (the wrapper checks the
    chunk against the built library on the card)."""
    src = (Path(lru_mod.__file__).parent / "csrc" /
           "lru_chunked.cuh").read_text()
    assert int(re.search(r"constexpr int kL = (\d+);", src)[1]) == L
    want = {"Fwd": lru_mod.SUB_STEPS, "Bwd": lru_mod.BWD_SUB_STEPS}
    for name in ("lru_scan.cu", "lru_scan_bwd.cu"):
        text = (Path(lru_mod.__file__).parent / "csrc" / name).read_text()
        steps = re.findall(r"constexpr int k(Fwd|Bwd)M = (\d+);", text)
        assert steps and all(int(m) == want[k] for k, m in steps)
    assert L % lru_mod.SUB_STEPS == 0 and L % lru_mod.BWD_SUB_STEPS == 0
