"""The port's kernels: the switch response-path filters (B1, B2) and flash
attention (B3).  Plain versions ≡ the reference's Pallas kernels (and, for
B3, its ``attention_ref`` oracle), and the CUDA kernels ≡ their plain
versions.

The reference kernels run in interpret mode on the CPU, as
``tests/test_kernels.py`` runs them, one config at a time; the port's plain
versions run the whole ``G`` batch at once.  The CUDA cases need a card
(marker ``cuda``) and skip without one; the reference is imported only by
the tests that use it, so on a machine with a card and no ``jax``

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

runs the kernel cases alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fingerprint_filter import fingerprint_filter
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.inputs import filter_lanes
from repro_torch.kernels.tickfuse import tickfuse_response_path

G, K = 5, 32


def _lanes(seed, n_tables=4, n_slots=64, n_servers=6):
    return filter_lanes(G, K, n_tables, n_slots, n_servers, seed=seed)


def _t(a, device="cpu"):
    return torch.from_numpy(a.copy()).to(device)


def _reference():
    """The reference's Pallas kernels (interpret mode) and numpy oracle."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core.switch_jax import filter_tick_oracle
    from repro.kernels.fingerprint_filter import fingerprint_filter
    from repro.kernels.tickfuse import tickfuse_response_path
    return jnp, fingerprint_filter, tickfuse_response_path, filter_tick_oracle


@pytest.mark.parametrize("seed", range(3))
def test_fingerprint_filter_plain_matches_pallas(seed):
    jnp, ref_ff, _, _ = _reference()
    x = _lanes(seed)
    tables, drop = ref.fingerprint_filter_ref(
        _t(x["tables"]), _t(x["rid"]), _t(x["idx"]), _t(x["clo"]))
    assert drop.any() and not drop.all()     # hits and misses both occur
    for g in range(G):
        want_t, want_d = ref_ff(jnp.asarray(x["tables"][g]),
                                jnp.asarray(x["rid"][g]),
                                jnp.asarray(x["idx"][g]),
                                jnp.asarray(x["clo"][g]), block=32)
        assert np.array_equal(tables[g].numpy(), np.asarray(want_t))
        assert np.array_equal(drop[g].numpy(), np.asarray(want_d))


@pytest.mark.parametrize("seed", range(3))
def test_tickfuse_plain_matches_pallas_and_oracle(seed):
    jnp, _, ref_tf, filter_tick_oracle = _reference()
    x = _lanes(10 + seed)
    sstate, tables, drop = ref.tickfuse_ref(
        _t(x["server_state"]), _t(x["tables"]), _t(x["rid"]), _t(x["idx"]),
        _t(x["clo"]), _t(x["sid"]), _t(x["qlen"]))
    for g in range(G):
        want_s, want_t, want_d = ref_tf(
            *(jnp.asarray(x[n][g]) for n in ("server_state", "tables", "rid",
                                              "idx", "clo", "sid", "qlen")),
            block=32)
        assert np.array_equal(sstate[g].numpy(), np.asarray(want_s))
        assert np.array_equal(tables[g].numpy(), np.asarray(want_t))
        assert np.array_equal(drop[g].numpy(), np.asarray(want_d))
        # the numpy oracle, with the inactive (out-of-range sid) lanes
        # taken out of its StateT loop
        act = x["sid"][g] < x["server_state"].shape[1]
        o_t, o_s, o_d = filter_tick_oracle(
            x["tables"][g], x["server_state"][g],
            *(x[n][g][act] for n in ("rid", "idx", "clo", "sid", "qlen")))
        assert np.array_equal(tables[g].numpy(), o_t)
        assert np.array_equal(sstate[g].numpy(), o_s)
        assert np.array_equal(drop[g].numpy()[act], o_d)


@pytest.mark.parametrize("kernel", ["fingerprint_filter", "tickfuse"])
def test_plain_versions_match_pallas_at_fabric_shape(kernel):
    """The 4-rack fabric's shape: (4 + 1) · 2 = 10 tables, the spine's
    filter group at 8-9, and 24 servers."""
    jnp, ref_ff, ref_tf, _ = _reference()
    x = _lanes(20, n_tables=10, n_servers=24)
    if kernel == "fingerprint_filter":
        names, plain, want_fn = ("tables", "rid", "idx", "clo"), \
            ref.fingerprint_filter_ref, ref_ff
    else:
        names, plain, want_fn = ("server_state", "tables", "rid", "idx",
                                 "clo", "sid", "qlen"), ref.tickfuse_ref, \
            ref_tf
    assert (x["idx"] >= 8).any()
    got = plain(*(_t(x[n]) for n in names))
    for g in range(G):
        want = want_fn(*(jnp.asarray(x[n][g]) for n in names), block=32)
        for a, b in zip(got, want):
            assert np.array_equal(a[g].numpy(), np.asarray(b))


def test_wrappers_take_the_plain_version_on_cpu():
    x = _lanes(3)
    fingerprint_filter.launches = 0
    tickfuse_response_path.launches = 0
    t1, d1 = fingerprint_filter(_t(x["tables"]), _t(x["rid"]),
                                _t(x["idx"]), _t(x["clo"]))
    t2, d2 = ref.fingerprint_filter_ref(_t(x["tables"]), _t(x["rid"]),
                                        _t(x["idx"]), _t(x["clo"]))
    assert torch.equal(t1, t2) and torch.equal(d1, d2)
    s3, t3, d3 = tickfuse_response_path(
        *(_t(x[n]) for n in ("server_state", "tables", "rid", "idx", "clo",
                             "sid", "qlen")))
    assert d3.dtype == torch.bool and s3.shape == (G, 6)
    # launches count CUDA launches only
    assert fingerprint_filter.launches == 0
    assert tickfuse_response_path.launches == 0


def test_wrappers_check_their_inputs():
    x = _lanes(4)
    good = [_t(x[n]) for n in ("tables", "rid", "idx", "clo")]
    with pytest.raises(TypeError):
        fingerprint_filter(good[0].long(), *good[1:])
    with pytest.raises(ValueError):
        fingerprint_filter(good[0], good[1][:, :5], *good[2:])
    with pytest.raises(ValueError):
        fingerprint_filter(good[0][:, :, ::2], *good[1:])
    with pytest.raises(ValueError):
        tickfuse_response_path(_t(x["server_state"])[:3], good[0],
                               *good[1:], _t(x["sid"]), _t(x["qlen"]))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fingerprint_filter", "tickfuse"])
@pytest.mark.parametrize("shape", [(200, 32, 4, 1024, 6),
                                   (9, 32, 10, 1024, 24)],
                         ids=["default", "4-rack"])
def test_cuda_kernel_matches_plain_version(kernel, shape):
    """At the default sweep's shape and at the 4-rack fabric's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    x = filter_lanes(*shape, seed=5)
    names = ("tables", "rid", "idx", "clo") if kernel == "fingerprint_filter" \
        else ("server_state", "tables", "rid", "idx", "clo", "sid", "qlen")
    fn = fingerprint_filter if kernel == "fingerprint_filter" \
        else tickfuse_response_path
    plain = ref.fingerprint_filter_ref if kernel == "fingerprint_filter" \
        else ref.tickfuse_ref
    before = fn.launches
    got = fn(*(_t(x[n], "cuda") for n in names))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*(_t(x[n], "cuda") for n in names))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


# ========================================================= flash attention ===
#: the reference's sweep (tests/test_kernels.py): b, h, hkv, s, d, causal,
#: window, dtype
FA_CASES = [
    (1, 4, 4, 256, 64, True, None, "float32"),
    (2, 8, 2, 256, 64, True, None, "float32"),      # GQA
    (1, 4, 1, 256, 128, True, None, "float32"),     # MQA
    (1, 4, 4, 512, 64, False, None, "float32"),     # bidirectional
    (1, 2, 2, 512, 64, True, 128, "float32"),       # sliding window
    (1, 2, 2, 256, 64, True, None, "bfloat16"),     # bf16
    (3, 2, 2, 128, 32, True, None, "float32"),      # odd batch
]
#: the reference's tolerances: f32 to 2e-5, bf16 to 2e-2
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, h, hkv, s, d, dtype, seed, skv=None):
    """q, k, v as float32 numpy (bf16 values already rounded) and as torch
    tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return [t.float().numpy() for t in ts], ts


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,dtype", FA_CASES)
def test_attention_plain_matches_reference(b, h, hkv, s, d, causal, window,
                                           dtype):
    """The port's plain B3 (what the wrapper runs on a CPU tensor) against
    the reference's ``attention_ref`` and its Pallas kernel in interpret
    mode, on the same inputs."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention as jfa
    arrs, ts = _qkv(b, h, hkv, s, d, dtype, seed=s + d + h)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrs)
    got = flash_attention(*ts, causal=causal, window=window)
    assert got.dtype == ts[0].dtype and got.shape == (b, h, s, d)
    assert torch.equal(got, ref.attention_ref(*ts, causal=causal,
                                              window=window))
    want_ref = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    want_fa = jfa(jq, jk, jv, causal=causal, window=window, block_q=128,
                  block_k=128, interpret=True)
    for want in (want_ref, want_fa):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=FA_TOL[dtype], rtol=0)


def test_attention_plain_query_chunking_changes_nothing(monkeypatch):
    _, ts = _qkv(1, 2, 1, 512, 32, "float32", seed=3)
    direct = ref.attention_ref(*ts, causal=True)
    monkeypatch.setattr(ref, "ATTN_CHUNK_THRESHOLD", 128)
    monkeypatch.setattr(ref, "ATTN_Q_CHUNK", 128)
    chunked = ref.attention_ref(*ts, causal=True)
    np.testing.assert_allclose(direct.numpy(), chunked.numpy(), atol=1e-6)


def test_flash_attention_keeps_the_reference_contract():
    """Causal or windowed attention with Sq != Skv raises (the Pallas kernel
    and attention_ref align causal rows differently there, ROADMAP C2);
    sequence lengths follow the reference's block contract; bidirectional
    cross-length attention is fine."""
    _, (q, k, v) = _qkv(1, 2, 2, 256, 32, "float32", seed=4, skv=512)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="C2"):
        flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="C2"):
        flash_attention(q, k, v, causal=False, window=64)
    out = flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape
    _, (q2, k2, v2) = _qkv(1, 2, 2, 384, 32, "float32", seed=5)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(q2, k2, v2)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double(), causal=False)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :1], k, v, causal=False)
    assert flash_attention.launches == before  # CPU tensors launch nothing


#: the reference's sweep plus qwen2.5-3b's heads (16 q, 2 kv, D 128) at a
#: ragged 255 rows, the tensor-core kernel (bf16, D 64 and 128) windowed
#: and bidirectional, and the scalar kernel at the other head dims
FA_CUDA_CASES = FA_CASES + [
    (1, 16, 2, 255, 128, True, None, "bfloat16"),
    (1, 4, 2, 512, 64, True, 128, "bfloat16"),
    (2, 4, 4, 256, 128, False, None, "bfloat16"),
    (2, 4, 4, 256, 96, True, None, "bfloat16"),
    (1, 2, 1, 256, 256, True, None, "float32"),
    (1, 2, 2, 256, 16, False, None, "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,dtype", FA_CUDA_CASES)
def test_cuda_flash_attention_matches_plain_version(b, h, hkv, s, d, causal,
                                                    window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, ts = _qkv(b, h, hkv, s, d, dtype, seed=s + d)
    q, k, v = (t.cuda() for t in ts)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=FA_TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_reads_transposed_views(dtype):
    """The model passes q, k, v as ``(B, S, H, D)`` tensors transposed to
    ``(B, H, S, D)``; the kernel reads them through their strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, ts = _qkv(2, 16, 2, 256, 128, dtype, seed=11)
    q, k, v = (t.transpose(1, 2).contiguous().cuda().transpose(1, 2)
               for t in ts)
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    want = ref.attention_ref(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=FA_TOL[dtype], rtol=0)
