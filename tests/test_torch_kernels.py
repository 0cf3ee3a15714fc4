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

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fingerprint_filter import emulate_warps, \
    filter_floor, fingerprint_filter, match_any
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.inputs import EDGE_CASES, OUTSIDE_REFERENCE, \
    edge_lanes, filter_lanes
from repro_torch.kernels.tickfuse import tickfuse_masked, \
    tickfuse_response_path
from test_torch_common import _one_torch_thread  # noqa: F401


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


def test_wrappers_write_into_out():
    x = _lanes(6)
    out = torch.ones((G, K), dtype=torch.bool)
    _, d1 = fingerprint_filter(_t(x["tables"]), _t(x["rid"]), _t(x["idx"]),
                               _t(x["clo"]), out=out)
    assert d1 is out
    assert torch.equal(out, ref.fingerprint_filter_ref(
        _t(x["tables"]), _t(x["rid"]), _t(x["idx"]), _t(x["clo"]))[1])
    names = ("server_state", "tables", "rid", "idx", "clo", "sid", "qlen")
    _, _, d2 = tickfuse_response_path(*(_t(x[n]) for n in names), out=out)
    assert d2 is out
    assert torch.equal(out, ref.tickfuse_ref(*(_t(x[n]) for n in names))[2])
    for bad in (out[:, :5], out.int(), out.t().contiguous().t()):
        with pytest.raises(ValueError, match="out"):
            fingerprint_filter(_t(x["tables"]), _t(x["rid"]), _t(x["idx"]),
                               _t(x["clo"]), out=bad)
    with pytest.raises(ValueError, match="CUDA"):
        filter_floor(_t(x["tables"]), _t(x["rid"]), _t(x["idx"]),
                     _t(x["clo"]))


# ------------------------------------------------- the kernels' warp plan --
#: (G, n_tables, n_slots, n_servers): the default sweep, the 4-rack fabric,
#: and the serving dispatcher (one switch, two tables of 4,096 slots, four
#: replicas)
PLAN_SHAPES = {"default": (200, 4, 1024, 6), "4-rack": (9, 10, 1024, 24),
               "serving": (1, 2, 4096, 4)}
B2_NAMES = ("server_state", "tables", "rid", "idx", "clo", "sid", "qlen")


def _plan_lanes(case, shape, seed):
    if case == "random":
        return filter_lanes(shape[0], 32, *shape[1:], seed=seed)
    if case == "serving":       # the dispatcher's 1-4 lanes a tick
        return filter_lanes(shape[0], 1 + seed, *shape[1:], seed=seed)
    return edge_lanes(case, *shape, seed=seed)


def _emulated(x):
    """(server_state, tables, drop) of B2's warp plan and (tables, drop) of
    B1's, on copies of ``x``."""
    s, t = x["server_state"].copy(), x["tables"].copy()
    d = emulate_warps(t, x["rid"], x["idx"], x["clo"], s, x["sid"],
                      x["qlen"])
    t1 = x["tables"].copy()
    d1 = emulate_warps(t1, x["rid"], x["idx"], x["clo"])
    return (s, t, d), (t1, d1)


def test_match_any_groups_lanes_by_key():
    keys = [5, 7, 5, ("own", 3), 7, 5]
    assert match_any(keys) == [0b100101, 0b010010, 0b100101, 0b001000,
                               0b010010, 0b100101]


@pytest.mark.parametrize("case", ["random", "serving", *EDGE_CASES])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_warp_plan_matches_plain_versions(shape, case):
    """The CUDA kernels' warp plan (``emulate_warps``: keys, ``match_any``
    groups, the leader's in-order walk, last-lane-wins StateT, 32-lane
    passes) is bit-exact with the lane-sequential plain versions, seeds
    0-3, on random lanes, the serving dispatcher's 1-4 lanes and every
    edge-lane case."""
    for seed in range(4):
        x = _plan_lanes(case, PLAN_SHAPES[shape], seed)
        (s, t, d), (t1, d1) = _emulated(x)
        ws, wt, wd = ref.tickfuse_ref(*(_t(x[n]) for n in B2_NAMES))
        assert np.array_equal(s, ws.numpy())
        assert np.array_equal(t, wt.numpy())
        assert np.array_equal(d, wd.numpy())
        w1t, w1d = ref.fingerprint_filter_ref(
            *(_t(x[n]) for n in ("tables", "rid", "idx", "clo")))
        assert np.array_equal(t1, w1t.numpy())
        assert np.array_equal(d1, w1d.numpy())


@pytest.mark.parametrize(
    "case", ["random", "serving",
             *(c for c in EDGE_CASES if c not in OUTSIDE_REFERENCE)])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_warp_plan_matches_pallas(shape, case):
    """The warp plan against the reference's Pallas kernels (interpret
    mode), on up to four configs of each batch, seeds 0-3.  Out-of-range
    table and server indices are outside the reference kernels' contract
    (they index out of bounds there), so those two cases are held to the
    plain versions only."""
    jnp, ref_ff, ref_tf, _ = _reference()
    for seed in range(4):
        x = _plan_lanes(case, PLAN_SHAPES[shape], seed)
        (s, t, d), (t1, d1) = _emulated(x)
        for g in range(min(4, x["rid"].shape[0])):
            want = ref_tf(*(jnp.asarray(x[n][g]) for n in B2_NAMES),
                          block=32)
            for got, w in zip((s, t, d), want):
                assert np.array_equal(got[g], np.asarray(w))
            want = ref_ff(*(jnp.asarray(x[n][g])
                            for n in ("tables", "rid", "idx", "clo")),
                          block=32)
            for got, w in zip((t1, d1), want):
                assert np.array_equal(got[g], np.asarray(w))


def test_edge_lanes_hold_their_edge():
    """Each edge-lane batch really holds what its name says."""
    from repro_torch.core.tables import fingerprint_hash
    g, n_tables, n_slots, n_servers = PLAN_SHAPES["default"]
    x = {c: edge_lanes(c, g, n_tables, n_slots, n_servers, seed=0)
         for c in EDGE_CASES}
    one = x["one_slot"]
    slots = fingerprint_hash(one["rid"].astype(np.int64), n_slots)
    assert (slots == slots[0, 0]).all() and (one["clo"] > 0).all()
    assert (one["idx"] == one["idx"][:, :1]).all()
    three = x["rid_thrice"]
    assert (three["rid"][:, [11, 20]] == three["rid"][:, [3]]).all()
    assert (x["rid_zero"]["rid"] == 0).any()
    oor = x["out_of_range"]
    assert ((oor["idx"] < 0) & (oor["clo"] > 0)).any()
    assert ((oor["idx"] >= n_tables) & (oor["clo"] > 0)).any()
    assert (oor["clo"] < 0).any()
    sid = x["sid_out"]["sid"]
    assert (sid < 0).any() and (sid > n_servers).any()
    assert (x["one_server"]["sid"] == x["one_server"]["sid"][:, :1]).all()
    for c, k in EDGE_CASES.items():
        assert x[c]["rid"].shape == (g, k)


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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


def _masked(x, seed):
    """``x``'s lanes as the staged engine hands them to B2: an ``active``
    mask, ``idx`` and ``sid`` in int64, every tensor a strided view."""
    rng = np.random.default_rng(seed)
    active = rng.random(x["rid"].shape) < 0.8

    def strided(a, dtype):
        wide = torch.zeros(a.shape + (2,), dtype=dtype)
        wide[..., 1] = torch.from_numpy(a.astype(np.int64)).to(dtype)
        return wide[..., 1]

    return (strided(active, torch.bool), strided(x["rid"], torch.int32),
            strided(x["idx"], torch.int64), strided(x["clo"], torch.int32),
            strided(x["sid"], torch.int64), strided(x["qlen"], torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", *EDGE_CASES])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_cuda_kernels_at_the_edge_lanes(shape, case):
    """B1, B2 and B2's staged entry point bit-exact with their plain
    versions on every edge-lane case."""
    _card()
    for seed in range(2):
        x = _plan_lanes(case, PLAN_SHAPES[shape], seed)
        b1 = ("tables", "rid", "idx", "clo")
        got = fingerprint_filter(*(_t(x[n], "cuda") for n in b1))
        want = ref.fingerprint_filter_ref(*(_t(x[n], "cuda") for n in b1))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = tickfuse_response_path(*(_t(x[n], "cuda") for n in B2_NAMES))
        want = ref.tickfuse_ref(*(_t(x[n], "cuda") for n in B2_NAMES))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        lanes = [t.cuda() for t in _masked(x, seed)]
        active, rest = lanes[0], lanes[1:]
        got = tickfuse_masked(_t(x["server_state"], "cuda"),
                              _t(x["tables"], "cuda"), *rest, active)
        want = ref.tickfuse_masked_ref(_t(x["server_state"], "cuda"),
                                       _t(x["tables"], "cuda"), *rest,
                                       active)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_kernels_replay_from_a_cuda_graph():
    """100 calls of B1, B2 and B2's staged entry point captured in one CUDA
    graph each, with a preallocated ``drop``; the replayed tables equal
    the plain version applied 100 times."""
    _card()
    x = filter_lanes(200, 32, 4, 1024, 6, seed=7)
    args = {n: _t(x[n], "cuda") for n in x}
    active, *rest = (t.cuda() for t in _masked(x, 7))
    drop = torch.empty((200, 32), dtype=torch.bool, device="cuda")
    calls = {
        "fingerprint_filter": (
            lambda: fingerprint_filter(args["tables"], args["rid"],
                                       args["idx"], args["clo"], out=drop),
            lambda s, t: ref.fingerprint_filter_ref(
                t, args["rid"], args["idx"], args["clo"])),
        "tickfuse": (
            lambda: tickfuse_response_path(
                *(args[n] for n in B2_NAMES), out=drop),
            lambda s, t: ref.tickfuse_ref(
                s, t, *(args[n] for n in B2_NAMES[2:]))),
        "tickfuse_masked": (
            lambda: tickfuse_masked(args["server_state"], args["tables"],
                                    *rest, active, out=drop),
            lambda s, t: ref.tickfuse_masked_ref(s, t, *rest, active)),
    }
    for name, (fn, plain) in calls.items():
        s0 = args["server_state"].clone()
        t0 = args["tables"].clone()
        fn()                                 # built and loaded before
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(100):
                fn()
        args["server_state"].copy_(s0)
        args["tables"].copy_(t0)
        graph.replay()
        torch.cuda.synchronize()
        s, t = s0.clone(), t0.clone()
        for _ in range(100):
            *_, d = plain(s, t)
        assert torch.equal(args["tables"], t), name
        assert torch.equal(drop, d), name
        if name != "fingerprint_filter":
            assert torch.equal(args["server_state"], s), name
        args["server_state"].copy_(s0)
        args["tables"].copy_(t0)


@pytest.mark.cuda
def test_cuda_floor_launch_touches_nothing():
    _card()
    x = filter_lanes(200, 32, 4, 1024, 6, seed=8)
    args = [_t(x[n], "cuda") for n in ("tables", "rid", "idx", "clo")]
    before = [a.clone() for a in args]
    filter_floor(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(args, before))


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
    """The contract of the reference's model path off a TPU, where
    ``impl="auto"`` resolves to its XLA oracle (ROADMAP C6): any sequence
    length runs, so 300 and 384 tokens (no multiple of the Pallas kernel's
    256-row blocks) match the reference's ``attention_ref``.  Causal or
    windowed attention with Sq != Skv still raises (the Pallas kernel and
    attention_ref align causal rows differently there, ROADMAP C2);
    bidirectional cross-length attention is fine."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    _, (q, k, v) = _qkv(1, 2, 2, 256, 32, "float32", seed=4, skv=512)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="C2"):
        flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="C2"):
        flash_attention(q, k, v, causal=False, window=64)
    out = flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape
    for s, window in ((300, None), (384, None), (300, 64)):
        arrs, ts = _qkv(1, 4, 2, s, 32, "float32", seed=s)
        got = flash_attention(*ts, causal=True, window=window)
        want = jref.attention_ref(*(jnp.asarray(a) for a in arrs),
                                  causal=True, window=window)
        assert got.shape == (1, 4, s, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FA_TOL["float32"], rtol=0)
    with pytest.raises(ValueError, match="empty"):
        flash_attention(q[:, :, :0], k[:, :, :0], v[:, :, :0])
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double(), causal=False)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :1], k, v, causal=False)
    assert flash_attention.launches == before  # CPU tensors launch nothing


#: (sq, skv, d, causal, window): causal at both tile sizes, windows
#: narrower than a tile and wider than the sequence, bidirectional, a
#: ragged 255 rows, and bidirectional cross-length attention; head dim 96
#: (phi3-mini's: 128-key tiles) causal, ragged under a narrow window, and
#: bidirectional cross-length
SCHEDULE_CASES = [
    (512, 512, 96, True, None),
    (300, 300, 96, True, 16),
    (200, 700, 96, False, None),
    (512, 512, 128, True, None),
    (512, 512, 256, True, None),
    (512, 512, 64, True, 16),
    (512, 512, 256, True, 100),
    (1024, 1024, 256, True, 300),
    (256, 256, 128, True, 4096),
    (512, 512, 128, False, None),
    (255, 255, 256, True, None),
    (255, 255, 128, True, 16),
    (256, 512, 128, False, None),
    (512, 256, 256, False, None),
]


@pytest.mark.parametrize("sq,skv,d,causal,window", SCHEDULE_CASES)
def test_tile_schedule_covers_the_band(sq, skv, d, causal, window):
    """The Hopper kernel's tile schedule (its Python mirror): every (row,
    col) pair that the mask keeps lies in a tile that the row's warpgroup
    computes, and every tile it computes without the mask keeps all its
    pairs."""
    bk = fa_mod.block_k(d)
    rows = np.arange(sq)[:, None]
    cols = np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= cols <= rows
    if window is not None:
        keep &= cols >= rows - window
    sched = fa_mod.tile_schedule(sq, skv, d, causal, window)
    assert len(sched) == -(-sq // fa_mod.CTA_ROWS)
    visited = np.zeros((sq, skv), bool)
    for block in sched:
        for wg, tiles in enumerate(block["warpgroups"]):
            r0 = block["qb"] * fa_mod.CTA_ROWS + wg * fa_mod.WG_ROWS
            r = slice(r0, min(r0 + fa_mod.WG_ROWS, sq))
            kbs = [kb for kb, _ in tiles]
            assert kbs == sorted(kbs)
            assert all(block["kb_lo"] <= kb < block["kb_hi"] for kb in kbs)
            for kb, masked in tiles:
                c = slice(kb * bk, min((kb + 1) * bk, skv))
                visited[r, c] = True
                if not masked:
                    assert kb * bk + bk <= skv
                    assert keep[r, c].all(), (block["qb"], wg, kb)
    assert not (keep & ~visited).any()


def test_tile_schedule_skips_tiles_outside_the_band():
    """Causal at qwen2.5-3b's sequence: a CTA loads only the tiles up to
    its diagonal, and at head dim 256 (64-key tiles) its first warpgroup
    skips the last one; a 2,048 window starts a late block's tiles at its
    lower edge."""
    sched = fa_mod.tile_schedule(4096, 4096, 128, True, None)
    assert [b["kb_hi"] for b in sched] == list(range(1, 33))
    assert all(b["kb_lo"] == 0 for b in sched)
    # one masked tile a warpgroup: the diagonal
    assert all(sum(m for _, m in t) == 1
               for b in sched for t in b["warpgroups"])
    band = fa_mod.tile_schedule(4096, 4096, 256, True, 2048)
    last = band[-1]
    assert (last["kb_lo"], last["kb_hi"]) == (30, 64)
    wg0, wg1 = last["warpgroups"]
    assert wg0[-1][0] == 62 and wg1[0][0] == 31


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 16, "scalar"),
    (torch.bfloat16, 32, "scalar"), (torch.bfloat16, 96, "wgmma"),
    (torch.float32, 64, "scalar"), (torch.float32, 128, "scalar"),
    (torch.float32, 256, "scalar"), (torch.float32, 96, "scalar")])
def test_kernel_routing(dtype, d, kernel):
    """Which CUDA kernel each dtype and head dim goes to: bf16 at 64, 96,
    128 and 256 to the TMA + wgmma kernel, everything else to the scalar
    one."""
    assert fa_mod.kernel_for(dtype, d) == kernel


def test_tma_alignment_checks():
    """TMA reads q, k and v in place only from 16-byte-aligned bases and
    strides; the wrapper copies anything else."""
    t = torch.zeros(2, 4, 64, 128, dtype=torch.bfloat16)
    assert fa_mod.tma_ready(t)
    # the model's (B, S, H, D) tensors, transposed
    assert fa_mod.tma_ready(t.permute(0, 2, 1, 3).contiguous()
                            .transpose(1, 2))
    # a base 2 bytes off a 16-byte boundary
    flat = torch.zeros(1 + 2 * 64 * 128, dtype=torch.bfloat16)
    assert not fa_mod.tma_ready(flat[1:].view(1, 2, 64, 128))
    # a sequence stride of 136 bytes
    wide = torch.zeros(1, 2, 64, 68, dtype=torch.bfloat16)
    assert not fa_mod.tma_ready(wide[..., :64])
    # a broadcast (stride 0) head dim longer than 1
    one = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    assert not fa_mod.tma_ready(one.expand(1, 4, 64, 64))
    # a dim of extent 1 may have any stride
    assert fa_mod.tma_ready(one.expand(1, 1, 64, 64))


#: (sq, skv, d, causal, window, group) of the backward's schedule:
#: causal at both head dims, ragged 255 rows, a window of 16 with a group
#: of 8, a window wider than a tile, whisper's cross-attention (448 rows
#: over 1,500 keys) and encoder, bidirectional Sq != Skv both ways, a
#: window without the causal mask, a 4-token sequence; head dim 96
#: (phi3-mini's MHA, causal; ragged under a window narrower than a tile;
#: bidirectional Sq != Skv)
BWD_SCHEDULE_CASES = [
    (512, 512, 96, True, None, 1),
    (300, 300, 96, True, 16, 2),
    (200, 700, 96, False, None, 1),
    (512, 512, 128, True, None, 8),
    (512, 512, 64, True, None, 1),
    (255, 255, 128, True, None, 2),
    (512, 512, 64, True, 16, 8),
    (1024, 1024, 128, True, 300, 2),
    (300, 300, 64, True, 100, 1),
    (448, 1500, 64, False, None, 1),
    (1500, 1500, 64, False, None, 1),
    (256, 512, 128, False, None, 4),
    (512, 200, 128, False, None, 2),
    (300, 300, 64, False, 50, 2),
    (4, 4, 128, True, None, 8),
]


def _band_keep(sq, skv, causal, window):
    rows = np.arange(sq)[:, None]
    cols = np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= cols <= rows
    if window is not None:
        keep &= cols >= rows - window
    return keep


def _edge_tile(q0, k0, causal, window):
    """The 64 x 64 tile from (q0, k0), unbounded, holds pairs on both
    sides of the band's edge."""
    t = fa_mod.BWD_TILE
    keep = _band_keep(q0 + t, k0 + t, causal, window)[q0:, k0:]
    return keep.any() and not keep.all()


@pytest.mark.parametrize("sq,skv,d,causal,window,group", BWD_SCHEDULE_CASES)
def test_bwd_tile_schedule_covers_the_band(sq, skv, d, causal, window, group):
    """The tensor-core backward's schedule (its Python mirror): the dK/dV
    pass computes every visible (query row, key) pair exactly once for each
    query head of the group, the dQ pass exactly once; a tile runs masked
    only where the band's edge crosses it, and one that runs unmasked keeps
    all its pairs."""
    t = fa_mod.BWD_TILE
    keep = _band_keep(sq, skv, causal, window)
    wgs = fa_mod.BWD_DKDV_WARPGROUPS
    sched = fa_mod.bwd_tile_schedule(sq, skv, d, causal, window, group)
    assert [c["kb"] for c in sched["dkdv"]] == list(range(-(-skv // t)))
    count = np.zeros((group, sq, skv), np.int64)
    for cta in sched["dkdv"]:
        items = cta["items"]
        kw = cta["kb"] * t
        assert len(cta["warpgroups"]) == wgs
        # the ring's items dealt in turn
        for wg, tiles in enumerate(cta["warpgroups"]):
            assert [(g, qt) for g, qt, _ in tiles] == items[wg::wgs]
            for g, qt, masked in tiles:
                r, c = slice(qt * t, (qt + 1) * t), slice(kw, kw + t)
                assert keep[r, c].any()  # every item meets the band
                count[g, r, c] += keep[r, c]
                assert masked == _edge_tile(qt * t, kw, causal, window)
                if not masked:
                    assert keep[r, c].all()
    assert (count == keep[None]).all()
    count = np.zeros((sq, skv), np.int64)
    for cta in sched["dq"]:
        q0 = cta["qb"] * fa_mod.BWD_DQ_ROWS
        for wg, tiles in enumerate(cta["warpgroups"]):
            r = slice(q0 + wg * t, q0 + (wg + 1) * t)
            assert [kb for kb, _ in tiles] == sorted(kb for kb, _ in tiles)
            for kb, masked in tiles:
                assert cta["kb_lo"] <= kb < cta["kb_hi"]
                c = slice(kb * t, (kb + 1) * t)
                count[r, c] += keep[r, c]
                assert masked == _edge_tile(q0 + wg * t, kb * t, causal,
                                            window)
                if not masked:
                    assert keep[r, c].all()
    assert (count == keep).all()


@pytest.mark.parametrize("sq,window", [(4096, None), (1024, 300),
                                       (512, 16), (1500, None)])
def test_bwd_tile_schedule_starts_the_longest_band(sq, window):
    """CTAs launch longest band first, so the grid's tail is short: under a
    causal mask the tiles a CTA computes never grow along the launch order
    of either pass; with a window the first CTA still has the most."""
    sched = fa_mod.bwd_tile_schedule(sq, sq, 128, True, window, 8)
    for ctas in (sched["dkdv"], sched["dq"]):
        work = [sum(map(len, c["warpgroups"])) for c in ctas]
        assert work[0] == max(work)
        if window is None:
            assert work == sorted(work, reverse=True)
    # qwen2.5-3b's training shape: 64 dK/dV CTAs a (batch, kv head), from
    # 8 heads x 64 query tiles, 256 a warpgroup, down to the diagonal's 8
    if (sq, window) == (4096, None):
        assert [len(w) for w in sched["dkdv"][0]["warpgroups"]] == [256, 256]
        assert [len(w) for w in sched["dkdv"][-1]["warpgroups"]] == [4, 4]
        assert sched["dq"][0]["qb"] == 31 and sched["dq"][-1]["qb"] == 0


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "scalar"), (torch.float32, 128, "scalar"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 256, "scalar"),
    (torch.bfloat16, 96, "wgmma"), (torch.float32, 96, "scalar"),
    (torch.bfloat16, 32, None), (torch.float32, 16, None)])
def test_bwd_kernel_routing(dtype, d, kernel):
    """Which backward each dtype and head dim goes to: bf16 at 64, 96, 128
    and 256 to the TMA + wgmma kernels, float32 to the scalar ones; the
    smoke widths 16 and 32 have none and raise ``NotImplementedError``
    naming the head dims that are built."""
    if kernel is None:
        with pytest.raises(NotImplementedError,
                           match=r"head dims \(64, 96, 128, 256\)"):
            fa_mod.bwd_kernel_for(dtype, d)
    else:
        assert fa_mod.bwd_kernel_for(dtype, d) == kernel


#: (sq, skv, causal, window, group) of the backward's schedule at head dim
#: 256: recurrentgemma-9b's training shape cut to 2,048 rows (window 1,024)
#: and to 1,024 (a group of 16), gemma-7b's causal MHA, ragged 255 rows, a window narrower than a tile,
#: bidirectional Sq != Skv, a 4-token sequence
BWD_SCHEDULE_256_CASES = [
    (2048, 2048, True, 1024, 2),
    (1024, 1024, True, 512, 16),
    (1024, 1024, True, None, 1),
    (255, 255, True, None, 2),
    (300, 300, True, 16, 4),
    (448, 1500, False, None, 1),
    (4, 4, True, None, 2),
]


@pytest.mark.parametrize("sq,skv,causal,window,group",
                         BWD_SCHEDULE_256_CASES)
def test_bwd_tile_schedule_at_head_dim_256_covers_the_band(sq, skv, causal,
                                                           window, group):
    """At head dim 256 the dK/dV pass gives every item to both warpgroups,
    which split dK's and dV's 256 columns between them, and the dQ pass
    owns 64 rows a CTA with its key tiles dealt to the two warpgroups in
    turn: every visible (query row, key) pair is computed exactly once for
    each column half and each query head (dK/dV) and exactly once (dQ); a
    tile runs masked only where the band's edge crosses it."""
    d, t = 256, fa_mod.BWD_TILE
    assert fa_mod.bwd_dq_rows(d) == t and fa_mod.bwd_dq_rows(128) == 2 * t
    keep = _band_keep(sq, skv, causal, window)
    sched = fa_mod.bwd_tile_schedule(sq, skv, d, causal, window, group)
    count = np.zeros((2, group, sq, skv), np.int8)
    for cta in sched["dkdv"]:
        kw = cta["kb"] * t
        assert cta["columns"] == [(0, 128), (128, 256)]
        for wg, tiles in enumerate(cta["warpgroups"]):
            assert [(g, qt) for g, qt, _ in tiles] == cta["items"]
            for g, qt, masked in tiles:
                r, c = slice(qt * t, (qt + 1) * t), slice(kw, kw + t)
                count[wg, g, r, c] += keep[r, c]
                assert masked == _edge_tile(qt * t, kw, causal, window)
    assert (count == keep[None, None]).all()
    count = np.zeros((sq, skv), np.int8)
    qbs = [cta["qb"] for cta in sched["dq"]]
    assert qbs == sorted(qbs, reverse=True) and qbs[-1] == 0
    for cta in sched["dq"]:
        q0 = cta["qb"] * t
        assert cta["rows"] == [(q0, q0 + t)] * 2
        dealt = [[kb for kb, _ in tiles] for tiles in cta["warpgroups"]]
        for wg, kbs in enumerate(dealt):
            assert all((kb - cta["kb_lo"]) % 2 == wg for kb in kbs)
        for tiles in cta["warpgroups"]:
            for kb, masked in tiles:
                assert cta["kb_lo"] <= kb < cta["kb_hi"]
                r, c = slice(q0, q0 + t), slice(kb * t, (kb + 1) * t)
                count[r, c] += keep[r, c]
                assert masked == _edge_tile(q0, kb * t, causal, window)
    assert (count == keep).all()


@functools.cache
def _jattention_vjp(causal, window):
    """``jax.vjp`` of the reference's ``attention_ref``, jitted: (q, k, v,
    dout) -> (dq, dk, dv)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref

    def grads(q, k, v, do):
        _, vjp = jax.vjp(lambda *t: jref.attention_ref(
            *t, causal=causal, window=window), q, k, v)
        return vjp(do)
    return jax.jit(grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 24), (True, None)])
def test_attention_bwd_plain_at_head_dim_256_matches_jax_vjp(causal, window,
                                                             dtype):
    """The backward's plain version (autograd through ``attention_ref``,
    what ``flash_attention_bwd`` runs on CPU tensors) at head dim 256 with
    GQA 16:1, recurrentgemma-9b's heads, under a window narrower than the
    sequence, against ``jax.vjp`` of the reference's ``attention_ref``:
    each gradient within FA_BWD_RTOL of its max |value|."""
    jnp = pytest.importorskip("jax.numpy")
    b, h, hkv, s, d = 1, 16, 1, 80, 256
    arrs, ts = _qkv(b, h, hkv, s, d, dtype, seed=256)
    rng = np.random.default_rng(7)
    do_np = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to(getattr(torch, dtype))
    jd = getattr(jnp, dtype)
    want = _jattention_vjp(causal, window)(
        *(jnp.asarray(a, jd) for a in arrs),
        jnp.asarray(do_np.float().numpy(), jd))
    out = ref.attention_ref(*ts, causal=causal, window=window)
    before = fa_mod.flash_attention_bwd.launches
    got = fa_mod.flash_attention_bwd(*ts, out, do_np, causal=causal,
                                     window=window)
    assert fa_mod.flash_attention_bwd.launches == before
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape and g.dtype == ts[0].dtype
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= FA_BWD_RTOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 24), (True, None)])
def test_attention_bwd_plain_at_head_dim_96_matches_jax_vjp(causal, window,
                                                            dtype):
    """The backward's plain version at head dim 96 with 32 heads over 32,
    phi3-mini's heads, with a window narrower than the sequence and
    without one, against ``jax.vjp`` of the reference's ``attention_ref``:
    each gradient within FA_BWD_RTOL of its max |value|."""
    jnp = pytest.importorskip("jax.numpy")
    b, h, hkv, s, d = 1, 32, 32, 72, 96
    arrs, ts = _qkv(b, h, hkv, s, d, dtype, seed=96)
    rng = np.random.default_rng(9)
    do_np = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to(getattr(torch, dtype))
    jd = getattr(jnp, dtype)
    want = _jattention_vjp(causal, window)(
        *(jnp.asarray(a, jd) for a in arrs),
        jnp.asarray(do_np.float().numpy(), jd))
    out = ref.attention_ref(*ts, causal=causal, window=window)
    before = fa_mod.flash_attention_bwd.launches
    got = fa_mod.flash_attention_bwd(*ts, out, do_np, causal=causal,
                                     window=window)
    assert fa_mod.flash_attention_bwd.launches == before
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape and g.dtype == ts[0].dtype
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= FA_BWD_RTOL[dtype], err


def test_bwd_raises_one_way_at_an_unbuilt_head_dim():
    """Head dim 32 has no backward kernel: ``bwd_kernel_for`` raises
    ``NotImplementedError`` naming the head dims that are built, and
    ``flash_attention_bwd`` raises through it on a CUDA tensor (checked on
    the card); on CPU tensors the plain version takes any head dim."""
    with pytest.raises(NotImplementedError, match="plain version on the CPU"):
        fa_mod.bwd_kernel_for(torch.bfloat16, 32)
    q, k, v, do = _bwd_inputs(1, 2, 2, 16, 16, 32, "float32", seed=2)
    out = ref.attention_ref(q, k, v)
    dq, dk, dv = fa_mod.flash_attention_bwd(q, k, v, out, do)
    assert dq.shape == q.shape and dk.shape == k.shape


@pytest.mark.parametrize("causal,window,skv", [(True, None, None),
                                               (True, 40, None),
                                               (False, None, 200)])
def test_flash_attention_with_lse_on_cpu_is_the_plain_versions(causal, window,
                                                               skv):
    """On CPU tensors the output is the plain version's and the log-sum-exp
    is each row's over the keys its mask keeps, as numpy computes it."""
    arrs, ts = _qkv(2, 4, 2, 130, 64, "float32", seed=5, skv=skv)
    before = flash_attention.launches
    out, lse = fa_mod.flash_attention_with_lse(*ts, causal=causal,
                                               window=window)
    assert flash_attention.launches == before
    assert torch.equal(out, ref.attention_ref(*ts, causal=causal,
                                              window=window))
    q, k, _ = arrs
    k = np.repeat(k, 2, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * 64 ** -0.5
    keep = _band_keep(s.shape[2], s.shape[3], causal, window)
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 130)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


#: the reference's sweep plus qwen2.5-3b's heads (16 q, 2 kv, D 128) at a
#: ragged 255 rows, the TMA + wgmma kernel (bf16, D 64, 128 and 256)
#: windowed and bidirectional, and the scalar kernel at the other head dims
FA_CUDA_CASES = FA_CASES + [
    (1, 16, 2, 255, 128, True, None, "bfloat16"),
    (1, 4, 2, 512, 64, True, 128, "bfloat16"),
    (2, 4, 4, 256, 128, False, None, "bfloat16"),
    (2, 4, 4, 256, 96, True, None, "bfloat16"),
    (1, 2, 1, 256, 256, True, None, "float32"),
    (1, 2, 2, 256, 16, False, None, "float32"),
    (1, 4, 1, 512, 256, True, 128, "bfloat16"),     # D 256 MQA, window
    (1, 4, 1, 255, 256, True, None, "bfloat16"),    # D 256 ragged
    (2, 8, 2, 512, 64, True, 16, "bfloat16"),       # D 64 GQA, window 16
    (1, 4, 4, 1024, 128, False, None, "bfloat16"),  # D 128 bidirectional
    (2, 4, 2, 4, 128, True, None, "bfloat16"),      # a 4-token prompt
    (1, 4, 1, 64, 256, True, None, "bfloat16"),     # one warpgroup's rows
    (1, 2, 2, 100, 64, False, None, "bfloat16"),    # ragged, bidirectional
    # prompt lengths no multiple of the Pallas kernel's blocks (ROADMAP
    # C6), on the TMA + wgmma kernel and on the scalar one
    (1, 16, 2, 300, 128, True, None, "bfloat16"),
    (1, 16, 2, 384, 128, True, None, "bfloat16"),
    (1, 4, 1, 300, 256, True, 128, "bfloat16"),
    (1, 4, 2, 300, 128, True, None, "float32"),
    (1, 4, 2, 384, 64, True, None, "float32"),
    (1, 4, 2, 300, 96, True, None, "bfloat16"),
    # head dim 96 (phi3-mini's) on the TMA + wgmma kernel: MHA causal,
    # ragged under a window narrower than a tile, GQA bidirectional, a
    # 4-token prompt; and on the scalar kernel in float32
    (1, 32, 32, 512, 96, True, None, "bfloat16"),
    (1, 4, 4, 300, 96, True, 16, "bfloat16"),
    (2, 8, 2, 384, 96, False, None, "bfloat16"),
    (2, 4, 4, 4, 96, True, None, "bfloat16"),
    (1, 4, 4, 300, 96, True, 100, "float32"),
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
    before = flash_attention.launches, fa_mod.wgmma_launches()
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    routed = fa_mod.kernel_for(q.dtype, d) == "wgmma"
    assert (flash_attention.launches, fa_mod.wgmma_launches()) == (
        before[0] + 1, before[1] + routed)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=FA_TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,hkv", [("bfloat16", 128, 2),
                                         ("float32", 128, 2),
                                         ("bfloat16", 256, 1),
                                         ("bfloat16", 96, 16)])
def test_cuda_flash_attention_reads_transposed_views(dtype, d, hkv):
    """The model passes q, k, v as ``(B, S, H, D)`` tensors transposed to
    ``(B, H, S, D)``; the kernel reads them through their strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, ts = _qkv(2, 16, hkv, 256, d, dtype, seed=11)
    q, k, v = (t.transpose(1, 2).contiguous().cuda().transpose(1, 2)
               for t in ts)
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    want = ref.attention_ref(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=FA_TOL[dtype], rtol=0)


# ------------------------------------------------------- B3's backward -----
#: the masks B3's backward takes: causal (GQA and MHA), a sliding window,
#: non-causal with Sq != Skv and a ragged last tile (whisper's
#: cross-attention), at the head dims it is built for
FA_BWD_CASES = [
    (1, 4, 4, 256, 256, 64, True, None, "float32"),
    (2, 8, 2, 200, 200, 128, True, None, "float32"),
    (1, 2, 2, 300, 300, 64, True, 100, "float32"),
    (2, 6, 6, 70, 150, 64, False, None, "float32"),
    (2, 8, 2, 300, 300, 128, True, None, "bfloat16"),
    (1, 2, 2, 512, 512, 128, True, 100, "bfloat16"),
    (2, 6, 6, 448, 1500, 64, False, None, "bfloat16"),
    (1, 8, 1, 300, 300, 256, True, 100, "float32"),   # 32-row scalar tiles
    (1, 16, 1, 512, 512, 256, True, 128, "bfloat16"),  # recurrentgemma's
    (1, 4, 4, 300, 300, 96, True, 100, "float32"),     # phi3-mini's width
    (1, 32, 32, 384, 384, 96, True, None, "bfloat16"),
]
#: the backward against autograd through ``attention_ref``, max |diff| over
#: max |grad| of each gradient: float32 sums in another order; bf16 also
#: rounds the plain version's P and dP at other points (measured on the
#: card: <= 1.5e-6 and <= 7e-3)
FA_BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _bwd_inputs(b, h, hkv, sq, skv, d, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)

    def t(*shape):
        return torch.randn(shape, generator=g).to(dt).to(device)
    # the model's (B, S, H, D) tensors, transposed
    q = t(b, sq, h, d).transpose(1, 2)
    k = t(b, skv, hkv, d).transpose(1, 2)
    v = t(b, skv, hkv, d).transpose(1, 2)
    return q, k, v, t(b, h, sq, d)


@pytest.mark.parametrize("case", FA_BWD_CASES[:4])
def test_flash_attention_grad_on_cpu_is_the_plain_versions(case):
    """On CPU tensors the wrapper is the plain version, so autograd
    through it equals ``flash_attention_bwd``'s plain version (autograd
    through ``attention_ref``), and neither launches a kernel."""
    b, h, hkv, sq, skv, d, causal, window, dtype = case
    q, k, v, do = _bwd_inputs(b, h, hkv, sq, skv, d, dtype, seed=sq)
    before = (fa_mod.flash_attention.launches,
              fa_mod.flash_attention_bwd.launches)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window)
    out.backward(do)
    got = fa_mod.flash_attention_bwd(q, k, v, out.detach(), do,
                                     causal=causal, window=window)
    for g, leaf in zip(got, leaves):
        assert g.shape == leaf.shape
        assert torch.equal(g, leaf.grad)
    assert (fa_mod.flash_attention.launches,
            fa_mod.flash_attention_bwd.launches) == before


def test_flash_attention_bwd_checks_its_inputs():
    q, k, v, do = _bwd_inputs(1, 2, 2, 16, 16, 64, "float32", seed=1)
    with pytest.raises(ValueError, match="out and dout"):
        fa_mod.flash_attention_bwd(q, k, v, do[:, :1], do)
    with pytest.raises(ValueError, match="Sq == Skv"):
        fa_mod.flash_attention_bwd(q, k[:, :, :8], v[:, :, :8], do, do)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_cuda_flash_attention_bwd_matches_plain_version(case):
    """The hand-written backward (``csrc/flash_attention_bwd.cu``) against
    autograd through ``attention_ref`` on the same inputs, called directly
    and through the wrapper's autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, hkv, sq, skv, d, causal, window, dtype = case
    q, k, v, do = _bwd_inputs(b, h, hkv, sq, skv, d, dtype, seed=sq,
                              device="cuda")
    want = ref.attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    out = flash_attention(q, k, v, causal=causal, window=window)
    before = fa_mod.flash_attention_bwd.launches
    direct = fa_mod.flash_attention_bwd(q, k, v, out, do, causal=causal,
                                        window=window)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    y = flash_attention(*leaves, causal=causal, window=window)
    assert y.grad_fn is not None
    y.backward(do)
    torch.cuda.synchronize()
    assert fa_mod.flash_attention_bwd.launches == before + 2
    for got in (direct, [t.grad for t in leaves]):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            err = float((g.float() - w.float()).abs().max()
                        / w.float().abs().max())
            assert err <= FA_BWD_RTOL[dtype], err


#: the tensor-core backward's edge cases (bf16): D 64 and 128, ragged 255
#: rows, a window of 16, a group of 8, whisper's cross-attention (Sq 448
#: over 1,500 keys), a window wider than a tile, bidirectional, a 4-token
#: sequence, fewer keys than one tile
FA_BWD_WGMMA_CASES = [
    (1, 4, 4, 256, 256, 64, True, None, "bfloat16"),
    (1, 16, 2, 512, 512, 128, True, None, "bfloat16"),
    (1, 16, 2, 255, 255, 128, True, None, "bfloat16"),
    (2, 8, 2, 512, 512, 64, True, 16, "bfloat16"),
    (1, 8, 1, 384, 384, 128, True, None, "bfloat16"),
    (1, 6, 6, 448, 1500, 64, False, None, "bfloat16"),
    (1, 2, 2, 300, 300, 64, True, 100, "bfloat16"),
    (1, 4, 2, 200, 700, 128, False, None, "bfloat16"),
    (2, 4, 2, 4, 4, 64, True, None, "bfloat16"),
    (1, 2, 1, 70, 33, 128, False, None, "bfloat16"),
    # head dim 256: GQA 16:1 under a window, ragged, MHA causal, a window
    # narrower than a tile, bidirectional Sq != Skv, a 4-token sequence
    (2, 16, 1, 640, 640, 256, True, 256, "bfloat16"),
    (1, 4, 1, 255, 255, 256, True, None, "bfloat16"),
    (1, 4, 4, 384, 384, 256, True, None, "bfloat16"),
    (1, 4, 2, 300, 300, 256, True, 16, "bfloat16"),
    (1, 2, 2, 200, 700, 256, False, None, "bfloat16"),
    (2, 4, 2, 4, 4, 256, True, None, "bfloat16"),
    # head dim 96: phi3-mini's MHA causal, ragged, a window narrower than a
    # tile with GQA, bidirectional Sq != Skv, a 4-token sequence
    (1, 32, 32, 512, 512, 96, True, None, "bfloat16"),
    (1, 4, 4, 255, 255, 96, True, None, "bfloat16"),
    (2, 8, 2, 300, 300, 96, True, 16, "bfloat16"),
    (1, 4, 2, 200, 700, 96, False, None, "bfloat16"),
    (2, 4, 4, 4, 4, 96, True, None, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_BWD_WGMMA_CASES)
def test_cuda_flash_attention_bwd_wgmma_edge_cases(case):
    """The TMA + wgmma backward at its edge cases against autograd through
    ``attention_ref`` on the model's transposed views; two calls give the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    b, h, hkv, sq, skv, d, causal, window, dtype = case
    assert fa_mod.bwd_kernel_for(torch.bfloat16, d) == "wgmma"
    q, k, v, do = _bwd_inputs(b, h, hkv, sq, skv, d, dtype, seed=sq + d,
                              device="cuda")
    want = ref.attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    out, lse = fa_mod.flash_attention_with_lse(q, k, v, causal=causal,
                                               window=window)
    got = fa_mod.flash_attention_bwd(q, k, v, out, do, causal=causal,
                                     window=window, lse=lse)
    again = fa_mod.flash_attention_bwd(q, k, v, out, do, causal=causal,
                                       window=window, lse=lse)
    # without the forward's LSE the call computes it itself
    alone = fa_mod.flash_attention_bwd(q, k, v, out, do, causal=causal,
                                       window=window)
    torch.cuda.synchronize()
    for g, a, s, w in zip(got, again, alone, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, a) and torch.equal(g, s)
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= FA_BWD_RTOL[dtype], err


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_reads_misaligned_views():
    """q, k, v whose sequence stride is no multiple of 16 bytes (TMA cannot
    read them in place: the wrapper copies them) give the gradients of
    their contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    g = torch.Generator().manual_seed(9)
    wide = [torch.randn(shape, generator=g).to(torch.bfloat16).cuda()
            for shape in ((1, 8, 256, 132), (1, 2, 256, 132),
                          (1, 2, 256, 132))]
    q, k, v = (t[..., :128] for t in wide)
    assert not any(fa_mod.tma_ready(t) for t in (q, k, v))
    do = torch.randn((1, 8, 256, 128), generator=g).to(torch.bfloat16).cuda()
    out = flash_attention(q, k, v)
    got = fa_mod.flash_attention_bwd(q, k, v, out, do)
    want = fa_mod.flash_attention_bwd(*(t.contiguous() for t in (q, k, v)),
                                      out, do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,window", [(64, True, None),
                                             (128, True, 16),
                                             (256, False, None),
                                             (96, True, 100)])
def test_cuda_flash_attention_lse_matches_logsumexp(d, causal, window):
    """The log-sum-exp the Hopper forward writes under grad against
    ``torch.logsumexp`` of the plain scores; the output is the kernel's
    without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    q, k, v, _ = _bwd_inputs(2, 8, 2, 300, 300, d, "bfloat16", seed=d,
                             device="cuda")
    out, lse = fa_mod.flash_attention_with_lse(q, k, v, causal=causal,
                                               window=window)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            window=window))
    want = ref.attention_lse_ref(q, k, v, causal=causal, window=window)
    assert float((lse - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_flash_attention_without_grad_records_nothing():
    """Inference keeps the forward's path: no grad mode, or no input that
    requires grad, gives an output without ``grad_fn``; a head dim the
    backward is not built for raises only when a gradient is needed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    q, k, v, do = _bwd_inputs(1, 4, 4, 128, 128, 32, "bfloat16", seed=3,
                              device="cuda")
    assert flash_attention(q, k, v).grad_fn is None
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        assert flash_attention(*leaves).grad_fn is None
    with pytest.raises(NotImplementedError, match="plain version on the CPU"):
        flash_attention(*leaves)
    with pytest.raises(NotImplementedError, match="plain version on the CPU"):
        fa_mod.flash_attention_bwd(q, k, v, flash_attention(q, k, v), do)
