"""The port's fused backend and ``EngineOptions`` ≡ the reference's, on the
CPU (mirroring ``tests/test_fused.py``).

* fused is bit-identical to the port's staged backend on the five
  always-on policies × 1 and 2 racks, and to the reference's ``simulate``
  on the same params; with the ``tickfuse`` filter too (its plain version
  on the CPU); for every chunk length K; and on the goldens;
* dtype packing widens or raises, never wraps, and round-trips exactly;
* ``EngineOptions`` validates, resolves and serialises as the reference's;
* ``sweep_grid(engine=)`` records its backend.

On the CPU the fused backend runs its blocks of ticks eagerly: the code a
CUDA run captures into a graph, with the tick as a device tensor.  The
``cuda``-marked case holds the graph's replay to the staged loop on a card.
The reference runs under ``jax.threefry_partitionable(False)`` (ROADMAP C0).
It is imported only by the tests that use it, so on a machine with a card
and no ``jax``

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fused.py

runs the card case alone.
"""

import functools
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.fleetsim as tf
from repro_torch.fleetsim import engine, fused
from repro_torch.fleetsim.fused import (
    fused_core,
    pack_array,
    pack_state,
    pick_count_dtype,
    unpack_state,
)
from repro_torch.fleetsim.options import EngineOptions
from repro_torch.fleetsim.shard import ShardSpec
from repro_torch.fleetsim.state import init_fleet_state
from repro_torch.scenarios.service import load_to_rate
from test_torch_common import _one_torch_thread  # noqa: F401


GOLDEN = Path(__file__).parent / "golden" / "fleetsim_single_tor.json"
FUSED_POLICIES = ("baseline", "c-clone", "netclone", "racksched",
                  "netclone+racksched")
STAGED = EngineOptions(backend="staged")
FUSED = EngineOptions(backend="fused")


def fused_cfg(pkg, n_racks=1, **kw):
    """The reference test's fabric, in ``pkg`` (the reference's
    ``repro.fleetsim`` or ``tf``)."""
    base = dict(n_racks=n_racks, n_servers=4, n_workers=8, queue_cap=64,
                max_arrivals=10, n_ticks=900,
                service=pkg.ServiceSpec.exponential(25.0))
    base.update(kw)
    return pkg.FleetConfig(**base)


def run_params(pkg, cfg, policy, load=0.6, seed=3):
    rate = load_to_rate(load, tf.ServiceSpec.exponential(25.0),
                        cfg.n_servers_total, cfg.n_workers)
    return pkg.make_params(cfg, pkg.POLICY_IDS[policy], rate, seed)


def simulate(cfg, params, options):
    return tf.simulate(cfg, params, device="cpu", options=options)


def assert_metrics_equal(got, want, what=""):
    for name in got._fields:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert np.array_equal(a, b), f"{what}: {name} differs"


@functools.lru_cache(maxsize=None)
def matrix(n_racks):
    """The five policies (load 0.6, seed 3) as one batch: the port's params
    and staged metrics, and the reference's metrics on the same params."""
    import jax
    import jax.numpy as jnp
    import repro.fleetsim as rf
    from repro.fleetsim.options import EngineOptions as RefOptions

    tcfg, rcfg = fused_cfg(tf, n_racks), fused_cfg(rf, n_racks)
    params = tf.stack_params([run_params(tf, tcfg, p)
                              for p in FUSED_POLICIES])
    staged = simulate(tcfg, params, STAGED)
    rparams = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[run_params(rf, rcfg, p) for p in FUSED_POLICIES])
    with jax.threefry_partitionable(False):
        ref = jax.device_get(rf.simulate(rcfg, rparams,
                                         options=RefOptions(backend="staged")))
    return tcfg, params, staged, ref


@functools.lru_cache(maxsize=None)
def fused_matrix(n_racks):
    tcfg, params, _, _ = matrix(n_racks)
    return simulate(tcfg, params, FUSED)


def row(m, i):
    return type(m)(*(np.asarray(x)[i] for x in m))


# ------------------------------------------------- fused == staged, bitwise --
@pytest.mark.parametrize("n_racks", [1, 2])
@pytest.mark.parametrize("policy", FUSED_POLICIES)
def test_fused_bit_identical_to_staged(policy, n_racks):
    """Same ticks, same draws, same bits: the fused backend replays the
    staged tick exactly, and both equal the reference's run."""
    _, _, staged, ref = matrix(n_racks)
    i = FUSED_POLICIES.index(policy)
    got = row(fused_matrix(n_racks), i)
    assert_metrics_equal(got, row(staged, i), f"{policy}/racks={n_racks}")
    assert_metrics_equal(got, row(ref, i), f"{policy}/racks={n_racks} ref")


@functools.lru_cache(maxsize=None)
def fused_tickfuse():
    """The two filtering policies of the 2-rack matrix under fused with
    the ``tickfuse`` filter."""
    tcfg, params, _, _ = matrix(2)
    rows = [FUSED_POLICIES.index(p) for p in TICKFUSE_POLICIES]
    return simulate(replace(tcfg, filter_backend="tickfuse"),
                    tf.RunParams(*(x[rows] for x in params)), FUSED)


TICKFUSE_POLICIES = ("netclone", "netclone+racksched")


@pytest.mark.parametrize("policy", TICKFUSE_POLICIES)
def test_fused_tickfuse_bit_identical(policy):
    """B2's plain version (the ``tickfuse`` filter on the CPU) inside the
    fused backend gives the staged ``vectorized`` run's bits."""
    _, _, staged, _ = matrix(2)
    got = row(fused_tickfuse(), TICKFUSE_POLICIES.index(policy))
    assert_metrics_equal(got, row(staged, FUSED_POLICIES.index(policy)),
                         policy)


@pytest.mark.parametrize("k", [1, 7, 256, 10_000])
def test_fused_chunk_length_invariant(k):
    """K only moves the pack points (and the graph's block length): every
    chunk length, a prime with a tail and one clipped to n_ticks included,
    is bit-identical."""
    tcfg, params, staged, _ = matrix(2)
    i = FUSED_POLICIES.index("netclone")
    one = tf.RunParams(*(x[i] for x in params))
    got = simulate(tcfg, one, EngineOptions(backend="fused",
                                            ticks_per_chunk=k))
    assert_metrics_equal(got, row(staged, i), f"K={k}")


def golden_batch():
    g = json.loads(GOLDEN.read_text())
    cfg = tf.FleetConfig(service=tf.ServiceSpec.exponential(25.0),
                         **g["cfg"])
    runs = []
    for c in g["cases"]:
        rate = load_to_rate(c["load"], cfg.service, cfg.n_servers,
                            cfg.n_workers)
        runs.append(tf.make_params(
            cfg, tf.POLICY_IDS[c["policy"]], rate, c["seed"],
            slowdown=c.get("slowdown"),
            fail_window=tuple(c["fail_window"]) if "fail_window" in c
            else None))
    return cfg, g["cases"], tf.stack_params(runs)


def assert_golden(m, cases):
    for i, c in enumerate(cases):
        for field, want in c["metrics"].items():
            got = np.asarray(getattr(m, field)[i].cpu()).reshape(-1)
            assert np.array_equal(got, np.asarray(want).reshape(-1)), \
                (c["policy"], field)


def test_fused_bit_identical_to_golden():
    """The 6 golden cases (a switch-failure window among them) as one batch
    under fused at K = 300 (six chunks and a tail), every field bit-exact."""
    cfg, cases, params = golden_batch()
    assert_golden(simulate(cfg, params, EngineOptions(
        backend="fused", ticks_per_chunk=300)), cases)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["tickfuse", "pallas", "vectorized"])
def test_fused_graph_replay_bit_identical_on_the_card(backend):
    """On a card the fused backend replays each block of ticks from a CUDA
    graph (B1 or B2 inside it under ``pallas`` / ``tickfuse``): the goldens
    stay bit-exact, at K = 512 and at K = 300 (a tail)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph replays only on a card)")
    cfg, cases, params = golden_batch()
    cfg = replace(cfg, filter_backend=backend)
    for k in (512, 300):
        stats = fused.GraphStats()
        m, ran = engine.run(cfg, params, "cuda", EngineOptions(
            backend="fused", ticks_per_chunk=k), stats)
        assert ran == "fused" and stats.replays > 0
        assert_golden(m, cases)


def test_fused_core_rejects_staged_only_stages():
    """Telemetry stays staged-only; the coordinator and hedge-timer stages
    (``test_torch_stages.py``) and the batch server
    (``test_torch_llmserve.py``) run fused."""
    cfg = fused_cfg(tf, telemetry=True, window_ticks=100)
    params, _ = engine.batched_params(run_params(tf, cfg, "baseline"),
                                      torch.device("cpu"))
    with pytest.raises(ValueError, match="staged"):
        fused_core(cfg, params)
    cfg = fused_cfg(tf, server_model="batch", n_ticks=50)
    params, _ = engine.batched_params(run_params(tf, cfg, "baseline"),
                                      torch.device("cpu"))
    assert int(fused_core(cfg, params).metrics.n_slot_busy[0]) > 0


def test_graph_block_length_divides_the_chunk():
    assert [fused.graph_ticks(k) for k in (512, 300, 2000, 7, 1, 509)] \
        == [64, 60, 50, 7, 1, 1]


# --------------------------------------------------------- dtype packing ----
def test_pick_count_dtype_tiers():
    assert pick_count_dtype(0) == torch.uint8
    assert pick_count_dtype(255) == torch.uint8
    assert pick_count_dtype(256) == torch.int16
    assert pick_count_dtype(32767) == torch.int16
    assert pick_count_dtype(32768) == torch.int32
    assert pick_count_dtype(2**31 - 1) == torch.int32
    with pytest.raises(ValueError, match="wrap"):
        pick_count_dtype(2**31)
    with pytest.raises(ValueError, match="non-negative"):
        pick_count_dtype(-1)


@pytest.mark.parametrize("bound", [0, 1, 254, 255, 256, 257, 32766, 32767,
                                   32768, 65535, 2**31 - 2, 2**31 - 1, 2**31,
                                   2**33])
def test_pack_never_wraps(bound):
    """Raises or widens, never wraps: a bound either gets a dtype that
    round-trips every value in [0, bound] exactly, or a ValueError; the
    same tier as the reference's."""
    from repro.fleetsim import fused as rfused

    try:
        dt = pick_count_dtype(bound)
    except ValueError:
        assert bound > 2**31 - 1
        with pytest.raises(ValueError):
            rfused.pick_count_dtype(bound)
        return
    assert bound <= torch.iinfo(dt).max
    assert str(dt).split(".")[1] == np.dtype(
        rfused.pick_count_dtype(bound)).name
    probe = np.unique(np.clip([0, 1, bound // 2, bound - 1, bound],
                              0, bound)).astype(np.int64)
    packed = pack_array(torch.from_numpy(probe), bound)
    assert packed.dtype == dt
    assert np.array_equal(packed.to(torch.int64).numpy(), probe)


def test_pack_state_round_trip():
    """pack → unpack restores the exact int32 state, and the packed state
    uses narrow dtypes for a small queue_cap."""
    from repro_torch import random as jr

    cfg = fused_cfg(tf, queue_cap=32)
    state = init_fleet_state(cfg, jr.PRNGKey(torch.tensor([0, 1])))
    state.queues.count.random_(0, 33)
    state.queues.head.random_(0, 32)
    state.switch.server_state.random_(0, 33)
    packed = pack_state(cfg, state)
    assert packed.queues.head.dtype == torch.uint8
    assert packed.queues.count.dtype == torch.uint8
    assert packed.switch.server_state.dtype == torch.uint8
    # REQ_ID carriers stay int32: a packed req-id would alias requests
    assert packed.switch.filter_tables.dtype == torch.int32
    back = unpack_state(packed)
    for a, b in zip(fused.leaves(state), fused.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -------------------------------------------------------- EngineOptions -----
def test_options_validation():
    with pytest.raises(ValueError, match="unknown backend"):
        EngineOptions(backend="warp")
    with pytest.raises(ValueError, match="ticks_per_chunk"):
        EngineOptions(ticks_per_chunk=-1)
    with pytest.raises(ValueError, match="sharded runner"):
        EngineOptions(telemetry=True, shard=2)
    assert EngineOptions(shard=2).shard == ShardSpec(devices=2)
    with pytest.raises(TypeError, match="shard must be"):
        EngineOptions(shard="two")


def test_options_json_round_trip_and_strict_keys():
    o = EngineOptions(backend="fused", ticks_per_chunk=64)
    assert EngineOptions.from_json(o.to_json()) == o
    assert EngineOptions.from_json({}) == EngineOptions()
    with pytest.raises(ValueError, match="unknown engine keys"):
        EngineOptions.from_json({"backand": "fused"})
    with pytest.raises(ValueError, match="unknown engine keys"):
        EngineOptions.from_json({"backend": "fused", "shard": {}})
    assert ShardSpec.from_json(ShardSpec(3, "x").to_json()) == ShardSpec(3,
                                                                         "x")
    with pytest.raises(ValueError, match="unknown shard keys"):
        ShardSpec.from_json({"device": 2})


@pytest.mark.parametrize("kw", [{}, dict(backend="fused"),
                                dict(backend="staged", ticks_per_chunk=300),
                                dict(backend="auto", ticks_per_chunk=7)])
def test_options_json_equals_the_reference(kw):
    """The same options write the reference's JSON, and each package reads
    the other's."""
    from repro.fleetsim.options import EngineOptions as RefOptions

    o, r = EngineOptions(**kw), RefOptions(**kw)
    assert o.to_json() == r.to_json()
    assert EngineOptions.from_json(r.to_json()) == o
    assert RefOptions.from_json(o.to_json()) == r


def test_resolve_backend():
    plain = fused_cfg(tf)
    coord = fused_cfg(tf, coordinator=True)
    assert EngineOptions(backend="staged").resolve_backend(plain) == "staged"
    assert EngineOptions(backend="fused").resolve_backend(plain) == "fused"
    # 'auto' is fused for a CUDA run, staged on the CPU
    assert EngineOptions().resolve_backend(plain, "cpu") == "staged"
    assert EngineOptions().resolve_backend(plain, "cuda") == "fused"
    # the coordinator and hedge-timer stages run fused on a card (the
    # reference routes them to its staged scan: ROADMAP C8)
    hedge = fused_cfg(tf, hedge_timer=True)
    for cfg in (coord, hedge):
        assert EngineOptions().resolve_backend(cfg, "cuda") == "fused"
        assert EngineOptions().resolve_backend(cfg, "cpu") == "staged"
        assert EngineOptions(backend="fused").resolve_backend(cfg) == "fused"
    # the batch server runs fused on a card too (C8's extension)
    batch = replace(plain, server_model="batch")
    assert EngineOptions().resolve_backend(batch, "cuda") == "fused"
    assert EngineOptions().resolve_backend(batch, "cpu") == "staged"
    assert EngineOptions(backend="fused").resolve_backend(batch) == "fused"
    # 'auto' falls back for telemetry, staged-only; explicit 'fused' raises
    tel = replace(plain, telemetry=True, window_ticks=100)
    assert EngineOptions().resolve_backend(tel, "cuda") == "staged"
    with pytest.raises(ValueError, match="telemetry"):
        EngineOptions(backend="fused",
                      telemetry=True).resolve_backend(plain)
    with pytest.raises(ValueError, match="telemetry"):
        EngineOptions(backend="fused").resolve_backend(tel)


def test_simulate_rejects_bad_options_and_params():
    cfg = fused_cfg(tf, n_ticks=20)
    params = run_params(tf, cfg, "netclone")
    bad = tf.RunParams(*(torch.stack([torch.stack([a, a])] * 2)
                         for a in params))
    with pytest.raises(ValueError, match="scalar .*or 1-D"):
        simulate(cfg, bad, FUSED)
    with pytest.raises(TypeError, match="EngineOptions"):
        simulate(cfg, params, "fused")
    with pytest.raises(ValueError, match="leading sweep axis"):
        simulate(cfg, params, EngineOptions(shard=1))
    with pytest.raises(ValueError, match="cfg.telemetry=True"):
        simulate(cfg, params, EngineOptions(telemetry=True))


def test_sweep_backend_recorded():
    """``engine=`` selects the backend and the result records it; 'auto'
    on the CPU runs staged, with the same rows."""
    svc = tf.ServiceSpec.exponential(25.0)
    res = tf.sweep_grid(svc, ["baseline"], [0.5], [0], n_racks=1,
                        n_ticks=300, engine=FUSED, device="cpu")
    assert res.backend == "fused" and res.compile_s == 0.0
    res2 = tf.sweep_grid(svc, ["baseline"], [0.5], [0], n_racks=1,
                         n_ticks=300, device="cpu")
    assert res2.backend == "staged"
    assert [r.row() for r in res.results] == [r.row() for r in res2.results]
