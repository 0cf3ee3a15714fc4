"""The port's optional tick stages (LÆDGE's coordinator, the hedge timer)
≡ the reference's, on the CPU (mirroring ``tests/test_fleetsim_stages.py``).

* ``wheel_arm`` / ``wheel_fire`` on random arms, slot overflow included;
* one tick, stage by stage, from a mid-run reference state that carries a
  coordinator ring and a timer wheel, for a batch of laedge, hedge and
  netclone;
* the fused backend equal to the staged loop with the stages on, for
  several chunk lengths; the ``hedge_delays`` axis's rows; a coordinator
  hook without a rank rule (called for each pop) equal to LÆDGE's
  tabulated one.

The seven policies' whole runs are in ``test_torch_stages_runs.py``.  The
reference runs under ``jax.threefry_partitionable(False)`` (ROADMAP
C0), set per test.  The ``cuda``-marked case replays the stages from CUDA
graphs under B1 and B2 on a card and skips here; the reference is imported
only by the tests that use it, so on a machine with a card and no ``jax``

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_stages.py

runs the card case alone.
"""

import functools
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro_torch.fleetsim as tf
from repro_torch.core.switch import group_pairs_array
from repro_torch.fleetsim import chaos as tchaos
from repro_torch.fleetsim import engine
from repro_torch.fleetsim import stages as tst
from repro_torch.fleetsim.engine import batched_params
from repro_torch.fleetsim.options import EngineOptions
from repro_torch.fleetsim.state import WH, HedgeWheel, to_numpy
from repro_torch.scenarios import registry
from repro_torch.scenarios.service import load_to_rate
from test_torch_common import _one_torch_thread  # noqa: F401


CPU = torch.device("cpu")
POLICIES = ("baseline", "c-clone", "netclone", "racksched",
            "netclone+racksched", "laedge", "hedge")
# LÆDGE at a load its coordinator CPU sustains, the rest at 0.5
LOADS = {"laedge": 0.1}


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's modules, imported on first use."""
    import jax
    import jax.numpy as jnp

    import repro.fleetsim as rf
    from repro.core.switch_jax import group_pairs_array
    from repro.fleetsim import chaos, stages
    from repro.fleetsim.state import HedgeWheel, init_fleet_state

    return (jax, jnp, rf, stages, chaos, HedgeWheel, init_fleet_state,
            group_pairs_array)


def _cfg(pkg, **kw):
    """The test fabric in ``pkg`` (the reference's ``repro.fleetsim`` or
    ``tf``), with both optional stages on."""
    base = dict(n_servers=4, n_workers=8, queue_cap=64, max_arrivals=8,
                coordinator=True, hedge_timer=True)
    base.update(kw)
    return pkg.FleetConfig(service=pkg.ServiceSpec.exponential(25.0), **base)


def _cfgs(**kw):
    """The same fabric in both packages."""
    return _cfg(_ref()[2], **kw), _cfg(tf, **kw)


def _params(pkg, cfg, policies, loads=LOADS, default_load=0.5):
    """Batched params, one config per policy; ``loads`` maps a policy to
    its load, or is a list with one load per config."""
    if isinstance(loads, dict):
        loads = [loads.get(p, default_load) for p in policies]
    runs = []
    for i, (p, load) in enumerate(zip(policies, loads)):
        rate = load_to_rate(load, tf.ServiceSpec.exponential(25.0),
                            cfg.n_servers_total, cfg.n_workers)
        runs.append(pkg.make_params(cfg, pkg.POLICY_IDS[p], rate, i + 3))
    if pkg is tf:
        return tf.stack_params(runs)
    jax, jnp = _ref()[:2]
    return jax.tree.map(lambda *a: jnp.stack(a), *runs)


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_metrics_equal(got, want, what=""):
    for name in want._fields:
        a, b = _host(getattr(got, name)), _host(getattr(want, name))
        assert a.shape == b.shape and np.array_equal(a, b), \
            f"{what}: {name} differs"


# ------------------------------------------------------------- timer wheel --
def test_wheel_arm_and_fire_match_reference():
    """Random arms over 40 ticks into a 9-slot wheel of width 3 (so slots
    overflow), three configs with their own delays: the wheel, the armed /
    dropped masks and the fired entries equal the reference's, config by
    config."""
    jax, jnp, _, rst, _, RWheel, _, _ = _ref()
    rng = np.random.default_rng(11)
    g, slots, width, lanes = 3, 9, 3, 5
    delays = np.array([2, 5, 8], np.int32)
    wheel = HedgeWheel(count=torch.zeros((g, slots), dtype=torch.int32),
                       data=torch.zeros((g, slots, width, WH)))
    ref = [RWheel(count=jnp.zeros((slots,), jnp.int32),
                  data=jnp.zeros((slots, width, WH), jnp.float32))
           for _ in range(g)]
    n_dropped = 0
    for tick in range(40):
        wheel, due, entries = tst.wheel_fire(
            wheel, torch.tensor(tick) if tick % 2 else tick)
        mask = rng.random((g, lanes)) < 0.6
        rows = rng.uniform(0, 100, (g, lanes, WH)).astype(np.float32)
        wheel, armed, dropped = tst.wheel_arm(
            wheel, tick, torch.from_numpy(delays), torch.from_numpy(mask),
            torch.from_numpy(rows))
        n_dropped += int(dropped.sum())
        for i in range(g):
            ref[i], r_due, r_entries = rst.wheel_fire(ref[i], jnp.int32(tick))
            assert np.array_equal(due[i].numpy(), np.asarray(r_due))
            assert np.array_equal(entries[i].numpy(), np.asarray(r_entries))
            ref[i], r_armed, r_dropped = rst.wheel_arm(
                ref[i], jnp.int32(tick), jnp.int32(delays[i]),
                jnp.asarray(mask[i]), jnp.asarray(rows[i]))
            assert np.array_equal(armed[i].numpy(), np.asarray(r_armed))
            assert np.array_equal(dropped[i].numpy(), np.asarray(r_dropped))
            assert np.array_equal(wheel.count[i].numpy(),
                                  np.asarray(ref[i].count))
            assert np.array_equal(wheel.data[i].numpy(),
                                  np.asarray(ref[i].data))
    assert n_dropped > 0


# ---------------------------------------------------------- one tick, staged
def test_one_tick_stage_by_stage_with_optional_stages():
    """A batch of laedge (at a load its CPU sustains, and past it), hedge
    and netclone on a 2-rack fabric: both engines start tick 300 from the
    same mid-run state (a coordinator ring with pending entries, a timer
    wheel with armed hedges) and agree after every stage; the lanes the
    coordinator and the hedge timer append (their inactive lanes too)
    equal the reference's.  The new jobs'
    ``workers.meta`` REM may differ by a few ulps (C1, as in
    ``test_torch_fleetsim.py``)."""
    (jax, jnp, rf, rst, rchaos, _, ref_init_state,
     ref_group_pairs) = _ref()
    rcfg, tcfg = _cfgs(n_racks=2, n_ticks=600)
    policies = ("laedge", "laedge", "hedge", "netclone")
    loads = [0.08, 0.3, 0.6, 0.6]
    t0, n_raw = 300, 7
    with jax.threefry_partitionable(False):
        rp = _params(rf, rcfg, policies, loads)
        gp = ref_group_pairs(rcfg.n_servers)

        def run_to(p):
            k_pois, k0 = jax.random.split(jax.random.PRNGKey(p.seed))
            counts = jax.random.poisson(k_pois, p.rate_per_us * rcfg.dt_us,
                                        (t0,)).astype(jnp.int32)
            step = rst.build_step(rcfg, p, gp)
            st, _ = jax.lax.scan(step, ref_init_state(rcfg, k0),
                                 (jnp.arange(t0, dtype=jnp.int32), counts))
            return st

        rstate = jax.jit(jax.vmap(run_to))(rp)

        def ref_tick(s, p, xs):
            """The reference's tick, every stage's output kept."""
            const = (rcfg.client_tx_us + 4 * rcfg.link_us
                     + 2 * rcfg.pipeline_pass_us + rcfg.spine_extra_us
                     + jnp.where(rf.policies.id_mask(
                         p.policy_id, rf.policies.registry.client_dup_ids()),
                         rcfg.client_tx_us, 0.0)
                     + jnp.where(rf.policies.id_mask(
                         p.policy_id,
                         rf.policies.registry.coordinator_ids()),
                         2.0 * rcfg.link_us + rcfg.coord_cpu_us, 0.0))
            out = {}
            s, arr = rst.stage_arrival(rcfg, p, s, xs)
            out["arrival"] = s
            s, arr, routed, lanes = rst.stage_route(
                rcfg, p, s, arr, gp, jnp.float32(rcfg.interrack_extra_us))
            out["route"] = (s, routed, lanes)
            s, lanes = rst.stage_coordinator(rcfg, p, s, arr, routed, lanes)
            out["coordinator"] = (s, lanes)
            s, lanes = rst.stage_hedge_timer(rcfg, p, s, arr, routed, lanes)
            out["hedge"] = (s, lanes)
            s, lanes = rchaos.stage_link_failure(rcfg, p, s, arr, lanes)
            s, resp = rst.stage_server(rcfg, p, s, arr, lanes)
            out["server"] = (s, resp)
            s, resp = rchaos.stage_link_response(rcfg, p, s, arr, resp)
            s, drop = rst.stage_response_filter(rcfg, p, s, arr, resp)
            out["filter"] = (s, drop)
            out["client"] = rst.stage_client(rcfg, p, s, arr, resp, drop,
                                             const)
            return out

        ref = jax.device_get(jax.jit(jax.vmap(ref_tick, (0, 0, None)))(
            rstate, rp, (jnp.int32(t0), jnp.int32(n_raw))))

    tstate = tf.state_from_numpy(tcfg, jax.device_get(rstate))
    tparams, _ = batched_params(tf.params_from_numpy(jax.device_get(rp)),
                                CPU)
    assert int(tstate.coord.count[1]) > 0             # a pending ring
    assert int(tstate.wheel.count[2].sum()) > 0       # armed hedges

    def check(t_state, r_state, ulp=()):
        for name, a, b in _leaves(to_numpy(t_state), r_state):
            if name in ulp:
                np.testing.assert_array_max_ulp(a, b, maxulp=4)
            else:
                assert a.shape == b.shape and np.array_equal(a, b), name

    def lanes_equal(t, r, names):
        for n in names:
            a, b = getattr(t, n).numpy(), np.asarray(getattr(r, n))
            assert np.array_equal(a, b.astype(a.dtype)), n

    ids = tst._present(tparams)
    xs = (t0, torch.full((4,), n_raw, dtype=torch.int32),
          tst.draw_ticks(tcfg, tstate.key, 1)[0])
    ts, tarr = tst.stage_arrival(tcfg, tparams, tstate, xs)
    check(ts, ref["arrival"])
    ts, tarr, troute, tl = tst.stage_route(
        tcfg, tparams, ts, tarr, group_pairs_array(tcfg.n_servers).long(),
        tst._f32(tcfg.interrack_extra_us), ids)
    check(ts, ref["route"][0])
    lanes_equal(troute, ref["route"][1], troute._fields)
    lanes_equal(tl, ref["route"][2], ("dst", "act", "clo", "payload"))
    ts, tl = tst.stage_coordinator(tcfg, tparams, ts, tarr, troute, tl, ids)
    check(ts, ref["coordinator"][0])
    lanes_equal(tl, ref["coordinator"][1], ("dst", "act", "clo", "payload"))
    assert bool(tl.act[0, 2 * tcfg.max_arrivals:].any())   # LÆDGE pops
    ts, tl = tst.stage_hedge_timer(tcfg, tparams, ts, tarr, troute, tl, ids)
    check(ts, ref["hedge"][0])
    lanes_equal(tl, ref["hedge"][1], ("dst", "act", "clo", "payload"))
    ts, tl = tchaos.stage_link_failure(tcfg, tparams, ts, tarr, tl)
    ts, tresp = tst.stage_server(tcfg, tparams, ts, tarr, tl,
                                 tst.divisors(tcfg, CPU))
    check(ts, ref["server"][0], ulp=("workers.meta",))
    lanes_equal(tresp, ref["server"][1], tresp._fields)
    ts, tresp = tchaos.stage_link_response(tcfg, tparams, ts, tarr, tresp)
    ts, tdrop = tst.stage_response_filter(tcfg, tparams, ts, tarr, tresp)
    assert np.array_equal(tdrop.numpy(), ref["filter"][1])
    check(ts, ref["filter"][0], ulp=("workers.meta",))
    ts = tst.stage_client(tcfg, tparams, ts, tarr, tresp, tdrop,
                          tst.const_latency(tcfg, tparams),
                          tst.divisors(tcfg, CPU))
    check(ts, ref["client"], ulp=("workers.meta",))


def _leaves(got, want, path=""):
    """``(name, port leaf, reference leaf)`` over two state trees."""
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, f"{path}{name}"
        elif hasattr(b, "_fields"):
            yield from _leaves(a, b, f"{path}{name}.")
        else:
            yield f"{path}{name}", np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("k", [1, 7, 256])
def test_fused_equals_staged_with_stages_on(k):
    """The fused backend (its blocks run eagerly on the CPU) equals the
    staged loop for laedge, hedge and netclone on 2 racks under B2's plain
    version, the coordinator ring and the wheel carried across chunk
    boundaries, for every chunk length."""
    tcfg = _cfg(tf, n_racks=2, n_ticks=300, filter_backend="tickfuse")
    params = _params(tf, tcfg, ("laedge", "hedge", "netclone"),
                     {"laedge": 0.3})
    staged = tf.simulate(tcfg, params, device="cpu",
                         options=EngineOptions(backend="staged"))
    fused, ran = engine.run(tcfg, params, "cpu",
                            EngineOptions(backend="fused",
                                          ticks_per_chunk=k))
    assert ran == "fused"
    _assert_metrics_equal(fused, staged, f"K={k}")
    assert int(staged.n_coord_queued[0]) > 0
    assert int(staged.n_hedges_armed[1]) > 0


def test_hedge_delays_rows_match_reference():
    """``sweep_grid(hedge_delays=...)``: the hedge rows multiply by the
    delay axis (the wheel deepened to the largest), netclone keeps one row
    reported at delay 0; every field equals the reference's."""
    jax, _, rf = _ref()[:3]
    kw = dict(policies=["netclone", "hedge"], loads=[0.3, 0.6], seeds=[0],
              hedge_delays=[25.0, 75.0, 150.0])
    rcfg = rf.FleetConfig(n_servers=4, n_workers=8, queue_cap=64,
                          n_ticks=1000)
    tcfg = tf.FleetConfig(n_servers=4, n_workers=8, queue_cap=64,
                          n_ticks=1000)
    with jax.threefry_partitionable(False):
        want = rf.sweep_grid(rcfg.service, cfg=rcfg, **kw)
    got = tf.sweep_grid(tcfg.service, cfg=tcfg, device="cpu", **kw)
    assert got.n_configs == want.n_configs == 8
    for a, b in zip(got.results, want.results):
        for field in b.__dataclass_fields__:
            assert getattr(a, field) == pytest.approx(
                getattr(b, field), rel=0, abs=0, nan_ok=True), field
    assert [r.hedge_delay_us for r in got.select(policy="hedge", load=0.3)] \
        == [25.0, 75.0, 150.0]
    assert got.select(hedge_delay_us=75.0)[0].policy == "hedge"
    with pytest.raises(ValueError, match="hedge_timer"):
        tf.sweep_grid(tcfg.service, ["netclone"], [0.3], [0], cfg=tcfg,
                      hedge_delays=[50.0], device="cpu")
    with pytest.raises(ValueError, match="wheel"):
        tf.make_params(replace(tcfg, hedge_timer=True),
                       tf.POLICY_IDS["hedge"], 0.1, 0, hedge_delay_us=500.0)


def test_coordinator_hook_without_rank_rule_equals_laedge():
    """A registered coordinator hook without a rank rule is called for
    each pop; wrapping LÆDGE's hook that way (id 7) gives LÆDGE's results
    bit for bit, from the same seed."""
    from repro_torch.core.policies import LaedgePolicy
    from repro_torch.fleetsim.policies import laedge_coordinator

    registry.register(
        "laedge-per-pop", policy_id=7, des=LaedgePolicy,
        route=registry.route_of("laedge"),
        coordinator=lambda *a: laedge_coordinator(*a))
    try:
        cfg = tf.FleetConfig(n_servers=4, n_workers=8, queue_cap=64,
                             max_arrivals=8, n_ticks=800,
                             coordinator=True)
        rate = load_to_rate(0.25, cfg.service, cfg.n_servers_total,
                            cfg.n_workers)
        both = tf.simulate(cfg, tf.stack_params([
            tf.make_params(cfg, tf.POLICY_IDS["laedge"], rate, 5),
            tf.make_params(cfg, tf.POLICY_IDS["laedge-per-pop"], rate, 5)]),
            device="cpu")
        for name in both._fields:
            a = getattr(both, name)
            assert torch.equal(a[0], a[1]), name
        assert int(both.n_cloned[0]) > 0 and int(both.n_coord_queued[0]) > 0
    finally:
        registry.remove("laedge-per-pop")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["tickfuse", "pallas"])
def test_stages_replayed_on_the_card_equal_staged(backend):
    """On a card the stages replay from CUDA graphs with B2 (``tickfuse``)
    or B1 (``pallas``) filtering LÆDGE's top-tier lanes: the seven
    policies on 2 racks equal the staged ``vectorized`` run there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels and graphs run only "
                    "on a card)")
    tcfg = _cfg(tf, n_racks=2, n_ticks=700, filter_backend=backend)
    params = _params(tf, tcfg, POLICIES)
    want = tf.simulate(replace(tcfg, filter_backend="vectorized"), params,
                       device="cuda", options=EngineOptions(backend="staged"))
    got, ran = engine.run(tcfg, params, "cuda",
                          EngineOptions(backend="fused"))
    assert ran == "fused"
    _assert_metrics_equal(got, want, backend)
