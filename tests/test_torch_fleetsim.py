"""The port's FleetSim engine ≡ the reference, on the CPU.

* one tick, stage by stage, from a mid-run reference state carried across
  (``state_from_numpy`` / ``params_from_numpy``);
* the 6 golden cases of ``tests/golden/fleetsim_single_tor.json`` as one
  batched run, under each of the four filter backends;
* a 2-rack skewed batch and a small ``sweep_grid`` against the reference;
* the package imports neither ``jax`` nor ``repro``, and never runs on the
  CPU unless asked to.

The reference runs under ``jax.threefry_partitionable(False)``, the stream
the goldens were captured in (set per test, never globally).
"""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleetsim as rf
from repro.core.switch_jax import group_pairs_array as ref_group_pairs
from repro.fleetsim import chaos as rchaos
from repro.fleetsim import stages as rst
from repro.fleetsim.engine import make_params as ref_make_params
from repro.fleetsim.policies import id_mask as ref_id_mask
from repro.fleetsim.state import init_fleet_state as ref_init_state
from repro.scenarios import registry as ref_registry
import repro_torch.fleetsim as tf
from repro_torch import random as jr
from repro_torch.core.switch import group_pairs_array
from repro_torch.fleetsim import chaos as tchaos
from repro_torch.fleetsim import stages as tst
from repro_torch.fleetsim.engine import batched_params
from repro_torch.fleetsim.state import to_numpy
from repro_torch.scenarios.service import load_to_rate
from test_torch_common import _one_torch_thread  # noqa: F401


GOLDEN = Path(__file__).parent / "golden" / "fleetsim_single_tor.json"
SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")


def _pair_cfgs(**kw):
    """The same fabric in both packages."""
    return (rf.FleetConfig(service=rf.ServiceSpec.exponential(25.0), **kw),
            tf.FleetConfig(service=tf.ServiceSpec.exponential(25.0), **kw))


def _assert_tree_equal(got, want, path="", ulp_fields=()):
    """``got`` (port, numpy leaves) equals ``want`` (reference) leaf by
    leaf; fields named in ``ulp_fields`` may differ by a few float32 ulps
    (see the stage test)."""
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a is None and b is None:
            continue
        if hasattr(a, "_fields"):
            _assert_tree_equal(a, b, f"{path}{name}.", ulp_fields)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{path}{name}: {a.shape} vs {b.shape}"
        if f"{path}{name}" in ulp_fields:
            np.testing.assert_array_max_ulp(a, b, maxulp=4)
        else:
            assert np.array_equal(a, b), f"{path}{name}"


# ---------------------------------------------------------- one tick, staged
def test_one_tick_stage_by_stage_from_carried_state():
    """Both engines start tick 200 from the same mid-run state and agree
    after every stage.  The new jobs' remaining-time field (``workers.meta``
    REM) may differ by a few ulps: the reference's float32 ``log1p`` is not
    correctly rounded (about 7% of its inputs are off by one ulp), the
    port's is; every other value is bit-exact."""
    rcfg, tcfg = _pair_cfgs(n_racks=2, n_servers=4, n_workers=8,
                            queue_cap=64, max_arrivals=10, n_ticks=600)
    rate = load_to_rate(0.7, tcfg.service, tcfg.n_servers_total,
                        tcfg.n_workers)
    t0, n_raw = 200, 7
    with jax.threefry_partitionable(False):
        rp = ref_make_params(rcfg, rf.POLICY_IDS["netclone"], rate, 3,
                             rack_weights=[0.85, 0.15])
        gp = ref_group_pairs(rcfg.n_servers)
        k_pois, k0 = jax.random.split(jax.random.PRNGKey(rp.seed))
        counts = jax.random.poisson(k_pois, rp.rate_per_us * rcfg.dt_us,
                                    (t0,)).astype(jnp.int32)
        step = rst.build_step(rcfg, rp, gp)
        rstate, _ = jax.jit(lambda s, xs: jax.lax.scan(step, s, xs))(
            ref_init_state(rcfg, k0),
            (jnp.arange(t0, dtype=jnp.int32), counts))
        tstate = tf.state_from_numpy(tcfg, jax.device_get(rstate))
        tparams, _ = batched_params(
            tf.params_from_numpy(jax.device_get(rp)), CPU)
        assert int(tstate.metrics.n_cloned[0]) > 0

        def check(t_state, r_state, ulp=()):
            _assert_tree_equal(to_numpy(t_state),
                               jax.tree.map(lambda a: np.asarray(a)[None],
                                            r_state), ulp_fields=ulp)

        def lanes_equal(t, r, names):
            for n in names:
                a = getattr(t, n).numpy()[0]
                b = np.asarray(getattr(r, n))
                assert np.array_equal(a, b.astype(a.dtype)), n

        const_r = (rcfg.client_tx_us + 4 * rcfg.link_us
                   + 2 * rcfg.pipeline_pass_us + rcfg.spine_extra_us
                   + jnp.where(ref_id_mask(rp.policy_id,
                                           ref_registry.client_dup_ids()),
                               rcfg.client_tx_us, 0.0))

        def ref_tick(s, xs):
            """The reference's tick, every stage's output kept."""
            out = {}
            s, arr = rst.stage_arrival(rcfg, rp, s, xs)
            out["arrival"] = (s, arr)
            s, arr, _, lanes = rst.stage_route(
                rcfg, rp, s, arr, gp, jnp.float32(rcfg.interrack_extra_us))
            out["route"] = (s, lanes)
            s, lanes = rchaos.stage_link_failure(rcfg, rp, s, arr, lanes)
            out["link_failure"] = lanes
            s, resp = rst.stage_server(rcfg, rp, s, arr, lanes)
            out["server"] = (s, resp)
            s, resp = rchaos.stage_link_response(rcfg, rp, s, arr, resp)
            s, drop = rst.stage_response_filter(rcfg, rp, s, arr, resp)
            out["filter"] = (s, drop)
            out["client"] = rst.stage_client(rcfg, rp, s, arr, resp, drop,
                                             const_r)
            return out

        ref = jax.device_get(jax.jit(ref_tick)(
            rstate, (jnp.int32(t0), jnp.int32(n_raw))))

    xs_t = (t0, torch.tensor([n_raw], dtype=torch.int32),
            tst.draw_ticks(tcfg, tstate.key, 1)[0])
    ts, tarr = tst.stage_arrival(tcfg, tparams, tstate, xs_t)
    check(ts, ref["arrival"][0])
    lanes_equal(tarr, ref["arrival"][1], ("active", "grp", "fidx", "client",
                                          "base", "home", "r1", "r2",
                                          "r2_local"))
    ts, tarr, _, tl = tst.stage_route(
        tcfg, tparams, ts, tarr, group_pairs_array(tcfg.n_servers).long(),
        tst._f32(tcfg.interrack_extra_us))
    check(ts, ref["route"][0])
    lanes_equal(tl, ref["route"][1], ("dst", "act", "clo", "payload"))
    ts, tl = tchaos.stage_link_failure(tcfg, tparams, ts, tarr, tl)
    lanes_equal(tl, ref["link_failure"], ("dst", "act", "clo", "payload"))
    ts, tresp = tst.stage_server(tcfg, tparams, ts, tarr, tl,
                                 tst.divisors(tcfg, CPU))
    check(ts, ref["server"][0], ulp=("workers.meta",))
    lanes_equal(tresp, ref["server"][1], tresp._fields)
    assert bool(tresp.active.any())
    ts, tresp = tchaos.stage_link_response(tcfg, tparams, ts, tarr, tresp)
    ts, tdrop = tst.stage_response_filter(tcfg, tparams, ts, tarr, tresp)
    assert np.array_equal(tdrop.numpy()[0], ref["filter"][1])
    check(ts, ref["filter"][0], ulp=("workers.meta",))
    ts = tst.stage_client(tcfg, tparams, ts, tarr, tresp, tdrop,
                          tst.const_latency(tcfg, tparams),
                          tst.divisors(tcfg, CPU))
    check(ts, ref["client"], ulp=("workers.meta",))


# ----------------------------------------------------------------- goldens --
def _golden_batch(backend):
    g = json.loads(GOLDEN.read_text())
    cfg = tf.FleetConfig(service=tf.ServiceSpec.exponential(25.0),
                         filter_backend=backend, **g["cfg"])
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


@pytest.mark.parametrize("backend",
                         ["vectorized", "scan", "pallas", "tickfuse"])
def test_golden_cases_bit_exact(backend):
    """All 6 golden cases in one batch (they differ only in per-run
    params), every one of the 16 fields bit-exact, under each backend (on
    the CPU ``pallas`` and ``tickfuse`` run their kernels' plain
    versions)."""
    cfg, cases, params = _golden_batch(backend)
    m = tf.simulate(cfg, params, device="cpu")
    for i, c in enumerate(cases):
        for field, want in c["metrics"].items():
            got = getattr(m, field)[i].numpy().reshape(-1)
            assert np.array_equal(got, np.asarray(want).reshape(-1)), \
                (c["policy"], field)


@pytest.mark.parametrize("case", ["random", "one_slot", "rid_zero",
                                  "sid_out", "one_server", "k33"])
def test_tickfuse_masked_matches_the_staged_neutralisation(case):
    """B2's staged entry point (``tickfuse_masked``: the stage's lanes as
    they are, an ``active`` mask, ``idx`` and ``sid`` in int64) on the CPU
    gives what the staged path gave before it: inactive lanes neutralised
    with ``torch.where`` and cast to int32, then ``tickfuse_response_path``;
    and the stage's ``tickfuse`` and ``pallas`` branches, writing into a
    reused ``out``, give the ``scan`` branch's drops and tables."""
    from repro_torch.kernels import inputs
    from repro_torch.kernels.ops import tickfuse_masked, \
        tickfuse_response_path
    g, n_tables, n_slots, n_servers = 9, 10, 1024, 24
    for seed in range(4):
        x = (inputs.filter_lanes(g, 32, n_tables, n_slots, n_servers, seed)
             if case == "random" else
             inputs.edge_lanes(case, g, n_tables, n_slots, n_servers, seed))
        t = {n: torch.from_numpy(a) for n, a in x.items()}
        active = torch.from_numpy(
            np.random.default_rng(seed).random(x["rid"].shape) < 0.8)
        idx64, sid64 = t["idx"].long(), t["sid"].long()

        def state():
            return t["server_state"].clone(), t["tables"].clone()

        s1, t1 = state()
        out = torch.empty(active.shape, dtype=torch.bool)
        _, _, d1 = tickfuse_masked(s1, t1, t["rid"], idx64, t["clo"], sid64,
                                   t["qlen"], active, out=out)
        assert d1 is out
        d1 = d1.clone()
        s2, t2 = state()
        _, _, d2 = tickfuse_response_path(
            s2, t2, t["rid"], idx64.to(torch.int32),
            torch.where(active, t["clo"], 0).to(torch.int32),
            torch.where(active, sid64, n_servers).to(torch.int32), t["qlen"])
        assert torch.equal(s1, s2) and torch.equal(t1, t2)
        assert torch.equal(d1, d2)
        for backend in ("tickfuse", "pallas", "scan"):
            cfg = tf.FleetConfig(filter_backend=backend)
            s3, t3 = state()
            out.fill_(False)
            d3 = tst._filter_responses(cfg, s3, t3, t["rid"], idx64,
                                       t["clo"], sid64, t["qlen"], active,
                                       out)
            assert torch.equal(s3, s1) and torch.equal(t3, t1), backend
            assert torch.equal(d3, d1), backend
    with pytest.raises(TypeError):
        tickfuse_masked(s1, t1, t["rid"], t["idx"], t["clo"], sid64,
                        t["qlen"], active)


# ------------------------------------------------------- fabric + sweeps ----
def test_two_rack_skewed_batch_matches_reference():
    """A hot rack drives inter-rack clones and spine filtering; a straggler
    rack and a link-failure window ride in the same batch.  Every metric of
    every config matches the reference's vmapped run."""
    rcfg, tcfg = _pair_cfgs(n_racks=2, n_servers=4, n_workers=8,
                            queue_cap=64, max_arrivals=10, n_ticks=800)
    weights, slowdown = tf.rack_skew(tcfg, 5.5, 2.0)
    runs = []
    link = dict(start_tick=300, duration=250, servers=(1, 6))
    for policy, load, seed, lf in [("netclone", 0.55, 0, None),
                                   ("netclone+racksched", 0.6, 1, None),
                                   ("netclone", 0.5, 2, link),
                                   ("racksched", 0.6, 3, None)]:
        rate = load_to_rate(load, tcfg.service, tcfg.n_servers_total,
                            tcfg.n_workers)
        runs.append(ref_make_params(
            rcfg, rf.POLICY_IDS[policy], rate, seed, slowdown=slowdown,
            rack_weights=weights,
            link_failure=rchaos.LinkFailure(**lf) if lf else None))
    with jax.threefry_partitionable(False):
        rparams = jax.tree.map(lambda *xs: jnp.stack(xs), *runs)
        want = jax.device_get(rf.simulate(rcfg, rparams))
    got = tf.simulate(tcfg, tf.params_from_numpy(jax.device_get(rparams)),
                      device="cpu")
    assert int(got.n_interrack_cloned[0]) > 0
    assert int(got.n_spine_filtered[0]) > 0
    assert int(got.n_link_dropped_req[2]) > 0
    _assert_tree_equal(to_numpy(got), want)
    # the spine's partition view, on a mask with one fully dead rack
    dead = np.zeros((3, tcfg.n_servers_total), bool)
    dead[1, :tcfg.n_servers] = True
    dead[2, 1] = True
    assert np.array_equal(
        tchaos.rack_dead_mask(torch.from_numpy(dead), 2, 4).numpy(),
        np.stack([np.asarray(rchaos.rack_dead_mask(jnp.asarray(d), 2, 4))
                  for d in dead]))


def test_trace_arrivals_match_reference():
    """``arrival="trace"`` replays per-tick counts instead of the Poisson
    draw; a bursty trace (over the lane headroom at its peaks) runs the
    same in both engines."""
    rcfg, tcfg = _pair_cfgs(n_servers=4, n_workers=8, queue_cap=64,
                            max_arrivals=6, n_ticks=300, arrival="trace")
    rng = np.random.default_rng(11)
    counts = np.where(rng.random(300) < 0.1, 9,
                      rng.integers(0, 3, 300)).astype(np.int32)
    rp = ref_make_params(rcfg, rf.POLICY_IDS["netclone"], 0.0, 5,
                         arrival_counts=counts)
    with jax.threefry_partitionable(False):
        want = jax.device_get(rf.simulate(rcfg, rp))
    got = tf.simulate(tcfg, tf.make_params(tcfg, tf.POLICY_IDS["netclone"],
                                           0.0, 5, arrival_counts=counts),
                      device="cpu")
    assert int(got.n_truncated) > 0
    _assert_tree_equal(to_numpy(got), want)


@pytest.mark.parametrize("kind,args", [
    ("exponential", ()), ("bimodal", ()), ("pareto", ()),
    ("llm", (20.0, 2.0, 4.0, 16.0, 0.2))])
def test_service_draws_match_reference(kind, args):
    """Every service kind's intrinsic demand and execution time, from the
    same uniforms and the same key, against the reference's samplers.
    Where the reference calls float32 ``log1p`` / ``pow`` (exponential,
    pareto) its result may differ by an ulp (ROADMAP C1)."""
    rcfg = rf.FleetConfig(service=getattr(rf.ServiceSpec, kind)(*args))
    tcfg = tf.FleetConfig(service=getattr(tf.ServiceSpec, kind)(*args))
    u = np.random.default_rng(3).random((2, 500)).astype(np.float32)
    u[0, :4] = [0.0, 0.5, 1.0 - 2.0 ** -24, 0.1]
    want = np.asarray(rst._intrinsic(rcfg, jnp.asarray(u)))
    got = tst._intrinsic(tcfg, torch.from_numpy(u)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(9)
        want = np.asarray(rst._execute(rcfg, key, jnp.asarray(got)))
        u_exec = jr.uniform(torch.from_numpy(
            np.asarray(key).astype(np.int64))[None], got.shape + (2,))
    got_exec = tst._execute(tcfg, u_exec, torch.from_numpy(got)[None])
    np.testing.assert_array_max_ulp(got_exec[0].numpy(), want, maxulp=2)


def test_sweep_grid_matches_reference_rows():
    rcfg, tcfg = _pair_cfgs(n_racks=2, n_servers=4, n_workers=8,
                            queue_cap=64, n_ticks=700)
    kw = dict(policies=["baseline", "c-clone", "netclone"],
              loads=[0.3, 0.85], seeds=[0])
    weights, slowdown = tf.rack_skew(tcfg, 3.0)
    with jax.threefry_partitionable(False):
        want = rf.sweep_grid(rcfg.service, cfg=rcfg, rack_weights=weights,
                             slowdown=slowdown, **kw)
    got = tf.sweep_grid(tcfg.service, cfg=tcfg, rack_weights=weights,
                        slowdown=slowdown, device="cpu", **kw)
    assert got.n_configs == want.n_configs == 6
    assert got.simulated_requests == want.simulated_requests
    for a, b in zip(got.results, want.results):
        for field in a.__dataclass_fields__:
            assert getattr(a, field) == pytest.approx(
                getattr(b, field), rel=0, abs=0, nan_ok=True), field
    assert np.array_equal(got.grid_hist, want.grid_hist)


def test_unported_features_raise():
    """Nothing of FleetSim is left unported: the sharded runner (A9-shard)
    runs, and refuses scalar params as the reference does; a sharded sweep
    equals the plain one.  What earlier slices ported runs: telemetry and
    the batch server (a telemetry
    entry point on a config without the flag raises the reference's
    ``ValueError``), the optional stages (a stage-policy on a config
    without its stage raises the reference's ``ValueError``), the
    hedge-delay axis and ``cross_validate_spec``."""
    from repro_torch.fleetsim.options import EngineOptions
    from repro_torch.fleetsim.validate import cross_validate_spec
    from repro_torch.scenarios import load_any

    cfg = tf.FleetConfig(n_servers=4, n_workers=4, queue_cap=16,
                         n_ticks=2000)
    params = tf.make_params(cfg, 0, 0.1, 0)
    with pytest.raises(ValueError, match="leading sweep axis"):
        tf.simulate(cfg, params, device="cpu",
                    options=EngineOptions(shard=1))
    kw = dict(cfg=replace(cfg, n_ticks=60), device="cpu")
    plain = tf.sweep_grid(cfg.service, ["baseline"], [0.2, 0.4], [0], **kw)
    sharded = tf.sweep_grid(cfg.service, ["baseline"], [0.2, 0.4], [0],
                            shard=2, **kw)
    assert sharded.results == plain.results and sharded.n_devices == 2
    assert np.array_equal(sharded.grid_hist, plain.grid_hist)
    with pytest.raises(ValueError, match="cfg.telemetry=True"):
        tf.simulate(cfg, params, device="cpu",
                    options=EngineOptions(telemetry=True))
    # ported since: telemetry and the batch server run
    short = replace(cfg, n_ticks=60)
    m, trace, _ = tf.simulate(
        replace(short, telemetry=True, window_ticks=60), params,
        device="cpu", options=EngineOptions(telemetry=True))
    assert int(trace.count) > 0 and int(m.n_arrivals) > 0
    m = tf.simulate(replace(short, server_model="batch"), params,
                    device="cpu")
    assert int(m.n_slot_busy) > 0
    # the stages run, and refuse flag-less configs as the reference does
    for policy, stage in (("laedge", "coordinator stage"),
                          ("hedge", "hedge_timer stage")):
        with pytest.raises(ValueError, match=stage):
            tf.make_params(cfg, tf.POLICY_IDS[policy], 0.1, 0)
    for flag in (dict(coordinator=True), dict(hedge_timer=True)):
        m = tf.simulate(replace(short, **flag), tf.make_params(
            replace(short, **flag), 0, 0.1, 0), device="cpu")
        assert int(m.n_arrivals) > 0
    sw = tf.sweep_grid(cfg.service, ["hedge"], [0.2], [0],
                       cfg=replace(cfg, n_ticks=60), hedge_delays=[50.0],
                       device="cpu")
    assert [r.hedge_delay_us for r in sw.results] == [50.0]
    checks = cross_validate_spec(load_any("validate_grid"), n_requests=20,
                                 n_ticks=60, device="cpu")
    assert len(checks) == 21


def test_package_is_jax_free_and_never_falls_back_to_cpu():
    """Importing the port (the FleetSim engine and its fused backend and
    options, the DES and cross-validation, the kernels, the model stack
    with whisper's encoder-decoder, the serving tier and its launcher,
    the sharded runner, training, the data pipeline, checkpointing, fault
    tolerance and the training launcher) pulls in neither ``jax`` nor
    ``repro``; without a card ``simulate`` raises instead of running on the
    CPU, under the default options, under the fused backend and sharded,
    and so does the training launcher."""
    code = """
import sys
import torch
import repro_torch.fleetsim as tf
from repro_torch import random as jr
from repro_torch.core.switch import group_pairs_array
import repro_torch.kernels.ops, repro_torch.kernels.build
import repro_torch.random, repro_torch.core.switch
import repro_torch.models, repro_torch.models.convert, repro_torch.configs
import repro_torch.models.recurrent, repro_torch.models.whisper
import repro_torch.kernels.ssd_scan, repro_torch.kernels.lru_scan
import repro_torch.serve, repro_torch.launch.serve
import repro_torch.fleetsim.options, repro_torch.fleetsim.fused
import repro_torch.fleetsim.validate, repro_torch.core.simulator
import repro_torch.core.hedging, repro_torch.configs.netclone_cluster
import repro_torch.scenarios, repro_torch.scenarios.spec
import repro_torch.scenarios.__main__, repro_torch.scenarios.fuzz
import repro_torch.fleetsim.telemetry, repro_torch.fleetsim.llmserve
import repro_torch.fleetsim.telemetry.export, repro_torch.analysis.roofline
import repro_torch.fleetsim.shard, repro_torch.train, repro_torch.train.step
import repro_torch.data, repro_torch.checkpoint, repro_torch.ft
import repro_torch.launch.train
import repro_torch.sharding, repro_torch.launch.mesh
import repro_torch.launch.specs, repro_torch.launch.steps
import repro_torch.launch.dryrun
import repro_torch.launch.ranks, repro_torch.sharding.collectives
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
cfg = tf.FleetConfig(n_servers=4, n_workers=4, queue_cap=16, n_ticks=10)
params = tf.make_params(cfg, 0, 0.1, 0)
from repro_torch.fleetsim.options import EngineOptions
if not torch.cuda.is_available():
    grid = tf.stack_params([params, params])
    for opts, p in ((None, params), (EngineOptions(backend="fused"), params),
                    (EngineOptions(shard=1), grid)):
        try:
            tf.simulate(cfg, p, options=opts)
        except RuntimeError as e:
            assert "device='cpu'" in str(e)
        else:
            raise AssertionError("simulate ran without a card")
    try:
        repro_torch.launch.train.main(["--steps", "1"])
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("the training launcher ran without a card")
m = tf.simulate(cfg, params, device="cpu")
assert int(m.n_arrivals) >= 0
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
