"""The port's discrete-event simulator (DES) ≡ the reference's, on the CPU.

The DES modules are numpy programs copied into the port
(``repro_torch.core``, ``repro_torch.scenarios.arrival``), so the same seed
must give the same ``SimResult`` bit for bit: every counter, every float
statistic and every latency sample.  Checked for each registered DES policy
(the seven of the array engine's table plus the DES-only
``netclone-nofilter``), a KV-store workload, a switch failure, a link
failure, the pinned hedge / LÆDGE goldens, and ``cross_validate``'s rows.
The switch, table and hedging unit cases mirror
``tests/test_core_switch.py`` and ``tests/test_hedging.py``.
"""

import json
from dataclasses import fields
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import simulator as rsim
from repro.core import workloads as rwl
from repro.fleetsim import validate as rval
from repro_torch.core import simulator as tsim
from repro_torch.core import workloads as twl
from repro_torch.core.header import CLO_CLONE, CLO_NONE, CLO_ORIG, Request, \
    Response
from repro_torch.core.hedging import HedgePolicy
from repro_torch.core.policies import POLICIES, make_policy
from repro_torch.core.switch import NetCloneSwitch, SwitchCosts
from repro_torch.core.tables import FilterTables, GroupTable, StateTable, \
    fingerprint_hash
from repro_torch.fleetsim import validate as tval
from repro_torch.scenarios import registry
from repro_torch.scenarios.arrival import PoissonArrival, TraceArrival, \
    arrival_from_json
from repro_torch.scenarios.service import ServiceSpec
from test_torch_common import _one_torch_thread  # noqa: F401


DES_GOLDEN = Path(__file__).parent / "golden" / "des_hedge_laedge.json"
DES_POLICIES = ("baseline", "c-clone", "netclone", "racksched",
                "netclone+racksched", "laedge", "hedge", "netclone-nofilter")


def assert_same_result(got, want):
    """Every field of two ``SimResult``s equal, arrays element for
    element (NaN where NaN)."""
    for f in fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "throughput_timeline":
            assert (a is None) == (b is None), f.name
            if a is not None:
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif isinstance(b, float) and np.isnan(b):
            assert np.isnan(a), f.name
        else:
            assert a == b, f.name


def both(policy, svc_args=(25.0,), kind="ExponentialService", sim_kw=None,
         run_kw=None, setup=None):
    """The same DES run in both packages."""
    out = []
    for sim, wl in ((tsim, twl), (rsim, rwl)):
        s = sim.Simulator(policy, getattr(wl, kind)(*svc_args),
                          **(sim_kw or {}))
        if setup is not None:
            setup(s)
        out.append(s.run(**(run_kw or {})))
    return out


# ---------------------------------------------------- DES ≡ the reference ---
def test_registered_des_policies():
    assert registry.names() == list(DES_POLICIES)
    assert list(POLICIES) == list(DES_POLICIES)
    assert registry.get("netclone-nofilter").policy_id is None
    assert "netclone-nofilter" not in registry.policy_id_map()
    assert make_policy("netclone-nofilter", 4).name == "netclone-nofilter"


@pytest.mark.parametrize("policy", DES_POLICIES)
def test_des_matches_reference(policy):
    """Same seed, same SimResult, for every registered DES policy: load 0.6
    (LÆDGE at 0.1, below its coordinator's CPU limit), 4,000 requests, with
    the throughput timeline."""
    load = 0.1 if policy == "laedge" else 0.6
    got, want = both(policy, sim_kw=dict(n_servers=4, n_workers=8, seed=7),
                     run_kw=dict(offered_load=load, n_requests=4000,
                                 timeline_bin_us=500.0))
    assert got.n_completed > 0
    assert_same_result(got, want)


@pytest.mark.parametrize("policy", ["netclone", "racksched"])
def test_kv_store_workload_matches_reference(policy):
    """The KV store's GET/SCAN mix (Zipf keys drawn from the same stream)
    on the paper's testbed cluster."""
    got, want = both(policy, svc_args=(), kind="KVStoreService",
                     sim_kw=dict(seed=3),
                     run_kw=dict(offered_load=0.5, n_requests=4000))
    assert_same_result(got, want)


def test_switch_failure_run_matches_reference():
    """A switch failure: arrivals dropped while dark, soft state wiped on
    recovery (the Fig. 16 experiment at a small size)."""
    got, want = both(
        "netclone", sim_kw=dict(n_servers=4, n_workers=8, seed=1),
        run_kw=dict(offered_load=0.5, n_requests=6000,
                    timeline_bin_us=200.0),
        setup=lambda s: s.schedule_switch_failure(1000.0, 2000.0))
    assert got.n_completed < got.n_requests
    assert_same_result(got, want)


def test_link_failure_and_trace_run_matches_reference():
    """A link failure over a trace arrival schedule."""
    counts = tuple(np.random.default_rng(0).integers(0, 4, 300).tolist())

    def run(sim, wl, arrival):
        s = sim.Simulator("netclone", wl.ExponentialService(25.0),
                          n_servers=4, n_workers=8, seed=2)
        s.schedule_link_failure(100.0, 900.0, [1, 2])
        return s, s.run(arrival=arrival, n_ticks=3000)

    from repro.scenarios.arrival import TraceArrival as RefTrace

    s_got, got = run(tsim, twl, TraceArrival(counts))
    s_want, want = run(rsim, rwl, RefTrace(counts))
    assert s_got.n_link_dropped_req == s_want.n_link_dropped_req > 0
    assert s_got.n_link_dropped_resp == s_want.n_link_dropped_resp
    assert_same_result(got, want)


def _des_golden_cases():
    return json.loads(DES_GOLDEN.read_text())["cases"]


@pytest.mark.parametrize("case_i", range(len(_des_golden_cases())))
def test_des_golden_hedge_laedge(case_i):
    """The port replays the reference's pinned hedge / LÆDGE DES goldens
    exactly (counters and statistics)."""
    c = _des_golden_cases()[case_i]
    r = tsim.Simulator(c["policy"], twl.ExponentialService(25.0),
                       **c["sim_kw"]).run(**c["run_kw"])
    for field, want in {**c["metrics"], **c["stats"]}.items():
        assert getattr(r, field) == want, field


def test_cross_validate_rows_match_reference():
    """``cross_validate`` on the CPU: FleetSim through the port's
    ``sweep_grid`` and the port's DES give the reference's CrossCheck rows,
    field for field."""
    with jax.threefry_partitionable(False):
        want = rval.cross_validate(rwl.ExponentialService(25.0),
                                   ["baseline", "netclone"], [0.3],
                                   n_requests=500)
    report = {}
    got = tval.cross_validate(twl.ExponentialService(25.0),
                              ["baseline", "netclone"], [0.3],
                              n_requests=500, device="cpu", report=report)
    assert [c.__dict__ for c in got] == [c.__dict__ for c in want]
    assert all(c.ok for c in got)
    assert report["fleet"].backend == "staged" and report["des_s"] > 0


def test_validate_features_of_later_slices_raise():
    """The validation features of the later slices run: ``shard_equivalence``
    (A9-shard) gives the reference's checks on a one-device shard, and
    ``cross_validate_spec`` and ``cross_check_scenario`` (A8) give the
    reference's rows."""
    from repro.scenarios import Scenario as RScenario
    from repro.scenarios import SweepSpec as RSweepSpec
    from repro.scenarios import load_any as rload
    from repro_torch.scenarios import Scenario as TScenario
    from repro_torch.scenarios import SweepSpec as TSweepSpec
    from repro_torch.scenarios import load_any as tload

    shard_kw = dict(policies=("netclone", "hedge"), loads=(0.3,),
                    hedge_delays=(40.0,))
    with jax.threefry_partitionable(False):
        want_s, want_h = rval.shard_equivalence(
            RSweepSpec(base=RScenario(servers=4, workers=8, n_ticks=400),
                       **shard_kw), shard=1)
    got_s, got_h = tval.shard_equivalence(
        TSweepSpec(base=TScenario(servers=4, workers=8, n_ticks=400),
                   **shard_kw), shard=1, device="cpu")
    assert [c.__dict__ for c in got_s] == [c.__dict__ for c in want_s]
    assert got_h and want_h and all(c.ok for c in got_s)
    with jax.threefry_partitionable(False):
        want = rval.cross_validate_spec(rload("hedge_vs_netclone"),
                                        n_requests=300)
        want.append(rval.cross_check_scenario(
            RScenario(policy="laedge", load=0.1, servers=4, workers=8,
                      n_ticks=1500), n_requests=300))
    got = tval.cross_validate_spec(tload("hedge_vs_netclone"),
                                   n_requests=300, device="cpu")
    got.append(tval.cross_check_scenario(
        TScenario(policy="laedge", load=0.1, servers=4, workers=8,
                  n_ticks=1500), n_requests=300, device="cpu"))
    assert [c.__dict__ for c in got] == [c.__dict__ for c in want]
    with pytest.raises(ValueError, match="n_racks == 1"):
        from repro_torch.fleetsim import FleetConfig
        tval.cross_validate(twl.ExponentialService(25.0), ["baseline"], [0.3],
                            cfg=FleetConfig(n_racks=2), device="cpu")


@pytest.mark.parametrize("svc", [twl.ExponentialService(50.0, jitter_p=0.001),
                                 twl.BimodalService(),
                                 twl.BoundedParetoService(),
                                 twl.LLMBimodalService()],
                         ids=repr)
def test_service_spec_round_trips_the_processes(svc):
    spec = ServiceSpec.from_process(svc)
    back = spec.to_process()
    assert type(back) is type(svc) and back.__dict__ == svc.__dict__
    assert spec.effective_mean == pytest.approx(svc.effective_mean)
    with pytest.raises(TypeError):
        ServiceSpec.from_process(twl.KVStoreService())


def test_arrival_json_round_trip_and_strict_keys():
    tr = TraceArrival((1, 0, 3), dt_us=2.0, repeat=False)
    assert arrival_from_json(tr.to_json()) == tr
    assert arrival_from_json(None) == PoissonArrival()
    assert list(tr.tick_counts(5)) == [1, 0, 3, 0, 0]
    with pytest.raises(ValueError, match="unknown trace arrival keys"):
        arrival_from_json({"kind": "trace", "counts": [1], "dt": 1.0})


# ------------------------------------------- switch, tables (unit cases) ----
def test_group_table_counts_and_uniform_first_candidate():
    for n in (2, 3, 6, 8):
        assert GroupTable(n).n_groups == n * (n - 1)
    counts = np.bincount(GroupTable(4).pairs[:, 0], minlength=4)
    assert (counts == counts[0]).all()
    assert (GroupTable(6).pairs[:, 0] != GroupTable(6).pairs[:, 1]).all()
    with pytest.raises(ValueError):
        GroupTable(1)


def test_group_table_remove_server():
    gt = GroupTable(4)
    gt.remove_server(2)
    assert not np.any(gt.pairs == 2)
    assert gt.n_groups == 3 * 2


def test_state_and_shadow_consistent():
    stt = StateTable(4)
    stt.update(1, 3)
    stt.update(2, 0)
    assert (stt.state == stt.shadow).all()
    assert stt.is_idle_pair(2, 0)
    assert not stt.is_idle_pair(1, 2)


def _collision(base_id, n_slots):
    base = fingerprint_hash(base_id, n_slots)
    return next(i for i in range(base_id + 1, 100000)
                if fingerprint_hash(i, n_slots) == base)


def test_filter_insert_drop_and_collisions():
    ft = FilterTables(n_tables=2, n_slots=64)
    assert ft.process(7, 1) is False       # faster response: insert
    assert ft.process(7, 1) is True        # slower response: clear, drop
    assert ft.process(7, 1) is False       # slot was cleared — reusable
    coll = _collision(7, 64)
    ft = FilterTables(n_tables=2, n_slots=64)
    assert ft.process(7, 0) is False
    assert ft.process(coll, 1) is False    # other table: no overwrite
    assert ft.process(7, 0) is True
    ft = FilterTables(n_tables=1, n_slots=64)
    assert ft.process(7, 0) is False
    assert ft.process(coll, 0) is False    # overwrites 7's fingerprint
    assert ft.n_overwrites == 1
    assert ft.process(7, 0) is False       # 7's slower copy not dropped
    assert FilterTables(2, 2 ** 17).memory_bytes == 2 * 2 ** 17 * 4
    with pytest.raises(ValueError):
        FilterTables(2, 100)


def test_filter_drops_only_after_insert():
    """A seeded stream of (id, table) responses: a response is dropped only
    if the same id was inserted in the same table and not overwritten."""
    rng = np.random.default_rng(0)
    ft = FilterTables(n_tables=2, n_slots=32)
    open_fp = {}
    for rid, idx in zip(rng.integers(1, 51, 300), rng.integers(0, 2, 300)):
        rid, idx = int(rid), int(idx)
        slot = fingerprint_hash(rid, 32)
        expected = open_fp.get((idx, slot)) == rid
        assert ft.process(rid, idx) == expected
        if expected:
            open_fp.pop((idx, slot))
        else:
            open_fp[(idx, slot)] = rid


def test_switch_clones_iff_both_idle_and_pays_recirculation():
    sw = NetCloneSwitch(4, n_filter_slots=64)
    out = sw.process_request(Request(grp=0))
    assert [p.clo for p, _ in out] == [CLO_ORIG, CLO_CLONE]
    assert out[0][0].req_id == out[1][0].req_id
    assert out[1][1] == out[0][1] + SwitchCosts().recirculation
    s1, s2 = sw.grp_table.lookup(1)
    sw.state_table.update(s2, 5)
    out = sw.process_request(Request(grp=1))
    assert len(out) == 1 and out[0][0].clo == CLO_NONE
    assert out[0][0].dst == s1


def test_switch_ids_state_and_filtering():
    sw = NetCloneSwitch(4, n_filter_slots=64)
    ids = [sw.process_request(Request(grp=0))[0][0].req_id
           for _ in range(10)]
    assert ids == list(range(1, 11))
    before = sw.state_table.state.copy()
    sw.process_request(Request(grp=0))
    assert (sw.state_table.state == before).all()  # requests never write
    sw = NetCloneSwitch(4, n_filter_slots=64)
    copies = sw.process_request(Request(grp=0))
    rid = copies[0][0].req_id
    r1 = Response(req_id=rid, sid=copies[0][0].dst, state=4, clo=CLO_ORIG)
    r2 = Response(req_id=rid, sid=copies[1][0].dst, state=0, clo=CLO_CLONE)
    assert sw.process_response(r1)[0] is False
    assert sw.process_response(r2)[0] is True
    assert sw.state_table.state[r1.sid] == 4
    for i in range(20):
        assert sw.process_response(Response(req_id=i + 100, sid=0, state=0,
                                            clo=CLO_NONE))[0] is False


def test_switch_failure_wipes_soft_state_only():
    sw = NetCloneSwitch(4, n_filter_slots=64)
    sw.process_request(Request(grp=0))
    sw.state_table.update(0, 3)
    sw.filter_tables.process(1, 0)
    sw.fail()
    assert sw.seq == 0
    assert (sw.state_table.state == 0).all()
    assert (sw.filter_tables.tables == 0).all()
    assert sw.process_request(Request(grp=0))[0][0].req_id == 1


# ------------------------------------------------------ hedging (unit) ------
def _hedged(delay=75.0):
    pol = HedgePolicy(4, delay_us=delay)
    [(pkt, _)] = pol.route(Request(grp=0), np.random.default_rng(0))
    return pol, pkt


def test_hedge_fires_only_after_delay():
    pol, pkt = _hedged()
    assert pkt.clo == CLO_ORIG
    pol.arm(pkt.req_id, now=10.0)
    assert pol.due_hedges(now=84.9) == []
    [clone] = pol.due_hedges(now=85.1)
    assert clone.clo == CLO_CLONE and clone.req_id == pkt.req_id
    assert pol.n_cloned == 1
    assert pol.due_hedges(now=1000.0) == []


def test_first_response_cancels_pending_hedge():
    pol, pkt = _hedged()
    pol.arm(pkt.req_id, now=0.0)
    assert pol.on_response(Response(req_id=pkt.req_id, sid=pkt.dst,
                                    clo=pkt.clo, idx=pkt.idx)) is False
    assert pol.due_hedges(now=1e9) == []
    assert pol.n_cloned == 0


def test_redundant_hedge_response_is_filtered_and_fail_wipes():
    pol, pkt = _hedged()
    pol.arm(pkt.req_id, now=0.0)
    [clone] = pol.due_hedges(now=80.0)
    assert pol.on_response(Response(req_id=pkt.req_id, sid=pkt.dst,
                                    clo=pkt.clo, idx=pkt.idx)) is False
    assert pol.on_response(Response(req_id=clone.req_id, sid=clone.dst,
                                    clo=clone.clo, idx=clone.idx)) is True
    assert pol.filter_tables.n_filtered == 1
    pol, pkt = _hedged()
    pol.arm(pkt.req_id, now=0.0)
    pol.fail()
    assert pol.due_hedges(now=1e9) == []
    assert not pol.filter_tables.tables.any()
