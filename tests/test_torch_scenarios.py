"""The port's Scenario layer, its CLIs and fuzzing ≡ the reference's, on the
CPU (mirroring ``tests/test_scenarios.py`` and ``tests/test_chaos.py``).

* the bundled library is the reference's, byte for byte, and every file
  loads to the reference's ``to_json`` and round-trips;
* the golden scenario file reproduces ``tests/golden/fleetsim_single_tor.
  json`` bit for bit; ``run_des`` equals the reference's on three files;
* the scenario CLI's ``--list`` and its one-line errors equal the
  reference's;
* a custom registration (the pow2-spine variant of
  ``examples/custom_spine_policy.py``, id 7) runs through both engines;
* the fuzzer draws the reference's cases, and its contract holds on the
  smallest drawn case (the full smoke carries the ``fuzz`` marker);
* what later slices port still raises: shard; telemetry and the batch
  server, ported since, run.

The reference runs under ``jax.threefry_partitionable(False)`` (ROADMAP
C0), set per test.  ``cross_validate_spec`` and the validate CLI are in
``test_torch_validate.py``.
"""

import importlib.util
import json
from dataclasses import fields, replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.scenarios import __main__ as rcli
from repro.scenarios import fuzz as rfuzz
from repro.scenarios import registry as rreg
from repro.scenarios import spec as rspec
from repro_torch.scenarios import __main__ as tcli
from repro_torch.scenarios import fuzz as tfuzz
from repro_torch.scenarios import registry as treg
from repro_torch.scenarios import spec as tspec
from test_torch_common import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "fleetsim_single_tor.json"
EXAMPLES = ROOT / "examples"
LIBRARY = sorted(p.stem for p in rspec.LIBRARY_DIR.glob("*.json"))


def assert_same_sim_result(got, want):
    """Every field of two DES ``SimResult``s equal (NaN where NaN)."""
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


# ----------------------------------------------------------------- library --
def test_library_is_the_references_byte_for_byte():
    assert len(LIBRARY) == 8
    assert sorted(tspec.scenario_library()) == LIBRARY
    for name in LIBRARY:
        assert tspec.resolve(name).read_bytes() \
            == rspec.resolve(name).read_bytes(), name
    assert isinstance(tspec.load_any("validate_grid"), tspec.SweepSpec)
    assert isinstance(tspec.load_any("trace_burst"), tspec.Scenario)
    with pytest.raises(FileNotFoundError, match="bundled"):
        tspec.resolve("no_such_scenario")


@pytest.mark.parametrize("name", LIBRARY)
def test_library_file_json_equals_the_reference(name):
    """Each file loads to the reference's ``to_json`` and round-trips
    (telemetry, shard and batch-server files included)."""
    got, want = tspec.load_any(name), rspec.load_any(name)
    assert got.to_json() == want.to_json()
    assert type(got).from_json(json.loads(json.dumps(got.to_json()))) == got


def test_strict_keys_and_window_validation():
    with pytest.raises(ValueError, match="unknown scenario keys"):
        tspec.Scenario.from_json({"polcy": "netclone"})
    with pytest.raises(ValueError, match="unknown sweep keys"):
        tspec.SweepSpec.from_json({"base": {}, "lods": [0.1]})
    with pytest.raises(ValueError, match="fail_window_ticks"):
        tspec.Scenario(n_ticks=100, fail_window_ticks=(50, 200))


# ------------------------------------------------------------------ engines --
def test_golden_scenario_file_bit_identical():
    """The bundled golden scenario reproduces the single-ToR golden run
    (every metric, full histogram) through ``Scenario``."""
    g = json.loads(GOLDEN.read_text())
    case = next(c for c in g["cases"]
                if c["policy"] == "netclone" and c["seed"] == 0)
    sc = tspec.Scenario.from_file("golden_single_tor")
    _, m = sc.fleet_metrics(device="cpu")
    for field, want in case["metrics"].items():
        got = m.hist.numpy() if field == "hist" \
            else getattr(m, field).numpy()
        assert np.array_equal(got.reshape(-1),
                              np.asarray(want).reshape(-1)), field


@pytest.mark.parametrize("name,kw", [
    ("golden_single_tor", dict(n_requests=3000)),
    ("trace_burst", dict(n_ticks=4000)),
    ("chaos_partition", dict(n_requests=20_000)),   # spans the link window
])
def test_run_des_matches_reference(name, kw):
    got = tspec.Scenario.from_file(name).run_des(**kw)
    want = rspec.Scenario.from_file(name).run_des(**kw)
    assert got.n_completed > 0
    assert_same_sim_result(got, want)


# ---------------------------------------------------------------------- CLI --
def test_cli_list_equals_the_reference(capsys):
    """``--list`` prints the reference's listing (its heading names the
    package's own registry module)."""
    assert tcli.main(["--list"]) == 0
    got = capsys.readouterr().out
    assert rcli.main(["--list"]) == 0
    want = capsys.readouterr().out
    assert got.replace("repro_torch.scenarios", "repro.scenarios") == want
    assert "laedge" in got and "golden_single_tor" in got


def test_cli_error_lines_equal_the_reference(tmp_path):
    """The one-line errors: a file naming an unregistered policy, and a
    scenario the DES cannot model asked of ``--engine des``."""
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"name": "bad", "policy": "no-such-policy"}))
    cases = ([str(bad)],
             ["multirack_hot", "--engine", "des", "--requests", "100"])
    for argv in cases:
        with pytest.raises(SystemExit) as got:
            tcli.main(argv + ["--device", "cpu"])
        with pytest.raises(SystemExit) as want:
            rcli.main(argv)
        assert str(got.value.code).startswith("error: ")
        assert got.value.code == want.value.code


def test_cli_runs_a_file_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert tcli.main(["golden_single_tor", "--engine", "both", "--ticks",
                      "400", "--requests", "500", "--device", "cpu",
                      "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["engine"] for r in rows] == ["fleetsim", "des"]


# ------------------------------------------------------ custom registration --
def _load_example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pow2_spine_place(rack_load, server_state, home, r1, r2, remote_cand, *,
                      n_racks, n_servers):
    """``examples/custom_spine_policy.py``'s power-of-two-choices spine
    placement over the port's ``(G, A)`` lanes."""
    la = (r1 % n_servers) % (n_racks - 1)
    lb = (r2 % n_servers) % (n_racks - 1)
    ra = (home + 1 + la) % n_racks            # never the home rack
    rb = (home + 1 + lb) % n_racks
    pick = torch.where(torch.gather(rack_load, 1, ra)
                       <= torch.gather(rack_load, 1, rb), ra, rb)
    return pick * n_servers + remote_cand


def test_custom_registration_runs_through_both_engines():
    """One registration (id 7, NetClone in-rack, pow2 spine placement) in
    each package: the same Scenario runs through the port's FleetSim with
    the reference's metrics on a hot 4-rack fabric, through both DES at a
    single ToR, and enters ``policies="registered"``."""
    from repro_torch.core.policies import NetClonePolicy

    ex = _load_example("custom_spine_policy")
    ex.register_pow2(7)
    treg.register("netclone+pow2spine", policy_id=7, des=NetClonePolicy,
                  route=treg.route_of("netclone"), spine_clone=True,
                  spine_place=_pow2_spine_place,
                  description="NetClone + power-of-two-choices spine "
                              "placement")
    try:
        kw = dict(name="hot", policy="netclone+pow2spine", load=0.55,
                  racks=4, servers=4, workers=8, n_ticks=1200,
                  hot_rack_weight=4.0)
        with jax.threefry_partitionable(False):
            _, want = rspec.Scenario(**kw).fleet_metrics()
        _, got = tspec.Scenario(**kw).fleet_metrics(device="cpu")
        for name in want._fields:
            assert np.array_equal(getattr(got, name).numpy(),
                                  np.asarray(getattr(want, name))), name
        assert int(got.n_interrack_cloned) > 0
        one = dict(policy="netclone+pow2spine", load=0.4, servers=4,
                   workers=8)
        assert_same_sim_result(
            tspec.Scenario(**one).run_des(n_requests=2000),
            rspec.Scenario(**one).run_des(n_requests=2000))
        assert "netclone+pow2spine" in tspec.SweepSpec(
            base=tspec.Scenario()).resolved_policies()
    finally:
        treg.remove("netclone+pow2spine")
        rreg.remove("netclone+pow2spine")
    assert treg.names() == rreg.names()


# ------------------------------------------------------------------- fuzzing --
def test_fuzz_draws_the_references_cases():
    r_rng, t_rng = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(20):
        got, want = tfuzz.draw_case(t_rng), rfuzz.draw_case(r_rng)
        assert got == want
        sc_got = tfuzz.build_scenario(got, i)
        sc_want = rfuzz.build_scenario(want, i)
        assert sc_got.to_json() == sc_want.to_json()
        assert tfuzz.des_comparable(sc_got) == rfuzz.des_comparable(sc_want)


def test_fuzz_contract_holds_on_the_smallest_case():
    """The fuzz contract (JSON round trip, determinism, invariants and the
    two-engine cross-check) on the cheapest DES-comparable case of seed
    7's first 20 (fewest rack-ticks, then no optional stage: racksched
    over a trace with a switch failure and a link failure);
    ``fuzz_contract(seed=7, n=2)`` takes over a minute here, so the whole
    campaign is the ``fuzz``-marked smoke."""
    rng = np.random.default_rng(7)
    cases = [tfuzz.draw_case(rng) for _ in range(20)]
    scs = [tfuzz.build_scenario(c, i) for i, c in enumerate(cases)]
    sc = min((s for s in scs if tfuzz.des_comparable(s)),
             key=lambda s: (s.n_ticks * s.racks,
                            treg.needs_coordinator(s.policy)
                            or treg.needs_hedge_timer(s.policy)))
    assert sc.fail_window_ticks is not None and sc.link_failure is not None
    assert tfuzz.check_case(sc, device="cpu") == []


@pytest.mark.fuzz
def test_fuzz_smoke_deterministic(tmp_path):
    """Same seed → same cases, same verdicts (the reference's smoke)."""
    r1 = tfuzz.fuzz_contract(seed=7, n=5, out_dir=tmp_path / "a",
                             device="cpu")
    r2 = tfuzz.fuzz_contract(seed=7, n=5, out_dir=tmp_path / "b",
                             device="cpu")
    assert r1.n_cases == r2.n_cases == 5
    assert r1.n_des_checked == r2.n_des_checked
    assert [f.case_index for f in r1.failures] \
        == [f.case_index for f in r2.failures]
    assert r1.ok, r1.describe()


# ------------------------------------------------------------ later slices --
def test_features_of_later_slices_raise():
    """Files with telemetry, shard or the batch server load and
    round-trip (above), and each runs now: a sharded sweep equals the
    unsharded one row for row (``test_torch_shard.py`` holds it to the
    reference), and telemetry and the batch server run
    (``test_torch_telemetry.py`` and ``test_torch_llmserve.py`` hold them
    to the reference).  Without a card the default device raises."""
    from repro_torch.fleetsim.shard import ShardSpec
    from repro_torch.fleetsim.telemetry import TelemetrySpec

    sc = tspec.Scenario(servers=4, workers=8, n_ticks=100)
    spec = tspec.SweepSpec(base=sc, policies=("netclone",), loads=(0.2, 0.5),
                           shard=ShardSpec(devices=2))
    sharded = spec.run_fleetsim(device="cpu")
    assert sharded.n_devices == 2 and sharded.shard == ShardSpec(devices=2)
    assert sharded.results == replace(spec, shard=None).run_fleetsim(
        device="cpu").results
    result, tel = tspec.Scenario(
        servers=4, workers=8, n_ticks=100,
        telemetry=TelemetrySpec(window_ticks=50)).run_traced(device="cpu")
    assert len(tel.events) > 0 and tel.series.n_windows == 2
    assert result.n_arrivals > 0
    row = tspec.load_any("llm_gemma7b").run_fleetsim(device="cpu",
                                                     n_ticks=10)
    assert row.mean_slot_occupancy > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sc.run_fleetsim()
