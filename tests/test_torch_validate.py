"""The port's ``cross_validate_spec`` and validate CLI ≡ the reference's,
on the CPU (the Scenario layer's validation; the rest of that layer is in
``test_torch_scenarios.py``).

* ``cross_validate_spec`` over ``validate_grid.json`` (all seven
  two-engine policies, its upper two loads) gives the reference's rows at
  2,000 requests;
* the validate CLI prints the reference's lines, on the trace scenario
  and on a small grid with ``--shard 1``.

The reference runs under ``jax.threefry_partitionable(False)`` (ROADMAP
C0), set per test.
"""

from dataclasses import replace

import jax

from repro.fleetsim import validate as rval
from repro.scenarios import spec as rspec
from repro_torch.fleetsim import validate as tval
from repro_torch.scenarios import spec as tspec
from test_torch_common import _one_torch_thread  # noqa: F401


def test_cross_validate_spec_rows_match_reference():
    """``validate_grid.json`` at its two upper loads (0.5, 0.8): the seven
    two-engine policies (laedge and hedge through the optional stages) as
    one FleetSim batch, each point beside its DES replay: every
    ``CrossCheck`` field equals the reference's, at 2,000 DES requests a
    point.  (Its 0.2 load would make the run 2.5× longer on the CPU: the
    ticks admit 2,000 requests at the lowest load.  ``chip_smoke.py``
    phase 12c runs all 21 points at 20,000 requests on the card.)"""
    specs = [replace(mod.load_any("validate_grid"), loads=(0.5, 0.8))
             for mod in (rspec, tspec)]
    with jax.threefry_partitionable(False):
        want = rval.cross_validate_spec(specs[0], n_requests=2000)
    report = {}
    got = tval.cross_validate_spec(specs[1], n_requests=2000, device="cpu",
                                   report=report)
    assert len(got) == 14
    assert [c.__dict__ for c in got] == [c.__dict__ for c in want]
    assert report["fleet"].n_configs == 14
    assert {c.policy for c in got} >= {"laedge", "hedge"}


def test_validate_cli_prints_the_references_lines(capsys, tmp_path):
    """``python -m repro_torch.fleetsim.validate`` on the trace scenario
    (no grid), then on a small grid with ``--shard 1``: the same check
    lines and exit code as the reference's."""
    argv = ["--grid", "none", "--trace", "trace_burst", "--trace-ticks",
            "1500"]
    with jax.threefry_partitionable(False):
        rc_want = rval.main(argv)
    want = capsys.readouterr().out
    rc_got = tval.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert rc_got == rc_want
    assert got == want and "points within tolerance" in got
    grid = tspec.SweepSpec(
        base=tspec.Scenario(name="cli-shard", servers=4, workers=8,
                            n_ticks=300),
        policies=("baseline", "netclone"), loads=(0.3,)).to_file(
            tmp_path / "grid.json")
    argv = ["--grid", str(grid), "--trace", "none", "--requests", "300",
            "--shard", "1", "--shard-ticks", "300"]
    with jax.threefry_partitionable(False):
        rc_want = rval.main(argv)
    want = capsys.readouterr().out
    rc_got = tval.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert rc_got == rc_want
    assert got == want and "2/2 sharded cells identical" in got
