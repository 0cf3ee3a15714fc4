"""Scenario CLI: list the registry + library, run scenario files end-to-end;
the port's copy of ``python -m repro.scenarios``.

    PYTHONPATH=src python -m repro_torch.scenarios --list
    PYTHONPATH=src python -m repro_torch.scenarios trace_burst --engine both
    PYTHONPATH=src python -m repro_torch.scenarios path/to/scenario.json \
        --ticks 4000 --out artifact.json --device cpu

A positional argument is a scenario/sweep JSON file path or the bare name of
a bundled library file.  ``--engine fleetsim`` is the default; ``--engine
both`` additionally replays the same frozen Scenario through the DES
(scenarios the DES cannot model, e.g. multi-rack fabrics, are skipped with a
note — asking for them with ``--engine des`` is an error).  ``--ticks`` /
``--requests`` shrink runs for smoke tests; ``--out`` writes the result rows
as a JSON artifact.  ``--device`` names where FleetSim runs: ``cuda`` (the
default; without a card the run raises) or ``cpu``.  ``--trace-out DIR``
runs each scenario with FleetScope telemetry on and writes its Chrome
trace, event and series CSVs and summary under ``DIR/<name>/``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.scenarios import registry
from repro_torch.scenarios.spec import SweepSpec, load_any, scenario_library


def _print_listing() -> None:
    print("== registered policies (repro_torch.scenarios.registry) ==")
    print(f"{'name':24s} {'id':>3s} {'engines':10s} description")
    for name in registry.names():
        d = registry.get(name)
        engines = "+".join(e for e, ok in (
            ("des", d.des is not None),
            ("fleetsim", d.policy_id is not None)) if ok)
        pid = "-" if d.policy_id is None else str(d.policy_id)
        print(f"{name:24s} {pid:>3s} {engines:10s} {d.description}")
    print("\n== bundled scenario library ==")
    for name, path in scenario_library().items():
        doc = json.loads(path.read_text())
        kind = "sweep" if "base" in doc or "policies" in doc else "scenario"
        base = doc.get("base", doc)
        arr = (base.get("arrival") or {}).get("kind", "poisson")
        print(f"{name:24s} {kind:9s} policy={base.get('policy', '-'):20s} "
              f"racks={base.get('racks', 1)} arrival={arr}")


def _try_des(sc, args, rows) -> None:
    """Run one scenario through the DES; with ``--engine both``, scenarios
    the DES cannot model (multi-rack, skew injection, DES-less policies)
    are skipped with a note instead of aborting the run."""
    try:
        r = sc.run_des(n_requests=args.requests, n_ticks=args.ticks)
        rows.append({"engine": "des", **r.row()})
    except ValueError as e:
        if args.engine == "des":
            raise SystemExit(f"error: {e}")
        print(f"[skip des] {sc.name}: {e}")


def _check_policies(names) -> None:
    """Fail fast — one line, nonzero exit — when a scenario file names a
    policy nothing registered, instead of a traceback from deep inside an
    engine."""
    registered = registry.names()
    for n in names:
        if n not in registered:
            raise SystemExit(f"error: unknown policy {n!r} "
                             f"(registered: {', '.join(registered)})")


def run_file(args) -> list[dict]:
    obj = load_any(args.file)
    _check_policies(obj.resolved_policies() if isinstance(obj, SweepSpec)
                    else [obj.policy])
    overrides = {"n_ticks": args.ticks} if args.ticks else {}
    rows: list[dict] = []
    dev = {"device": args.device}
    if args.trace_out:
        # FleetScope export path: per-scenario traced runs (telemetry is
        # turned on; counters stay bit-identical to the plain run)
        from repro_torch.fleetsim.telemetry import write_run

        scenarios = obj.scenarios() if isinstance(obj, SweepSpec) else [obj]
        for sc in scenarios:
            result, tel = sc.run_traced(**dev, **overrides)
            row = {"engine": "fleetsim", **result.row()}
            rows.append(row)
            paths = write_run(args.trace_out, sc.name, tel, summary=row)
            print(f"[trace] {sc.name}: {len(tel.events)} events "
                  f"({tel.events.n_lost} lost), {tel.series.n_windows} "
                  f"windows -> {paths['trace'].parent}")
        for row in rows:
            print(",".join(f"{k}={v}" for k, v in row.items()))
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(
                {"file": str(args.file), "engine": "fleetsim",
                 "device": args.device,
                 "trace_out": str(args.trace_out),
                 "scenarios": [s.to_json() for s in scenarios],
                 "rows": rows}, indent=1, default=str))
            print(f"wrote {out}")
        return rows
    if isinstance(obj, SweepSpec):
        scs = obj.scenarios()
        print(f"sweep {obj.base.name}: {len(scs)} scenarios "
              f"({len(obj.resolved_policies())} policies x "
              f"{len(obj.resolved_loads())} loads x {len(obj.seeds)} seeds)")
        if args.engine in ("fleetsim", "both"):
            sw = obj.run_fleetsim(**dev, **overrides)
            for r in sw.results:
                rows.append({"engine": "fleetsim", **r.row()})
        if args.engine in ("des", "both"):
            for sc in scs:
                _try_des(sc, args, rows)
        scenarios = scs
    else:
        scenarios = [obj]
        print(f"scenario {obj.name}: policy={obj.policy} racks={obj.racks} "
              f"arrival={obj.arrival.kind} "
              f"load={obj.effective_load(args.ticks or obj.n_ticks):.2f}")
        if args.engine in ("fleetsim", "both"):
            rows.append({"engine": "fleetsim",
                         **obj.run_fleetsim(**dev, **overrides).row()})
        if args.engine in ("des", "both"):
            _try_des(obj, args, rows)
    for row in rows:
        print(",".join(f"{k}={v}" for k, v in row.items()))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"file": str(args.file), "engine": args.engine,
             "scenarios": [s.to_json() for s in scenarios],
             "rows": rows}, indent=1, default=str))
        print(f"wrote {out}")
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scenarios",
                                 description=__doc__)
    ap.add_argument("file", nargs="?",
                    help="scenario/sweep JSON path or bundled library name")
    ap.add_argument("--list", action="store_true",
                    help="list registered policies + bundled scenarios")
    ap.add_argument("--engine", choices=["fleetsim", "des", "both"],
                    default="fleetsim")
    ap.add_argument("--ticks", type=int, default=None,
                    help="override n_ticks (smoke runs)")
    ap.add_argument("--requests", type=int, default=None,
                    help="DES requests per scenario (Poisson runs)")
    ap.add_argument("--out", default=None,
                    help="write result rows to this JSON artifact")
    ap.add_argument("--trace-out", default=None, metavar="DIR",
                    help="run with FleetScope telemetry and write one "
                         "Chrome-trace/CSV bundle per scenario under DIR")
    ap.add_argument("--device", default="cuda",
                    help="where FleetSim runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.list:
        _print_listing()
        return 0
    if not args.file:
        ap.error("need a scenario file (or --list)")
    run_file(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
