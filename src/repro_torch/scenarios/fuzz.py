"""ChaosFuzz: generative scenario fuzzing with the DES as oracle; the port's
copy of the reference's fuzzer (the same seed draws the same cases: the
draws are numpy).

Hypothesis-style property fuzzing, but self-contained — ``hypothesis`` is
not a dependency of this repo, so the "strategies" are a seeded
:class:`numpy.random.Generator` drawing from **quantized knob grids**
(:data:`CHOICES`).  Quantization matters twice over: every knob value is
valid by construction (the fuzzer never wastes budget on spec errors), and
the set of reachable ``FleetConfig`` shapes is small.

Each drawn :class:`~repro_torch.scenarios.Scenario` is pushed through the
contract checks in :func:`check_case`:

* JSON round-trip identity (``from_json(to_json(sc)) == sc``),
* array-engine determinism (two runs, identical result rows),
* counter invariants (conservation, no drops without an injected failure),
* and — for DES-comparable scenarios — the full two-engine cross-check
  (:func:`repro_torch.fleetsim.validate.cross_check_scenario`) with the DES
  as the behavioural oracle.

A failing case is **shrunk** (greedy dimension-wise descent toward each
knob's simplest value, re-checking the contract at every step) and the
shrunk scenario is persisted as replayable Scenario JSON under
``results/fuzz/`` — replay it with ``python -m repro_torch.scenarios
<path>`` or load it with :func:`repro_torch.scenarios.spec.load_any`.
Every FleetSim run of a case takes ``device`` (CUDA by default).

CLI (the nightly tier)::

    PYTHONPATH=src python -m repro_torch.scenarios.fuzz --n 50 \
        --seed from-date --device cuda

``--seed from-date`` derives the seed from today's UTC date, so every
nightly run explores a fresh slice of the space while staying reproducible
from its logs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from repro_torch.fleetsim import validate as _validate
from repro_torch.fleetsim.chaos import LinkFailure
from repro_torch.scenarios import registry
from repro_torch.scenarios.arrival import PoissonArrival, TraceArrival
from repro_torch.scenarios.service import ServiceSpec
from repro_torch.scenarios.spec import Scenario

DEFAULT_OUT_DIR = Path("results/fuzz")

#: Quantized strategy grids.  Index 0 of every tuple is the *simplest*
#: value — the shrinker walks each dimension toward index 0 while the
#: failure persists, so counterexamples come out in canonical form.
CHOICES: dict[str, tuple] = {
    "policy": ("baseline", "netclone", "hedge", "c-clone", "laedge",
               "racksched", "netclone+racksched"),
    "service": ("exponential", "bimodal", "llm"),
    "arrival": ("poisson", "trace"),
    "racks": (1, 2),
    "workers": (8, 16),
    "load": (0.3, 0.5, 0.65),
    "n_ticks": (4_000, 8_000),
    "fail_window": (False, True),
    "link_failure": (False, True),
}

_SERVICES = {
    "exponential": ServiceSpec.exponential(25.0),
    "bimodal": ServiceSpec.bimodal(),
    "llm": ServiceSpec.llm(),
}

N_SERVERS = 4          # fixed per-rack width: keeps the shape set small
_TRACE_LEN = 64        # trace tile length (tiles over n_ticks when shorter)


# ------------------------------------------------------------- strategies --
def draw_case(rng: np.random.Generator) -> dict:
    """Draw one case: a ``{knob: index}`` map plus the case's own seed and
    (for trace arrivals) its drawn per-tick counts.

    Every case consumes the *same* number of rng draws regardless of which
    branches it lands in, so case ``i`` of a run is a pure function of
    ``(seed, i)`` — shrinking or re-running one case never perturbs the
    others.
    """
    case = {k: int(rng.integers(len(v))) for k, v in CHOICES.items()}
    case["seed"] = int(rng.integers(1 << 16))
    # always burn the trace draws (constant draw count per case)
    lam = rng.uniform(0.3, 0.8)
    counts = rng.poisson(lam * N_SERVERS, _TRACE_LEN)
    case["trace_counts"] = tuple(int(c) for c in counts)
    return case


def build_scenario(case: dict, index: int) -> Scenario:
    """Materialise a drawn case as a valid, frozen :class:`Scenario`."""
    pick = {k: CHOICES[k][case[k]] for k in CHOICES}
    n_ticks = pick["n_ticks"]
    racks = pick["racks"]
    if pick["arrival"] == "trace":
        arrival = TraceArrival(counts=case["trace_counts"], dt_us=1.0)
    else:
        arrival = PoissonArrival()
    fail_window = None
    if pick["fail_window"]:
        # mid-run switch blackout, 10% of the horizon
        fail_window = (int(0.40 * n_ticks), int(0.50 * n_ticks))
    link_failure = None
    if pick["link_failure"]:
        # partition the last server of the last rack for 20% of the run
        link_failure = LinkFailure(
            start_tick=int(0.40 * n_ticks), duration=int(0.20 * n_ticks),
            servers=(racks * N_SERVERS - 1,))
    return Scenario(
        name=f"fuzz_{index:03d}", policy=pick["policy"],
        load=pick["load"], seed=case["seed"], racks=racks,
        servers=N_SERVERS, workers=pick["workers"], n_ticks=n_ticks,
        service=_SERVICES[pick["service"]], arrival=arrival,
        fail_window_ticks=fail_window, link_failure=link_failure)


def des_comparable(sc: Scenario) -> bool:
    """Can the DES serve as oracle for this scenario?  Single ToR, FCFS
    workers, no skew injection, and a policy both engines implement."""
    return (sc.racks == 1 and sc.server_model == "fcfs"
            and sc.hot_rack_weight == 1.0
            and sc.straggler_rack_mult == 1.0 and sc.slowdown is None
            and sc.policy in registry.two_engine_names())


# ----------------------------------------------------------------- checks --
def check_case(sc: Scenario, device=None) -> list[str]:
    """Run the fuzz contract on one scenario (FleetSim on ``device``, CUDA
    by default); returns failure strings (empty list == the case
    holds)."""
    fails: list[str] = []
    try:
        rt = Scenario.from_json(json.loads(json.dumps(sc.to_json())))
        if rt != sc:
            fails.append("json-round-trip: from_json(to_json(sc)) != sc")
    except Exception as e:          # noqa: BLE001 — report, don't crash
        fails.append(f"json-round-trip raised: {e!r}")
    try:
        r1 = sc.run_fleetsim(device=device)
        r2 = sc.run_fleetsim(device=device)
    except Exception as e:          # noqa: BLE001
        fails.append(f"fleetsim raised: {e!r}")
        return fails
    if r1.row() != r2.row():
        fails.append("fleetsim nondeterministic: two runs of the same "
                     "params disagree")
    fails += _invariants(sc, r1)
    if des_comparable(sc):
        try:
            chk = _validate.cross_check_scenario(sc, device=device)
        except Exception as e:      # noqa: BLE001
            fails.append(f"cross-check raised: {e!r}")
        else:
            if not chk.ok:
                fails.append("cross-check: " + chk.describe())
    return fails


def _invariants(sc: Scenario, r) -> list[str]:
    """Engine-independent conservation laws on one FleetResult."""
    fails = []
    counters = {k: v for k, v in vars(r).items()
                if k.startswith("n_") and isinstance(v, int)}
    bad = {k: v for k, v in counters.items() if v < 0}
    if bad:
        fails.append(f"negative counters: {bad}")
    if r.n_completed > r.n_arrivals:
        fails.append(f"completed {r.n_completed} > arrivals {r.n_arrivals}")
    if sc.fail_window_ticks is None and r.n_dropped_down:
        fails.append(f"{r.n_dropped_down} switch-down drops without a "
                     "fail window")
    if sc.link_failure is None and (r.n_link_dropped_req
                                    or r.n_link_dropped_resp):
        fails.append(f"link drops ({r.n_link_dropped_req} req, "
                     f"{r.n_link_dropped_resp} resp) without a "
                     "link_failure window")
    if not 0.0 <= r.clone_fraction <= 1.0:
        fails.append(f"clone fraction {r.clone_fraction} outside [0, 1]")
    return fails


# --------------------------------------------------------------- shrinker --
def shrink_case(case: dict, index: int, *, max_passes: int = 4,
                device=None) -> tuple[dict, list[str]]:
    """Greedy dimension-wise shrink: walk every knob toward its simplest
    value (index 0 of its :data:`CHOICES` grid) while the failure persists.

    Returns ``(shrunk_case, fails)`` where ``fails`` is the surviving
    failure list of the shrunk case.
    """
    fails = check_case(build_scenario(case, index), device)
    if not fails:
        raise ValueError("shrink_case called on a passing case")
    for _ in range(max_passes):
        moved = False
        for dim in CHOICES:
            while case[dim] > 0:
                cand = dict(case)
                cand[dim] = case[dim] - 1
                cand_fails = check_case(build_scenario(cand, index),
                                        device)
                if not cand_fails:
                    break           # this step repairs it — keep current
                case, fails, moved = cand, cand_fails, True
        if not moved:
            break
    return case, fails


# --------------------------------------------------------------- campaign --
@dataclass
class FuzzFailure:
    case_index: int
    fails: list[str]
    shrunk_fails: list[str]
    counterexample: Path


@dataclass
class FuzzReport:
    seed: int
    n_cases: int
    n_des_checked: int = 0
    failures: list[FuzzFailure] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def describe(self) -> str:
        head = (f"fuzz seed={self.seed}: {self.n_cases} cases, "
                f"{self.n_des_checked} DES-checked, "
                f"{len(self.failures)} failing")
        lines = [head]
        for f in self.failures:
            lines.append(f"  case {f.case_index}: {'; '.join(f.fails)}")
            lines.append(f"    shrunk -> {f.counterexample} "
                         f"({'; '.join(f.shrunk_fails)})")
        return "\n".join(lines)


def fuzz_contract(seed: int, n: int,
                  out_dir: Path | str = DEFAULT_OUT_DIR,
                  device=None) -> FuzzReport:
    """Fuzz ``n`` scenarios drawn from seed ``seed`` through the contract.

    Deterministic: the same ``(seed, n)`` draws, checks, and (on failure)
    shrinks the same cases.  Shrunk counterexamples are written to
    ``out_dir`` as replayable Scenario JSON.
    """
    rng = np.random.default_rng(seed)
    report = FuzzReport(seed=seed, n_cases=n)
    for i in range(n):
        case = draw_case(rng)
        sc = build_scenario(case, i)
        report.n_des_checked += des_comparable(sc)
        fails = check_case(sc, device)
        if not fails:
            continue
        shrunk, shrunk_fails = shrink_case(case, i, device=device)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = build_scenario(shrunk, i).to_file(
            out / f"counterexample_s{seed}_c{i:03d}.json")
        report.failures.append(FuzzFailure(
            case_index=i, fails=fails, shrunk_fails=shrunk_fails,
            counterexample=path))
    return report


def _resolve_seed(raw: str) -> int:
    """``--seed`` value: an integer, or ``from-date`` → today's UTC date
    as YYYYMMDD (fresh nightly slice, reproducible from the log line)."""
    if raw == "from-date":
        import datetime

        return int(datetime.datetime.now(datetime.timezone.utc)
                   .strftime("%Y%m%d"))
    return int(raw)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="ChaosFuzz: fuzz generated scenarios through the "
                    "two-engine contract; shrunk counterexamples land in "
                    "--out as replayable Scenario JSON.")
    ap.add_argument("--n", type=int, default=25,
                    help="number of scenarios to draw")
    ap.add_argument("--seed", default="0",
                    help="rng seed (integer, or 'from-date' for today's "
                         "UTC date as YYYYMMDD)")
    ap.add_argument("--out", default=str(DEFAULT_OUT_DIR),
                    help="directory for shrunk counterexample JSON")
    ap.add_argument("--device", default="cuda",
                    help="where FleetSim runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    seed = _resolve_seed(args.seed)
    report = fuzz_contract(seed, args.n, out_dir=args.out,
                           device=args.device)
    print(report.describe())
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
