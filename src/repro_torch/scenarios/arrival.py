"""Pluggable arrival processes shared by the DES and FleetSim; the port's
copy of ``repro.scenarios.arrival`` (numpy only).

An :class:`ArrivalProcess` answers the same question for both engines —
*when do requests arrive?* — in each engine's native form:

* FleetSim consumes **per-tick arrival counts**:
  :meth:`ArrivalProcess.tick_counts` returns them host-side, or ``None``
  for processes the device draws itself (Poisson);
* the DES consumes **arrival times**: :meth:`ArrivalProcess.des_times`.

:class:`PoissonArrival` is the paper's open-loop Poisson client (§4.2).
:class:`TraceArrival` replays a recorded per-tick count sequence (tiled or
zero-padded to the run length) — closing the ROADMAP trace-replay item:
feeding an Azure/Twitter trace is now a data-loading problem, not an engine
change.  Both serialize to JSON for scenario files.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ARRIVAL_POISSON = "poisson"
ARRIVAL_TRACE = "trace"


@dataclass(frozen=True)
class ArrivalProcess:
    """Interface: subclasses define ``kind`` and the two engine views."""

    @property
    def kind(self) -> str:
        raise NotImplementedError

    def tick_counts(self, n_ticks: int) -> np.ndarray | None:
        """Per-tick arrival counts for the array engine, or ``None`` when
        the device draws them itself from the run's rate + seed."""
        return None

    def des_times(self, rng: np.random.Generator, rate_per_us: float,
                  n_requests: int,
                  n_ticks: int | None = None) -> np.ndarray:
        """Arrival times (µs) for the DES.  Processes with a time base own
        it themselves (``TraceArrival.dt_us``) — it is not a parameter, so
        the two engines cannot be handed different bin widths."""
        raise NotImplementedError

    def mean_rate_per_us(self, rate_per_us: float, n_ticks: int) -> float:
        """Offered rate for reporting/normalisation (Poisson: the load-derived
        rate; trace: the replayed sequence's own mean)."""
        return rate_per_us

    # ------------------------------------------------------------- JSON ----
    def to_json(self) -> dict:
        return {"kind": self.kind}


@dataclass(frozen=True)
class PoissonArrival(ArrivalProcess):
    """Open-loop Poisson arrivals at the scenario's load-derived rate."""

    @property
    def kind(self) -> str:
        return ARRIVAL_POISSON

    def des_times(self, rng, rate_per_us, n_requests, n_ticks=None):
        gaps = rng.exponential(1.0 / rate_per_us, n_requests)
        return np.cumsum(gaps)


@dataclass(frozen=True)
class TraceArrival(ArrivalProcess):
    """Replay a per-tick arrival-count sequence.

    ``counts[t]`` requests arrive during tick ``t`` (bin width ``dt_us``).
    Runs longer than the trace tile it when ``repeat`` (the default) or see
    zero arrivals past its end; the same tiled sequence drives both
    engines, so a cross-validation compares like against like.  The DES
    spreads each tick's arrivals uniformly inside the tick (the array
    engine quantizes to the tick anyway).
    """

    counts: tuple[int, ...]
    dt_us: float = 1.0
    repeat: bool = True

    def __post_init__(self):
        if len(self.counts) == 0:
            raise ValueError("TraceArrival needs at least one tick count")
        if any(c < 0 for c in self.counts):
            raise ValueError("trace counts must be non-negative")
        object.__setattr__(self, "counts",
                           tuple(int(c) for c in self.counts))

    @property
    def kind(self) -> str:
        return ARRIVAL_TRACE

    def tick_counts(self, n_ticks: int) -> np.ndarray:
        c = np.asarray(self.counts, np.int32)
        if self.repeat:
            reps = -(-n_ticks // len(c))        # ceil
            return np.tile(c, reps)[:n_ticks]
        out = np.zeros(n_ticks, np.int32)
        out[:min(n_ticks, len(c))] = c[:n_ticks]
        return out

    def des_times(self, rng, rate_per_us, n_requests, n_ticks=None):
        if n_ticks is None:
            raise ValueError("TraceArrival.des_times needs n_ticks")
        counts = self.tick_counts(n_ticks)
        ticks = np.repeat(np.arange(n_ticks), counts)
        times = (ticks + rng.random(len(ticks))) * self.dt_us
        return np.sort(times)

    def mean_rate_per_us(self, rate_per_us, n_ticks):
        counts = self.tick_counts(n_ticks)
        return float(counts.sum() / (n_ticks * self.dt_us))

    def max_count(self, n_ticks: int) -> int:
        return int(self.tick_counts(n_ticks).max())

    def to_json(self) -> dict:
        return {"kind": self.kind, "counts": list(self.counts),
                "dt_us": self.dt_us, "repeat": self.repeat}


def arrival_from_json(d: dict | None) -> ArrivalProcess:
    """Inverse of ``ArrivalProcess.to_json`` (``None`` → Poisson).  Unknown
    keys raise — a misspelled knob must not silently fall back to a
    default."""
    if d is None:
        return PoissonArrival()
    kind = d.get("kind", ARRIVAL_POISSON)
    valid = {ARRIVAL_POISSON: {"kind"},
             ARRIVAL_TRACE: {"kind", "counts", "dt_us", "repeat"}}.get(kind)
    if valid is None:
        raise ValueError(f"unknown arrival kind {kind!r}")
    unknown = sorted(set(d) - valid)
    if unknown:
        raise ValueError(f"unknown {kind} arrival keys {unknown}; "
                         f"valid: {sorted(valid)}")
    if kind == ARRIVAL_POISSON:
        return PoissonArrival()
    if "counts" not in d:
        raise ValueError("trace arrival needs per-tick 'counts'")
    return TraceArrival(counts=tuple(d["counts"]),
                        dt_us=float(d.get("dt_us", 1.0)),
                        repeat=bool(d.get("repeat", True)))
