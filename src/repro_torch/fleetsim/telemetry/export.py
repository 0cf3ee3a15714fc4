"""FleetScope exporters: Chrome-trace/Perfetto JSON and CSV artifacts (the
port's copy of ``repro.fleetsim.telemetry.export``).

The Chrome trace (load it at ``chrome://tracing`` or https://ui.perfetto.dev)
carries one *complete* (``"ph": "X"``) span per delivered request — ts at
the request's fabric arrival, duration its recorded latency — and one span
per clone copy placed (immediate, coordinator, or hedge-fired), so span
counts line up with the run counters of an unwrapped trace::

    #request spans == Metrics.n_completed
    #clone   spans == Metrics.n_cloned

Hedge cancels and filter drops ride along as instant (``"ph": "i"``)
events, and a :class:`~repro_torch.fleetsim.telemetry.decode.TickSeries` adds
Perfetto counter tracks (queue depth, per-window p99).  All timestamps are
microseconds — Chrome's native trace unit.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np

from repro_torch.fleetsim.telemetry.decode import (
    RunTelemetry,
    TickSeries,
    TraceEvents,
)
from repro_torch.fleetsim.telemetry.events import (
    EV_ARRIVAL,
    EV_CLIENT_COMPLETE,
    EV_CLONE,
    EV_FILTER_DROP,
    EV_HEDGE_ARMED,
    EV_HEDGE_CANCELLED,
    EV_SERVER_FINISH,
    EVENT_NAMES,
    SERIES_COUNTERS,
)

PID_REQUESTS = 1
PID_CLONES = 2
PID_SERIES = 3


def chrome_trace(events: TraceEvents, name: str = "fleetsim",
                 series: TickSeries | None = None) -> dict:
    """Build the Chrome-trace JSON document for one run's decoded events."""
    te: list[dict] = []
    for pid, pname in ((PID_REQUESTS, "requests"), (PID_CLONES, "clones"),
                       (PID_SERIES, "series")):
        te.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                   "args": {"name": f"{name}/{pname}"}})

    dt = events.dt_us
    # arrival time per REQ_ID (spans anchor at fabric arrival); a request
    # whose arrival record was overwritten falls back to completion - lat
    arrival_t: dict[int, float] = {}
    finish_t: dict[tuple[int, int], float] = {}
    for i in np.nonzero(events.kind == EV_SERVER_FINISH)[0]:
        finish_t[(int(events.rid[i]), int(events.server[i]))] = \
            float(events.tick[i]) * dt
    for i in np.nonzero(events.kind == EV_ARRIVAL)[0]:
        arrival_t.setdefault(int(events.rid[i]), float(events.tick[i]) * dt)

    for i in range(len(events)):
        k = int(events.kind[i])
        rid = int(events.rid[i])
        t = float(events.tick[i]) * dt
        if k == EV_CLIENT_COMPLETE:
            lat = max(float(events.arg[i]), dt)
            ts = arrival_t.get(rid, t - lat)
            te.append({"name": f"req {rid}", "cat": "request", "ph": "X",
                       "ts": ts, "dur": lat, "pid": PID_REQUESTS, "tid": rid,
                       "args": {"rid": rid, "client": int(events.client[i]),
                                "server": int(events.server[i]),
                                "latency_us": float(events.arg[i])}})
        elif k == EV_CLONE:
            dur = max(finish_t.get((rid, int(events.server[i])), t) - t, dt)
            te.append({"name": f"clone {rid}", "cat": "clone", "ph": "X",
                       "ts": t, "dur": dur, "pid": PID_CLONES, "tid": rid,
                       "args": {"rid": rid, "server": int(events.server[i]),
                                "clone_src": int(events.arg[i])}})
        elif k in (EV_HEDGE_ARMED, EV_HEDGE_CANCELLED, EV_FILTER_DROP):
            te.append({"name": EVENT_NAMES[k], "cat": "event", "ph": "i",
                       "s": "t", "ts": t, "pid": PID_REQUESTS, "tid": rid,
                       "args": {"rid": rid, "arg": int(events.arg[i])}})

    if series is not None:
        for w in range(series.n_windows):
            ts = float(series.t_end_us[w])
            te.append({"name": "queue_depth", "ph": "C", "ts": ts,
                       "pid": PID_SERIES, "tid": 0,
                       "args": {"mean": float(series.mean_queue_depth[w]),
                                "max": int(series.max_queue_depth[w])}})
            te.append({"name": "p99_us", "ph": "C", "ts": ts,
                       "pid": PID_SERIES, "tid": 0,
                       "args": {"p99": 0.0 if series.completed_win[w] == 0
                                else float(series.p99_us[w])}})

    return {"traceEvents": te, "displayTimeUnit": "ms",
            "metadata": {"tool": "fleetscope", "run": name,
                         "n_events": len(events),
                         "n_lost": events.n_lost}}


def _write_csv(path: Path, rows: list[dict]) -> None:
    keys: list[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, restval="")
        w.writeheader()
        w.writerows(rows)


def write_run(outdir, name: str, tel: RunTelemetry,
              summary: dict | None = None) -> dict[str, Path]:
    """Write one run's full export bundle under ``outdir/name/``:
    ``trace.json`` (Chrome trace), ``events.csv``, ``series.csv``, and
    ``summary.json`` (the result row + telemetry accounting)."""
    d = Path(outdir) / name
    d.mkdir(parents=True, exist_ok=True)
    paths = {
        "trace": d / "trace.json",
        "events": d / "events.csv",
        "series": d / "series.csv",
        "summary": d / "summary.json",
    }
    doc = chrome_trace(tel.events, name=name, series=tel.series)
    paths["trace"].write_text(json.dumps(doc) + "\n")
    _write_csv(paths["events"], tel.events.as_rows())
    _write_csv(paths["series"], tel.series.rows())
    paths["summary"].write_text(json.dumps({
        "run": name,
        "result": summary or {},
        "n_events": len(tel.events),
        "n_events_emitted": tel.events.n_emitted,
        "n_events_lost": tel.events.n_lost,
        "events_by_kind": tel.events.counts_by_kind(),
        "series_counters": list(SERIES_COUNTERS),
        "n_windows": tel.series.n_windows,
    }, indent=1) + "\n")
    return paths
