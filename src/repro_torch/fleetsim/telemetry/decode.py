"""Host-side FleetScope decode: ring buffer → events, series → TickSeries
(the port's copy of ``repro.fleetsim.telemetry.decode``).

Everything here operates on one run's telemetry state (one config's row of
the batched :class:`~repro_torch.fleetsim.telemetry.device.TraceBuffer` /
``SeriesState``, as tensors on any device or numpy arrays) and produces
plain numpy/dataclass views: chronological :class:`TraceEvents`,
per-request timelines, and the windowed :class:`TickSeries` whose
per-window rates come from differencing the cumulative counter snapshots.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.fleetsim.config import FleetConfig
from repro_torch.fleetsim.metrics import bin_mids_us, hist_percentile
from repro_torch.fleetsim.telemetry.events import (
    EVENT_ARG,
    EVENT_NAMES,
    REC_ARG,
    REC_CLIENT,
    REC_KIND,
    REC_RID,
    REC_SERVER,
    REC_TICK,
    SERIES_COUNTERS,
)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


@dataclass
class TraceEvents:
    """Chronologically-ordered decoded trace records of one run.

    When the run emitted more records than the ring buffer holds, the
    *oldest* ``n_lost`` records were overwritten and only the latest
    ``len(tick)`` survive — consistency checks against run counters
    (``count(kind) == Metrics.n_*``) hold only for unwrapped runs.
    """

    tick: np.ndarray          # (N,) int32
    kind: np.ndarray          # (N,) int32 — EV_* (telemetry.events)
    rid: np.ndarray           # (N,) int32 — REQ_ID, -1 if not request-scoped
    server: np.ndarray        # (N,) int32 — fabric-global server id or -1
    client: np.ndarray        # (N,) int32 — client id or -1
    arg: np.ndarray           # (N,) int32 — kind-specific (EVENT_ARG)
    n_emitted: int            # total records the run produced
    n_lost: int               # overwritten by the ring (= n_emitted - N)
    dt_us: float
    n_servers: int            # per rack — rack = server // n_servers

    def __len__(self) -> int:
        return len(self.tick)

    @property
    def t_us(self) -> np.ndarray:
        return self.tick.astype(np.float64) * self.dt_us

    @property
    def rack(self) -> np.ndarray:
        """Rack of the involved server (-1 where no server is involved)."""
        return np.where(self.server >= 0, self.server // self.n_servers, -1)

    def counts_by_kind(self) -> dict[str, int]:
        kinds, counts = np.unique(self.kind, return_counts=True)
        return {EVENT_NAMES.get(int(k), f"kind{int(k)}"): int(c)
                for k, c in zip(kinds, counts)}

    def select(self, kind: int) -> "TraceEvents":
        m = self.kind == kind
        return TraceEvents(
            tick=self.tick[m], kind=self.kind[m], rid=self.rid[m],
            server=self.server[m], client=self.client[m], arg=self.arg[m],
            n_emitted=self.n_emitted, n_lost=self.n_lost, dt_us=self.dt_us,
            n_servers=self.n_servers)

    def timelines(self) -> dict[int, list[dict]]:
        """Per-request event timelines: REQ_ID → chronological event rows
        (request-scoped events only; decode order is emit order, so
        same-tick events keep their pipeline-stage order)."""
        out: dict[int, list[dict]] = {}
        for row in self.as_rows():
            if row["rid"] >= 0:
                out.setdefault(row["rid"], []).append(row)
        return out

    def as_rows(self) -> list[dict]:
        """Flat list-of-dict view (CSV/JSON friendly)."""
        rows = []
        for i in range(len(self.tick)):
            k = int(self.kind[i])
            rows.append({
                "tick": int(self.tick[i]),
                "t_us": float(self.tick[i]) * self.dt_us,
                "event": EVENT_NAMES.get(k, f"kind{k}"),
                "rid": int(self.rid[i]),
                "server": int(self.server[i]),
                "rack": int(self.server[i]) // self.n_servers
                if self.server[i] >= 0 else -1,
                "client": int(self.client[i]),
                EVENT_ARG.get(k, "arg"): int(self.arg[i]),
            })
        return rows


def decode_trace(cfg: FleetConfig, trace) -> TraceEvents:
    """Unroll one run's ring buffer into chronological event arrays.

    ``trace`` is one run's :class:`TraceBuffer` (or any ``(count, data)``
    pair); for a batch, index the config row out first.
    """
    count = int(_host(trace.count))
    data = _host(trace.data)
    cap = data.shape[0]
    if count <= cap:
        recs = data[:count]
        lost = 0
    else:
        head = count % cap            # oldest surviving record
        recs = np.concatenate([data[head:], data[:head]], axis=0)
        lost = count - cap
    return TraceEvents(
        tick=recs[:, REC_TICK], kind=recs[:, REC_KIND], rid=recs[:, REC_RID],
        server=recs[:, REC_SERVER], client=recs[:, REC_CLIENT],
        arg=recs[:, REC_ARG], n_emitted=count, n_lost=lost, dt_us=cfg.dt_us,
        n_servers=cfg.n_servers)


@dataclass
class TickSeries:
    """Windowed time-series of one run (window = ``cfg.window_ticks``).

    ``rates`` holds *per-window increments* of each ``SERIES_COUNTERS``
    field (cumulative end-of-window snapshots, differenced), so
    ``rates[f].sum() == final Metrics.<f>`` exactly.  Queue gauges are the
    per-window mean/max of the fabric-total / per-server queue depth, and
    the latency columns come from the per-window in-measurement-window
    histogram rows (same log-spaced bins as the run histogram).
    """

    window_ticks: int
    dt_us: float
    t_end_us: np.ndarray                       # (W,) window end times
    rates: dict[str, np.ndarray]               # field → (W,) increments
    mean_queue_depth: np.ndarray               # (W,) fabric-total mean
    max_queue_depth: np.ndarray                # (W,) per-server max
    completed_win: np.ndarray                  # (W,) recorded latencies
    p50_us: np.ndarray                         # (W,) NaN when empty
    p99_us: np.ndarray
    hist: np.ndarray = field(repr=False, default=None)  # (W, hist_bins)

    @property
    def n_windows(self) -> int:
        return len(self.t_end_us)

    def rows(self) -> list[dict]:
        out = []
        for w in range(self.n_windows):
            row = {"window": w, "t_end_us": float(self.t_end_us[w])}
            row.update({f: int(self.rates[f][w]) for f in SERIES_COUNTERS})
            row.update({
                "mean_queue_depth": round(float(self.mean_queue_depth[w]), 3),
                "max_queue_depth": int(self.max_queue_depth[w]),
                "completed_win": int(self.completed_win[w]),
                "p50_us": round(float(self.p50_us[w]), 1),
                "p99_us": round(float(self.p99_us[w]), 1),
            })
            out.append(row)
        return out


def decode_series(cfg: FleetConfig, series) -> TickSeries:
    """Reduce one run's device series state to a :class:`TickSeries`."""
    counters = _host(series.counters)            # (W, NC) cumulative
    qsum = _host(series.qsum).astype(np.float64)
    qmax = _host(series.qmax)
    hist = _host(series.hist)                    # (W, hist_bins)
    W = counters.shape[0]
    # per-window increments from the cumulative end-of-window snapshots
    prev = np.vstack([np.zeros((1, counters.shape[1]), counters.dtype),
                      counters[:-1]])
    deltas = counters - prev
    rates = {f: deltas[:, i] for i, f in enumerate(SERIES_COUNTERS)}
    # window lengths (the last window may be partial)
    starts = np.arange(W) * cfg.window_ticks
    lengths = np.minimum(cfg.window_ticks, cfg.n_ticks - starts)
    mids = bin_mids_us(cfg)
    p50 = np.array([hist_percentile(hist[w], mids, 50.0) for w in range(W)])
    p99 = np.array([hist_percentile(hist[w], mids, 99.0) for w in range(W)])
    return TickSeries(
        window_ticks=cfg.window_ticks,
        dt_us=cfg.dt_us,
        t_end_us=(starts + lengths) * cfg.dt_us,
        rates=rates,
        mean_queue_depth=qsum / lengths,
        max_queue_depth=qmax,
        completed_win=hist.sum(axis=1),
        p50_us=p50,
        p99_us=p99,
        hist=hist,
    )


@dataclass
class RunTelemetry:
    """One run's decoded observability bundle (events + time-series)."""

    events: TraceEvents
    series: TickSeries

    def chrome_trace(self, name: str = "fleetsim") -> dict:
        from repro_torch.fleetsim.telemetry.export import chrome_trace

        return chrome_trace(self.events, name=name)


def decode_run(cfg: FleetConfig, trace, series) -> RunTelemetry:
    """Decode one run's telemetry state pair."""
    return RunTelemetry(events=decode_trace(cfg, trace),
                        series=decode_series(cfg, series))
