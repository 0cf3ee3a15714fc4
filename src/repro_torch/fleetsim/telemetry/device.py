"""Device-side FleetScope state: the trace ring buffer + windowed series.

Port of ``repro.fleetsim.telemetry.device`` with the config axis written
out: every tensor leads with ``G`` (one configuration per row), where the
reference ``vmap``s one run's state.  Both sub-states ride in
:class:`~repro_torch.fleetsim.state.FleetState` like the coordinator and
hedge-wheel states: ``None`` when ``FleetConfig.telemetry`` is off (a
flag-off tick runs no op of them), live tensors advanced by the emit points
in ``stages.py`` when it is on.  Telemetry is an *observer*: it draws no
random numbers and never feeds back into routing, service or filtering, so
a telemetry-on run leaves every ``Metrics`` counter bit-identical to the
telemetry-off run (``tests/test_torch_telemetry.py``).

The ring buffer is a flight recorder: ``count`` is the total number of
records ever emitted, ``data`` the last ``trace_cap`` of them (oldest
overwritten first).  The host-side decoder reconstructs chronological order
from ``count % cap`` and reports ``count - cap`` lost records when the run
outgrew the buffer.  The tensors are updated in place where the reference
returns new arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.fleetsim.config import FleetConfig
from repro_torch.fleetsim.telemetry.events import REC, SERIES_COUNTERS
from repro_torch.scatter import scatter_add_drop, scatter_last

_I32 = torch.int32


class TraceBuffer(NamedTuple):
    """Request-event flight recorder (see ``telemetry.events`` for layout)."""

    count: torch.Tensor  # (G,) int32 — total records emitted (may exceed cap)
    data: torch.Tensor   # (G, trace_cap, REC) int32 ring of the latest records


class SeriesState(NamedTuple):
    """Per-window time-series accumulators (window = ``cfg.window_ticks``).

    ``counters`` rows are *cumulative* ``Metrics`` snapshots taken at every
    tick of the window (the last tick's write survives, i.e. the
    end-of-window value); differencing adjacent rows host-side yields
    per-window rates without carrying any per-tick delta state.
    """

    counters: torch.Tensor  # (G, n_windows, len(SERIES_COUNTERS)) int32
    qsum: torch.Tensor      # (G, n_windows) int32 — Σ over ticks of queued
    qmax: torch.Tensor      # (G, n_windows) int32 — max per-server depth
    hist: torch.Tensor      # (G, n_windows, hist_bins) int32 — latencies


def init_trace_buffer(cfg: FleetConfig, g: int, device=None) -> TraceBuffer:
    return TraceBuffer(
        count=torch.zeros((g,), dtype=_I32, device=device),
        data=torch.zeros((g, cfg.trace_cap, REC), dtype=_I32, device=device))


def init_series_state(cfg: FleetConfig, g: int, device=None) -> SeriesState:
    w = cfg.n_windows

    def z(*shape):
        return torch.zeros((g, *shape), dtype=_I32, device=device)

    return SeriesState(counters=z(w, len(SERIES_COUNTERS)), qsum=z(w),
                       qmax=z(w), hist=z(w, cfg.hist_bins))


def emit(trace: TraceBuffer, mask: torch.Tensor, *, tick, kind, rid,
         server=None, client=None, arg=None) -> TraceBuffer:
    """Append one record per True lane of ``mask`` ``(G, N)`` to each
    config's ring buffer.

    ``tick`` is a Python int or a 0-d tensor, ``kind`` an int;
    ``rid``/``server``/``client``/``arg`` are ints or tensors that
    broadcast to ``(G, N)`` (a per-config value as ``(G, 1)``; ``None`` →
    -1/0 filler).  Lanes keep their order: the i-th active lane lands
    ``i`` slots past the config's write head, so within-tick ordering
    mirrors stage order.  Oldest records are overwritten when the buffer
    is full — ``count`` keeps the true total."""
    g, n = mask.shape
    cap = trace.data.shape[1]
    dev = mask.device

    def col(v, fill):
        if v is None:
            v = fill
        if not isinstance(v, torch.Tensor):
            return torch.full((g, n), v, dtype=_I32, device=dev)
        return v.to(_I32).expand(g, n)

    rows = torch.stack([col(tick, 0), col(kind, 0), col(rid, -1),
                        col(server, -1), col(client, -1), col(arg, 0)],
                       dim=2)                   # (G, N, REC)
    m = mask.to(torch.int64)
    rank = torch.cumsum(m, dim=1) - m
    pos = (trace.count.to(torch.int64)[:, None] + rank) % cap
    scatter_last(trace.data, pos, rows, mask)
    return TraceBuffer(count=(trace.count + mask.sum(dim=1)).to(_I32),
                       data=trace.data)


def series_record_hist(series: SeriesState, window, bins: torch.Tensor,
                       recorded: torch.Tensor) -> SeriesState:
    """Add this tick's recorded-latency bins ``(G, K)`` (lanes where
    ``recorded``) to the window's histogram row.  The reference passes
    out-of-range bins for unrecorded lanes and drops them; here the mask
    drops them, and bins out of range are dropped too."""
    g, w, nb = series.hist.shape
    keep = recorded & (bins >= 0) & (bins < nb)
    scatter_add_drop(series.hist.view(g, w * nb), window * nb + bins, 1,
                     keep)
    return series


def series_tick(cfg: FleetConfig, series: SeriesState, metrics,
                queue_count: torch.Tensor, tick) -> SeriesState:
    """End-of-tick series update: snapshot the cumulative counters into the
    window row (last tick of the window wins) and accumulate queue-depth
    sum/max for the window's mean/max gauges.  ``queue_count`` is
    ``(G, ...)``; ``tick`` a Python int (telemetry runs on the staged
    loop only)."""
    g = queue_count.shape[0]
    snap = torch.stack([getattr(metrics, f).to(_I32)
                        for f in SERIES_COUNTERS], dim=1)    # (G, NC)
    flat = queue_count.reshape(g, -1)
    w = tick // cfg.window_ticks
    series.counters[:, w] = snap
    series.qsum[:, w] += flat.sum(dim=1, dtype=_I32)
    series.qmax[:, w] = torch.maximum(series.qmax[:, w],
                                      flat.amax(dim=1).to(_I32))
    return series
