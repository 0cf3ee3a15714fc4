"""FleetScope in PyTorch: optional observability for the FleetSim engine,
port of ``repro.fleetsim.telemetry``.

Three layers, all gated by the static ``FleetConfig.telemetry`` flag like
the coordinator / hedge-timer stages (flag off ⇒ no op of them runs, and
the tick is the one it always was):

* **device** — the telemetry state carried through the ticks: a
  request-event ring buffer (:class:`TraceBuffer`) written by ``emit()``
  calls inside the stages, and the windowed time-series accumulator
  (:class:`SeriesState`), each with a leading config axis;
* **decode** — host-side views: chronological :class:`TraceEvents`,
  per-request timelines, and the per-window :class:`TickSeries`;
* **export** — Chrome-trace/Perfetto JSON + CSV artifact bundles
  (:func:`write_run`).

:class:`TelemetrySpec` is the declarative knob block scenarios carry.
Telemetry is a pure observer: it draws no random numbers and feeds nothing
back, so a telemetry-on run reproduces every ``Metrics`` counter of the
telemetry-off run bit for bit.  It runs on the staged backend only, as in
the reference, and the sharded runner refuses it, as the reference's
does.
"""

from repro_torch.fleetsim.telemetry.decode import (
    RunTelemetry,
    TickSeries,
    TraceEvents,
    decode_run,
    decode_series,
    decode_trace,
)
from repro_torch.fleetsim.telemetry.device import (
    SeriesState,
    TraceBuffer,
    emit,
    init_series_state,
    init_trace_buffer,
    series_record_hist,
    series_tick,
)
from repro_torch.fleetsim.telemetry.events import (
    EVENT_ARG,
    EVENT_NAMES,
    SERIES_COUNTERS,
)
from repro_torch.fleetsim.telemetry.export import chrome_trace, write_run
from repro_torch.fleetsim.telemetry.spec import TelemetrySpec

__all__ = [
    "EVENT_ARG",
    "EVENT_NAMES",
    "SERIES_COUNTERS",
    "RunTelemetry",
    "SeriesState",
    "TelemetrySpec",
    "TickSeries",
    "TraceBuffer",
    "TraceEvents",
    "chrome_trace",
    "decode_run",
    "decode_series",
    "decode_trace",
    "emit",
    "init_series_state",
    "init_trace_buffer",
    "series_record_hist",
    "series_tick",
    "write_run",
]
