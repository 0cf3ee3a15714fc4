"""FleetScope telemetry, port of ``repro.fleetsim.telemetry``: only the
scenario files' :class:`TelemetrySpec` so far.  The device-side trace ring,
the series and their decoders are not ported yet (``ROADMAP.md`` A9)."""

from repro_torch.fleetsim.telemetry.spec import TelemetrySpec

__all__ = ["TelemetrySpec"]
