"""Declarative telemetry knobs: the ``telemetry`` sub-object of a Scenario;
the port's copy of ``repro.fleetsim.telemetry.spec``.

:class:`TelemetrySpec` freezes the FleetScope configuration a scenario file
asks for — whether the observability stages run, the ring-buffer depth,
and the time-series window — and maps it onto the static
:class:`~repro_torch.fleetsim.config.FleetConfig` flags.  JSON round-trip
is strict-keyed like ``Scenario``/``SweepSpec``: a misspelled knob raises
instead of silently tracing a different experiment.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.fleetsim.config import FleetConfig


@dataclass(frozen=True)
class TelemetrySpec:
    """Scenario-level FleetScope settings (``0`` keeps the config default)."""

    enabled: bool = True
    trace_cap: int = 0       # ring-buffer records; 0 → FleetConfig default
    window_ticks: int = 0    # series window (ticks); 0 → FleetConfig default

    def __post_init__(self):
        if self.trace_cap < 0:
            raise ValueError("trace_cap must be >= 0 (0 = default)")
        if self.window_ticks < 0:
            raise ValueError("window_ticks must be >= 0 (0 = default)")

    def apply(self, cfg: FleetConfig) -> FleetConfig:
        """Flip the static telemetry flags onto a built config.  A disabled
        spec returns ``cfg`` unchanged, preserving the exact flag-off
        program."""
        if not self.enabled:
            return cfg
        kw: dict = {"telemetry": True}
        if self.trace_cap:
            kw["trace_cap"] = self.trace_cap
        if self.window_ticks:
            kw["window_ticks"] = min(self.window_ticks, cfg.n_ticks)
        return replace(cfg, **kw)

    # --------------------------------------------------------------- JSON --
    _JSON_KEYS = ("enabled", "trace_cap", "window_ticks")

    def to_json(self) -> dict:
        d: dict = {"enabled": self.enabled}
        if self.trace_cap:
            d["trace_cap"] = self.trace_cap
        if self.window_ticks:
            d["window_ticks"] = self.window_ticks
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TelemetrySpec":
        unknown = sorted(set(d) - set(cls._JSON_KEYS))
        if unknown:
            raise ValueError(f"unknown telemetry keys {unknown}; "
                             f"valid: {sorted(cls._JSON_KEYS)}")
        return cls(enabled=bool(d.get("enabled", True)),
                   trace_cap=int(d.get("trace_cap", 0)),
                   window_ticks=int(d.get("window_ticks", 0)))
