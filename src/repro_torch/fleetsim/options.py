"""EngineOptions: one knob object selecting FleetSim's execution path.

Port of ``repro.fleetsim.options``.  The entry point is

    repro_torch.fleetsim.simulate(cfg, params, *, options=EngineOptions(...))

Backends
--------
``'staged'``
    The tick loop on the host: one Python call per tick, each tick's
    stages launched op by op (:func:`repro_torch.fleetsim.engine.advance`).
``'fused'``
    The chunked backend (:mod:`repro_torch.fleetsim.fused`): ``K`` ticks a
    chunk with the integer state dtype-packed at chunk boundaries; on a
    CUDA run the ticks of a chunk replay from one captured CUDA graph.
    **Bit-identical** to ``'staged'``, with or without the coordinator and
    hedge-timer stages and the batch server.  Telemetry is staged-only.
``'auto'``
    ``'fused'`` on a CUDA run, ``'staged'`` on the CPU and for telemetry.
    The reference routes coordinator, hedge-timer and batch-server configs
    to its staged backend, a compiled ``lax.scan``; the port's staged
    backend dispatches every op from the host, so on a card those configs
    run fused, with the same results (``ROADMAP.md`` C8).

``telemetry=True`` makes :func:`~repro_torch.fleetsim.engine.simulate`
return ``(metrics, trace, series)`` (needs ``cfg.telemetry``).  ``shard``
lays a batched run over devices (:mod:`repro_torch.fleetsim.shard`); it
refuses telemetry, as in the reference.  ``donate`` is accepted for the
reference's API and has no effect in the port: the engine never writes
into the caller's ``params``.

The JSON form (:meth:`to_json` / :meth:`from_json`) is the strict-keyed
``engine`` sub-object scenario and sweep files carry.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.fleetsim.shard import ShardSpec, as_shard

#: execution backends selectable via EngineOptions.backend
BACKENDS = ("auto", "fused", "staged")

_TELEMETRY_SHARD_ERROR = (
    "telemetry is not supported on the sharded runner (the trace ring would "
    "be sharded too and its per-device rings cannot be merged into one "
    "chronological stream); drop shard= or telemetry=")


def _accel_default_backend(device=None) -> str:
    """What 'auto' resolves to for a run on ``device`` (``None``: the
    device the port's entry points default to, CUDA when there is one)."""
    if device is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = torch.device(device)
    return "fused" if dev.type == "cuda" else "staged"


@dataclass(frozen=True)
class EngineOptions:
    """How one :func:`repro_torch.fleetsim.simulate` call executes.

    ``backend`` picks staged vs fused (see module docstring);
    ``ticks_per_chunk`` sets the fused backend's K (0 → 512, clipped to
    ``n_ticks``); results are K-independent.  ``telemetry`` returns the
    trace ring and series beside the metrics; ``shard`` and ``donate`` as
    in the reference (see module docstring)."""

    backend: str = "auto"
    shard: ShardSpec | None = None
    telemetry: bool = False
    donate: bool = False
    ticks_per_chunk: int = 0

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"valid: {list(BACKENDS)}")
        object.__setattr__(self, "shard", as_shard(self.shard))
        if self.telemetry and self.shard is not None:
            raise ValueError(_TELEMETRY_SHARD_ERROR)
        if self.ticks_per_chunk < 0:
            raise ValueError("ticks_per_chunk must be >= 0 (0 = auto)")

    # ------------------------------------------------------------ resolve --
    def resolve_backend(self, cfg, device=None) -> str:
        """The concrete backend ('staged' | 'fused') for ``cfg`` on
        ``device``.  ``'fused'`` raises for telemetry, which is
        staged-only; ``'auto'`` falls back to ``'staged'`` for it and on
        the CPU."""
        if self.backend == "staged":
            return "staged"
        telemetry = self.telemetry or cfg.telemetry
        if self.backend == "fused":
            if telemetry:
                raise ValueError(
                    "backend='fused' does not support telemetry (FleetScope)"
                    "; use backend='staged' (or 'auto', which falls back)")
            return "fused"
        if telemetry:
            return "staged"
        return _accel_default_backend(device)

    # --------------------------------------------------------------- JSON --
    def to_json(self) -> dict:
        d: dict = {"backend": self.backend}
        if self.ticks_per_chunk:
            d["ticks_per_chunk"] = self.ticks_per_chunk
        return d

    _JSON_KEYS = ("backend", "ticks_per_chunk")

    @classmethod
    def from_json(cls, d: dict) -> "EngineOptions":
        unknown = sorted(set(d) - set(cls._JSON_KEYS))
        if unknown:
            # a misspelled knob must not silently run a different engine
            raise ValueError(f"unknown engine keys {unknown}; "
                             f"valid: {sorted(cls._JSON_KEYS)}")
        return cls(backend=str(d.get("backend", "auto")),
                   ticks_per_chunk=int(d.get("ticks_per_chunk", 0)))
