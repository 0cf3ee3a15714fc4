"""The sweep grid's layout over devices: :class:`ShardSpec`.

Port of the spec half of ``repro.fleetsim.shard``: the layout object, its
validation and its JSON form, so :class:`~repro_torch.fleetsim.options.
EngineOptions` and sweep files can carry one.  Running a grid sharded over
several devices is not ported: ``simulate`` and ``sweep_grid`` raise
``NotImplementedError`` for a shard layout (ROADMAP.md A9).
"""

from __future__ import annotations

from dataclasses import dataclass

#: default mesh-axis name the grid is sharded over
GRID_AXIS = "grid"


@dataclass(frozen=True)
class ShardSpec:
    """How a sweep grid is laid out over devices.

    ``devices=0`` (the default) takes every visible device; an explicit
    count takes the first ``devices``.  ``axis`` names the mesh axis.
    Round-trips through JSON (:meth:`to_json` / :meth:`from_json`)."""

    devices: int = 0
    axis: str = GRID_AXIS

    def __post_init__(self):
        if self.devices < 0:
            raise ValueError("ShardSpec.devices must be >= 0 (0 = all)")
        if not self.axis or not isinstance(self.axis, str):
            raise ValueError("ShardSpec.axis must be a non-empty string")

    # --------------------------------------------------------------- JSON --
    def to_json(self) -> dict:
        return {"devices": self.devices, "axis": self.axis}

    @classmethod
    def from_json(cls, d: dict) -> "ShardSpec":
        unknown = sorted(set(d) - {"devices", "axis"})
        if unknown:
            raise ValueError(f"unknown shard keys {unknown}; "
                             "valid: ['axis', 'devices']")
        return cls(devices=int(d.get("devices", 0)),
                   axis=str(d.get("axis", GRID_AXIS)))


def as_shard(shard) -> ShardSpec | None:
    """Normalize a ``shard`` argument: ``None`` (unsharded), a device
    count, or a :class:`ShardSpec`."""
    if shard is None or isinstance(shard, ShardSpec):
        return shard
    if isinstance(shard, bool):
        return ShardSpec() if shard else None
    if isinstance(shard, int):
        return ShardSpec(devices=shard)
    raise TypeError(f"shard must be None, bool, int, or ShardSpec; "
                    f"got {type(shard).__name__}")
