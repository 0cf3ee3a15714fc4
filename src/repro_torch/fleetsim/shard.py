"""ShardSweep: the sweep grid axis laid out over devices; port of
``repro.fleetsim.shard``.

The unsharded engine runs a whole policy × load × seed (× hedge-delay)
grid as one batch on one device.  This module is the multi-device path —
``simulate(cfg, params, options=EngineOptions(shard=...))`` and
``sweep_grid(shard=...)``: the grid is cut into contiguous **slabs of
configurations**, one a device of the spec's ordered device list
(:meth:`ShardSpec.mesh`), and each slab advances with the per-config
program of the unsharded engine (staged or fused, through
:func:`~repro_torch.fleetsim.engine.run_state`).  Configurations are
independent, so the only traffic between devices is the histogram merge.

Three pieces, as in the reference:

* **padding + masking** (:func:`plan_grid`) — a grid whose size does not
  divide the device count is padded by repeating its last row (a valid
  configuration), and a boolean mask rides with it; padded rows are
  masked out of the histogram merge and stripped before results reach
  the host;
* **the merge** (:attr:`ShardedMetrics.grid_hist`) — each slab sums the
  latency histograms of its own masked rows on its device, and the slabs'
  sums are added on the first device: the counterpart of the reference's
  ``psum`` over the mesh axis;
* **devices** — in one process, on a card, ``devices=0`` takes every
  visible CUDA device and ``devices=n`` the first ``n``, but more than one
  CUDA device is refused (:data:`MAX_CUDA_DEVICES`: several cards take one
  process each); a caller that asks for the CPU may pass ``devices=n`` and
  gets ``n`` CPU slabs, so the CPU tests exercise pad → split → run →
  strip → merge, as the reference's forced XLA host devices do.  Those
  slabs run one after another from one host thread, each under its own
  device guard (so its placement, graph capture and replays use its
  device's streams).
* **ranks** — where a ``torch.distributed`` process group of W is up (one
  process a device: ``torchrun``, NCCL on ``cuda:LOCAL_RANK`` or gloo on
  the CPU), the mesh is the W ranks (``devices=0``; an explicit count must
  be W): rank ``r`` runs slab ``r`` on its own device, the histogram merge
  is an all-reduce of the masked local sums over the group (the
  reference's ``psum``), and the slabs' :class:`Metrics` are all-gathered,
  so every rank returns the same :class:`ShardedMetrics`, pad stripped.

Each cell runs the same per-config program, so sharded results are
bit-identical to the unsharded run per configuration
(:func:`repro_torch.fleetsim.validate.shard_equivalence`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.fleetsim.config import FleetConfig
from repro_torch.fleetsim.engine import RunParams, batched_params, run_state
from repro_torch.fleetsim.fused import GraphStats
from repro_torch.fleetsim.state import Metrics
from repro_torch.launch.ranks import on_ranks, rank_device
from repro_torch.sharding import collectives

#: default mesh-axis name the grid is sharded over
GRID_AXIS = "grid"

#: the most CUDA devices a sharded run takes in one process; several cards
#: run one process (rank) each
MAX_CUDA_DEVICES = 1

_TELEMETRY_ERROR = (
    "telemetry is not supported on the sharded runner (the trace ring "
    "would be sharded too and its per-device rings cannot be merged into "
    "one chronological stream); run the traced config unsharded, or drop "
    "cfg.telemetry for the sharded sweep")


@dataclass(frozen=True)
class ShardSpec:
    """How a sweep grid is laid out over devices.

    ``devices=0`` (the default) takes every visible device; an explicit
    count takes the first ``devices``.  ``axis`` names the mesh axis.
    Round-trips through JSON (:meth:`to_json` / :meth:`from_json`) so a
    :class:`repro_torch.scenarios.SweepSpec` can carry its layout."""

    devices: int = 0
    axis: str = GRID_AXIS

    def __post_init__(self):
        if self.devices < 0:
            raise ValueError("ShardSpec.devices must be >= 0 (0 = all)")
        if not self.axis or not isinstance(self.axis, str):
            raise ValueError("ShardSpec.axis must be a non-empty string")

    def resolve_devices(self, device=None) -> list[torch.device]:
        """The concrete device list this spec runs on (validated): under a
        process group, one entry a rank, each rank's its own device
        (``devices`` must be 0 or W); else the first ``devices`` visible
        CUDA devices (all of them for 0), or, for a run the caller put on
        the CPU, ``devices`` CPU slabs (one for 0)."""
        if on_ranks():
            return [rank_device(device)] * self._ranks()
        dev = resolve_device(device)
        if dev.type == "cpu":
            return [dev] * (self.devices or 1)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        n = self.devices or len(devs)
        if n > len(devs):
            raise ValueError(
                f"ShardSpec wants {n} devices but only {len(devs)} CUDA "
                f"devices are visible")
        if n > MAX_CUDA_DEVICES:
            raise ValueError(
                f"ShardSpec resolves to {n} CUDA devices in one process; run "
                f"one process a card (python -m torch.distributed.run "
                f"--nproc-per-node {n} ...) or pass ShardSpec(devices=1)")
        return devs[:n]

    def _ranks(self) -> int:
        w = dist.get_world_size()
        if self.devices not in (0, w):
            raise ValueError(f"ShardSpec wants {self.devices} devices; the "
                             f"process group has {w} ranks (pass 0 or {w})")
        return w

    def mesh(self, device=None) -> list[torch.device]:
        """The 1-D device mesh: the ordered device list, slab ``i`` on
        ``mesh[i]``."""
        return self.resolve_devices(device)

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


class GridPlan(NamedTuple):
    """A padded grid laid out on a device mesh (host-side plan)."""

    mesh: list            # the ordered devices, one slab each
    params: RunParams     # leading axis padded to a multiple of len(mesh)
    mask: torch.Tensor    # (padded,) bool — True for real grid rows
    n_grid: int           # true grid size (rows the caller asked for)
    n_pad: int            # rows appended to divide evenly


class ShardedMetrics(NamedTuple):
    """Per-configuration metrics plus the merged aggregate."""

    metrics: Metrics      # every leaf has leading axis n_grid (pad stripped)
    # (n_racks, hist_bins) — the grid-total latency histogram: each slab's
    # masked sum on its device, added across slabs on the first device
    grid_hist: torch.Tensor


def grid_size(params: RunParams) -> int:
    """Leading-axis length of a batched :class:`RunParams`."""
    return int(params.policy_id.shape[0])


def pad_params(params: RunParams,
               n_shards: int) -> tuple[RunParams, torch.Tensor, int]:
    """Pad the grid axis to a multiple of ``n_shards`` and build the mask.

    Padding repeats the **last row** — a valid configuration, so the padded
    rows run a well-defined program (their results are masked out of the
    merge and sliced away before the host sees them).  Returns
    ``(padded_params, mask, n_pad)`` with ``mask`` True on real rows."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    g = grid_size(params)
    if g < 1:
        raise ValueError("cannot shard an empty grid")
    n_pad = (-g) % n_shards
    params = RunParams(*(torch.as_tensor(a) for a in params))
    if n_pad:
        params = RunParams(*(
            torch.cat([a, a[-1:].expand(n_pad, *a.shape[1:])])
            for a in params))
    mask = torch.arange(g + n_pad, device=params.policy_id.device) < g
    return params, mask, n_pad


def plan_grid(params: RunParams, spec: ShardSpec, device=None) -> GridPlan:
    """Resolve ``spec``'s mesh for a run on ``device`` and pad ``params``
    to divide it."""
    mesh = spec.mesh(device)
    g = grid_size(params)
    params, mask, n_pad = pad_params(params, len(mesh))
    return GridPlan(mesh=mesh, params=params, mask=mask, n_grid=g,
                    n_pad=n_pad)


def _on(dev: torch.device):
    """The device guard a slab runs under: ``dev`` made the current CUDA
    device (streams, graph capture and replays), nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _merge_stats(into: GraphStats, parts: list[GraphStats],
                 place_s: float) -> None:
    into.ticks = max(s.ticks for s in parts)
    into.replays = sum(s.replays for s in parts)
    into.warmup_s = sum(s.warmup_s for s in parts)
    into.capture_s = sum(s.capture_s for s in parts)
    into.instantiate_s = sum(s.instantiate_s for s in parts)
    into.place_s = place_s


@dataclass
class ShardedProgram:
    """The sharded runner set up for one plan (:func:`lower_sharded`):
    each slab's params and mask already on its device, the placement's
    seconds in :attr:`setup_s`.  Calling it runs every slab and merges."""

    cfg: FleetConfig
    plan: GridPlan
    backend: str
    ticks_per_chunk: int
    #: ``[(device, RunParams, mask)]``: every slab in one process, this
    #: rank's alone under a process group
    slabs: list = field(repr=False)
    setup_s: float = 0.0
    #: the ranks run one slab each (:func:`on_ranks`)
    ranks: bool = False

    def __call__(self, stats: GraphStats | None = None) -> ShardedMetrics:
        """Run every slab and merge; ``stats`` receives the fused graphs'
        set-up and replays over this process's slabs and the placement's
        seconds."""
        from repro_torch.fleetsim.options import EngineOptions

        opts = EngineOptions(backend=self.backend,
                             ticks_per_chunk=self.ticks_per_chunk)
        first = self.slabs[0][0]
        parts, hist, slab_stats = [], None, []
        for dev, p, m in self.slabs:
            st = GraphStats()
            with _on(dev):
                # each slab: the per-config program of the unsharded
                # engine …
                state, _, _ = run_state(self.cfg, p, dev, opts, st)
                met = state.metrics
                # … and its masked histogram sum, reduced on its device
                keep = m.to(met.hist.dtype)[:, None, None]
                local = (met.hist * keep).sum(dim=0, dtype=met.hist.dtype)
            local = local.to(first)
            hist = local if hist is None else hist + local
            parts.append(met)
            slab_stats.append(st)
        if stats is not None:
            _merge_stats(stats, slab_stats, self.setup_s)
        if self.ranks:
            # the reference's psum over the mesh axis, and the whole grid's
            # rows on every rank
            with _on(first):
                hist = collectives.all_reduce_sum(hist, None)
                metrics = Metrics(*(collectives.all_gather(x, 0, None)
                                    for x in parts[0]))
        else:
            metrics = Metrics(*(torch.cat([x.to(first) for x in leaves])
                                for leaves in zip(*parts)))
        return ShardedMetrics(metrics=_strip_pad(self.plan, metrics),
                              grid_hist=hist)


def lower_sharded(cfg: FleetConfig, plan: GridPlan, backend: str = "staged",
                  ticks_per_chunk: int = 0) -> ShardedProgram:
    """Set the sharded runner up for ``plan``: cut the padded grid into one
    contiguous slab a device and place each slab's params and mask there.
    Sweeps time this (and the fused graphs' capture, which the first
    replay of each slab does) apart from the run, as
    ``SweepResult.compile_s``."""
    if cfg.telemetry:
        raise ValueError(_TELEMETRY_ERROR)
    t0 = time.perf_counter()
    n = len(plan.mesh)
    rows = grid_size(plan.params) // n
    ranks = on_ranks()
    mine = [dist.get_rank()] if ranks else range(n)
    slabs = []
    for i in mine:
        dev = plan.mesh[i]
        sl = slice(i * rows, (i + 1) * rows)
        with _on(dev):
            p, _ = batched_params(RunParams(*(a[sl] for a in plan.params)),
                                  dev)
            slabs.append((dev, p, plan.mask[sl].to(dev)))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return ShardedProgram(cfg=cfg, plan=plan, backend=backend,
                          ticks_per_chunk=ticks_per_chunk, slabs=slabs,
                          setup_s=time.perf_counter() - t0, ranks=ranks)


def _strip_pad(plan: GridPlan, metrics: Metrics) -> Metrics:
    return Metrics(*(a[:plan.n_grid] for a in metrics))


def run_sharded(cfg: FleetConfig, params: RunParams, spec: ShardSpec, *,
                backend: str = "staged", ticks_per_chunk: int = 0,
                device=None, stats: GraphStats | None = None
                ) -> ShardedMetrics:
    """The sharded execution path behind ``simulate(..., options=
    EngineOptions(shard=...))`` and ``sweep_grid(shard=...)``: pads the
    grid onto ``spec``'s mesh for a run on ``device`` and runs every slab
    on the selected backend; per-configuration results are bit-identical
    to the unsharded run.  ``stats`` receives the set-up (placement and
    fused graphs, over all slabs) and the replays."""
    if cfg.telemetry:
        raise ValueError(_TELEMETRY_ERROR)
    plan = plan_grid(params, spec, device)
    return lower_sharded(cfg, plan, backend, ticks_per_chunk)(stats)


def simulate_batch_sharded(cfg: FleetConfig, params: RunParams, shard=None,
                           *, device=None) -> ShardedMetrics:
    """Deprecated, as in the reference: use ``simulate(cfg, params,
    options=EngineOptions(shard=...))``.  ``shard=None`` runs the staged
    batch program unsharded, its aggregate histogram summed from its
    output; any other ``shard`` runs :func:`run_sharded` staged."""
    import warnings

    warnings.warn(
        "repro_torch.fleetsim.simulate_batch_sharded(cfg, params, shard) is "
        "deprecated; use simulate(cfg, params, options="
        "EngineOptions(shard=shard))", DeprecationWarning, stacklevel=2)
    spec = as_shard(shard)
    if cfg.telemetry and spec is not None:
        raise ValueError(_TELEMETRY_ERROR)
    if spec is None:
        from repro_torch.fleetsim.options import EngineOptions

        state, _, _ = run_state(cfg, params, device,
                                EngineOptions(backend="staged"))
        met = state.metrics
        return ShardedMetrics(metrics=met,
                              grid_hist=met.hist.sum(dim=0,
                                                     dtype=met.hist.dtype))
    return run_sharded(cfg, params, spec, device=device)
