"""Host-side reduction of device metrics to per-configuration results —
port of ``repro.fleetsim.metrics``.

Latency statistics come from the log-spaced histogram the engine
accumulates (geometric bin midpoints), so percentile error is bounded by
the bin width.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.fleetsim.config import FleetConfig


@dataclass
class FleetResult:
    """One (policy, load, seed) cell of a sweep.  The scalar latency
    statistics are fabric-wide; ``rack_*`` tuples break them out per rack
    (the rack that served the winning response)."""

    policy: str
    offered_load: float
    offered_rate_mrps: float
    seed: int
    throughput_mrps: float
    mean_us: float
    p50_us: float
    p99_us: float
    p999_us: float
    n_arrivals: int
    n_completed: int
    n_cloned: int
    n_interrack_cloned: int
    n_clone_drops: int
    n_filtered: int
    n_spine_filtered: int
    n_redundant_at_client: int
    n_overflow: int
    n_truncated: int
    n_dropped_down: int
    n_dedup_evicted: int
    empty_queue_fraction: float
    # staged-pipeline counters (nonzero only for coordinator / hedge runs)
    n_coord_queued: int = 0    # requests parked at the coordinator node
    n_coord_overflow: int = 0  # … lost to coordinator-ring exhaustion
    n_hedges_armed: int = 0    # timer-wheel entries armed
    n_hedges_cancelled: int = 0  # … cancelled (earlier response / fabric dark)
    n_wheel_dropped: int = 0   # … lost to wheel-slot exhaustion
    # the (possibly swept) hedge delay this cell ran with; 0.0 when the
    # hedge_timer stage is off
    hedge_delay_us: float = 0.0
    # mean busy fraction of the batch server's decode slots; 0.0 under
    # server_model="fcfs"
    mean_slot_occupancy: float = 0.0
    n_link_dropped_req: int = 0
    n_link_dropped_resp: int = 0
    rack_completed: tuple[int, ...] = ()
    rack_p50_us: tuple[float, ...] = ()
    rack_p99_us: tuple[float, ...] = ()

    @property
    def clone_fraction(self) -> float:
        return self.n_cloned / max(self.n_arrivals, 1)

    @property
    def interrack_clone_fraction(self) -> float:
        return self.n_interrack_cloned / max(self.n_arrivals, 1)

    def row(self) -> dict:
        return {
            "policy": self.policy, "load": self.offered_load,
            "seed": self.seed,
            "throughput_mrps": round(self.throughput_mrps, 4),
            "p50_us": round(self.p50_us, 1), "p99_us": round(self.p99_us, 1),
            "p999_us": round(self.p999_us, 1),
            "mean_us": round(self.mean_us, 1),
            "cloned": self.n_cloned, "filtered": self.n_filtered,
            "interrack": self.n_interrack_cloned,
            "spine_filtered": self.n_spine_filtered,
            "clone_drops": self.n_clone_drops,
            "redundant": self.n_redundant_at_client,
            "coord_queued": self.n_coord_queued,
            "coord_overflow": self.n_coord_overflow,
            "hedges_armed": self.n_hedges_armed,
            "hedge_delay_us": round(self.hedge_delay_us, 2),
            "slot_occupancy": round(self.mean_slot_occupancy, 3),
            "link_dropped_req": self.n_link_dropped_req,
            "link_dropped_resp": self.n_link_dropped_resp,
            "empty_q": round(self.empty_queue_fraction, 3),
            "rack_completed": list(self.rack_completed),
            "rack_p50_us": [round(v, 1) for v in self.rack_p50_us],
            "rack_p99_us": [round(v, 1) for v in self.rack_p99_us],
        }


def bin_mids_us(cfg: FleetConfig) -> np.ndarray:
    b = np.arange(cfg.hist_bins)
    return cfg.hist_lo_us * cfg.hist_growth ** (b + 0.5)


def hist_percentile(hist: np.ndarray, mids: np.ndarray, q: float) -> float:
    total = hist.sum()
    if total == 0:
        return float("nan")
    c = np.cumsum(hist)
    # q == 0 asks for the minimum: step right past leading zero-count bins
    target = q / 100.0 * total
    k = np.searchsorted(c, target, side="right" if target <= 0 else "left")
    return float(mids[min(k, len(mids) - 1)])


def summarize(cfg: FleetConfig, metrics, *, policy: str, load: float,
              rate_per_us: float, seed: int,
              hedge_delay_us: float | None = None) -> FleetResult:
    """Reduce one configuration's metrics (indexed out of the sweep batch;
    tensors or numpy) to a :class:`FleetResult`.  ``metrics.hist`` is
    ``(n_racks, hist_bins)``; fabric-wide statistics come from the
    rack-summed histogram, per-rack tails from each row.
    ``hedge_delay_us`` records the (possibly swept) per-run delay;
    ``None`` resolves to the config's own delay when the hedge stage is
    on, else 0.0."""
    if hedge_delay_us is None:
        hedge_delay_us = cfg.hedge_delay_us if cfg.hedge_timer else 0.0

    def host(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x)

    rack_hist = host(metrics.hist).reshape(cfg.n_racks, cfg.hist_bins)
    hist = rack_hist.sum(axis=0)
    mids = bin_mids_us(cfg)
    total = int(hist.sum())
    mean = float((hist * mids).sum() / total) if total else float("nan")
    window_us = cfg.duration_us - cfg.warmup_us
    n_resp = int(host(metrics.n_resp))

    def n(field):
        return int(host(getattr(metrics, field)))

    return FleetResult(
        policy=policy,
        offered_load=load,
        offered_rate_mrps=float(rate_per_us),
        seed=seed,
        throughput_mrps=float(n("n_completed_win") / window_us),
        mean_us=mean,
        p50_us=hist_percentile(hist, mids, 50.0),
        p99_us=hist_percentile(hist, mids, 99.0),
        p999_us=hist_percentile(hist, mids, 99.9),
        n_arrivals=n("n_arrivals"),
        n_completed=n("n_completed"),
        n_cloned=n("n_cloned"),
        n_interrack_cloned=n("n_interrack_cloned"),
        n_clone_drops=n("n_clone_drops"),
        n_filtered=n("n_filtered"),
        n_spine_filtered=n("n_spine_filtered"),
        n_redundant_at_client=n("n_redundant"),
        n_overflow=n("n_overflow"),
        n_truncated=n("n_truncated"),
        n_dropped_down=n("n_dropped_down"),
        n_dedup_evicted=n("n_dedup_evicted"),
        empty_queue_fraction=(n("n_resp_empty") / n_resp
                              if n_resp else 1.0),
        n_coord_queued=n("n_coord_queued"),
        n_coord_overflow=n("n_coord_overflow"),
        n_hedges_armed=n("n_hedges_armed"),
        n_hedges_cancelled=n("n_hedges_cancelled"),
        n_wheel_dropped=n("n_wheel_dropped"),
        hedge_delay_us=float(hedge_delay_us),
        mean_slot_occupancy=(
            n("n_slot_busy") / float(cfg.n_ticks * cfg.n_servers_total
                                     * cfg.n_slots)
            if cfg.server_model == "batch" else 0.0),
        n_link_dropped_req=n("n_link_dropped_req"),
        n_link_dropped_resp=n("n_link_dropped_resp"),
        rack_completed=tuple(int(r.sum()) for r in rack_hist),
        rack_p50_us=tuple(hist_percentile(r, mids, 50.0) for r in rack_hist),
        rack_p99_us=tuple(hist_percentile(r, mids, 99.0) for r in rack_hist),
    )
