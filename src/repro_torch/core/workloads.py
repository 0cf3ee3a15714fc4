"""Workload generators (paper §5.1.2); the port's copy of
``repro.core.workloads`` (numpy only).

Synthetic service-time processes:

* ``ExponentialService(mean)`` — Exp(25), Exp(50), Exp(500) in the paper.
* ``BimodalService`` — 90% 25 µs / 10% 250 µs (simple + complex RPCs).
* jitter: with probability ``p`` (0.01 high / 0.001 low variability) a request
  takes ``jitter_mult`` (15×) its drawn service time — the unexpected
  latency spikes (GC, interrupts, power management) cloning is meant to mask.

Real-application workloads:

* ``KVStoreService`` — Redis/Memcached-style replicated key-value store:
  1M objects, 16 B keys / 64 B values, Zipf-0.99 key popularity, GET reads a
  single object and SCAN reads 100 (paper §5.5).  Writes exist but NetClone
  never clones them (replication protocols own write coordination).

Arrival process: open-loop Poisson (exponential inter-arrival, §4.2).
"""

from __future__ import annotations

import numpy as np

OP_GET = 0
OP_SCAN = 1
OP_WRITE = 2


class ServiceProcess:
    """Base class separating *intrinsic* request size from *server-side*
    execution randomness.

    Cloning masks service-time variability precisely because the two copies of
    a request experience **independent** server-side randomness (interference,
    GC, scheduling — and, for the synthetic dummy-RPC workload, the drawn spin
    duration itself).  The split:

    * ``intrinsic(rng, n)``    — per-request base demand, shared by clones
      (e.g. the bimodal simple/complex class, GET vs SCAN).
    * ``execute(rng, base)``   — the actual runtime of one execution on one
      server: base × per-execution noise, plus the jitter spike (probability
      ``jitter_p``, multiplier ``jitter_mult``) drawn independently per copy.
    """

    #: mean execution time in µs, pre-jitter (for load normalisation)
    mean: float

    def __init__(self, jitter_p: float = 0.01, jitter_mult: float = 15.0):
        self.jitter_p = jitter_p
        self.jitter_mult = jitter_mult

    def intrinsic(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError

    def _execute_base(self, rng: np.random.Generator, base: float) -> float:
        raise NotImplementedError

    def execute(self, rng: np.random.Generator, base: float) -> float:
        s = self._execute_base(rng, base)
        if self.jitter_p > 0 and rng.random() < self.jitter_p:
            s *= self.jitter_mult
        return s

    def ops_of(self, bases: np.ndarray) -> np.ndarray:
        """Op class of each request, derived from its intrinsic demand."""
        return np.full(len(bases), OP_GET, dtype=np.int8)

    @property
    def effective_mean(self) -> float:
        """Mean including jitter inflation — used for load normalisation."""
        return self.mean * (1.0 + self.jitter_p * (self.jitter_mult - 1.0))


class ExponentialService(ServiceProcess):
    """Dummy-RPC spin for an Exp(mean) duration drawn *at the server* — two
    executions of the same request draw independently (paper §5.1.2)."""

    def __init__(self, mean: float = 25.0, **kw):
        super().__init__(**kw)
        self.mean = float(mean)

    def intrinsic(self, rng, n):
        return np.full(n, self.mean)

    def _execute_base(self, rng, base):
        return float(rng.exponential(base))

    def __repr__(self):
        return f"Exp({self.mean:g})"


class BimodalService(ServiceProcess):
    """90% simple / 10% complex RPCs (25/250 µs).  The class is intrinsic to
    the request; execution adds ±10% noise + jitter per copy."""

    def __init__(self, short: float = 25.0, long: float = 250.0,
                 p_long: float = 0.10, **kw):
        super().__init__(**kw)
        self.short, self.long, self.p_long = float(short), float(long), float(p_long)
        self.mean = (1 - p_long) * short + p_long * long

    def intrinsic(self, rng, n):
        long_mask = rng.random(n) < self.p_long
        return np.where(long_mask, self.long, self.short)

    def _execute_base(self, rng, base):
        return base * float(rng.uniform(0.9, 1.1))

    def __repr__(self):
        return f"Bimodal({1-self.p_long:.0%}-{self.short:g},{self.p_long:.0%}-{self.long:g})"


class LLMBimodalService(ServiceProcess):
    """LLM-serving demand: fixed prefill cost plus a per-request decode cost
    proportional to a bimodal generated length.

    Total demand is ``prefill + gen × decode`` µs where ``gen`` is
    ``gen_long`` with probability ``p_long`` else ``gen_short`` — short
    chat-style turns vs long completions.  The generated length is intrinsic
    to the request (shared by both copies of a clone pair); execution adds
    ±10% noise + jitter per copy, like the other real-workload processes.
    Derive the per-token numbers from a model registry config with
    :func:`repro_torch.fleetsim.llmserve.llm_service`.
    """

    def __init__(self, prefill: float = 200.0, decode: float = 10.0,
                 gen_short: float = 8.0, gen_long: float = 64.0,
                 p_long: float = 0.10, **kw):
        super().__init__(**kw)
        if prefill < 0:
            raise ValueError("prefill must be >= 0")
        if decode <= 0 or gen_short <= 0 or gen_long <= 0:
            raise ValueError("decode / gen_short / gen_long must be > 0")
        if not 0.0 <= p_long <= 1.0:
            raise ValueError("need 0 <= p_long <= 1")
        self.prefill, self.decode = float(prefill), float(decode)
        self.gen_short, self.gen_long = float(gen_short), float(gen_long)
        self.p_long = float(p_long)
        self.mean = self.prefill + self.decode * (
            (1 - self.p_long) * self.gen_short
            + self.p_long * self.gen_long)

    def intrinsic(self, rng, n):
        long_mask = rng.random(n) < self.p_long
        gen = np.where(long_mask, self.gen_long, self.gen_short)
        return self.prefill + gen * self.decode

    def _execute_base(self, rng, base):
        return base * float(rng.uniform(0.9, 1.1))

    def __repr__(self):
        return (f"LLM(prefill={self.prefill:g},decode={self.decode:g},"
                f"gen={self.gen_short:g}/{self.gen_long:g}"
                f"@{self.p_long:.0%})")


class BoundedParetoService(ServiceProcess):
    """Heavy-tailed RPCs: bounded Pareto on ``[xm, cap]`` with shape ``alpha``.

    The standard microsecond-RPC stress workload (RackSched, R2P2 use the same
    family): most requests are near ``xm`` but the tail stretches to ``cap``,
    which is exactly the regime where cloning pays.  The *size* is intrinsic to
    the request (shared by both copies); execution adds ±10% noise + jitter.
    """

    def __init__(self, xm: float = 10.0, alpha: float = 1.2,
                 cap: float = 1000.0, **kw):
        super().__init__(**kw)
        if not (0 < xm < cap):
            raise ValueError("need 0 < xm < cap")
        if alpha <= 0:
            raise ValueError("alpha must be positive")
        self.xm, self.alpha, self.cap = float(xm), float(alpha), float(cap)
        r = xm / cap
        if abs(alpha - 1.0) < 1e-9:
            mean = xm * np.log(cap / xm) / (1.0 - r)
        else:
            mean = (xm ** alpha / (1.0 - r ** alpha)) * (alpha / (alpha - 1.0)) \
                * (xm ** (1.0 - alpha) - cap ** (1.0 - alpha))
        self.mean = float(mean)

    def _inverse_cdf(self, u):
        """Inverse CDF of the bounded Pareto — shared with the array engine."""
        r = (self.xm / self.cap) ** self.alpha
        return self.xm / (1.0 - u * (1.0 - r)) ** (1.0 / self.alpha)

    def intrinsic(self, rng, n):
        return self._inverse_cdf(rng.random(n))

    def _execute_base(self, rng, base):
        return base * float(rng.uniform(0.9, 1.1))

    def __repr__(self):
        return f"BPareto(xm={self.xm:g},a={self.alpha:g},cap={self.cap:g})"


class KVStoreService(ServiceProcess):
    """Replicated in-memory KV store (Redis / Memcached experiments, §5.5).

    GET cost ``t_get`` covers the full server-side op (hash lookup + value
    copy + stack) — ~10 µs for Redis-class stores on the paper's testbed;
    SCAN reads ``scan_objects`` objects.  Key popularity is Zipf(0.99) over
    ``n_objects`` keys; with full replication every server holds every key, so
    skew stresses tail latency through SCAN head-of-line blocking rather than
    per-key load imbalance.
    """

    def __init__(
        self,
        p_scan: float = 0.01,
        t_get: float = 10.0,
        scan_objects: int = 100,
        n_objects: int = 1_000_000,
        zipf_alpha: float = 0.99,
        **kw,
    ):
        super().__init__(**kw)
        self.p_scan = float(p_scan)
        self.t_get = float(t_get)
        self.t_scan = float(t_get) * scan_objects
        self.n_objects = n_objects
        self.zipf_alpha = zipf_alpha
        self.mean = (1 - self.p_scan) * self.t_get + self.p_scan * self.t_scan
        # Zipf CDF over a truncated support (numpy's zipf is unbounded);
        # sampled via inverse-CDF on 2^16 buckets for speed.
        ranks = np.arange(1, 2 ** 16 + 1, dtype=np.float64)
        w = ranks ** (-zipf_alpha)
        self._cdf = np.cumsum(w) / np.sum(w)

    def intrinsic(self, rng, n):
        scan = rng.random(n) < self.p_scan
        return np.where(scan, self.t_scan, self.t_get)

    def _execute_base(self, rng, base):
        # per-op cost noise (cache effects, memory allocator)
        return base * float(rng.uniform(0.9, 1.1))

    def ops_of(self, bases):
        return np.where(bases >= self.t_scan, OP_SCAN, OP_GET).astype(np.int8)

    def keys(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Zipf-0.99 keys (bucketed inverse-CDF)."""
        u = rng.random(n)
        bucket = np.searchsorted(self._cdf, u)
        # spread each popularity bucket over the 1M-object key space
        per = max(1, self.n_objects // len(self._cdf))
        return (bucket * per + rng.integers(0, per, n)) % self.n_objects

    def __repr__(self):
        return f"KV({1-self.p_scan:.0%}GET,{self.p_scan:.0%}SCAN)"


def poisson_arrivals(
    rng: np.random.Generator, rate_per_us: float, n: int, start: float = 0.0
) -> np.ndarray:
    """Open-loop Poisson arrival times (µs)."""
    gaps = rng.exponential(1.0 / rate_per_us, n)
    return start + np.cumsum(gaps)


def load_to_rate(load: float, service: ServiceProcess, n_servers: int,
                 n_workers: int) -> float:
    """Offered load (fraction of cluster capacity) → arrival rate (req/µs)."""
    capacity = n_servers * n_workers / service.effective_mean
    return load * capacity


def rate_to_load(rate_per_us: float, service: ServiceProcess, n_servers: int,
                 n_workers: int) -> float:
    """Arrival rate (req/µs) → offered load (inverse of
    :func:`load_to_rate`; used to report the effective load of trace-driven
    arrival schedules)."""
    return rate_per_us * service.effective_mean / (n_servers * n_workers)
