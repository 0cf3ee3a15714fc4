"""Service-time specification shared by the engine and its sweeps.

The port's copy of ``repro.scenarios.service.ServiceSpec``, with its
conversions to and from the DES service processes of
:mod:`repro_torch.core.workloads`, and of ``load_to_rate``.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

from repro_torch.core.workloads import (
    BimodalService,
    BoundedParetoService,
    ExponentialService,
    LLMBimodalService,
    ServiceProcess,
)

SERVICE_EXPONENTIAL = "exponential"
SERVICE_BIMODAL = "bimodal"
SERVICE_PARETO = "pareto"
SERVICE_LLM = "llm"

#: per-kind positional parameter names, for construction-time validation
_PARAM_NAMES = {
    SERVICE_EXPONENTIAL: ("mean",),
    SERVICE_BIMODAL: ("short", "long", "p_long"),
    SERVICE_PARETO: ("xm", "alpha", "cap"),
    SERVICE_LLM: ("prefill", "decode", "gen_short", "gen_long", "p_long"),
}


def bounded_pareto_mean(xm: float, alpha: float, cap: float) -> float:
    """Mean of the bounded Pareto on ``[xm, cap]`` with shape ``alpha``."""
    r = xm / cap
    if abs(alpha - 1.0) < 1e-9:
        return float(xm * math.log(cap / xm) / (1.0 - r))
    return float((xm ** alpha / (1.0 - r ** alpha)) * (alpha / (alpha - 1.0))
                 * (xm ** (1.0 - alpha) - cap ** (1.0 - alpha)))


@dataclass(frozen=True)
class ServiceSpec:
    """Hashable, array-free description of a service-time process:
    ``intrinsic`` demand drawn per request (shared by both copies of a
    clone pair), execution noise and the jitter spike drawn per
    execution."""

    kind: str
    params: tuple[float, ...]
    jitter_p: float = 0.01
    jitter_mult: float = 15.0
    mean: float = 0.0           # pre-jitter mean, for load normalisation

    def __post_init__(self):
        if not 0.0 <= self.jitter_p <= 1.0:
            raise ValueError(
                f"service jitter_p must be in [0, 1], got {self.jitter_p}")
        if self.jitter_mult <= 0:
            raise ValueError(
                f"service jitter_mult must be > 0, got {self.jitter_mult}")
        names = _PARAM_NAMES.get(self.kind)
        if names is None:
            raise ValueError(f"unknown service kind {self.kind!r}")
        if len(self.params) != len(names):
            raise ValueError(
                f"service kind {self.kind!r} takes {len(names)} params "
                f"{names}, got {len(self.params)}")
        p = dict(zip(names, self.params))
        if "p_long" in p and not 0.0 <= p["p_long"] <= 1.0:
            raise ValueError(f"service {self.kind!r} p_long must be in "
                             f"[0, 1], got {p['p_long']}")
        # prefill may be 0 (decode-only service); every other scale must be
        # strictly positive for the process to have a positive mean
        for name, v in p.items():
            lo_ok = v >= 0.0 if name in ("prefill", "p_long") else v > 0.0
            if not lo_ok:
                raise ValueError(
                    f"service {self.kind!r} {name} must be "
                    f"{'>= 0' if name == 'prefill' else '> 0'}, got {v}")
        if self.kind == SERVICE_PARETO and not p["xm"] < p["cap"]:
            raise ValueError(f"service 'pareto' needs xm < cap, got "
                             f"xm={p['xm']} cap={p['cap']}")

    @property
    def effective_mean(self) -> float:
        return self.mean * (1.0 + self.jitter_p * (self.jitter_mult - 1.0))

    @classmethod
    def exponential(cls, mean: float = 25.0, **kw) -> "ServiceSpec":
        return cls(SERVICE_EXPONENTIAL, (float(mean),), mean=float(mean),
                   **kw)

    @classmethod
    def bimodal(cls, short: float = 25.0, long: float = 250.0,
                p_long: float = 0.10, **kw) -> "ServiceSpec":
        mean = (1 - p_long) * short + p_long * long
        return cls(SERVICE_BIMODAL,
                   (float(short), float(long), float(p_long)),
                   mean=float(mean), **kw)

    @classmethod
    def pareto(cls, xm: float = 10.0, alpha: float = 1.2,
               cap: float = 1000.0, **kw) -> "ServiceSpec":
        return cls(SERVICE_PARETO, (float(xm), float(alpha), float(cap)),
                   mean=bounded_pareto_mean(xm, alpha, cap), **kw)

    @classmethod
    def llm(cls, prefill: float = 200.0, decode: float = 10.0,
            gen_short: float = 8.0, gen_long: float = 64.0,
            p_long: float = 0.10, **kw) -> "ServiceSpec":
        """LLM-serving demand: ``prefill + gen × decode`` µs with ``gen``
        drawn short/long per request."""
        mean = prefill + decode * ((1 - p_long) * gen_short
                                   + p_long * gen_long)
        return cls(SERVICE_LLM,
                   (float(prefill), float(decode), float(gen_short),
                    float(gen_long), float(p_long)),
                   mean=float(mean), **kw)

    @classmethod
    def from_process(cls, svc: ServiceProcess) -> "ServiceSpec":
        """Map a DES service process onto its array-form spec."""
        kw = dict(jitter_p=svc.jitter_p, jitter_mult=svc.jitter_mult)
        if isinstance(svc, ExponentialService):
            return cls.exponential(svc.mean, **kw)
        if isinstance(svc, LLMBimodalService):
            return cls.llm(svc.prefill, svc.decode, svc.gen_short,
                           svc.gen_long, svc.p_long, **kw)
        if isinstance(svc, BimodalService):
            return cls.bimodal(svc.short, svc.long, svc.p_long, **kw)
        if isinstance(svc, BoundedParetoService):
            return cls.pareto(svc.xm, svc.alpha, svc.cap, **kw)
        raise TypeError(f"no fleetsim mapping for {type(svc).__name__}")

    def to_process(self) -> ServiceProcess:
        """The equivalent DES service process (inverse of
        :meth:`from_process`)."""
        kw = dict(jitter_p=self.jitter_p, jitter_mult=self.jitter_mult)
        if self.kind == SERVICE_EXPONENTIAL:
            return ExponentialService(self.params[0], **kw)
        if self.kind == SERVICE_BIMODAL:
            return BimodalService(*self.params, **kw)
        if self.kind == SERVICE_PARETO:
            return BoundedParetoService(*self.params, **kw)
        if self.kind == SERVICE_LLM:
            return LLMBimodalService(*self.params, **kw)
        raise ValueError(f"unknown service kind {self.kind!r}")

    def to_json(self) -> dict:
        d = asdict(self)
        d["params"] = list(self.params)
        d.pop("mean")            # derived; recomputed on load
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ServiceSpec":
        unknown = sorted(set(d) - {"kind", "params", "jitter_p",
                                   "jitter_mult"})
        if unknown:
            raise ValueError(f"unknown service keys {unknown}; valid: "
                             "['jitter_mult', 'jitter_p', 'kind', 'params']")
        kw = {k: d[k] for k in ("jitter_p", "jitter_mult") if k in d}
        factory = {SERVICE_EXPONENTIAL: cls.exponential,
                   SERVICE_BIMODAL: cls.bimodal,
                   SERVICE_PARETO: cls.pareto,
                   SERVICE_LLM: cls.llm}.get(d["kind"])
        if factory is None:
            raise ValueError(f"unknown service kind {d['kind']!r}")
        return factory(*d["params"], **kw)


def load_to_rate(load: float, service: ServiceSpec, n_servers: int,
                 n_workers: int) -> float:
    """Offered load (fraction of cluster capacity) → arrival rate (req/µs)."""
    capacity = n_servers * n_workers / service.effective_mean
    return load * capacity
