"""Model-derived LLM service specs, port of
``repro.fleetsim.llmserve.service``.

:func:`llm_service` turns a model registry config into an ``llm``-kind
:class:`~repro_torch.scenarios.service.ServiceSpec`: per-token decode cost
and prompt prefill cost from the same analytic roofline the dry-run tables
use (:mod:`repro_torch.analysis.roofline`, whose ``PEAK_FLOPS`` and
``HBM_BW`` are the reference's modelling constants for the simulated
replica), plus a bimodal generated-length distribution.  The derivation is
artifact-free: parameter counts come from the shapes the port's
``init_params`` builds on the ``meta`` device (MoE experts scaled by
``top_k / n_experts``), so nothing is allocated and no dry-run JSON is
needed.  ``llm_service("gemma-7b")`` gives the ``params`` the scenario
library's ``llm_gemma7b.json`` and ``llm_moe_hetero.json`` pin.

Per-request demand in the spec is total wall time in µs::

    demand = prefill_us(model, prompt_len) + gen × decode_step_us(model)

with ``gen`` drawn short/long per request.  Decode for a batch-1 request
streams the active weights once per token, so the per-token cost is the
max of the compute and memory terms — memory-bound for every dense
registry model, which is exactly why continuous batching (the
``server_model="batch"`` stage) is nearly free up to the compute roof.

A 7B-class decode step is tens of *milliseconds*, far above FleetSim's
default 1 µs tick; scenarios built on these specs set
``Scenario.dt_us``/``FleetConfig.dt_us`` to the decode step so one tick is
one token and horizons stay in the thousands of ticks.
"""

from __future__ import annotations

from functools import lru_cache

from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS, n_params_active
from repro_torch.configs import get_config
from repro_torch.scenarios.service import ServiceSpec

#: bytes per parameter (bf16 weights streamed from memory)
BYTES_PER_PARAM = 2.0


@lru_cache(maxsize=None)
def _active_params(model_name: str, smoke: bool) -> float:
    _, active = n_params_active(get_config(model_name, smoke=smoke))
    return active


def decode_step_us(model_name: str, *, smoke: bool = False) -> float:
    """Per-token decode cost (µs) for one batch-1 request on one device:
    max of the compute term (2 FLOPs per active param per token) and the
    memory term (active weights streamed once per token)."""
    active = _active_params(model_name, smoke)
    compute_s = 2.0 * active / PEAK_FLOPS
    memory_s = BYTES_PER_PARAM * active / HBM_BW
    return max(compute_s, memory_s) * 1e6


def prefill_us(model_name: str, prompt_len: int, *,
               smoke: bool = False) -> float:
    """Prefill cost (µs) for a ``prompt_len``-token prompt: compute over
    all prompt tokens (prefill is parallel over the sequence) against one
    streaming pass over the active weights."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    active = _active_params(model_name, smoke)
    compute_s = 2.0 * active * prompt_len / PEAK_FLOPS
    memory_s = BYTES_PER_PARAM * active / HBM_BW
    return max(compute_s, memory_s) * 1e6


def _fixed(dist, name: str) -> float:
    """Resolve an int or ``("fixed", n)`` length distribution."""
    if isinstance(dist, (int, float)):
        return float(dist)
    if isinstance(dist, (tuple, list)) and len(dist) == 2 \
            and dist[0] == "fixed":
        return float(dist[1])
    raise ValueError(f"{name} must be an int or ('fixed', n), got {dist!r}")


def llm_service(model_name: str, prompt_len_dist=128,
                gen_len_dist=("bimodal", 8, 64, 0.10), *,
                smoke: bool = False, **spec_kw) -> ServiceSpec:
    """Build the ``llm`` ServiceSpec for a registry model.

    ``prompt_len_dist`` is an int or ``("fixed", n)`` (prefill is charged
    per request at that length); ``gen_len_dist`` is an int /
    ``("fixed", n)`` for deterministic generation length or
    ``("bimodal", short, long, p_long)`` for the short-chat-turn vs
    long-completion mix.  ``smoke=True`` derives from the model's smoke
    config (tiny shapes — used by tests and the DES-oracle
    cross-validation).  Extra keywords (``jitter_p``, ``jitter_mult``)
    pass through to :meth:`ServiceSpec.llm`.
    """
    prompt_len = int(_fixed(prompt_len_dist, "prompt_len_dist"))
    if isinstance(gen_len_dist, (tuple, list)) \
            and len(gen_len_dist) == 4 and gen_len_dist[0] == "bimodal":
        _, gen_short, gen_long, p_long = gen_len_dist
    else:
        gen_short = gen_long = _fixed(gen_len_dist, "gen_len_dist")
        p_long = 0.0
    return ServiceSpec.llm(
        prefill=prefill_us(model_name, prompt_len, smoke=smoke),
        decode=decode_step_us(model_name, smoke=smoke),
        gen_short=float(gen_short), gen_long=float(gen_long),
        p_long=float(p_long), **spec_kw)
