"""ServeSim in PyTorch: LLM serving as a FleetSim workload, port of
``repro.fleetsim.llmserve``.

Three pieces close the loop between the port's serving stack and the
cluster simulator:

* :func:`llm_service` — derive an ``llm``-kind
  :class:`~repro_torch.scenarios.service.ServiceSpec` (prefill + per-token
  decode cost, bimodal generated length) from a model registry config via
  the roofline estimates in :mod:`repro_torch.analysis.roofline`;
* :func:`stage_server_batch` (:mod:`repro_torch.fleetsim.llmserve.stage`)
  — the continuous-batching server stage ``stages.stage_server``
  dispatches to when ``FleetConfig.server_model == "batch"``:
  admit-into-free-slot, per-tick progress on every busy slot, completion
  on exhausted demand, with the CLO=2 drop rule and queue-length
  piggyback at the slot-wait boundary so routing policies route on batch
  pressure;
* :func:`serve_equivalence` (:mod:`repro_torch.fleetsim.llmserve.oracle`)
  — the cross-validation tier comparing the array batch server against
  :class:`repro_torch.serve.engine.DecodeReplica` ticked as a
  discrete-event oracle (documented tolerances ``SERVE_*``).
"""

from repro_torch.fleetsim.llmserve.oracle import ServeCheck, \
    serve_equivalence
from repro_torch.fleetsim.llmserve.service import decode_step_us, \
    llm_service, prefill_us
from repro_torch.fleetsim.llmserve.stage import stage_server_batch

__all__ = [
    "ServeCheck",
    "decode_step_us",
    "llm_service",
    "prefill_us",
    "serve_equivalence",
    "stage_server_batch",
]
