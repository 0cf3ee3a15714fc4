"""One Scenario API: policy registry, arrival processes, scenario files;
the port's copy of ``repro.scenarios``.

The package has three layers:

* :mod:`repro_torch.scenarios.registry` — the unified policy registry.  A
  policy is registered once (name, stable int id, DES factory, array-form
  route / spine / stage hooks) and enters both engines and every sweep;
* :mod:`repro_torch.scenarios.service` / :mod:`repro_torch.scenarios.
  arrival` — the declarative workload pieces: one :class:`ServiceSpec` for
  both engines, pluggable :class:`ArrivalProcess` (Poisson, trace replay);
* :mod:`repro_torch.scenarios.spec` — the frozen :class:`Scenario`
  dataclass and :class:`SweepSpec` grid with JSON round-trip, consumed by
  ``core.simulator`` and ``fleetsim`` alike.  Imported lazily here: it
  pulls in the engines, while this ``__init__`` stays import-light so
  ``core``/``fleetsim`` modules can import the registry without cycles.

``python -m repro_torch.scenarios --list`` lists policies and bundled
scenario files; ``python -m repro_torch.scenarios NAME_OR_PATH`` runs one
end-to-end (on the card unless ``--device cpu``).
"""

from repro_torch.scenarios import registry
from repro_torch.scenarios.arrival import (
    ArrivalProcess,
    PoissonArrival,
    TraceArrival,
    arrival_from_json,
)
from repro_torch.scenarios.registry import DuplicatePolicyError, PolicyDef, register
from repro_torch.scenarios.service import ServiceSpec

_LAZY = ("Scenario", "SweepSpec", "run_scenarios", "scenario_library",
         "load_any")

__all__ = [
    "registry",
    "register",
    "PolicyDef",
    "DuplicatePolicyError",
    "ServiceSpec",
    "ArrivalProcess",
    "PoissonArrival",
    "TraceArrival",
    "arrival_from_json",
    *_LAZY,
]


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.scenarios import spec

        return getattr(spec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
