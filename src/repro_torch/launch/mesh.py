"""Device meshes, port of ``repro.launch.mesh``.

The reference's production meshes are 16×16 = 256 TPU chips (``("data",
"model")``) and 2×16×16 = 512 (a leading ``"pod"`` axis over DCI).  The port
cannot make 512 devices, so :func:`make_production_mesh` gives a
*shape-only* mesh: its axis sizes, no devices.  The sharding rules and the
dry-run's lowering read sizes only.  :func:`make_host_mesh` works over the
devices present: the card, or the CPU.  It refuses more than one CUDA
device until a multi-card host has run the sharded step (ROADMAP.md queue
A, A9-shard-multi).  Importing this module touches no device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

#: CUDA devices a host mesh may span (one card has run it)
MAX_CUDA_DEVICES = 1


@dataclass(frozen=True)
class Mesh:
    """Named axis sizes (``shape``, in order) and the devices they lay out
    (``devices``; ``None`` for a shape-only mesh)."""

    shape: dict
    devices: tuple | None = None

    @property
    def device(self) -> torch.device | None:
        """The one device of a single-device mesh (where a cell runs)."""
        return self.devices[0] if self.devices else None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16×16 (or 2×16×16 with ``multi_pod``) mesh, shape
    only."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh(data: int | None = None, model: int = 1,
                   device=None) -> Mesh:
    """A ``("data", "model")`` mesh over the devices present on ``device``'s
    kind (CUDA unless named; ``"cpu"`` is one device): ``data`` defaults to
    the devices over ``model``.  Raises for more devices than are present,
    and for more than :data:`MAX_CUDA_DEVICES` on CUDA."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    data = data or max(1, n // model)
    if data * model > n:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"{dev.type} devices; {n} present")
    if dev.type == "cuda" and data * model > MAX_CUDA_DEVICES:
        raise NotImplementedError(
            f"a mesh over {data * model} CUDA devices: the sharded step has "
            f"run on {MAX_CUDA_DEVICES} card only (ROADMAP.md queue A, "
            "A9-shard-multi)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh({"data": data, "model": model},
                devices=tuple([dev] * (data * model)))
