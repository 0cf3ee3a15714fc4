"""Device meshes, port of ``repro.launch.mesh``.

The reference's production meshes are 16×16 = 256 TPU chips (``("data",
"model")``) and 2×16×16 = 512 (a leading ``"pod"`` axis over DCI).  The port
cannot make 512 devices, so :func:`make_production_mesh` gives a
*shape-only* mesh: its axis sizes, no devices.  The sharding rules and the
dry-run's lowering read sizes only.

:func:`make_host_mesh` works over the devices present.  Where a
``torch.distributed`` process group is up (one process a device: ``torchrun``
and :func:`repro_torch.launch.ranks.init_ranks`, or a group the caller set
up), it is a **rank mesh**: ``("data", "model")`` of W × 1 over the W ranks,
carrying this rank, the group, its ``DeviceMesh`` and this rank's device;
the sharding hooks then run real collectives over its ``data`` group, even
at W = 1.  Without a group it is one device, the card or the CPU: several
CUDA devices in one process are refused (one process a device is the
path).  Tensor parallelism over ranks (``model`` > 1) is not written
(ROADMAP A9-shard-multi's TP part).  Importing this module touches no
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.ranks import on_ranks, rank_device

#: CUDA devices a mesh in one process may span; more take one process a
#: device (a rank mesh)
MAX_CUDA_DEVICES = 1

_TP_ERROR = ("a rank mesh with model = {model} > 1: tensor parallelism over "
             "ranks is not written (ROADMAP.md queue A, A9-shard-multi's TP "
             "part); use model = 1")


@dataclass(frozen=True)
class Mesh:
    """Named axis sizes (``shape``, in order) and the devices they lay out
    (``devices``; ``None`` for a shape-only mesh).  A rank mesh also
    carries this process's ``rank``, the ``data`` axis's process ``group``
    and the ``DeviceMesh`` over the ranks; its ``devices`` is this rank's
    device alone."""

    shape: dict
    devices: tuple | None = None
    rank: int = 0
    group: Any = None
    device_mesh: Any = None

    @property
    def device(self) -> torch.device | None:
        """The device a cell runs on: a single-device mesh's, or this
        rank's."""
        return self.devices[0] if self.devices else None

    @property
    def ranks(self) -> bool:
        """Whether this is a mesh of ranks (its hooks run collectives)."""
        return self.group is not None

    @property
    def rules_mesh(self) -> "Mesh":
        """The axis sizes the sharding rules read for a rank mesh's layout:
        its own, except that a one-rank world reads ``data = 2``, so its
        leaves take a two-rank world's specs (each block the whole leaf) and
        its hooks run the collectives a two-card host runs."""
        data = self.shape["data"]
        return self if data > 1 else Mesh({**self.shape, "data": 2})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16×16 (or 2×16×16 with ``multi_pod``) mesh, shape
    only."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_rank_mesh(data: int | None = None, model: int = 1,
                   device=None) -> Mesh:
    """The W × 1 ``("data", "model")`` mesh over the ranks of the process
    group that is up, on this rank's device (``device``'s kind, CUDA unless
    named: the current CUDA device, which :func:`~repro_torch.launch.ranks.
    init_ranks` binds to ``LOCAL_RANK``).  ``data`` must be W if given;
    ``model`` > 1 raises ``NotImplementedError``."""
    from torch.distributed.device_mesh import init_device_mesh

    if model != 1:
        raise NotImplementedError(_TP_ERROR.format(model=model))
    w = dist.get_world_size()
    if data not in (None, w):
        raise ValueError(f"a rank mesh's data axis is the world's {w} "
                         f"ranks, not {data}")
    dev = rank_device(device)
    dmesh = init_device_mesh(dev.type, (w, 1),
                             mesh_dim_names=("data", "model"))
    return Mesh({"data": w, "model": 1}, devices=(dev,),
                rank=dist.get_rank(), group=dmesh.get_group("data"),
                device_mesh=dmesh)


def make_host_mesh(data: int | None = None, model: int = 1,
                   device=None) -> Mesh:
    """A ``("data", "model")`` mesh over the devices present on ``device``'s
    kind (CUDA unless named): the rank mesh (:func:`make_rank_mesh`) where
    a process group is up, else one device (``"cpu"`` is one device).
    Without a group, raises for more devices than are present and for more
    than :data:`MAX_CUDA_DEVICES` on CUDA."""
    if on_ranks():
        return make_rank_mesh(data, model, device)
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    data = data or max(1, n // model)
    if data * model > n:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"{dev.type} devices; {n} present")
    if dev.type == "cuda" and data * model > MAX_CUDA_DEVICES:
        raise NotImplementedError(
            f"a mesh over {data * model} CUDA devices in one process: run "
            "one process a device (python -m torch.distributed.run "
            "--nproc-per-node N ...) and build the rank mesh with "
            "make_host_mesh() over its process group (ROADMAP.md queue A, "
            "A9-shard-multi)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh({"data": data, "model": model},
                devices=tuple([dev] * (data * model)))
