"""One process a device: the process group a rank mesh runs over.

``python -m torch.distributed.run --nproc-per-node N -m <module> ...``
starts N processes and gives each its ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  :func:`init_ranks`
reads them and joins the group: NCCL with this process bound to
``cuda:LOCAL_RANK``, or gloo where the caller asks for the CPU.  A caller
may set its group up itself (``torch.distributed.init_process_group`` with a
``FileStore``, as the tests and ``chip_smoke.py`` do);
:func:`repro_torch.launch.mesh.make_host_mesh` then builds the rank mesh
over whichever group is up.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def launched() -> bool:
    """Whether this process was started by ``torchrun`` (its env is set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def on_ranks() -> bool:
    """Whether a process group is up (this process is one rank of it)."""
    return dist.is_available() and dist.is_initialized()


def rank_device(device=None) -> torch.device:
    """This rank's device for a run on ``device``'s kind (CUDA unless
    named): the current CUDA device over NCCL, the CPU over gloo; raises
    where the group's backend cannot run on that kind."""
    dev = resolve_device(device)
    backend = dist.get_backend()
    if (dev.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"a {backend} process group cannot run on "
                         f"{dev.type}: NCCL for CUDA, gloo for the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_ranks(device=None) -> torch.device:
    """Join the process group ``torchrun``'s env describes (if none is up
    yet) and return this rank's device: ``cuda:LOCAL_RANK`` over NCCL
    (CUDA unless ``device`` names the CPU), the CPU over gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not on_ranks():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dev


def close_ranks() -> None:
    """Leave the process group, if one is up."""
    if on_ranks():
        dist.destroy_process_group()
