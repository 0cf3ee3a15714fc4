"""Sharding, port of ``repro.sharding``: logical-axis rules mapping trees to
partition specs, and the mesh context with the model's use-site hooks."""

from repro_torch.sharding.context import (
    constrain_batch,
    current_mesh,
    fsdp_use,
    use_mesh,
)
from repro_torch.sharding.rules import (
    BATCH_AXES,
    FSDP_AXIS,
    TP_AXIS,
    PartitionSpec,
    batch_axes,
    batch_spec,
    cache_shardings,
    data_shardings,
    param_shardings,
    spec_for_cache,
    spec_for_param,
)

__all__ = [
    "use_mesh",
    "current_mesh",
    "fsdp_use",
    "constrain_batch",
    "FSDP_AXIS",
    "TP_AXIS",
    "BATCH_AXES",
    "PartitionSpec",
    "batch_axes",
    "batch_spec",
    "param_shardings",
    "data_shardings",
    "cache_shardings",
    "spec_for_param",
    "spec_for_cache",
]
