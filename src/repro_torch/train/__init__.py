"""Training on one device, port of ``repro.train``: AdamW, int8 gradient
compression with error feedback, and the step builder."""

from repro_torch.train.compress import EFState, compress_grads, init_ef_state
from repro_torch.train.optimizer import (
    OptimizerConfig,
    OptState,
    adamw_update,
    init_opt_state,
    lr_at,
)
from repro_torch.train.step import TrainState, TrainStepBundle, \
    make_train_step

__all__ = [
    "OptimizerConfig",
    "OptState",
    "adamw_update",
    "init_opt_state",
    "lr_at",
    "EFState",
    "compress_grads",
    "init_ef_state",
    "TrainState",
    "TrainStepBundle",
    "make_train_step",
]
