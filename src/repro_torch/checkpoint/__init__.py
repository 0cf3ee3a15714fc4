"""Checkpointing, port of ``repro.checkpoint``: atomic save, restore onto
a device, async writer."""

from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, \
    load_tree, restore, save

__all__ = ["save", "restore", "load_tree", "latest_step",
           "AsyncCheckpointer"]
