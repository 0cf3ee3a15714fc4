"""Data pipeline, port of ``repro.data``: seeded synthetic LM streams with
host sharding and prefetch (numpy only; a copy of the reference's)."""

from repro_torch.data.pipeline import DataConfig, PrefetchingLoader, \
    SyntheticLM

__all__ = ["DataConfig", "SyntheticLM", "PrefetchingLoader"]
