"""Public entry points of the port's kernels (the reference's
``repro.kernels.ops``).  Each wrapper launches its CUDA kernel on CUDA
tensors and runs its plain PyTorch version on CPU tensors; the flash
attention and scan kernels of the reference are not ported yet (see
``ROADMAP.md`` queue B)."""

from repro_torch.kernels.fingerprint_filter import fingerprint_filter
from repro_torch.kernels.tickfuse import tickfuse_response_path

__all__ = ["fingerprint_filter", "tickfuse_response_path"]
