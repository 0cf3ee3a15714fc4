"""Public entry points of the port's kernels (the reference's
``repro.kernels.ops``).  Each wrapper launches its CUDA kernel on CUDA
tensors and runs its plain PyTorch version on CPU tensors.  The SSD and
LRU scan kernels of the reference are not ported yet (ROADMAP queue B)."""

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fingerprint_filter import fingerprint_filter
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.tickfuse import tickfuse_response_path


def attention(q, k, v, *, causal=True, window=None, sm_scale=None,
              impl: str = "auto"):
    """Multi-head attention; q (B,H,S,D), k/v (B,Hkv,S,D).

    ``impl`` as in the reference: ``"auto"`` and ``"pallas"`` take kernel
    B3 (:func:`flash_attention`: the CUDA kernel on a CUDA tensor, its plain
    version on a CPU tensor); ``"xla"`` names the reference's XLA oracle,
    whose port is :func:`~repro_torch.kernels.ref.attention_ref`."""
    if impl == "xla":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  sm_scale=sm_scale)
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention(q, k, v, causal=causal, window=window,
                           sm_scale=sm_scale)


__all__ = ["attention", "fingerprint_filter", "flash_attention",
           "tickfuse_response_path"]
