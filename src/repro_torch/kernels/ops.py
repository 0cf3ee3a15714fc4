"""Public entry points of the port's kernels (the reference's
``repro.kernels.ops``).  Each wrapper launches its CUDA kernel on CUDA
tensors and runs its plain PyTorch version on CPU tensors."""

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fingerprint_filter import fingerprint_filter
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels import lru_scan as _lru
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.tickfuse import tickfuse_masked, \
    tickfuse_response_path


def attention(q, k, v, *, causal=True, window=None, sm_scale=None,
              impl: str = "auto"):
    """Multi-head attention; q (B,H,S,D), k/v (B,Hkv,S,D).

    ``impl`` as in the reference: ``"auto"`` and ``"pallas"`` take kernel
    B3 (:func:`flash_attention`: the CUDA kernel on a CUDA tensor, its plain
    version on a CPU tensor); ``"xla"`` names the reference's XLA oracle,
    whose port is :func:`~repro_torch.kernels.ref.attention_ref`.  Every
    path takes any sequence length, as the reference's ``"auto"`` does off
    a TPU; causal or windowed attention needs ``Sq == Skv`` on the kernel
    path (ROADMAP C2)."""
    if impl == "xla":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  sm_scale=sm_scale)
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention(q, k, v, causal=causal, window=window,
                           sm_scale=sm_scale)


def _impl(impl: str) -> str:
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def ssd_scan(x, a, b_mat, c_mat, h0=None, *, impl: str = "auto",
             chunk: int = 128):
    """mamba2 SSD scan; returns ``(y, final_state)``.  ``"auto"`` and
    ``"pallas"`` take kernel B4 (:func:`repro_torch.kernels.ssd_scan.
    ssd_scan`: the CUDA kernel on a CUDA tensor, its plain version on a
    CPU tensor); ``"xla"`` names the reference's XLA path, whose port is
    :func:`~repro_torch.kernels.ref.ssd_scan_ref`, here at the same
    ``chunk`` (the reference's drops it, ROADMAP C5).  Both hold B4's
    length contract."""
    if _impl(impl) == "xla":
        _ssd.check_ssd_args(x, a, b_mat, c_mat, h0, chunk)
        return _ref.ssd_scan_ref(x, a, b_mat, c_mat, h0, chunk=chunk)
    return _ssd.ssd_scan(x, a, b_mat, c_mat, h0, chunk=chunk)


def lru_scan(x, a, h0=None, *, impl: str = "auto"):
    """RG-LRU diagonal recurrence; returns ``(y, final_state)``.
    ``"auto"`` and ``"pallas"`` take kernel B5 (:func:`repro_torch.kernels.
    lru_scan.lru_scan`); ``"xla"`` its plain version
    :func:`~repro_torch.kernels.ref.lru_scan_ref`.  Both take any ``S, D
    >= 1``, as the reference's ``"auto"`` does off a TPU."""
    if _impl(impl) == "xla":
        _lru.check_lru_args(x, a, h0)
        return _ref.lru_scan_ref(x, a, h0)
    return _lru.lru_scan(x, a, h0)


__all__ = ["attention", "fingerprint_filter", "flash_attention",
           "lru_scan", "ssd_scan", "tickfuse_masked",
           "tickfuse_response_path"]
