"""Helpers the port's test modules share; this module holds no tests.

A module takes the thread policy with

    from test_torch_common import _one_torch_thread  # noqa: F401

(pytest finds the fixture in the module's namespace), and the scan tests
their common input and comparison helpers from here.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops in one thread while this module runs: the suite runs
    one worker process a core, and an OpenMP pool in every worker would
    oversubscribe the cores many times over (its threads spin waiting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _round(a, dtype):
    """``a`` rounded to ``dtype`` and back to float32 numpy (exact both
    ways), so both packages see the same values."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _torch(arrs, state, dtype, device="cpu"):
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)).to(device)
          for a in arrs]
    return ts, None if state is None else torch.from_numpy(state).to(device)


def _jax(arrs, state, dtype):
    jnp = pytest.importorskip("jax.numpy")
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            None if state is None else jnp.asarray(state))


def close_scans(got, want, dtype, tol, bf16_rtol):
    """The outputs and final state of one scan against another's: within
    ``tol`` in float32, within ``bf16_rtol`` of max |want| in bfloat16."""
    for g, w in zip(got, want):
        g = g.detach().float().cpu().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g, np.float32)
        w = w.detach().float().cpu().numpy() if isinstance(w, torch.Tensor) \
            else np.asarray(w, np.float32)
        assert g.shape == w.shape
        atol = tol if dtype == "float32" else bf16_rtol * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
