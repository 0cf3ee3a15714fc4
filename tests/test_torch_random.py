"""The port's threefry stream is ``jax.random``'s, word for word.

Every comparison runs the reference under ``jax.threefry_partitionable(
False)`` — the stream the FleetSim goldens were captured in — and batches
the reference with ``vmap`` the way the engine does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as jr
from test_torch_common import _one_torch_thread  # noqa: F401


SEEDS = np.array([0, 1, 7, 123456, -5, 2 ** 31 - 1], np.int32)


def _keys():
    with jax.threefry_partitionable(False):
        jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(SEEDS))
    return jk, jr.PRNGKey(torch.from_numpy(SEEDS))


def _same(jax_out, torch_out):
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    assert want.shape == got.shape
    assert np.array_equal(want, got)


def test_prng_key_matches():
    jk, tk = _keys()
    _same(jk, tk)


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_matches(num):
    jk, tk = _keys()
    with jax.threefry_partitionable(False):
        want = jax.vmap(lambda k: jax.random.split(k, num))(jk)
    _same(want, jr.split(tk, num))


@pytest.mark.parametrize("data", [0, 1, 12345])
def test_fold_in_matches(data):
    jk, tk = _keys()
    with jax.threefry_partitionable(False):
        want = jax.vmap(lambda k: jax.random.fold_in(k, data))(jk)
    _same(want, jr.fold_in(tk, data))


@pytest.mark.parametrize("shape", [(1,), (7,), (12, 6), (8, 7), (6, 15, 2)])
def test_uniform_matches(shape):
    jk, tk = _keys()
    with jax.threefry_partitionable(False):
        want = jax.vmap(lambda k: jax.random.uniform(k, shape))(jk)
    _same(want, jr.uniform(tk, shape))


def test_keys_with_extra_axes_draw_like_single_keys():
    """A ``(G, n, 2)`` key batch draws what each key draws alone — the
    engine draws a chunk of ticks' uniforms that way."""
    _, tk = _keys()
    keys = jr.split(tk, 4)                           # (G, 4, 2)
    both = jr.uniform(keys, (6, 15, 2))
    for i in range(4):
        assert torch.equal(both[:, i], jr.uniform(keys[:, i], (6, 15, 2)))
    assert torch.equal(jr.split(keys, 3)[:, 2], jr.split(keys[:, 2], 3))


def test_draw_ticks_chunks_equal_tick_by_tick():
    from repro_torch.fleetsim.config import FleetConfig
    from repro_torch.fleetsim.stages import draw_ticks

    cfg = FleetConfig(n_racks=2, n_servers=4, n_workers=8, queue_cap=64)
    _, tk = _keys()
    chunk = draw_ticks(cfg, tk, 5)
    key = tk
    for d in chunk:
        one = draw_ticks(cfg, key, 1)[0]
        for a, b in zip(d, one):
            assert torch.equal(a, b)
        key = one.key


def test_poisson_matches_both_branches():
    """One batched draw over rates on both sides of the Knuth/rejection
    switch at 10 (and λ = 0), as the engine's per-config arrival counts."""
    lams = np.array([0.1, 1.0, 3.6, 9.9, 12.0, 40.0, 0.0], np.float32)
    n = 3000
    seeds = np.arange(len(lams), dtype=np.int32)
    with jax.threefry_partitionable(False):
        keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
        want = jax.jit(jax.vmap(
            lambda k, lam: jax.random.poisson(k, lam, (n,))))(
                keys, jnp.asarray(lams))
    got = jr.poisson(jr.PRNGKey(torch.from_numpy(seeds)),
                     torch.from_numpy(lams), n)
    _same(want, got)
    assert got.dtype == torch.int32
    np.testing.assert_allclose(got.double().mean(1).numpy(), lams,
                               rtol=0.1, atol=0.02)


def test_float_helpers_are_correctly_rounded():
    x = torch.tensor([1e-3, 0.5, 1.0, 7.25, 1e5], dtype=torch.float32)
    want = np.log(x.numpy().astype(np.float64)).astype(np.float32)
    assert np.array_equal(jr.log_f32(x).numpy(), want)
    y = -x[:3] * 0.5
    want = np.log1p(y.numpy().astype(np.float64)).astype(np.float32)
    assert np.array_equal(jr.log1p_f32(y).numpy(), want)


def test_number_over_tensor_divides_once():
    """``over(number, t)`` is one float32 division, as XLA's: torch's own
    ``number / t`` is ``reciprocal(t) * number`` and differs in the last
    bit for many quotients (ROADMAP C9).  The bounded-Pareto service
    draw divides this way."""
    t = (np.random.default_rng(5).random(1 << 16, dtype=np.float32)
         * 50 + 0.5)
    want = np.float32(7.3) / t
    got = jr.over(7.3, torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((7.3 / torch.from_numpy(t)).numpy() != want).any()
