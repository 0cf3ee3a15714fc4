"""The port's whisper encoder-decoder (``repro_torch.models.whisper``)
against the JAX reference, on the CPU, at whisper-tiny's smoke width.

Weights are drawn once by the reference (plus numpy noise, so the
LayerNorms' unit scales and zero biases and the zero QKV biases take part)
and carried across by ``repro_torch.models.convert``; frames and tokens
come from numpy seeds; each reference result is computed once per module,
jitted.  Tolerances: float32 ``atol`` 1e-5 for the encoder output and the
caches, 1e-4 for logits; bfloat16 5e-2, as ``tests/test_torch_models.py``
states it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import whisper as ref_whisper
from repro_torch.configs import get_config
from repro_torch.models import common, convert, family_of, lm, whisper
from test_torch_common import _one_torch_thread  # noqa: F401


ARCH = "whisper-tiny"
B, S = 2, 12


def _noisy(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32)
                   + scale * rng.standard_normal(x.shape).astype(np.float32)),
        tree)


def _close(got, want, atol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else got, np.asarray(want, np.float32), atol=atol, rtol=0)


def _reference(cfg_r, p_ref, frames, tok, steps=2) -> dict:
    """The reference's encoder, teacher-forced decoder, prefill of S tokens
    into an S+4 cache and ``steps`` decode steps (jitted), numpy caches."""
    fr, tk = jnp.asarray(frames), jnp.asarray(tok)
    want = {"encode": jax.jit(ref_whisper.encode, static_argnums=0)(
        cfg_r, p_ref, fr)}
    want["decode_train"] = jax.jit(ref_whisper.decode_train,
                                   static_argnums=0)(cfg_r, p_ref, fr, tk)
    lg, c = jax.jit(ref_whisper.prefill, static_argnums=(0, 4))(
        cfg_r, p_ref, fr, tk[:, :S], S + 4)
    want["prefill"] = (lg, jax.tree.map(np.asarray, c))
    step = jax.jit(ref_whisper.decode_step, static_argnums=0)
    for i in range(steps):
        lg, c = step(cfg_r, p_ref, tk[:, S + i:S + i + 1],
                     jnp.full((B,), S + i, jnp.int32), c)
        want[f"decode{i}"] = (lg, jax.tree.map(np.asarray, c))
    return want


@pytest.fixture(scope="module")
def model():
    cfg_r = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    with jax.threefry_partitionable(False):
        tree = _noisy(jax.jit(lambda k: ref_whisper.init_params(cfg_r, k))(
            jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    frames = rng.standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 2)).astype(np.int32)
    want = _reference(cfg_r, jax.tree.map(jnp.asarray, tree), frames, tok)
    return cfg_r, cfg, convert.params_from_numpy(cfg, tree), tree, frames, \
        tok, want


def _same_cache(cfg, got, want, atol):
    """A port ``WhisperCache`` against the reference's (numpy leaves):
    every stacked leaf, self K/V and cross K/V."""
    got = convert.cache_to_numpy(cfg, got)
    for g, w in [(got.self_kv.k, want.self_kv.k),
                 (got.self_kv.v, want.self_kv.v),
                 (got.cross_k, want.cross_k), (got.cross_v, want.cross_v)]:
        assert g.shape == w.shape
        _close(g, w, atol)


def test_encode_matches_reference(model):
    _, cfg, p, _, frames, _, want = model
    out = whisper.encode(cfg, p, frames, device="cpu")
    assert out.shape == (B, cfg.encoder.n_frames, cfg.d_model)
    _close(out, want["encode"], 1e-5)


def test_decode_train_matches_reference(model):
    _, cfg, p, _, frames, tok, want = model
    lg = whisper.decode_train(cfg, p, frames, tok, device="cpu")
    assert lg.shape == (B, S + 2, cfg.vocab_size)
    _close(lg, want["decode_train"], 1e-4)


def test_prefill_and_decode_match_reference(model):
    """Prefill (encoder, then the prompt into an S+4 self cache and the
    cross K/V), then two decode steps: logits and every cache leaf after
    each, in the reference's stacked layout."""
    _, cfg, p, _, frames, tok, want = model
    lg, c = whisper.prefill(cfg, p, frames, tok[:, :S], S + 4, device="cpu")
    assert lg.shape == (B, 1, cfg.vocab_size)
    _close(lg, want["prefill"][0], 1e-4)
    _same_cache(cfg, c, want["prefill"][1], 1e-5)
    for i in range(2):
        lg, c = whisper.decode_step(
            cfg, p, tok[:, S + i:S + i + 1],
            np.full((B,), S + i, np.int32), c, device="cpu")
        _close(lg, want[f"decode{i}"][0], 1e-4)
        _same_cache(cfg, c, want[f"decode{i}"][1], 1e-5)


def test_caches_carry_across_both_ways(model):
    """The reference's prefill cache carried into the port decodes to the
    reference's logits, and carried back out it is the same tree."""
    _, cfg, p, _, _, tok, want = model
    c = convert.cache_from_numpy(cfg, want["prefill"][1])
    assert isinstance(c, whisper.WhisperCache)
    assert len(c.self_kv) == len(c.cross_k) == cfg.n_layers
    _same_cache(cfg, c, want["prefill"][1], 0)
    lg, _ = whisper.decode_step(cfg, p, tok[:, S:S + 1],
                                np.full((B,), S, np.int32), c, device="cpu")
    _close(lg, want["decode0"][0], 1e-4)
    empty = whisper.init_cache(cfg, B, S + 4, device="cpu")
    got = convert.cache_to_numpy(cfg, empty)
    assert got.self_kv.k.shape == want["prefill"][1].self_kv.k.shape
    assert got.cross_k.shape == want["prefill"][1].cross_k.shape


def test_bfloat16_prefill_and_decode_match_reference(model):
    """bf16 activations over float32 weights, as the full config runs."""
    _, _, _, tree, frames, tok, _ = model
    cfg_r = ref_get_config(ARCH, smoke=True, dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True, dtype="bfloat16")
    want = _reference(cfg_r, jax.tree.map(jnp.asarray, tree), frames, tok,
                      steps=1)
    p = convert.params_from_numpy(cfg, tree)
    _close(whisper.encode(cfg, p, frames, device="cpu"), want["encode"],
           5e-2)
    lg, c = whisper.prefill(cfg, p, frames, tok[:, :S], S + 4, device="cpu")
    assert lg.dtype == torch.bfloat16 and c.cross_k[0].dtype == torch.bfloat16
    _close(lg, want["prefill"][0], 5e-2)
    _same_cache(cfg, c, want["prefill"][1], 5e-2)
    lg, _ = whisper.decode_step(cfg, p, tok[:, S:S + 1],
                                np.full((B,), S, np.int32), c, device="cpu")
    _close(lg, want["decode0"][0], 5e-2)


def test_params_carry_across_and_counts_match_reference(model):
    """Every reference leaf lands in one port tensor; ``n_params()`` keeps
    the reference's quirk of counting ``lm.init_params``' tree even for
    whisper (27,005,568 at full width, the whisper family's tree being
    49,616,256), so ``lm.init_params`` builds an ``encdec`` config."""
    cfg_r, cfg, p, tree, _, _, _ = model
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    assert n_ref == sum(t.numel() for t in common._leaves(p))
    assert len(p["enc"]) == cfg.encoder.n_layers
    np.testing.assert_array_equal(p["dec"][1]["xattn"]["wk"].numpy(),
                                  tree["dec"]["stack"]["xattn"]["wk"][1])
    assert cfg.n_params() == cfg_r.n_params()
    full = get_config(ARCH)
    assert full.n_params() == 27_005_568
    meta = whisper.init_params(full, 0, device="meta")
    assert sum(t.numel() for t in common._leaves(meta)) == 49_616_256
    assert family_of(cfg).prefill is whisper.prefill
    assert family_of(get_config("qwen2.5-3b")).prefill is lm.prefill


def test_serve_launcher_refuses_encdec():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", ARCH], device="cpu")


def test_entry_points_run_on_the_card_unless_asked(model):
    _, cfg, p, _, frames, tok, _ = model
    if torch.cuda.is_available():
        return
    for call in (lambda: whisper.init_params(cfg, 0),
                 lambda: whisper.encode(cfg, p, frames),
                 lambda: whisper.prefill(cfg, p, frames, tok, S + 4),
                 lambda: whisper.init_cache(cfg, B, S)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
