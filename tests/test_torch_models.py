"""The port's model stack (``repro_torch.models``) against the JAX
reference, at smoke widths on the CPU.

Weights are drawn once by the reference, perturbed with numpy noise (so the
norm scales and QKV biases, zero at init, take part), and carried across by
``repro_torch.models.convert``; inputs come from numpy seeds.  Tolerances:
float32 ``atol`` 1e-5 for single layers and 1e-4 for whole-model logits
(the two frameworks sum in different orders); the bfloat16 case is stated
beside it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import ffn as ref_ffn
from repro.models import lm as ref_lm
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import attention, common, convert, ffn, lm, whisper
from repro_torch.models import family_of
from repro_torch.train import tree as ttree
from test_torch_common import _one_torch_thread  # noqa: F401


ARCH = "qwen2.5-3b"
B, S = 2, 32


def _noisy(tree, seed=0, scale=0.05):
    """The reference's tree as numpy leaves plus float32 noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32)
                   + scale * rng.standard_normal(x.shape).astype(np.float32)),
        tree)


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def model():
    cfg_r = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    tree = _noisy(ref_lm.init_params(cfg_r, jax.random.PRNGKey(0)))
    p_ref = jax.tree.map(jnp.asarray, tree)
    return cfg_r, cfg, p_ref, convert.params_from_numpy(cfg, tree), tree


def _close(got, want, atol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else got, np.asarray(want, np.float32), atol=atol, rtol=0)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------ primitives ----
def test_rms_norm_matches_reference():
    x, sc = _x((B, S, 64)), _x((64,), 2)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(sc)),
           ref_common.rms_norm(jnp.asarray(x), jnp.asarray(sc)), 1e-5)


def test_apply_rope_matches_reference():
    x = _x((B, S, 4, 16))
    pos = np.random.default_rng(3).integers(0, 4096, (B, S)).astype(np.int32)
    cos_r, sin_r = ref_common.rope_angles(jnp.asarray(pos), 16, 1e6)
    cos, sin = common.rope_angles(torch.from_numpy(pos), 16, 1e6)
    _close(cos, cos_r, 1e-5)
    _close(sin, sin_r, 1e-5)
    _close(common.apply_rope(torch.from_numpy(x), cos, sin),
           ref_common.apply_rope(jnp.asarray(x), cos_r, sin_r), 1e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_and_unembed_match_reference(tied):
    cfg_r = ref_get_config(ARCH, smoke=True, tie_embeddings=tied,
                           scale_embed=True, logit_softcap=30.0)
    cfg = get_config(ARCH, smoke=True, tie_embeddings=tied,
                     scale_embed=True, logit_softcap=30.0)
    p_ref, tree = _both(_noisy(ref_common.init_embed(
        cfg_r, jax.random.PRNGKey(1))))
    p = convert._map(tree, convert._tensor)
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S))
    x_r = ref_common.embed_tokens(cfg_r, p_ref, jnp.asarray(tok))
    x = common.embed_tokens(cfg, p, torch.from_numpy(tok))
    _close(x, x_r, 1e-5)
    _close(common.unembed(cfg, p, x), ref_common.unembed(cfg_r, p_ref, x_r),
           1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_forward_matches_reference(gated):
    cfg_r = ref_get_config(ARCH, smoke=True, gated_ffn=gated, act="gelu")
    cfg = get_config(ARCH, smoke=True, gated_ffn=gated, act="gelu")
    p_ref, tree = _both(_noisy(ref_ffn.init_mlp(cfg_r,
                                                jax.random.PRNGKey(2))))
    p = convert._map(tree, convert._tensor)
    x = _x((B, S, cfg.d_model))
    _close(ffn.mlp_forward(cfg, p, torch.from_numpy(x)),
           ref_ffn.mlp_forward(cfg_r, p_ref, jnp.asarray(x)), 1e-5)


# ------------------------------------------------------------- attention ----
CACHES = {"global": dict(window=None, kv_cache_dtype="bfloat16"),
          "ring": dict(window=8, kv_cache_dtype="bfloat16"),
          "int8": dict(window=None, kv_cache_dtype="int8")}


def _attn_pair(kind):
    kw = CACHES[kind]
    cfg_r = ref_get_config(ARCH, smoke=True,
                           kv_cache_dtype=kw["kv_cache_dtype"])
    cfg = get_config(ARCH, smoke=True, kv_cache_dtype=kw["kv_cache_dtype"])
    p_ref, tree = _both(_noisy(ref_attn.init_attention(
        cfg_r, jax.random.PRNGKey(3))))
    return cfg_r, cfg, p_ref, convert._map(tree, convert._tensor), \
        kw["window"]


def _same_cache(c, c_r):
    """Every field of a port cache against the reference's: int8 values to
    one step (a rounding tie can land either side), the rest to 1e-5."""
    for got, want in zip(c, c_r):
        assert (got is None) == (want is None)
        if got is not None:
            tol = 1.0 if got.dtype == torch.int8 else 1e-5
            _close(got, want, tol)


@pytest.mark.parametrize("kind", list(CACHES))
def test_attention_forward_and_decode_match_reference(kind):
    """Prefill of S tokens (output and cache), then three decode steps
    against the cache (output and cache after each)."""
    cfg_r, cfg, p_ref, p, window = _attn_pair(kind)
    x = _x((B, S + 3, cfg.d_model), 5)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    y_r, c_r = ref_attn.attention_forward(
        cfg_r, p_ref, jnp.asarray(x[:, :S]), jnp.asarray(pos),
        window=window, make_cache=True)
    y, c = attention.attention_forward(
        cfg, p, torch.from_numpy(x[:, :S]), torch.from_numpy(pos.copy()),
        window=window, make_cache=True)
    _close(y, y_r, 1e-5)
    # the reference's padding of a global cache to S_max (lm._pad_caches)
    if window is None:
        c_r = ref_lm._pad_caches(cfg_r, {"l": c_r}, S, S + 8)["l"]
        c = lm._pad_caches(cfg, [c], S, S + 8)[0]
    _same_cache(c, c_r)
    for step in range(3):
        at = np.full((B,), S + step, np.int32)
        y_r, c_r = ref_attn.attention_decode(
            cfg_r, p_ref, jnp.asarray(x[:, S + step:S + step + 1]),
            jnp.asarray(at), c_r, window=window)
        y, c = attention.attention_decode(
            cfg, p, torch.from_numpy(x[:, S + step:S + step + 1]),
            torch.from_numpy(at), c, window=window)
        _close(y, y_r, 1e-5)
        _same_cache(c, c_r)


def test_int8_cache_quantizes_like_reference():
    t = _x((B, S, 2, 16), 6) * 3
    q_r, s_r = ref_attn._quantize_kv(jnp.asarray(t))
    q, s = attention._quantize_kv(torch.from_numpy(t))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(q_r))
    _close(s, s_r, 1e-7)


# ----------------------------------------------------------------- model ----
def _tokens(cfg, seed=7, n=S + 4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def test_forward_matches_reference(model):
    cfg_r, cfg, p_ref, p, _ = model
    tok = _tokens(cfg)
    want, aux_r = ref_lm.forward(cfg_r, p_ref, jnp.asarray(tok),
                                 eval_mode=True)
    got, aux = lm.forward(cfg, p, torch.from_numpy(tok), eval_mode=True,
                          device="cpu")
    assert got.shape == (B, S + 4, cfg.vocab_size)
    _close(got, want, 1e-4)
    assert float(aux) == float(aux_r) == 0.0


def test_prefill_and_decode_match_reference(model):
    """Prefill S tokens into an S+8 cache, then decode 4 tokens; logits and
    every cache tensor after each call, in the reference's layout."""
    cfg_r, cfg, p_ref, p, _ = model
    tok = _tokens(cfg)
    lg_r, c_r = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok[:, :S]),
                               s_max=S + 8)
    lg, c = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]), s_max=S + 8,
                       device="cpu")
    assert lg.shape == (B, 1, cfg.vocab_size)
    _close(lg, lg_r, 1e-4)

    def same_cache(c, c_r):
        got = convert.cache_to_numpy(cfg, c)
        assert set(got) == set(c_r) == {"stack"}
        for f in ("k", "v"):
            _close(getattr(got["stack"]["p0"], f),
                   getattr(c_r["stack"]["p0"], f), 1e-5)

    same_cache(c, c_r)
    for i in range(4):
        at = np.full((B,), S + i, np.int32)
        lg_r, c_r = ref_lm.decode_step(cfg_r, p_ref,
                                       jnp.asarray(tok[:, S + i:S + i + 1]),
                                       jnp.asarray(at), c_r)
        lg, c = lm.decode_step(cfg, p, torch.from_numpy(tok[:, S + i:S + i + 1]),
                               torch.from_numpy(at), c, device="cpu")
        _close(lg, lg_r, 1e-4)
        same_cache(c, c_r)


def test_decode_from_a_carried_cache(model):
    """A cache built by the reference, carried across by
    ``cache_from_numpy``, decodes to the reference's logits."""
    cfg_r, cfg, p_ref, p, _ = model
    tok = _tokens(cfg, seed=8)
    _, c_r = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok[:, :S]),
                            s_max=S + 8)
    c = convert.cache_from_numpy(cfg, jax.tree.map(np.asarray, c_r))
    at = np.full((B,), S, np.int32)
    lg_r, _ = ref_lm.decode_step(cfg_r, p_ref, jnp.asarray(tok[:, S:S + 1]),
                                 jnp.asarray(at), c_r)
    lg, _ = lm.decode_step(cfg, p, torch.from_numpy(tok[:, S:S + 1]),
                           torch.from_numpy(at), c, device="cpu")
    _close(lg, lg_r, 1e-4)


def test_bfloat16_prefill_and_decode_match_reference(model):
    """``dtype=bfloat16`` activations over float32 weights, as the full
    config runs.  Tolerance: 0.05 on logits of magnitude ~1-4 — both sides
    round every activation to bfloat16 (8 bits of mantissa, a relative
    step of 2^-8 ≈ 0.004) but at different points (XLA fuses, torch rounds
    each op), and two layers compound that."""
    _, _, _, _, tree = model
    cfg_r = ref_get_config(ARCH, smoke=True, dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True, dtype="bfloat16")
    p_ref = jax.tree.map(jnp.asarray, tree)
    p = convert.params_from_numpy(cfg, tree)
    tok = _tokens(cfg, seed=9)
    lg_r, c_r = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok[:, :S]),
                               s_max=S + 4)
    lg, c = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]), s_max=S + 4,
                       device="cpu")
    assert lg.dtype == torch.bfloat16
    assert c[0].k.dtype == torch.bfloat16
    _close(lg, lg_r, 5e-2)
    got = convert.cache_to_numpy(cfg, c)
    _close(got["stack"]["p0"].k, c_r["stack"]["p0"].k, 5e-2)
    at = np.full((B,), S, np.int32)
    lg_r, _ = ref_lm.decode_step(cfg_r, p_ref, jnp.asarray(tok[:, S:S + 1]),
                                 jnp.asarray(at), c_r)
    lg, _ = lm.decode_step(cfg, p, torch.from_numpy(tok[:, S:S + 1]),
                           torch.from_numpy(at), c, device="cpu")
    _close(lg, lg_r, 5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [300, 384])
def test_prefill_of_unblocked_lengths_matches_reference(model, s, dtype):
    """ROADMAP C6: prompts of 300 and 384 tokens, no multiple of the
    Pallas kernel's 256-row blocks, prefill through ``impl="auto"`` (the
    plain B3 on the CPU) as the reference's prefill does off a TPU (its
    XLA path).  Logits and the KV cache, at the whole-model tolerances
    above: 1e-4 in float32, 5e-2 in bfloat16."""
    _, _, _, _, tree = model
    cfg_r = ref_get_config(ARCH, smoke=True, dtype=dtype)
    cfg = get_config(ARCH, smoke=True, dtype=dtype)
    assert cfg.attn_impl == "auto"
    p_ref = jax.tree.map(jnp.asarray, tree)
    p = convert.params_from_numpy(cfg, tree)
    tok = np.random.default_rng(s).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32)
    lg_r, c_r = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok), s_max=s + 4)
    lg, c = lm.prefill(cfg, p, torch.from_numpy(tok), s_max=s + 4,
                       device="cpu")
    tol = 1e-4 if dtype == "float32" else 5e-2
    _close(lg, lg_r, tol)
    got = convert.cache_to_numpy(cfg, c)
    for f in ("k", "v"):
        _close(getattr(got["stack"]["p0"], f),
               getattr(c_r["stack"]["p0"], f), tol)


def test_cast_params_keeps_the_numbers(model):
    _, _, _, p, _ = model
    cfg = get_config(ARCH, smoke=True, dtype="bfloat16")
    tok = torch.from_numpy(_tokens(cfg, seed=10))
    a, _ = lm.prefill(cfg, p, tok, device="cpu")
    cast = lm.cast_params(cfg, p)
    assert cast["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["blocks"][0]["attn"]["bq"].dtype == torch.bfloat16
    assert cast["blocks"][0]["pre_norm"]["scale"].dtype == torch.float32
    b, _ = lm.prefill(cfg, cast, tok, device="cpu")
    assert torch.equal(a, b)


def test_params_carry_across_one_to_one(model):
    """Every leaf of the reference's tree lands in exactly one port tensor
    (the scan-stacked layers unstacked), and the parameter counts agree."""
    cfg_r, cfg, _, p, tree = model
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    n_port = sum(t.numel() for t in common._leaves(p))
    assert n_ref == n_port == cfg.n_params() == cfg_r.n_params()
    assert len(p["blocks"]) == cfg.n_layers
    np.testing.assert_array_equal(
        p["blocks"][1]["mlp"]["wo"].numpy(),
        tree["blocks"]["stack"]["p0"]["mlp"]["wo"][1])


def test_full_config_counts_3_086b_parameters():
    assert get_config(ARCH).n_params() == 3_085_938_688


#: the cast trees ``chip_smoke.py``'s phase 24 holds on the card: (arch,
#: parameters, GiB of the bf16 tree to one decimal)
CAST_FITS = (("gemma-7b", 8_537_680_896, 15.9),
             ("codeqwen1.5-7b", 8_190_038_016, 15.3),
             ("chameleon-34b", 34_293_436_416, 63.9))


@pytest.mark.parametrize("arch,n,gib", CAST_FITS)
def test_full_config_cast_tree_fits_the_card(arch, n, gib):
    """The full config's ``init_params(cast=True)`` tree, on the ``meta``
    device: every leaf of two or more dims in bf16 but
    ``lm.FLOAT32_LEAVES``, the vectors (norm scales, qk-norm) in float32,
    and the bytes those make, which set what fits beside it on an 80 GB
    card."""
    cfg = get_config(arch)
    flat = ttree.flatten(lm.init_params(cfg, 0, device="meta", cast=True))
    leaves = [t for _, t in flat]
    assert all(t.device.type == "meta" for t in leaves)
    for path, t in flat:
        want = (torch.float32 if t.dim() < 2 or path[-1] in lm.FLOAT32_LEAVES
                else torch.bfloat16)
        assert t.dtype == want, path
    assert sum(t.numel() for t in leaves) == n == cfg.n_params() \
        == ref_get_config(arch).n_params()
    assert round(sum(t.numel() * t.element_size() for t in leaves) / 2**30,
                 1) == gib



@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_resolves_and_unported_layers_raise(arch):
    """Every arch's config equals the reference's, and every arch builds
    and runs on the CPU: no layer kind is left unported (MoE, MLA and the
    encoder-decoder landed with ROADMAP A11), so nothing raises."""
    cfg = get_config(arch, smoke=True)
    # the config modules are the reference's, copied
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_get_config(arch, smoke=True))
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        ref_get_config(arch))
    fam = family_of(cfg)
    p = fam.init_params(cfg, 0, device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.long)
    if cfg.arch_type == "encdec":
        assert fam.prefill is whisper.prefill
        frames = torch.zeros((1, cfg.encoder.n_frames, cfg.d_model))
        logits, _ = whisper.prefill(cfg, p, frames, tok, 8, device="cpu")
        assert logits.shape == (1, 1, cfg.vocab_size)
    else:
        assert fam.prefill is lm.prefill
        logits, _ = lm.forward(cfg, p, tok, device="cpu")
        assert logits.shape == (1, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()


DENSE = [a for a in ARCHS if a != ARCH and not (
    set(get_config(a, smoke=True).layer_kinds) - {"attn", "attn_local"}
    or get_config(a, smoke=True).moe is not None
    or get_config(a, smoke=True).arch_type == "encdec")]


@pytest.mark.parametrize("arch", DENSE)
def test_other_dense_archs_match_reference(arch):
    """The other dense configs (GeGLU and scaled embeddings, qk-norm, MHA,
    head dim 32): forward, prefill and one decode step against the
    reference, float32 logits to 1e-4."""
    _dense_matches_reference(arch)


def test_phi3_at_its_own_head_dim_matches_reference():
    """phi3-mini's smoke config at the arch's own head dim, 96 (32 columns
    past the 64-column slabs of B3's other tensor-core builds): forward,
    prefill and one decode step against the reference, float32 logits to
    1e-4."""
    _dense_matches_reference("phi3-mini-3.8b", head_dim=96)


def _dense_matches_reference(arch, **overrides):
    cfg_r = ref_get_config(arch, smoke=True, **overrides)
    cfg = get_config(arch, smoke=True, **overrides)
    tree = _noisy(ref_lm.init_params(cfg_r, jax.random.PRNGKey(5)), seed=5)
    p_ref = jax.tree.map(jnp.asarray, tree)
    p = convert.params_from_numpy(cfg, tree)
    tok = _tokens(cfg, seed=11)
    want, _ = ref_lm.forward(cfg_r, p_ref, jnp.asarray(tok), eval_mode=True)
    got, _ = lm.forward(cfg, p, torch.from_numpy(tok), eval_mode=True,
                        device="cpu")
    _close(got, want, 1e-4)
    lg_r, c_r = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok[:, :S]),
                               s_max=S + 4)
    lg, c = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]), s_max=S + 4,
                       device="cpu")
    _close(lg, lg_r, 1e-4)
    at = np.full((B,), S, np.int32)
    lg_r, _ = ref_lm.decode_step(cfg_r, p_ref, jnp.asarray(tok[:, S:S + 1]),
                                 jnp.asarray(at), c_r)
    lg, _ = lm.decode_step(cfg, p, torch.from_numpy(tok[:, S:S + 1]),
                           torch.from_numpy(at), c, device="cpu")
    _close(lg, lg_r, 1e-4)
