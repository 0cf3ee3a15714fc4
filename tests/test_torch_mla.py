"""The port's multi-head latent attention (``repro_torch.models.attention``'s
MLA) and the deepseek-v2-lite-16b smoke model (MLA plus MoE) against the
JAX reference, on the CPU.

Weights are drawn once by the reference (plus numpy noise, so the zero-init
norm scales take part) and carried across by ``repro_torch.models.
convert``; inputs come from numpy seeds; each reference result is computed
once per module, jitted.  Tolerances: float32 ``atol`` 1e-5 for one layer,
1e-4 for whole-model logits; bfloat16 5e-2, as ``tests/test_torch_models.
py`` states it, with the MoE near-tie rule of ``tests/test_torch_moe.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import lm as ref_lm
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention, common, convert, ffn, lm
from test_torch_common import _one_torch_thread  # noqa: F401


ARCH = "deepseek-v2-lite-16b"
B, S = 2, 32
#: see tests/test_torch_moe.py
NEAR_TIE = 2.0 ** -8


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


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------ the mixer ----
@pytest.fixture(scope="module")
def mixer():
    cfg_r = ref_get_config(ARCH, smoke=True)
    with jax.threefry_partitionable(False):
        tree = _noisy(jax.jit(lambda k: ref_attn.init_mla(cfg_r, k))(
            jax.random.PRNGKey(3)))
    return cfg_r, jax.tree.map(jnp.asarray, tree), \
        convert._map(tree, convert._tensor)


#: (activation dtype, kv_cache_dtype, tolerance)
MIXER_CASES = {"float32": ("float32", "bfloat16", 1e-5),
               "float32_int8_cache": ("float32", "int8", 1e-5),
               "bfloat16": ("bfloat16", "bfloat16", 5e-2)}


@pytest.mark.parametrize("case", list(MIXER_CASES))
def test_mla_forward_and_decode_match_reference(mixer, case):
    """``mla_forward`` over S tokens (output and the latent cache, padded
    as ``lm._pad_caches`` pads it), then three absorbed ``mla_decode``
    steps (output and cache after each).  MLA ignores ``kv_cache_dtype``,
    as the reference does: an int8 setting changes nothing.  In bf16 only
    the forward is held: this XLA's CPU backend refuses the reference's
    bf16 x bf16 = f32 decode products ("Unsupported element type for
    DotThunk"), so its bf16 decode does not run here."""
    dtype, kv_cache_dtype, tol = MIXER_CASES[case]
    _, p_ref, p = mixer
    cfg_r = ref_get_config(ARCH, smoke=True, dtype=dtype)
    cfg = get_config(ARCH, smoke=True, dtype=dtype,
                     kv_cache_dtype=kv_cache_dtype)
    dt = cfg.activation_dtype
    x = _x((B, S + 3, cfg.d_model), 5)
    xr = jnp.asarray(x).astype(cfg_r.activation_dtype)
    xt = torch.from_numpy(x).to(dt)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    y_r, c_r = ref_attn.mla_forward(cfg_r, p_ref, xr[:, :S],
                                    jnp.asarray(pos), make_cache=True)
    y, c = attention.mla_forward(cfg, p, xt[:, :S],
                                 torch.from_numpy(pos.copy()),
                                 make_cache=True)
    _close(y, y_r, tol)
    c_r = ref_lm._pad_caches(cfg_r, {"l": c_r}, S, S + 8)["l"]
    c = lm._pad_caches(cfg, [c], S, S + 8)[0]
    assert c.k.shape == (B, S + 8, cfg.mla.kv_lora_rank)
    assert c.v.shape == (B, S + 8, cfg.mla.qk_rope_dim)
    assert c.k.dtype == dt and c.k_scale is None
    _close(c.k, c_r.k, tol)
    _close(c.v, c_r.v, tol)
    for i in range(3 if dtype == "float32" else 0):
        at = np.full((B,), S + i, np.int32)
        y_r, c_r = ref_attn.mla_decode(cfg_r, p_ref, xr[:, S + i:S + i + 1],
                                       jnp.asarray(at), c_r)
        y, c = attention.mla_decode(cfg, p, xt[:, S + i:S + i + 1],
                                    torch.from_numpy(at), c)
        _close(y, y_r, tol)
        _close(c.k, c_r.k, tol)
        _close(c.v, c_r.v, tol)
    empty = attention.init_mla_cache(cfg, B, 8, "cpu")
    assert empty.k.shape == (B, 8, cfg.mla.kv_lora_rank)
    assert empty.k.dtype == cfg.activation_dtype


def test_mla_prefill_never_reaches_b3(mixer, monkeypatch):
    """MLA pins the plain attention (``impl="xla"``), as the reference
    does: q/k heads of 24 dims and v heads of 16 here (192 and 128 at full
    width) never go to kernel B3, whatever ``attn_impl`` says."""
    _, _, p = mixer
    cfg = get_config(ARCH, smoke=True, attn_impl="pallas")
    seen = []
    real = ops.attention

    def spy(*a, impl="auto", **k):
        seen.append(impl)
        return real(*a, impl=impl, **k)

    monkeypatch.setattr(ops, "attention", spy)
    x = torch.from_numpy(_x((B, S, cfg.d_model)))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    attention.mla_forward(cfg, p, x, pos)
    assert seen == ["xla"]


#: the bf16 decode's tolerance against the reference's float32 decode of the
#: same bf16 values: the float32 decode tolerance (1e-5) plus four bf16
#: roundings (2^-8 each) of max |y| — the output's own and the port's
#: rounding points on the way (the query, the latent written to the cache,
#: the probabilities, the latent sum)
BF16_DECODE_STEPS = 4 * 2.0 ** -8


def test_bf16_mla_decode_matches_reference_on_bf16_values(mixer):
    """C12: the port's bf16 absorbed decode against the reference's
    ``mla_decode`` run in float32 on the same bf16-valued weights, inputs
    and cache (this XLA's CPU refuses the reference's own bf16 products).
    bf16 products are exact in float32, so the two differ by summation
    order and by the bf16 roundings of the port's path: three steps, the
    output held to ``1e-5 + BF16_DECODE_STEPS · max |y|`` (measured
    0.0045-0.0060 of max |y| with torch 2.13 and jax 0.9.0: a margin of
    2.6x) and the written latent and rope key to two bf16 roundings of
    their max."""
    cfg_r, p_ref, _ = mixer
    cfg = get_config(ARCH, smoke=True, dtype="bfloat16")

    def bf(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16).float().numpy()

    tree = jax.tree.map(bf, p_ref)
    p = convert._map(tree, convert._tensor)
    rng = np.random.default_rng(4)
    r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_dim
    ck = bf(rng.standard_normal((B, S + 8, r)))
    kr = bf(rng.standard_normal((B, S + 8, dr)))
    ck[:, S:] = kr[:, S:] = 0
    cache_r = ref_attn.KVCache(k=jnp.asarray(ck), v=jnp.asarray(kr))
    cache = attention.KVCache(k=torch.from_numpy(ck).to(torch.bfloat16),
                              v=torch.from_numpy(kr).to(torch.bfloat16))
    step = jax.jit(ref_attn.mla_decode, static_argnums=0)
    for i in range(3):
        x = bf(rng.standard_normal((B, 1, cfg.d_model)))
        at = np.full((B,), S + i, np.int32)
        y_r, cache_r = step(cfg_r, jax.tree.map(jnp.asarray, tree),
                            jnp.asarray(x), jnp.asarray(at), cache_r)
        y, cache = attention.mla_decode(
            cfg, p, torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(at), cache)
        assert y.dtype == torch.bfloat16
        y_r = np.asarray(y_r)
        _close(y, y_r, 1e-5 + BF16_DECODE_STEPS * np.abs(y_r).max())
        for got, want in ((cache.k, cache_r.k), (cache.v, cache_r.v)):
            want = np.asarray(want)
            _close(got, want, 2 * 2.0 ** -8 * np.abs(want).max())


# ------------------------------------------------------------ the model ----
@pytest.fixture(scope="module")
def model():
    cfg_r = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    with jax.threefry_partitionable(False):
        tree = _noisy(jax.jit(lambda k: ref_lm.init_params(cfg_r, k))(
            jax.random.PRNGKey(0)))
    p_ref = jax.tree.map(jnp.asarray, tree)
    tok = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S + 2)).astype(np.int32)
    fwd = jax.jit(ref_lm.forward, static_argnums=(0, 4))
    want = {"forward": fwd(cfg_r, p_ref, jnp.asarray(tok), None, True)}
    want.update(_prefill_decode(cfg_r, p_ref, tok))
    return cfg_r, cfg, convert.params_from_numpy(cfg, tree), tree, tok, \
        want


def _prefill_decode(cfg_r, p_ref, tok, steps=2) -> dict:
    """The reference's prefill of S tokens into an S+4 cache and ``steps``
    decode steps (jitted), with numpy caches."""
    lg, c = jax.jit(ref_lm.prefill, static_argnums=(0, 3))(
        cfg_r, p_ref, jnp.asarray(tok[:, :S]), S + 4)
    want = {"prefill": (lg, jax.tree.map(np.asarray, c))}
    step = jax.jit(ref_lm.decode_step, static_argnums=0)
    for i in range(steps):
        lg, c = step(cfg_r, p_ref, jnp.asarray(tok[:, S + i:S + i + 1]),
                     jnp.full((B,), S + i, jnp.int32), c)
        want[f"decode{i}"] = (lg, jax.tree.map(np.asarray, c))
    return want


def _latents(cache):
    """(layer-0 latent and rope key, the stacked MLA layers')."""
    return [(cache["pro_0"].k, cache["pro_0"].v),
            (cache["stack"]["p0"].k, cache["stack"]["p0"].v)]


def test_forward_matches_reference(model):
    _, cfg, p, _, tok, want = model
    lg_r, aux_r = want["forward"]
    lg, aux = lm.forward(cfg, p, torch.from_numpy(tok), eval_mode=True,
                         device="cpu")
    _close(lg, lg_r, 1e-4)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-6)


def test_prefill_and_decode_match_reference(model):
    """Logits and every latent cache (B, S+4, R) and rope key (B, S+4, dr)
    after the prefill and after each decode step, in the reference's
    layout."""
    _, cfg, p, _, tok, want = model
    lg, c = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]), s_max=S + 4,
                       device="cpu")
    for name in ("prefill", "decode0", "decode1"):
        if name != "prefill":
            i = int(name[-1])
            lg, c = lm.decode_step(
                cfg, p, torch.from_numpy(tok[:, S + i:S + i + 1]),
                torch.full((B,), S + i, dtype=torch.int32), c, device="cpu")
        _close(lg, want[name][0], 1e-4)
        for got, ref in zip(_latents(convert.cache_to_numpy(cfg, c)),
                            _latents(want[name][1])):
            _close(got[0], ref[0], 1e-5)
            _close(got[1], ref[1], 1e-5)


def test_decode_from_a_carried_cache(model):
    _, cfg, p, _, tok, want = model
    c = convert.cache_from_numpy(cfg, want["prefill"][1])
    assert isinstance(c[0], attention.KVCache) and c[0].k.dim() == 3
    lg, _ = lm.decode_step(cfg, p, torch.from_numpy(tok[:, S:S + 1]),
                           torch.full((B,), S, dtype=torch.int32), c,
                           device="cpu")
    _close(lg, want["decode0"][0], 1e-4)


def test_bfloat16_prefill_matches_reference(model, monkeypatch):
    """bf16 activations over float32 weights (5e-2); tokens within a bf16
    step of a top-k tie in a MoE layer are exempt in the later layers'
    caches, as in ``tests/test_torch_moe.py``.  The reference's bf16 MLA
    decode does not run on this XLA's CPU backend (see the mixer test), so
    no bf16 decode is compared."""
    _, _, _, tree, tok, _ = model
    cfg_r = ref_get_config(ARCH, smoke=True, dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True, dtype="bfloat16")
    want = _prefill_decode(cfg_r, jax.tree.map(jnp.asarray, tree), tok, 0)
    p = convert.params_from_numpy(cfg, tree)
    seen = []
    real = ffn.moe_forward

    def spy(c_, p_, x, dropless=False):
        top = torch.sort(ffn.route(c_, p_, x, True)[1], dim=-1,
                         descending=True).values
        k = c_.moe.top_k
        seen.append((top[:, k - 1] - top[:, k]).float())
        return real(c_, p_, x, dropless)

    with monkeypatch.context() as m:
        m.setattr(ffn, "moe_forward", spy)
        lg, c = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]),
                           s_max=S + 4, device="cpu")
    near = (torch.stack(seen).amin(dim=0) < NEAR_TIE).view(B, S).numpy()
    assert near.sum() <= B * S // 4
    assert lg.dtype == torch.bfloat16 and c[0].k.dtype == torch.bfloat16
    _close(lg, want["prefill"][0], 5e-2)
    (k0, r0), (ks, rs) = _latents(convert.cache_to_numpy(cfg, c))
    (k0_r, r0_r), (ks_r, rs_r) = _latents(want["prefill"][1])
    _close(k0, k0_r, 5e-2)
    _close(r0, r0_r, 5e-2)
    for got, ref in ((ks, ks_r), (rs, rs_r)):
        rows = (np.abs(got - ref)[:, :, :S].max(axis=(0, 3)) > 5e-2)
        assert not (rows & ~near).any(), np.argwhere(rows & ~near)


def test_params_carry_across_one_to_one(model):
    cfg_r, cfg, p, tree, _, _ = model
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    assert n_ref == sum(t.numel() for t in common._leaves(p)) \
        == cfg.n_params() == cfg_r.n_params()
    assert set(p["blocks"][0]["attn"]) == {"wq", "w_dkv", "w_kr", "w_uk",
                                           "w_uv", "wo", "kv_norm"}
    np.testing.assert_array_equal(
        p["blocks"][2]["attn"]["w_uk"].numpy(),
        tree["blocks"]["stack"]["p0"]["attn"]["w_uk"][1])
    assert get_config(ARCH).n_params() == 15_706_484_224
