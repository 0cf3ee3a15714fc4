"""The port's recurrent mixers (``repro_torch.models.recurrent``) and the
two models built on them, mamba2-370m and recurrentgemma-9b, against the
JAX reference at smoke widths on the CPU.

Weights are drawn once by the reference, perturbed with numpy noise (so
the zero-initialised norm scales and conv biases take part), and carried
across by ``repro_torch.models.convert``; inputs come from numpy seeds.
Tolerances, as ``tests/test_torch_models.py``: float32 ``atol`` 1e-5 for
single layers and their states, 1e-4 for whole-model logits (the two
frameworks sum in different orders); the bfloat16 case is stated beside
it.  The mamba2 layer is held to 1e-4: on the CPU the port chunks its SSD
at the config's 32 steps (the Pallas kernel's chunk) and the reference's
XLA path at 128 (ROADMAP C5), so the log-space decays are summed in other
orders (3.9e-5 seen on outputs of magnitude ~1).  Two faults of the
reference are pinned here too (ROADMAP C3, C4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models import recurrent as ref_rec
from repro.serve import DecodeReplica as RefReplica
from repro.serve import ServeRequest as RefRequest
from repro_torch.configs import get_config
from repro_torch.models import RGLRUConfig, convert, lm, recurrent
from repro_torch.models.attention import KVCache
from repro_torch.serve import DecodeReplica, ServeRequest
from test_torch_common import _one_torch_thread  # noqa: F401


ARCHS = ["mamba2-370m", "recurrentgemma-9b"]
B, S = 2, 32


def _noisy(tree, seed=0, scale=0.05):
    """The reference's tree as numpy leaves plus float32 noise."""
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


def _same_state(got, want, atol=1e-5):
    """Every field of a port state against the reference's."""
    assert got._fields == want._fields
    for g, w in zip(got, want):
        _close(g, w, atol)


# ================================================================= layers ===
LAYER_ATOL = {"mamba2": 1e-4, "rglru": 1e-5}
MIXERS = {
    "mamba2": ("mamba2-370m", ref_rec.init_mamba2, ref_rec.mamba2_forward,
               ref_rec.mamba2_decode, recurrent.mamba2_forward,
               recurrent.mamba2_decode),
    "rglru": ("recurrentgemma-9b", ref_rec.init_rglru, ref_rec.rglru_forward,
              ref_rec.rglru_decode, recurrent.rglru_forward,
              recurrent.rglru_decode),
}


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_forward_and_decode_match_reference(mixer):
    """Forward over S tokens (output and state), then three decode steps
    from the state (output and state after each), and one decode step from
    the reference's own state carried across."""
    arch, r_init, r_fwd, r_dec, fwd, dec = MIXERS[mixer]
    cfg_r = ref_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    tree = _noisy(r_init(cfg_r, jax.random.PRNGKey(3)))
    p_ref = jax.tree.map(jnp.asarray, tree)
    p = convert._map(tree, convert._tensor)
    x = _x((B, S + 3, cfg.d_model), 5)
    atol = LAYER_ATOL[mixer]
    y_r, st_r = r_fwd(cfg_r, p_ref, jnp.asarray(x[:, :S]), make_cache=True)
    y, st = fwd(cfg, p, torch.from_numpy(x[:, :S]), make_cache=True)
    _close(y, y_r, atol)
    _same_state(st, st_r, atol)
    y_n, _ = fwd(cfg, p, torch.from_numpy(x[:, :S]))
    assert torch.equal(y_n, y)
    carried = type(st)(*(convert._tensor(np.asarray(f)) for f in st_r))
    y_c, _ = dec(cfg, p, torch.from_numpy(x[:, S:S + 1]), carried)
    for step in range(3):
        xs = x[:, S + step:S + step + 1]
        y_r, st_r = r_dec(cfg_r, p_ref, jnp.asarray(xs), st_r)
        y, st = dec(cfg, p, torch.from_numpy(xs), st)
        _close(y, y_r, atol)
        _same_state(st, st_r, atol)
        if step == 0:
            _close(y_c, y_r, 1e-5)


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_state_init_matches_reference(mixer):
    arch = MIXERS[mixer][0]
    cfg_r = ref_get_config(arch, smoke=True, dtype="bfloat16")
    cfg = get_config(arch, smoke=True, dtype="bfloat16")
    if mixer == "mamba2":
        want = ref_rec.init_ssm_state(cfg_r, 3)
        got = recurrent.init_ssm_state(cfg, 3, "cpu")
    else:
        want = ref_rec.init_lru_state(cfg_r, 3)
        got = recurrent.init_lru_state(cfg, 3, "cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape and not g.any()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_causal_conv_carries_its_prefix():
    """Two halves with the prefix carried give the whole, and the prefix
    owns its memory (a view would keep the whole padded input alive in
    every layer's cache: 29 GB over mamba2-370m's 48 layers at 4 x 32,768
    tokens)."""
    x = torch.from_numpy(_x((B, 12, 8), 6))
    w = torch.from_numpy(_x((4, 8), 7))
    whole, pre_w = recurrent._causal_conv(x, w)
    assert pre_w.untyped_storage().nbytes() == \
        pre_w.numel() * pre_w.element_size()
    a, pre = recurrent._causal_conv(x[:, :5], w)
    b, pre_b = recurrent._causal_conv(x[:, 5:], w, pre)
    _close(torch.cat([a, b], 1), whole.numpy(), 1e-6)
    assert torch.equal(pre_b, pre_w)
    want, want_pre = ref_rec._causal_conv(jnp.asarray(x.numpy()),
                                          jnp.asarray(w.numpy()))
    _close(whole, want, 1e-6)
    _close(pre_w, want_pre, 0)


# ================================================================= models ===
def _model(arch, seed=0, **over):
    cfg_r = ref_get_config(arch, smoke=True, **over)
    cfg = get_config(arch, smoke=True, **over)
    tree = _noisy(ref_lm.init_params(cfg_r, jax.random.PRNGKey(seed)), seed)
    return cfg_r, cfg, jax.tree.map(jnp.asarray, tree), \
        convert.params_from_numpy(cfg, tree), tree


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _tokens(cfg, seed=7, n=S + 4, b=B):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, n)).astype(np.int32)


def _same_caches(cfg, c, c_r, atol, scaled=False):
    """The port's per-layer caches against the reference's tree, field by
    field, in the reference's (stacked) layout; ``scaled`` holds each
    tensor to ``atol`` times its largest magnitude (at least 1)."""
    got = convert.cache_to_numpy(cfg, c)
    want = jax.tree.map(np.asarray, c_r)
    assert set(got) == set(want)
    for key, sub in want.items():
        pairs = ([(got[key][slot], w) for slot, w in sub.items()]
                 if key == "stack" else [(got[key], sub)])
        for g, w in pairs:
            assert g._fields == w._fields
            for f in w._fields:
                gf, wf = getattr(g, f), getattr(w, f)
                assert (gf is None) == (wf is None)
                if wf is not None:
                    tol = atol * max(1.0, np.abs(wf).max()) if scaled \
                        else atol
                    _close(gf, wf, tol)


def test_params_carry_across_one_to_one(model):
    cfg_r, cfg, _, p, tree = model
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    assert n_ref == cfg.n_params() == cfg_r.n_params()
    assert len(p["blocks"]) == cfg.n_layers
    kinds = [("mixer" in blk, "attn" in blk, "mlp" in blk)
             for blk in p["blocks"]]
    for kind, (mixer, ffn) in zip(kinds, lm.layer_specs(cfg)):
        assert kind == (mixer in ("ssm", "rec"), mixer.startswith("attn"),
                        ffn == "glu")


def test_forward_matches_reference(model):
    cfg_r, cfg, p_ref, p, _ = model
    tok = _tokens(cfg)[:, :S]
    want, _ = ref_lm.forward(cfg_r, p_ref, jnp.asarray(tok), eval_mode=True)
    got, aux = lm.forward(cfg, p, torch.from_numpy(tok), device="cpu")
    assert got.shape == (B, S, cfg.vocab_size)
    _close(got, want, 1e-4)
    assert float(aux) == 0.0


def test_prefill_and_decode_match_reference(model):
    """Prefill S tokens into an S+8 cache, then decode 4 tokens; logits and
    every state and cache tensor after each call, in the reference's
    layout; then one step from the reference's cache carried across."""
    cfg_r, cfg, p_ref, p, _ = model
    tok = _tokens(cfg)
    lg_r, c_r = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok[:, :S]),
                               s_max=S + 8)
    lg, c = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]), s_max=S + 8,
                       device="cpu")
    assert lg.shape == (B, 1, cfg.vocab_size)
    _close(lg, lg_r, 1e-4)
    _same_caches(cfg, c, c_r, 1e-4)
    for i in range(4):
        at = np.full((B,), S + i, np.int32)
        step = tok[:, S + i:S + i + 1]
        lg_r, c_r = ref_lm.decode_step(cfg_r, p_ref, jnp.asarray(step),
                                       jnp.asarray(at), c_r)
        lg, c = lm.decode_step(cfg, p, torch.from_numpy(step),
                               torch.from_numpy(at), c, device="cpu")
        _close(lg, lg_r, 1e-4)
        _same_caches(cfg, c, c_r, 1e-4)
    carried = convert.cache_from_numpy(cfg, jax.tree.map(np.asarray, c_r))
    assert [type(x) for x in carried] == [type(x) for x in c]
    at = np.full((B,), S + 4, np.int32)
    step = tok[:, S + 3:S + 4]
    lg_r, _ = ref_lm.decode_step(cfg_r, p_ref, jnp.asarray(step),
                                 jnp.asarray(at), c_r)
    lg, _ = lm.decode_step(cfg, p, torch.from_numpy(step),
                           torch.from_numpy(at), carried, device="cpu")
    _close(lg, lg_r, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_prefill_and_decode_match_reference(arch):
    """``dtype=bfloat16`` activations over float32 weights, as the full
    configs run.  Tolerance: 0.05 on logits of magnitude ~1-4, and 0.05 of
    each state's largest magnitude (the float32 SSD states reach ~5) —
    both sides round activations to bfloat16 (a relative step of 2^-8 ≈
    0.004) at different points (XLA fuses, torch rounds each op), and the
    layers compound that."""
    cfg_r, cfg, p_ref, p, _ = _model(arch, seed=1, dtype="bfloat16")
    tok = _tokens(cfg, seed=9)
    lg_r, c_r = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok[:, :S]),
                               s_max=S + 4)
    lg, c = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]), s_max=S + 4,
                       device="cpu")
    assert lg.dtype == torch.bfloat16
    assert c[0].conv.dtype == torch.bfloat16
    _close(lg, lg_r, 5e-2)
    _same_caches(cfg, c, c_r, 5e-2, scaled=True)
    for i in range(2):
        at = np.full((B,), S + i, np.int32)
        step = tok[:, S + i:S + i + 1]
        lg_r, c_r = ref_lm.decode_step(cfg_r, p_ref, jnp.asarray(step),
                                       jnp.asarray(at), c_r)
        lg, c = lm.decode_step(cfg, p, torch.from_numpy(step),
                               torch.from_numpy(at), c, device="cpu")
        _close(lg, lg_r, 5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_params_keeps_the_numbers(arch):
    """``cast_params`` keeps float32 the leaves the reference reads in
    float32 (the conv weights in decode, the RG-LRU's gates), so a prefill
    and a decode step from the cast copy are the ones from the float32
    tree, bit for bit."""
    _, cfg, _, p, _ = _model(arch, seed=2, dtype="bfloat16")
    cast = lm.cast_params(cfg, p)
    for blk in cast["blocks"]:
        if "mixer" in blk:
            for name, t in blk["mixer"].items():
                want = (torch.float32 if name in lm.FLOAT32_LEAVES
                        or t.dim() < 2 else torch.bfloat16)
                assert t.dtype == want, name
    tok = torch.from_numpy(_tokens(cfg, seed=10))
    lg_a, c_a = lm.prefill(cfg, p, tok[:, :S], s_max=S + 2, device="cpu")
    lg_b, c_b = lm.prefill(cfg, cast, tok[:, :S], s_max=S + 2, device="cpu")
    assert torch.equal(lg_a, lg_b)
    pos = torch.full((B,), S, dtype=torch.int32)
    lg_a, _ = lm.decode_step(cfg, p, tok[:, S:S + 1], pos, c_a, device="cpu")
    lg_b, _ = lm.decode_step(cfg, cast, tok[:, S:S + 1], pos, c_b,
                             device="cpu")
    assert torch.equal(lg_a, lg_b)


def test_local_attention_ring_buffer_beyond_window():
    """Port of the reference's ``tests/test_models.py`` case: decode past
    the ring's capacity stays consistent with the windowed forward."""
    cfg = get_config("recurrentgemma-9b", smoke=True).replace(
        window=8, rglru=RGLRUConfig(d_rnn=64, d_conv=4, c=8.0, window=8))
    params = lm.init_params(cfg, 0, device="cpu")
    total = 24  # > 2x window
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, total + 1)))
    full, _ = lm.forward(cfg, params, toks, device="cpu")
    _, cache = lm.prefill(cfg, params, toks[:, :4], s_max=total + 4,
                          device="cpu")
    for i in range(4, total):
        pos = torch.full((1,), i, dtype=torch.int32)
        lg, cache = lm.decode_step(cfg, params, toks[:, i:i + 1], pos, cache,
                                   device="cpu")
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(),
                                   atol=3e-3, err_msg=f"pos {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [300, 384])
def test_prefill_of_unblocked_lengths_matches_reference(s, dtype):
    """ROADMAP C6: recurrentgemma-9b prefills of 300 and 384 tokens (no
    multiple of the Pallas kernels' 256-step blocks) through
    ``impl="auto"`` (the plain B3 and B5 on the CPU) match the reference's
    prefill off a TPU (its XLA paths): logits and every state and cache,
    at 1e-4 in float32 and the bfloat16 tolerances above.  mamba2's SSD
    keeps its chunk rule in both packages (C5): 300 tokens raise in each,
    384 run."""
    cfg_r, cfg, p_ref, p, _ = _model("recurrentgemma-9b", seed=2,
                                     dtype=dtype)
    assert cfg.attn_impl == "auto"
    tok = _tokens(cfg, seed=s, n=s, b=1)
    lg_r, c_r = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok), s_max=s + 4)
    lg, c = lm.prefill(cfg, p, torch.from_numpy(tok), s_max=s + 4,
                       device="cpu")
    if dtype == "float32":
        _close(lg, lg_r, 1e-4)
        _same_caches(cfg, c, c_r, 1e-4)
    else:
        _close(lg, lg_r, 5e-2)
        _same_caches(cfg, c, c_r, 5e-2, scaled=True)
    if dtype == "float32":
        cfg_r, cfg, p_ref, p, _ = _model("mamba2-370m", seed=2)
        tok = _tokens(cfg, seed=s, n=s, b=1)
        if s % 128:
            with pytest.raises(ValueError):
                ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok))
            with pytest.raises(ValueError):
                lm.prefill(cfg, p, torch.from_numpy(tok), device="cpu")
        else:
            lg_r, _ = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok))
            lg, _ = lm.prefill(cfg, p, torch.from_numpy(tok), device="cpu")
            _close(lg, lg_r, 1e-4)


# ====================================================== faults of the ref ===
@pytest.mark.parametrize("arch,s,raises", [
    ("mamba2-370m", 8, TypeError),         # s == H: the SSD state
    ("mamba2-370m", 3, ValueError),        # s == d_conv - 1: the conv buffer
    ("recurrentgemma-9b", 3, ValueError),  # the RG-LRU's conv buffer
], ids=["mamba2-heads", "mamba2-conv", "rglru-conv"])
def test_prefill_of_state_length_tokens_decodes_consistently(arch, s,
                                                             raises):
    """ROADMAP C3: the reference's ``_pad_caches`` pads every cache leaf
    with ``s`` on its sequence axis, recurrent states included, so a
    prefill of exactly H (mamba2's head count, 8 at smoke width) or
    d_conv - 1 (3) tokens with ``s_max > s`` breaks its next decode step.
    The port pads only the attention caches, and its decode agrees with the
    forward."""
    cfg_r, cfg, p_ref, p, _ = _model(arch, seed=4)
    if cfg.ssm is not None:
        assert s in (cfg.ssm.expand * cfg.d_model // cfg.ssm.headdim,
                     cfg.ssm.d_conv - 1)
    else:
        assert s == cfg.rglru.d_conv - 1
    tok = _tokens(cfg, seed=11, n=16)
    full, _ = lm.forward(cfg, p, torch.from_numpy(tok), device="cpu")
    _, c = lm.prefill(cfg, p, torch.from_numpy(tok[:, :s]), s_max=16,
                      device="cpu")
    init = lm.init_cache(cfg, B, 16, device="cpu")
    for got, want in zip(c, init):
        if not isinstance(got, KVCache):
            assert [t.shape for t in got] == [t.shape for t in want]
    for i in range(s, s + 4):
        pos = torch.full((B,), i, dtype=torch.int32)
        lg, c = lm.decode_step(cfg, p, torch.from_numpy(tok[:, i:i + 1]), pos,
                               c, device="cpu")
        _close(lg[:, 0], full[:, i].numpy(), 1e-4)
    _, c_r = ref_lm.prefill(cfg_r, p_ref, jnp.asarray(tok[:, :s]), s_max=16)
    with pytest.raises(raises):
        ref_lm.decode_step(cfg_r, p_ref, jnp.asarray(tok[:, s:s + 1]),
                           jnp.full((B,), s, jnp.int32), c_r)


def _replica_tokens(replica_cls, request_cls, cfg, params, prompts, **dev):
    """Serve ``prompts`` one after another through one slot; returns each
    request's generated tokens."""
    rep = replica_cls(cfg, params, sid=0, n_slots=1, s_max=64, **dev)
    for rid, prompt in enumerate(prompts):
        rep.submit(request_cls(req_id=rid, prompt=prompt, max_new_tokens=4))
    done = {}
    for t in range(100):
        for c in rep.tick(t):
            done[c.req_id] = c.tokens.tolist()
        if len(done) == len(prompts):
            return [done[i] for i in range(len(prompts))]
    raise AssertionError("the replica did not finish")


def test_replica_reuses_a_slot_as_the_reference_does():
    """ROADMAP C4: the reference's ``DecodeReplica`` admits a request into
    a freed slot at position 0 without resetting its cache.  Attention
    masks the old positions; an SSD state carries over, so a request's
    tokens depend on what the slot served before.  The port carries the
    reference's behaviour and gives its tokens exactly, reused slot
    included."""
    cfg_r, cfg, p_ref, p, _ = _model("mamba2-370m", seed=3)
    rng = np.random.default_rng(12)
    a, b = (rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
            for _ in range(2))
    want = _replica_tokens(RefReplica, RefRequest, cfg_r, p_ref, [a, b])
    got = _replica_tokens(DecodeReplica, ServeRequest, cfg, p, [a, b],
                          device="cpu")
    assert got == want
    alone = _replica_tokens(DecodeReplica, ServeRequest, cfg, p, [b],
                            device="cpu")
    assert alone == _replica_tokens(RefReplica, RefRequest, cfg_r, p_ref,
                                    [b])
    assert alone[0] != got[1]   # the leak: b's tokens depend on a
