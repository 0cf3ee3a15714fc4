"""Training on one device (``repro_torch.train``, ``repro_torch.data``,
the models' ``loss_fn``) against the JAX reference, on the CPU.

For one smoke config of each family — dense (qwen2.5-3b), mamba2, RG-LRU
(recurrentgemma-9b), MoE with capacity routing (deepseek-moe-16b), MLA
(deepseek-v2-lite-16b), whisper, phi3-mini (MHA at head dim 96), gemma-7b
(an all-attention stack with GeGLU and tied embeddings scaled by
sqrt(d_model)) and chameleon-34b (qk-norm under RoPE and GQA's repeat) —
the reference draws the weights (plus
numpy noise, so the zero-init norm scales take part), ``convert.
params_from_numpy`` carries them across, and both packages take the loss
and its gradient on the same numpy batch; each reference call is jitted
once per family.  Then one AdamW step and one compression step run on the
reference's gradients in both layouts.  Tolerances:

* loss, ce, aux: ``rtol`` 1e-5 (float32, other summation orders);
  accuracy equal (it counts argmax hits);
* gradients: per leaf, max |diff| <= 1e-4 of the leaf's max |g|, or
  1e-6 of the model's largest gradient for a leaf whose gradient is
  rounding noise (attention's key biases: softmax ignores a shift common
  to all keys, so their true gradient is zero);
* AdamW: the moments and parameters ``rtol`` 1e-5, ``atol`` 1e-7 of the
  values' scale: the elementwise update is the same float32 arithmetic,
  but the clip scale comes from a global norm summed in another order and
  XLA's ``pow``/``cos`` are not correctly rounded (ROADMAP C1); the
  weight-decay leaf set equal leaf by leaf to the reference's ``ndim >=
  2`` on its stacked tree;
* compression: bit for bit, with one absmax scale a stacked reference
  leaf; the schedule ``rtol`` 1e-6; the data batches bit for bit.

codeqwen1.5-7b has no family of its own: its training path (QKV bias,
SiLU GLU, untied embeddings) is the dense family's code, and untied
embeddings are phi3-mini's too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import family_of as ref_family_of
from repro.models import lm as ref_lm
from repro.train import compress as ref_compress
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, PrefetchingLoader, SyntheticLM
from repro_torch.models import convert, family_of, lm
from repro_torch.train import OptimizerConfig, adamw_update, \
    compress_grads, init_ef_state, init_opt_state, lr_at, make_train_step
from repro_torch.train import tree as ttree
from repro_torch.train.step import loss_and_grads
from test_torch_common import _one_torch_thread  # noqa: F401


B, S = 2, 32
#: family → (arch, sequence length, the CE's chunk in both packages,
#: config overrides): three chunks for the dense model, a chunk that does
#: not divide S (the whole sequence then) for RG-LRU, one chunk elsewhere;
#: RG-LRU at 4 layers, one stacked period of 3 and one epilogue layer, and
#: once more at recurrentgemma-9b's head dim 256 (smoke widths otherwise,
#: one (rec, rec, attn) period, a window of 12 under S = 32); phi3-mini at
#: its own head dim 96 (MHA, smoke widths otherwise); gemma-7b in two
#: chunks, so its tied embedding's gradient sums the lookup's and two CE
#: chunks'; chameleon-34b's smoke config (qk-norm, 8 heads over 2)
FAMILIES = {"dense": ("qwen2.5-3b", 48, 16, {}),
            "mamba2": ("mamba2-370m", S, 512, {}),
            "rglru": ("recurrentgemma-9b", S, 12, {"n_layers": 4}),
            "rglru256": ("recurrentgemma-9b", S, 512,
                         {"n_layers": 3, "head_dim": 256, "window": 12}),
            "moe": ("deepseek-moe-16b", S, 512, {}),
            "mla": ("deepseek-v2-lite-16b", S, 512, {}),
            "whisper": ("whisper-tiny", S, 512, {}),
            "phi3_96": ("phi3-mini-3.8b", S, 512, {"head_dim": 96}),
            "gemma": ("gemma-7b", S, 16, {}),
            "chameleon": ("chameleon-34b", S, 512, {})}
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
           clip_norm=1.0)
GRAD_RTOL = 1e-4


def _noisy(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32)
                   + scale * rng.standard_normal(x.shape).astype(np.float32)),
        tree)


def _batch(cfg, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s), dtype=np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    labels[:, -3:] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.arch_type == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(cfg, grads_np):
    """The reference's gradient tree (numpy) as port leaves, in the port's
    flatten order."""
    return ttree.leaves(convert.params_from_numpy(cfg, grads_np))


_CACHE = {}


def _family(name):
    """The family's reference results, computed once: weights, batch,
    ``(loss, metrics)`` and gradients (numpy trees), and the port's loss,
    metrics and gradients on the same inputs."""
    if name in _CACHE:
        return _CACHE[name]
    arch, s, chunk, kw = FAMILIES[name]
    cfg_r = ref_get_config(arch, smoke=True, **kw)
    cfg = get_config(arch, smoke=True, **kw)
    fam_r = ref_family_of(cfg_r)
    with jax.threefry_partitionable(False):
        tree = _noisy(jax.jit(lambda k: fam_r.init_params(cfg_r, k))(
            jax.random.PRNGKey(7)))
    batch = _batch(cfg, s, seed=11)
    saved = ref_lm.LOSS_CHUNK, lm.LOSS_CHUNK
    ref_lm.LOSS_CHUNK = lm.LOSS_CHUNK = chunk
    try:
        f = jax.jit(jax.value_and_grad(
            lambda p, b: fam_r.loss_fn(cfg_r, p, b), has_aux=True))
        (loss_r, met_r), grads_r = f(jax.tree.map(jnp.asarray, tree),
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        params = convert.params_from_numpy(cfg, tree)
        for p in ttree.leaves(params):
            p.requires_grad_(True)
        loss, met, grads = loss_and_grads(
            cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        ref_lm.LOSS_CHUNK, lm.LOSS_CHUNK = saved
    out = dict(cfg_r=cfg_r, cfg=cfg, tree=tree, batch=batch,
               loss_r=float(loss_r),
               met_r={k: float(v) for k, v in met_r.items()},
               grads_r=jax.tree.map(np.asarray, grads_r),
               loss=float(loss), met={k: float(v) for k, v in met.items()},
               grads=grads, params=params)
    _CACHE[name] = out
    return out


# ------------------------------------------------ loss and gradients -------
@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_fn_matches_reference(name):
    """Loss, ce, aux and accuracy of ``family_of(cfg).loss_fn`` equal the
    reference's on the same weights and batch (capacity-routed MoE,
    ``-1`` labels as padding, chunked CE)."""
    r = _family(name)
    np.testing.assert_allclose(r["loss"], r["loss_r"], rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(r["met"][k], r["met_r"][k], rtol=1e-5,
                                   atol=1e-9)
    assert r["met"]["accuracy"] == pytest.approx(r["met_r"]["accuracy"],
                                                 abs=1e-7)
    if r["cfg"].moe is not None:
        assert r["met"]["aux"] > 0
    else:
        assert r["met"]["aux"] == 0.0


@pytest.mark.parametrize("name", list(FAMILIES))
def test_gradients_match_jax_grad(name):
    """Every leaf's gradient against ``jax.grad`` of the reference's loss,
    the stacked leaves mapped to per-layer ones, within the module's
    tolerance.  Every leaf gets a gradient."""
    r = _family(name)
    want = _port_grads(r["cfg"], r["grads_r"])
    paths = [p for p, _ in ttree.flatten(r["params"])]
    assert len(want) == len(r["grads"]) == len(paths)
    top = max(float(w.abs().max()) for w in want)
    for path, g, w in zip(paths, r["grads"], want):
        assert g is not None, path
        scale = float(w.abs().max())
        diff = float((g - w).abs().max())
        assert diff <= max(GRAD_RTOL * scale, 1e-6 * top), (path, diff,
                                                            scale)


def test_qk_norm_and_tied_embedding_gradients_are_live():
    """The leaves only chameleon-34b and gemma-7b train among the families:
    qk-norm's scales (each layer's ``q_norm`` and ``k_norm``) and gemma's
    one tied, scaled embedding get gradients that are not zero and that
    hold to ``jax.grad``'s leaf by leaf (as
    :func:`test_gradients_match_jax_grad` holds every leaf)."""
    for name, kinds in (("chameleon", ("q_norm", "k_norm")),
                        ("gemma", ("tokens",))):
        r = _family(name)
        want = _port_grads(r["cfg"], r["grads_r"])
        paths = [p for p, _ in ttree.flatten(r["params"])]
        held = [(p, g, w) for p, g, w in zip(paths, r["grads"], want)
                if p[-1] in kinds]
        assert len(held) == len(kinds) * (r["cfg"].n_layers
                                          if name == "chameleon" else 1)
        for path, g, w in held:
            scale = float(w.abs().max())
            assert scale > 0 and float(g.abs().max()) > 0, path
            assert float((g - w).abs().max()) <= GRAD_RTOL * scale, path


# --------------------------------------------------------------- AdamW -----
@pytest.mark.parametrize("name", list(FAMILIES))
def test_weight_decay_leaves_follow_the_stacked_tree(name):
    """AdamW decays a port leaf exactly when the reference decays the leaf
    that holds it: ``ndim >= 2`` on the reference's tree, whose scanned
    layers are stacked (so a stacked norm scale is decayed)."""
    r = _family(name)
    flags = jax.tree.map(
        lambda x: np.full(x.shape, float(np.ndim(x) >= 2), np.float32),
        r["tree"])
    want = [bool(t.reshape(-1)[0]) if t.numel() else False
            for t in ttree.leaves(convert.params_from_numpy(r["cfg"],
                                                            flags))]
    assert ttree.decay_mask(r["cfg"], r["params"]) == want
    if name != "whisper":
        # a stacked norm scale (1-D a layer) is decayed, an unstacked one
        # (the final norm) is not
        paths = [p for p, _ in ttree.flatten(r["params"])]
        got = dict(zip(paths, want))
        for i, (_, slot, _) in enumerate(convert._layer_keys(r["cfg"])):
            assert got[("blocks", i, "pre_norm", "scale")] == \
                (slot is not None)
        assert not got[("final_norm", "scale")]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_adamw_step_matches_reference(name):
    """One AdamW step on the reference's gradients: parameters and moments
    against the reference's ``adamw_update`` on its stacked tree."""
    r = _family(name)
    cfg, cfg_o = r["cfg"], ref_opt.OptimizerConfig(**OPT)
    p_r = jax.tree.map(jnp.asarray, r["tree"])
    new_r, st_r, m_r = jax.jit(ref_opt.adamw_update, static_argnums=0)(
        cfg_o, p_r, jax.tree.map(jnp.asarray, r["grads_r"]),
        ref_opt.init_opt_state(p_r))
    params = convert.params_from_numpy(cfg, r["tree"])
    state = init_opt_state(params)
    grads = _port_grads(cfg, r["grads_r"])
    params, st, m = adamw_update(OptimizerConfig(**OPT), params, grads,
                                 state, ttree.decay_mask(cfg, params))
    assert int(st.step) == int(st_r.step) == 1
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_r["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), float(m_r["lr"]), rtol=1e-6)
    for got, want in ((params, new_r), (st.mu, st_r.mu), (st.nu, st_r.nu)):
        want = ttree.leaves(convert.params_from_numpy(
            cfg, jax.tree.map(np.asarray, want)))
        for a, b in zip(ttree.leaves(got), want):
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7 * scale + 1e-30)


# --------------------------------------------------------- compression -----
@pytest.mark.parametrize("name", list(FAMILIES))
def test_compression_step_matches_reference_bit_for_bit(name):
    """Two compression steps (the second with the carried residual) on the
    reference's gradients: one absmax scale a reference leaf, so a stacked
    group's layers share it; gradients and residuals equal bit for bit."""
    r = _family(name)
    cfg = r["cfg"]
    g_r = jax.tree.map(jnp.asarray, r["grads_r"])
    ef_r = ref_compress.init_ef_state(g_r)
    params = convert.params_from_numpy(cfg, r["tree"])
    ef = init_ef_state(params)
    groups = [x.members for x in ttree.ref_leaves(cfg, params)]
    for k in range(2):
        gq_r, ef_r = jax.jit(ref_compress.compress_grads)(
            jax.tree.map(lambda x: x * (1 + k), g_r), ef_r)
        gq, ef = compress_grads([g * (1 + k) for g in
                                 _port_grads(cfg, r["grads_r"])], ef, groups)
        want_g = _port_grads(cfg, jax.tree.map(np.asarray, gq_r))
        want_r = _port_grads(cfg, jax.tree.map(np.asarray, ef_r.residual))
        for a, b in zip(gq, want_g):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        for a, b in zip(ttree.leaves(ef.residual), want_r):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_stacked_leaves_share_one_scale():
    """With a scan group of several layers, a per-layer scale would differ
    from the reference's: the group's quantisation steps are equal."""
    r = _family("dense")
    cfg = r["cfg"]
    params = r["params"]
    refs = ttree.ref_leaves(cfg, params)
    stacked = [x for x in refs if len(x.members) > 1]
    assert stacked and all(x.ndim == ttree.flatten(params)[x.members[0]][1]
                           .dim() + 1 for x in stacked)
    grads = [torch.full_like(p, float(i + 1), dtype=torch.float32)
             for i, p in enumerate(ttree.leaves(params))]
    gq, _ = compress_grads(grads, init_ef_state(params),
                           [x.members for x in refs])
    for x in stacked:
        top = max(float(grads[i].max()) for i in x.members)
        for i in x.members:
            step = top / 127.0
            q = (gq[i] / torch.tensor(step, dtype=torch.float32)).round()
            assert float((gq[i] - q * step).abs().max()) < 1e-5 * top


def test_lr_schedule_matches_reference():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    cfg_r = ref_opt.OptimizerConfig(lr=1.0, warmup_steps=10,
                                    total_steps=100, min_lr_frac=0.1)
    steps = np.arange(0, 111, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: ref_opt.lr_at(cfg_r, s)))(jnp.asarray(steps)))
    got = np.array([float(lr_at(cfg, torch.tensor(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------ the reference's ----
# tests/test_train.py, on the port
def _quad_params():
    return {"w": torch.tensor([3.0, -2.0, 1.0]),
            "b": torch.tensor([[1.0, -1.0]])}


def _unstacked_decay(params) -> list[bool]:
    """The reference's ``p.ndim >= 2`` on a tree with no scan stacks (the
    toy trees of its own optimizer tests)."""
    return [p.dim() >= 2 for p in ttree.leaves(params)]


#: one leaf, one compression scale (the toy trees of the reference's own
#: compression tests)
ONE_LEAF = [(0,)]


def test_adamw_converges_on_quadratic():
    params = _quad_params()
    opt = init_opt_state(params)
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=200,
                          weight_decay=0.0, clip_norm=100.0)
    for _ in range(150):
        grads = [2 * p for p in ttree.leaves(params)]
        params, opt, _ = adamw_update(cfg, params, grads, opt,
                                      _unstacked_decay(params))
    assert sum(float((p ** 2).sum()) for p in ttree.leaves(params)) < 1e-2


def test_lr_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    lrs = [float(lr_at(cfg, torch.tensor(s))) for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, abs=0.05)
    assert lrs[-1] == pytest.approx(0.1, abs=0.02)
    assert all(a >= b - 1e-6 for a, b in zip(lrs[2:], lrs[3:]))


def test_grad_clipping():
    params = {"w": torch.ones(4)}
    opt = init_opt_state(params)
    cfg = OptimizerConfig(clip_norm=1.0, warmup_steps=0, lr=1e-3)
    _, _, metrics = adamw_update(cfg, params, [torch.full((4,), 1e6)], opt,
                                 _unstacked_decay(params))
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_opt_state_mirrors_params():
    params = _quad_params()
    opt = init_opt_state(params)
    assert [p for p, _ in ttree.flatten(opt.mu)] == \
        [p for p, _ in ttree.flatten(params)]


def test_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    ef = init_ef_state({"w": torch.zeros(256)})
    true_sum = np.zeros(256)
    comp_sum = np.zeros(256)
    for i in range(30):
        g = torch.from_numpy(
            (rng.standard_normal(256) * (1 + i % 3)).astype(np.float32))
        gq, ef = compress_grads([g], ef, ONE_LEAF)
        true_sum += g.numpy()
        comp_sum += gq[0].numpy()
    resid = np.abs(true_sum - comp_sum).max()
    assert resid < 0.05 * np.abs(true_sum).max() + 0.1


@pytest.mark.parametrize("seed", range(10))
def test_compression_residual_bounded(seed):
    """The reference's property test (hypothesis, seeds 0-50, 10
    examples), here over ten fixed seeds."""
    rng = np.random.default_rng(seed)
    ef = init_ef_state({"w": torch.zeros(64)})
    for _ in range(10):
        g = torch.from_numpy(
            (rng.standard_normal(64) * 10).astype(np.float32))
        gq, ef = compress_grads([g], ef, ONE_LEAF)
        assert float(ef.residual["w"].abs().max()) <= \
            float(g.abs().max()) / 127.0 * 1.5 + 1e-5


def test_compression_int8_range():
    ef = init_ef_state({"w": torch.zeros(16)})
    g = torch.from_numpy(np.linspace(-5, 5, 16).astype(np.float32))
    gq, _ = compress_grads([g], ef, ONE_LEAF)
    assert float((gq[0] - g).abs().max()) <= 5 / 127 + 1e-6


# ----------------------------------------------------------------- data ----
@pytest.mark.parametrize("index", [0, 5, 17])
def test_data_batches_equal_the_reference(index):
    kw = dict(vocab_size=512, seq_len=64, global_batch=8, seed=4,
              pad_frac=0.25)
    got = SyntheticLM(DataConfig(**kw))
    want = RefSyntheticLM(RefDataConfig(**kw))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got.batch(index)[k],
                                      want.batch(index)[k])
        np.testing.assert_array_equal(got.host_batch(index, 1, 2)[k],
                                      want.host_batch(index, 1, 2)[k])


def test_data_deterministic_and_host_sharded():
    src = SyntheticLM(DataConfig(vocab_size=512, seq_len=64, global_batch=8,
                                 seed=4))
    b1, b2 = src.batch(5), src.batch(5)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(src.batch(6)["tokens"], b1["tokens"])
    h0, h1 = src.host_batch(5, 0, 2), src.host_batch(5, 1, 2)
    assert np.array_equal(np.concatenate([h0["tokens"], h1["tokens"]]),
                          b1["tokens"])


def test_data_labels_are_next_tokens():
    b = SyntheticLM(DataConfig(vocab_size=128, seq_len=32, global_batch=2,
                               seed=0)).batch(0)
    assert b["tokens"].shape == b["labels"].shape == (2, 32)
    assert (b["labels"] >= 0).all()


def test_data_structure_is_learnable():
    cfg = DataConfig(vocab_size=256, seq_len=256, global_batch=4, seed=1)
    src = SyntheticLM(cfg)
    b = src.batch(0)
    pred = (src._a * b["tokens"] + src._b) % cfg.vocab_size
    assert (pred == b["labels"]).mean() > 0.5


def test_prefetching_loader():
    src = SyntheticLM(DataConfig(vocab_size=128, seq_len=16, global_batch=2,
                                 seed=0))
    loader = PrefetchingLoader(src, start=3, depth=2)
    assert next(loader)[0] == 3
    assert next(loader)[0] == 4
    loader.close()


# ----------------------------------------------------------- the step ------
def test_train_step_lowers_the_loss_on_the_cpu():
    """``make_train_step`` on the CPU: 25 steps of a small qwen-style model
    on the synthetic stream, metrics as the reference's; the mean loss of
    the last five steps is below the first step's
    (``examples/train_100m.py``'s check)."""
    cfg = get_config("qwen2.5-3b", smoke=True, vocab_size=256)
    bundle = make_train_step(cfg, "cpu", OptimizerConfig(
        lr=3e-3, warmup_steps=5, total_steps=25))
    state = bundle.init_state_fn(0)
    src = SyntheticLM(DataConfig(vocab_size=256, seq_len=64, global_batch=4))
    losses = []
    for i in range(25):
        state, m = bundle.step_fn(state, src.batch(i))
        assert set(m) == {"loss", "ce", "aux", "accuracy", "grad_norm", "lr"}
        losses.append(float(m["loss"]))
    assert int(state.opt.step) == 25
    assert np.mean(losses[-5:]) < losses[0]


def test_train_step_with_compression_matches_the_plain_steps_shape():
    cfg = get_config("qwen2.5-3b", smoke=True, vocab_size=256)
    bundle = make_train_step(cfg, "cpu", use_compression=True)
    state = bundle.init_state_fn(0)
    src = SyntheticLM(DataConfig(vocab_size=256, seq_len=32, global_batch=2))
    state, m = bundle.step_fn(state, src.batch(0))
    assert np.isfinite(float(m["loss"]))
    assert [p for p, _ in ttree.flatten(state.ef.residual)] == \
        [p for p, _ in ttree.flatten(state.params)]
    assert any(float(r.abs().max()) > 0
               for r in ttree.leaves(state.ef.residual))


def test_train_needs_a_card_unless_asked_for_the_cpu():
    from repro_torch.launch import train as launch_train

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(get_config("qwen2.5-3b", smoke=True))


def test_family_loss_fn_is_the_models():
    assert family_of(get_config("qwen2.5-3b", smoke=True)).loss_fn \
        is lm.loss_fn
