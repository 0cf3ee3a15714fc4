"""The port's MoE FFN (``repro_torch.models.ffn.moe_forward``) and the
deepseek-moe-16b smoke model against the JAX reference, on the CPU.

The port computes the reference's capacity-grouped GShard MoE by sorting
the kept (token, k) pairs by expert instead of one-hot einsums; it must
give the same outputs, keep the same pairs and report the same aux losses.
Weights are drawn once by the reference (plus numpy noise, so the zero-init
norm scales take part) and carried across by ``repro_torch.models.
convert``; inputs come from numpy seeds; each reference result is computed
once per module and jitted (eager dispatch costs several times the
compile).  Tolerances: float32 ``atol`` 1e-5 for one layer, 1e-4
for whole-model logits, aux losses ``rtol`` 1e-6; bfloat16 logits 5e-2,
as ``tests/test_torch_models.py`` states it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ffn as ref_ffn
from repro.models import lm as ref_lm
from repro.serve import DecodeReplica as RefReplica
from repro.serve import NetCloneServer as RefServer
from repro_torch.configs import get_config
from repro_torch.models import common, convert, ffn, lm
from repro_torch.serve import DecodeReplica, NetCloneServer

ARCH = "deepseek-moe-16b"
B, S = 2, 32


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


def _with_capacity(cfg, cf):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


# ------------------------------------------------------------ the layer ----
@pytest.fixture(scope="module")
def layer():
    cfg_r = ref_get_config(ARCH, smoke=True)
    with jax.threefry_partitionable(False):
        tree = _noisy(jax.jit(lambda k: ref_ffn.init_moe(cfg_r, k))(
            jax.random.PRNGKey(0)))
    return (jax.tree.map(jnp.asarray, tree),
            convert._map(tree, convert._tensor))


#: (dropless, capacity factor, sequence length): dropless prefill, capacity
#: routing that drops a few pairs, a capacity that drops most, 600 tokens
#: (no multiple of the 512-token groups: one group a sequence), and decode
#: (one token a group)
MOE_CASES = {"dropless": (True, 1.25, S), "capacity": (False, 1.25, S),
             "capacity_drops": (False, 0.5, S),
             "one_group_a_sequence": (False, 1.25, 600),
             "decode": (True, 1.25, 1)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(layer, case):
    dropless, cf, s = MOE_CASES[case]
    p_ref, p = layer
    cfg_r = _with_capacity(ref_get_config(ARCH, smoke=True), cf)
    cfg = _with_capacity(get_config(ARCH, smoke=True), cf)
    x = _x((B, s, cfg.d_model), seed=s)
    y_r, aux_r = jax.jit(ref_ffn.moe_forward, static_argnums=(0, 3))(
        cfg_r, p_ref, jnp.asarray(x), dropless)
    y, aux = ffn.moe_forward(cfg, p, torch.from_numpy(x), dropless=dropless)
    assert y.shape == (B, s, cfg.d_model) and y.dtype == torch.float32
    _close(y, y_r, 1e-5)
    for name in ("moe_aux", "router_z"):
        np.testing.assert_allclose(float(aux[name]), float(aux_r[name]),
                                   rtol=1e-6)
    keep = ffn.route(cfg, p, torch.from_numpy(x), dropless)[-1]
    assert (keep is None) == dropless
    tg, g, _ = ffn.capacity_groups(cfg, B, s, dropless)
    assert (tg, g) == (s, B)        # one group a sequence at these lengths
    pairs = B * s * cfg.moe.top_k
    if case == "capacity":
        assert 0 < int((~keep).sum()) < pairs // 8
    elif case == "capacity_drops":
        assert int((~keep).sum()) >= pairs // 4


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_dense_dispatch_matches_moe_forward(layer, case):
    """The dry-run's one-hot dispatch (taken on ``meta``) gives the sorted
    dispatch's outputs and aux losses, dropped pairs included."""
    dropless, cf, s = MOE_CASES[case]
    _, p = layer
    cfg = _with_capacity(get_config(ARCH, smoke=True), cf)
    x = torch.from_numpy(_x((B, s, cfg.d_model), seed=s))
    y, aux = ffn.moe_forward(cfg, p, x, dropless=dropless)
    y_d, aux_d = ffn.moe_dense_dispatch(cfg, p, x, dropless=dropless)
    _close(y_d, y.numpy(), 1e-5)
    for name in ("moe_aux", "router_z"):
        np.testing.assert_allclose(float(aux_d[name]), float(aux[name]),
                                   rtol=1e-6)
    meta = ffn.moe_forward(cfg, convert._map(p, lambda t: t.to("meta")),
                           x.to("meta"), dropless=dropless)
    assert meta[0].shape == y.shape and meta[0].device.type == "meta"


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, idx = ffn._top_k(probs, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 2, 4]]
    _close(vals, want_v, 0)


# ------------------------------------------------------------ the model ----
@pytest.fixture(scope="module")
def model():
    """The smoke model's weights both ways and the reference's results,
    each computed once: forward in train (capacity) and eval (dropless)
    mode, then a prefill of S tokens into an S+4 cache and two decode
    steps, in float32."""
    cfg_r = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    with jax.threefry_partitionable(False):
        tree = _noisy(jax.jit(lambda k: ref_lm.init_params(cfg_r, k))(
            jax.random.PRNGKey(0)))
    p_ref = jax.tree.map(jnp.asarray, tree)
    tok = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S + 2)).astype(np.int32)
    fwd = jax.jit(ref_lm.forward, static_argnums=(0, 4))
    want = {"forward": {ev: fwd(cfg_r, p_ref, jnp.asarray(tok), None, ev)
                        for ev in (False, True)}}
    want.update(_prefill_decode(cfg_r, p_ref, tok))
    return cfg_r, cfg, p_ref, convert.params_from_numpy(cfg, tree), tree, \
        tok, want


def _prefill_decode(cfg_r, p_ref, tok) -> dict:
    """The reference's prefill of S tokens into an S+4 cache and two
    decode steps (jitted), with numpy caches."""
    lg, c = jax.jit(ref_lm.prefill, static_argnums=(0, 3))(
        cfg_r, p_ref, jnp.asarray(tok[:, :S]), S + 4)
    want = {"prefill": (lg, jax.tree.map(np.asarray, c))}
    step = jax.jit(ref_lm.decode_step, static_argnums=0)
    for i in range(2):
        lg, c = step(cfg_r, p_ref, jnp.asarray(tok[:, S + i:S + i + 1]),
                     jnp.full((B,), S + i, jnp.int32), c)
        want[f"decode{i}"] = (lg, jax.tree.map(np.asarray, c))
    return want


def _same_caches(cfg, got, want, atol):
    got = convert.cache_to_numpy(cfg, got)
    assert set(got) == set(want) == {"pro_0", "stack"}
    for g, w in [(got["pro_0"], want["pro_0"]),
                 (got["stack"]["p0"], want["stack"]["p0"])]:
        for f in ("k", "v"):
            _close(getattr(g, f), getattr(w, f), atol)


@pytest.mark.parametrize("eval_mode", [False, True],
                         ids=["train_capacity", "eval_dropless"])
def test_forward_matches_reference(model, eval_mode):
    """Logits and the summed MoE aux loss; training mode routes with
    capacity, eval dropless, as the reference does."""
    _, cfg, _, p, _, tok, want = model
    lg_r, aux_r = want["forward"][eval_mode]
    lg, aux = lm.forward(cfg, p, torch.from_numpy(tok), eval_mode=eval_mode,
                         device="cpu")
    _close(lg, lg_r, 1e-4)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-6)


def test_prefill_and_decode_match_reference(model):
    """Prefill S tokens into an S+4 cache, then two decode steps: logits
    and every cache tensor (the dense layer 0 and the MoE layers) in the
    reference's layout."""
    _, cfg, _, p, _, tok, want = model
    lg, c = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]), s_max=S + 4,
                       device="cpu")
    _close(lg, want["prefill"][0], 1e-4)
    _same_caches(cfg, c, want["prefill"][1], 1e-5)
    for i in range(2):
        lg, c = lm.decode_step(cfg, p, torch.from_numpy(tok[:, S + i:S + i + 1]),
                               torch.full((B,), S + i, dtype=torch.int32), c,
                               device="cpu")
        _close(lg, want[f"decode{i}"][0], 1e-4)
        _same_caches(cfg, c, want[f"decode{i}"][1], 1e-5)


def test_decode_from_a_carried_cache(model):
    """The reference's prefill cache, carried across, decodes to its
    logits."""
    _, cfg, _, p, _, tok, want = model
    c = convert.cache_from_numpy(cfg, want["prefill"][1])
    lg, _ = lm.decode_step(cfg, p, torch.from_numpy(tok[:, S:S + 1]),
                           torch.full((B,), S, dtype=torch.int32), c,
                           device="cpu")
    _close(lg, want["decode0"][0], 1e-4)


#: a token whose k-th and (k+1)-th router probabilities lie within one
#: bf16 step (2^-8) of each other can be routed either way by two correct
#: bf16 computations that round at different points
NEAR_TIE = 2.0 ** -8


def route_margins(monkeypatch, run):
    """``run()``'s result and, for every token, the smallest gap between
    its k-th and (k+1)-th router probability over the MoE layers (each
    layer's routing recomputed from the input the model gave it)."""
    seen = []
    real = ffn.moe_forward

    def spy(cfg, p, x, dropless=False):
        top = torch.sort(ffn.route(cfg, p, x, True)[1], dim=-1,
                         descending=True).values
        k = cfg.moe.top_k
        seen.append((top[:, k - 1] - top[:, k]).float())
        return real(cfg, p, x, dropless)

    with monkeypatch.context() as m:
        m.setattr(ffn, "moe_forward", spy)
        out = run()
    return out, torch.stack(seen).amin(dim=0)


def test_bfloat16_prefill_and_decode_match_reference(model, monkeypatch):
    """bf16 activations over float32 weights, as the full config runs; the
    tolerance of ``tests/test_torch_models.py``'s bf16 test (5e-2).  The
    two frameworks round bf16 at different points, so a token whose top-k
    sits within a bf16 step of a tie may take another expert in one of
    them and carry a different state from there on: such tokens (at most
    a quarter: 8 experts leave many near ties) are exempt in the MoE layers' caches, every other cache row
    and the logits are held."""
    _, _, _, _, tree, tok, _ = model
    cfg_r = ref_get_config(ARCH, smoke=True, dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True, dtype="bfloat16")
    want = _prefill_decode(cfg_r, jax.tree.map(jnp.asarray, tree), tok)
    p = convert.params_from_numpy(cfg, tree)
    (lg, c), margin = route_margins(monkeypatch, lambda: lm.prefill(
        cfg, p, torch.from_numpy(tok[:, :S]), s_max=S + 4, device="cpu"))
    assert lg.dtype == torch.bfloat16 and c[1].k.dtype == torch.bfloat16
    _close(lg, want["prefill"][0], 5e-2)
    near = (margin < NEAR_TIE).view(B, S).numpy()
    assert near.sum() <= B * S // 4
    got, ref = convert.cache_to_numpy(cfg, c), want["prefill"][1]
    for f in ("k", "v"):
        _close(getattr(got["pro_0"], f), getattr(ref["pro_0"], f), 5e-2)
        diff = np.abs(getattr(got["stack"]["p0"], f)
                      - getattr(ref["stack"]["p0"], f))[:, :, :S]
        rows = diff.max(axis=(0, 3, 4)) > 5e-2           # (B, S)
        assert not (rows & ~near).any(), np.argwhere(rows & ~near)
    for i in range(2):
        lg, c = lm.decode_step(cfg, p, torch.from_numpy(tok[:, S + i:S + i + 1]),
                               torch.full((B,), S + i, dtype=torch.int32), c,
                               device="cpu")
        _close(lg, want[f"decode{i}"][0], 5e-2)


def test_params_carry_across_one_to_one(model):
    """Every reference leaf lands in one port tensor; layer 0 keeps the
    dense FFN at ``d_ff_dense`` (not ``d_ff``), the others stack the
    experts, and the counts agree."""
    cfg_r, cfg, _, p, tree, _, _ = model
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    assert n_ref == sum(t.numel() for t in common._leaves(p)) \
        == cfg.n_params() == cfg_r.n_params()
    assert p["blocks"][0]["mlp"]["wi_up"].shape == (cfg.d_model,
                                                    cfg.moe.d_ff_dense)
    assert "moe" not in p["blocks"][0] and "mlp" not in p["blocks"][1]
    np.testing.assert_array_equal(
        p["blocks"][2]["moe"]["shared"]["wo"].numpy(),
        tree["blocks"]["stack"]["p0"]["moe"]["shared"]["wo"][1])
    np.testing.assert_array_equal(p["blocks"][1]["moe"]["router"].numpy(),
                                  tree["blocks"]["stack"]["p0"]["moe"]
                                  ["router"][0])


def test_init_params_cast_equals_cast_params():
    """``init_params(cast=True)`` draws the same numbers as ``init_params``
    and holds ``cast_params``' copy of them."""
    cfg = get_config(ARCH, smoke=True, dtype="bfloat16")
    full = lm.cast_params(cfg, lm.init_params(cfg, 3, device="cpu"))
    cast = lm.init_params(cfg, 3, device="cpu", cast=True)
    a, b = list(common._leaves(full)), list(common._leaves(cast))
    assert len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert cast["blocks"][1]["moe"]["wi_gate"].dtype == torch.bfloat16


def test_server_over_moe_replicas_matches_reference(model):
    """NetClone serving over three deepseek-moe-16b smoke replicas (one a
    straggler): the reference's ``ServeStats`` and tokens.  Decode routes
    dropless, one token a group, so a slot's tokens do not depend on its
    neighbours."""
    cfg_r, cfg, _, p, tree, _, _ = model
    p_ref = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(3)
    wl = [(int(t), rng.integers(0, cfg.vocab_size, 3).astype(np.int32))
          for t in np.sort(rng.integers(0, 12, 12))]

    def run(replica_cls, server_cls, c, params, **dev):
        reps = [replica_cls(c, params, sid=i, n_slots=2, s_max=64, **dev)
                for i in range(3)]
        reps[1].inject_slowdown(8)
        srv = server_cls(reps, policy="netclone", n_slots=256, seed=3, **dev)
        stats = srv.run(wl, max_new_tokens=3, max_ticks=300)
        return stats, {r: c.tokens.tolist() for r, c in srv._done.items()}

    want, want_tok = run(RefReplica, RefServer, cfg_r, p_ref)
    got, got_tok = run(DecodeReplica, NetCloneServer, cfg, p, device="cpu")
    assert got.n_completed == want.n_completed == 12
    assert got.latencies_ticks == want.latencies_ticks
    for f in ("n_cloned", "n_filtered", "n_clone_drops"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.n_cloned > 0
    assert got_tok == want_tok
