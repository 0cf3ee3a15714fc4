"""The port's sharding rules and launch lowering (``repro_torch.sharding``,
``repro_torch.launch.{mesh,specs,steps,dryrun}``) against the JAX
reference.

* the reference's rule tests (``tests/test_sharding.py``), on the port's
  per-layer paths and on the reference's stacked ones;
* the port's specs equal to the reference's ``PartitionSpec``s leaf by
  leaf, for every arch's full config, parameters and decode caches, on the
  16×16 and 2×16×16 production meshes and on a 2×2 one (a per-layer
  leaf's spec is the reference's stacked leaf's without its leading
  ``None``); the leaves are paired through ``train.tree.ref_leaves`` and
  ``convert.cache_to_numpy``, the reference's trees come from
  ``repro.launch.specs`` (``jax.eval_shape``);
* ``input_specs`` equal in shape and dtype for every supported cell;
* the dry-run on smoke configs: argument bytes equal to the bytes the
  reference's specs give, the probes extrapolating exactly to the full
  FLOP count, one dense layer's FLOPs the closed-form sum of its products;
* the hooks transparent (the same objects, the same bits) off a mesh and
  on a host mesh, and ``build_cell``'s steps bit-equal to the direct calls.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.sharding import context as ref_ctx
from repro.sharding import rules as ref_rules
from repro.train.step import make_train_state_shapes as ref_state_shapes
from repro_torch.configs import ARCHS, SHAPES, SMOKE_SHAPES, get_config, \
    supported_shapes
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh, make_host_mesh, \
    make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import family_of, lm
from repro_torch.models.convert import cache_to_numpy
from repro_torch.sharding import context, rules
from repro_torch.sharding.rules import P
from repro_torch.train import make_train_step
from repro_torch.train import tree as ttree
from test_torch_common import _one_torch_thread  # noqa: F401


CPU = "cpu"
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}


class FakeMesh:
    """Shape-only stand-in for the reference's rules."""

    def __init__(self, shape):
        self.shape = shape


MESH = Mesh(MESHES["16x16"])
MESH_MP = Mesh(MESHES["2x16x16"])


def _spec(path_str, shape, mesh=MESH):
    class L:
        pass
    leaf = L()
    leaf.shape = shape
    return rules.spec_for_param(path_str, leaf, mesh)


# ------------------------------------------------- the reference's rules --
@pytest.mark.parametrize("path,shape,want", [
    ("blocks/stack/p0/attn/wq", (1, 3072, 16, 256),
     P(None, "data", "model", None)),
    ("blocks/3/attn/wq", (3072, 16, 256), P("data", "model", None)),
    ("blocks/pro_0/attn/wo", (16, 256, 3072), P("model", None, "data")),
])
def test_attention_weight_specs(path, shape, want):
    assert _spec(path, shape) == want


def test_divisibility_guard_drops_axis():
    # 2 KV heads cannot shard over 16-way model axis
    assert _spec("blocks/stack/p0/attn/wk", (1, 2048, 2, 128)) == \
        P(None, "data", None, None)
    assert _spec("blocks/0/attn/wk", (2048, 2, 128)) == P("data", None, None)


def test_moe_expert_parallelism():
    assert _spec("blocks/stack/p0/moe/wi_gate", (1, 64, 2048, 1408)) == \
        P(None, "model", "data", None)
    assert _spec("blocks/1/moe/wo", (64, 1408, 2048)) == \
        P("model", None, "data")


def test_embed_specs():
    assert _spec("embed/tokens", (256000, 3072)) == P("model", "data")
    assert _spec("embed/unembed", (3072, 256000)) == P("data", "model")


def test_norm_vectors_zero_sharded():
    """Large 1-D params hit the FSDP fallback; small ones stay replicated,
    stacked or per layer."""
    assert _spec("blocks/stack/p0/pre_norm/scale", (1, 3072)) == \
        P(None, "data")
    assert _spec("blocks/5/pre_norm/scale", (3072,)) == P("data")
    assert _spec("blocks/stack/p0/pre_norm/scale", (1, 512)) == P()
    assert _spec("blocks/5/pre_norm/scale", (512,)) == P()


def test_no_duplicate_axis_assignment():
    s = _spec("blocks/pro_0/mlp/wi_gate", (4096, 4096))
    axes = [a for a in s if a is not None]
    assert len(axes) == len(set(axes))


def test_batch_spec_fallbacks():
    assert rules.batch_spec(MESH, 2, 0, 256) == P("data", None)
    assert rules.batch_spec(MESH, 2, 0, 1) == P(None, None)
    assert rules.batch_spec(MESH_MP, 2, 0, 256) == P(("pod", "data"), None)


def test_cache_specs_head_and_seq_fallback():
    class L:
        def __init__(self, shape):
            self.shape = shape

    assert rules.spec_for_cache("k", L((128, 32768, 16, 256)), MESH) == \
        P("data", None, "model", None)
    assert rules.spec_for_cache("k", L((128, 32768, 2, 128)), MESH) == \
        P("data", "model", None, None)
    # the port's per-layer list puts an index after the field
    assert rules.spec_for_cache("cross_k/3", L((128, 1500, 16, 64)),
                                MESH) == P("data", None, "model", None)


def test_param_shardings_cover_every_leaf():
    for arch in ("gemma-7b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
                 "mamba2-370m", "whisper-tiny"):
        params = specs.param_specs(get_config(arch))
        tree = rules.param_shardings(params, MESH)
        for (path, leaf) in ttree.flatten(params):
            spec = _at(tree, path)
            for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * 8):
                if ax is not None:
                    assert dim % MESH.shape[ax] == 0, (arch, path, spec)


def _at(tree, path):
    for k in path:
        tree = getattr(tree, k) if isinstance(k, str) and \
            hasattr(tree, "_fields") else tree[k]
    return tree


# ------------------------------------------ leaf by leaf, all ten archs ---
def _ref_leaves(tree):
    """{reference path: leaf} of a jax pytree."""
    return {ref_rules._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_param_path(key) -> str:
    parts = [str(k) for k in key if k is not None]
    if parts[0] == "stack" or parts[0].startswith(("pro_", "epi_")):
        parts = ["blocks"] + parts
    return "/".join(parts)


def _drop_stack(spec, stacked: bool) -> tuple:
    spec = tuple(spec)
    return spec[1:] if stacked and spec else spec


@pytest.fixture(scope="module")
def full_trees():
    """Per arch: the port's parameters and decode_32k cache on ``meta``,
    the reference's as ``jax.eval_shape`` gives them."""
    out = {}
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        shape = SHAPES["decode_32k"]
        out[arch] = (cfg, specs.param_specs(cfg),
                     specs.cache_specs(cfg, shape.global_batch,
                                       shape.seq_len),
                     ref_specs.param_specs(rcfg),
                     ref_specs.cache_specs(rcfg, shape.global_batch,
                                           shape.seq_len))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_equal_the_reference_leaf_by_leaf(full_trees,
                                                      mesh_name):
    mesh, fake = Mesh(MESHES[mesh_name]), FakeMesh(MESHES[mesh_name])
    n = 0
    for arch, (cfg, params, _, rparams, _) in full_trees.items():
        ref = _ref_leaves(rparams)
        flat = ttree.flatten(params)
        port_specs = rules.param_shardings(params, mesh)
        for rl in ttree.ref_leaves(cfg, params):
            rpath = _ref_param_path(rl.key)
            want = ref_rules.spec_for_param(rpath.split("/"), ref[rpath],
                                            fake)
            stacked = len(ref[rpath].shape) == flat[rl.members[0]][1].dim() + 1
            for i in rl.members:
                path, leaf = flat[i]
                got = _at(port_specs, path)
                assert tuple(got) == _drop_stack(want, stacked), \
                    (arch, rpath, path, got, want)
                n += 1
        assert n, arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_specs_equal_the_reference_leaf_by_leaf(full_trees,
                                                      mesh_name):
    mesh, fake = Mesh(MESHES[mesh_name]), FakeMesh(MESHES[mesh_name])
    for arch, (cfg, _, cache, _, rcache) in full_trees.items():
        flat = ttree.flatten(cache)
        # each port leaf replaced by its index: cache_to_numpy lays the
        # indices out as the reference's tree holds the leaves
        it = iter(range(len(flat)))
        index = ttree.tree_map(lambda _: torch.tensor([next(it)]), cache)
        paired = _ref_leaves(cache_to_numpy(cfg, index))
        ref = _ref_leaves(rcache)
        assert set(paired) == set(ref), arch
        port_specs = rules.cache_shardings(cache, mesh)
        for rpath, idx in paired.items():
            want = ref_rules.spec_for_cache(rpath.split("/"), ref[rpath],
                                            fake)
            stacked = np.asarray(idx).ndim == 2
            for i in np.asarray(idx).reshape(-1):
                path, leaf = flat[int(i)]
                assert tuple(ref[rpath].shape)[stacked:] == \
                    tuple(leaf.shape), (arch, rpath)
                got = _at(port_specs, path)
                assert tuple(got) == tuple(want)[stacked:], \
                    (arch, rpath, path, got, want)


def _jax_dtype_name(dt) -> str:
    return np.dtype(dt).name


def test_input_specs_equal_the_reference():
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for name in supported_shapes(arch):
            got = specs.input_specs(cfg, SHAPES[name])
            want = ref_specs.input_specs(rcfg, SHAPES[name])
            assert set(got) == set(want), (arch, name)
            for k in got:
                if k == "cache":
                    continue
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[-1] == \
                    _jax_dtype_name(want[k].dtype), (arch, name, k)
            if "cache" in got:
                leaves = ttree.flatten(got["cache"])
                it = iter(range(len(leaves)))
                index = ttree.tree_map(lambda _: torch.tensor([next(it)]),
                                       got["cache"])
                paired = _ref_leaves(cache_to_numpy(cfg, index))
                ref = _ref_leaves(want["cache"])
                assert set(paired) == set(ref), (arch, name)
                for rpath, idx in paired.items():
                    idx = np.asarray(idx)
                    for i in idx.reshape(-1):
                        leaf = leaves[int(i)][1]
                        assert tuple(ref[rpath].shape)[idx.ndim - 1:] == \
                            tuple(leaf.shape)
                        assert str(leaf.dtype).split(".")[-1] == \
                            _jax_dtype_name(ref[rpath].dtype), (arch, rpath)


# --------------------------------------------------- the dry-run, smoke ---
SMOKE_MESH = Mesh(MESHES["2x2"])
DRY = {}


def _dry(arch, shape):
    if (arch, shape) not in DRY:
        DRY[arch, shape] = dryrun.run_cell(arch, shape, False, smoke=True,
                                           mesh=SMOKE_MESH)
    return DRY[arch, shape]


def _ref_bytes(tree, spec_fn, mesh) -> int:
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = spec_fn(path, leaf)
        div = math.prod(ref_rules._axis_size(mesh, ax) for ax in spec
                        if ax is not None)
        total += math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize // div
    return total


def _ref_argument_bytes(arch, shape_name, mesh) -> int:
    shape = SMOKE_SHAPES[shape_name]
    rcfg = ref_get_config(arch, smoke=True, max_seq_len=shape.seq_len)
    ins = ref_specs.input_specs(rcfg, shape)

    def pspec(path, leaf):
        return ref_rules.spec_for_param(path, leaf, mesh)

    def bspec(path, leaf):
        return ref_rules.batch_spec(mesh, leaf.ndim, 0, leaf.shape[0])

    if shape.kind == "train":
        st = jax.eval_shape(ref_state_shapes(rcfg, False),
                            jax.random.PRNGKey(0))
        return (sum(_ref_bytes(t, pspec, mesh)
                    for t in (st.params, st.opt.mu, st.opt.nu))
                + _ref_bytes(st.opt.step, lambda p, x: (), mesh)
                + _ref_bytes(ins, bspec, mesh))
    params = _ref_bytes(ref_specs.param_specs(rcfg), pspec, mesh)
    if shape.kind == "prefill":
        return params + _ref_bytes(ins, bspec, mesh)
    return (params + _ref_bytes(ins["tokens"], bspec, mesh)
            + _ref_bytes(ins["pos"], bspec, mesh)
            + _ref_bytes(ins["cache"], lambda p, x: ref_rules.spec_for_cache(
                p, x, mesh), mesh))


@pytest.mark.parametrize("arch,shape", [
    ("qwen2.5-3b", "train_4k"), ("mamba2-370m", "train_4k"),
    ("deepseek-moe-16b", "train_4k"), ("whisper-tiny", "train_4k"),
    ("qwen2.5-3b", "prefill_32k"), ("mamba2-370m", "decode_32k"),
    ("whisper-tiny", "decode_32k")])
def test_dryrun_argument_bytes_and_probes(arch, shape):
    rec = _dry(arch, shape)
    assert rec["ok"], rec.get("traceback")
    assert rec["full"]["memory"]["argument_bytes"] == \
        _ref_argument_bytes(arch, shape, FakeMesh(MESHES["2x2"]))
    check = rec["probe_check"]
    assert check["exact"] and check["extrapolated_flops"] == \
        rec["full"]["cost"]["flops_global"] > 0
    assert rec["full"]["memory"]["temp_bytes"] is None
    if shape == "train_4k":
        coll = rec["full"]["collectives"]
        assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
        # donated state: every output byte but the metrics' aliases
        assert rec["full"]["memory"]["alias_bytes"] <= \
            rec["full"]["memory"]["output_bytes"]


def test_dryrun_dense_layer_flops_closed_form():
    """probe2 − probe1 is one qwen layer: the sum of 2·M·N·K over its
    projections and MLP plus the two attention products."""
    rec = _dry("qwen2.5-3b", "prefill_32k")
    cfg = get_config("qwen2.5-3b", smoke=True)
    shape = SMOKE_SHAPES["prefill_32k"]
    b, s = shape.global_batch, shape.seq_len
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    m = b * s
    mats = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f
    want = 2 * m * mats + 2 * (2 * b * h * s * s * hd)
    got = (rec["probe2"]["cost"]["flops_global"]
           - rec["probe1"]["cost"]["flops_global"])
    assert got == want


def _ref_fsdp_bytes(rcfg, mesh) -> dict:
    """{"blocks" | "tokens" | "unembed": (gathered, shard)}: bytes a
    device of one ``fsdp_use`` over every layer's FSDP-sharded weights, or
    over one embed table leaf, at the reference's specs: gathered at the spec
    without ``data`` (the reference's ``_drop_fsdp``), a gradient
    reduce-scattered back to the full spec, in the dtype the reference's
    ``cast=`` gives a floating weight of two or more dims."""
    cast = (np.dtype(rcfg.activation_dtype).itemsize
            if rcfg.cast_weights_on_gather else None)
    out = {"blocks": [0, 0], "tokens": [0, 0], "unembed": [0, 0]}
    tree = ref_specs.param_specs(rcfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        ps = ref_rules._path_str(path)
        top = ps.split("/")[0] if ps.startswith("blocks/") else \
            ps.removeprefix("embed/")
        spec = tuple(ref_rules.spec_for_param(path, leaf, mesh))
        if top not in out or ref_rules.FSDP_AXIS not in spec:
            continue
        stacked = "/stack/" in f"/{ps}/"
        item = np.dtype(leaf.dtype).itemsize
        if cast and leaf.ndim - stacked >= 2 and leaf.dtype == np.float32:
            item = cast
        n = math.prod(leaf.shape) * item
        for i, sp in enumerate((tuple(ref_ctx._drop_fsdp(P(*spec))), spec)):
            out[top][i] += n // math.prod(ref_rules._axis_size(mesh, ax)
                                          for ax in sp if ax is not None)
    return out


def _ref_seq_bytes(rcfg, shape, mesh) -> int:
    """Bytes a device of one layer input (B, S, D) at the batch sharding
    the reference's ``constrain_seq`` gives it with the sequence gathered
    (0 where it falls back to ``constrain_batch``)."""
    tp = mesh.shape.get(ref_rules.TP_AXIS, 1)
    b, s = shape.global_batch, shape.seq_len
    if not rcfg.sequence_parallel or tp <= 1 or s % tp:
        return 0
    ax = ref_rules.batch_axes(mesh)
    if b % ref_rules._axis_size(mesh, ax):
        ax = "data" if b % mesh.shape["data"] == 0 else None
    return (b * s * rcfg.d_model * np.dtype(rcfg.activation_dtype).itemsize
            // ref_rules._axis_size(mesh, ax))


@pytest.mark.parametrize("arch,shape", [
    ("qwen2.5-3b", "train_4k"), ("mamba2-370m", "train_4k"),
    ("deepseek-moe-16b", "train_4k"), ("qwen2.5-3b", "prefill_32k")])
def test_dryrun_collectives_equal_the_reference_reckoning(arch, shape):
    """The recorded collectives against the reference's specs and hook
    sites (``lm._apply_layer``'s ``fsdp_use`` and ``constrain_seq`` once a
    layer, ``_emb`` once for the embedding and once for the unembedding):
    the weights' all-gathers once a layer and pass, again in each layer's
    remat recompute, and the embed leaf each pass reads (the reference's
    lowering drops the other's gather); in a train step each layer's input
    gathered over ``model`` as often, and each gathered weight's and
    layer input's gradient reduce-scattered once."""
    rec = _dry(arch, shape)
    sh = SMOKE_SHAPES[shape]
    rcfg = ref_get_config(arch, smoke=True, max_seq_len=sh.seq_len)
    assert not rcfg.pin_attention_heads
    mesh = FakeMesh(MESHES["2x2"])
    fsdp = _ref_fsdp_bytes(rcfg, mesh)
    out = "tokens" if rcfg.tie_embeddings else "unembed"
    g_blocks, s_blocks = fsdp["blocks"]
    g_embed, s_embed = (fsdp["tokens"][i] + fsdp[out][i] for i in (0, 1))
    assert g_blocks > 0 and fsdp["tokens"][0] > 0 and fsdp[out][0] > 0
    if sh.kind == "train":
        seq = rcfg.n_layers * _ref_seq_bytes(rcfg, sh, mesh)
        assert seq > 0
        passes = 2 if rcfg.remat != "none" else 1
        want = {"all-gather": passes * (g_blocks + seq) + g_embed,
                "reduce-scatter": (s_blocks + seq // mesh.shape["model"]
                                   + s_embed)}
    else:
        want = {"all-gather": g_blocks + g_embed}
    assert rec["full"]["collectives"] == want


def test_dryrun_prefill_flops_closed_form():
    """A dense prefill's FLOPs: every layer's closed-form sum and the
    unembedding of the last position, split evenly over the devices."""
    rec = _dry("qwen2.5-3b", "prefill_32k")
    cfg = get_config("qwen2.5-3b", smoke=True)
    shape = SMOKE_SHAPES["prefill_32k"]
    b, s = shape.global_batch, shape.seq_len
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    mats = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f
    layer = 2 * b * s * mats + 2 * (2 * b * h * s * s * hd)
    cost = rec["full"]["cost"]
    assert cost["flops_global"] == cfg.n_layers * layer \
        + 2 * b * d * cfg.vocab_size
    assert cost["flops"] == cost["flops_global"] / math.prod(
        SMOKE_MESH.shape.values())


def test_dryrun_cli_writes_its_records(tmp_path):
    out = tmp_path / "dry"
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                        "--no-probes", "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    rec = json.loads((out / "mamba2-370m__long_500k__sp.json").read_text())
    assert rec["ok"] and rec["mesh"] == "16x16"
    assert rec["full"]["memory"]["argument_bytes"] > 0
    skip = json.loads((out / "qwen2.5-3b__long_500k__sp.json").read_text())
    assert skip["ok"] and skip["skipped"]


# ------------------------------------------------ hooks and build_cell ----
def test_hooks_return_their_input_off_a_mesh():
    x = torch.zeros(2, 4, 8)
    p = {"attn": {"wq": torch.zeros(8, 2, 4)}}
    for mesh in (None, make_host_mesh(device=CPU)):
        with context.use_mesh(mesh):
            assert context.fsdp_use(p) is p
            for hook in (context.constrain_batch, context.constrain_seq,
                         context.constrain_heads):
                assert hook(x) is x
    # a shape-only mesh outside a lowering records nothing, moves nothing
    with context.use_mesh(MESH):
        assert context.fsdp_use(p) is p
        assert context.constrain_seq(x) is x


def test_real_mesh_of_several_devices_is_refused(monkeypatch):
    """Several devices in one process are refused (one process a device is
    the path: a rank mesh, ``tests/test_torch_ranks.py``), and so is a rank
    mesh with a ``model`` axis; a shape-only mesh still records."""
    import repro_torch.launch.mesh as mesh_mod
    from repro_torch.launch.mesh import make_rank_mesh

    with pytest.raises(ValueError):
        make_host_mesh(data=2, device=CPU)
    fake = Mesh({"data": 2, "model": 1}, devices=("cpu", "cpu"))
    with context.use_mesh(fake), pytest.raises(NotImplementedError,
                                               match="A9-shard-multi"):
        context.fsdp_use({"w": torch.zeros(2)})
    # a CUDA mesh of several devices in one process
    monkeypatch.setattr(mesh_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert make_host_mesh(data=1).devices == (torch.device("cuda", 0),)
    with pytest.raises(NotImplementedError, match="one process a device"):
        make_host_mesh(data=2)
    monkeypatch.undo()
    # tensor parallelism over ranks is not written
    with pytest.raises(NotImplementedError, match="A9-shard-multi's TP"):
        make_rank_mesh(model=2, device=CPU)
    tp = Mesh({"data": 1, "model": 2}, devices=("cpu",), group=object())
    with context.use_mesh(tp), pytest.raises(NotImplementedError,
                                             match="A9-shard-multi's TP"):
        context.constrain_heads(torch.zeros(1, 2, 2, 4))
    # a shape-only mesh records under a lowering, as before
    with context.use_mesh(SMOKE_MESH), context.recording() as coll:
        w = torch.zeros(64, 2, 16)
        assert context.fsdp_use({"attn": {"wq": w}})["attn"]["wq"] is w
    assert coll["all-gather"] > 0
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.devices is None and math.prod(mesh.shape.values()) == 512


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-370m",
                                  "deepseek-moe-16b", "whisper-tiny"])
def test_hooks_are_bit_transparent_on_the_smoke_models(arch):
    """The smoke model's loss bit-equal off a mesh, on the host mesh and
    under a dry-run's recorder on a 2x2 shape-only mesh."""
    cfg = get_config(arch, smoke=True)
    fam = family_of(cfg)
    params = fam.init_params(cfg, 0, CPU)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=2, seed=0))
    batch = data.batch(0)
    if cfg.arch_type == "encdec":
        batch["frames"] = np.random.default_rng(0).standard_normal(
            (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    outs = []
    for mesh in (None, make_host_mesh(device=CPU)):
        with context.use_mesh(mesh):
            loss, _ = fam.loss_fn(cfg, params, batch, device=CPU)
        outs.append(loss)
    # under a lowering's recorder on a shape-only mesh: values unchanged
    with context.use_mesh(SMOKE_MESH), context.recording() as coll:
        loss, _ = fam.loss_fn(cfg, params, batch, device=CPU)
    outs.append(loss)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert coll["all-gather"] > 0


def _tree_equal(a, b) -> bool:
    la, lb = ttree.leaves(a), ttree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_build_cell_train_step_equals_the_direct_step():
    cfg = get_config("mamba2-370m", smoke=True)
    shape = SMOKE_SHAPES["train_4k"]
    bundle = build_cell(cfg, shape, make_host_mesh(device=CPU))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=shape.seq_len,
                                  global_batch=shape.global_batch, seed=0))
    direct = make_train_step(cfg, CPU)
    s1, s2 = bundle.init_state(0), direct.init_state_fn(0)
    for i in range(2):
        s1, m1 = bundle.run(s1, data.batch(i))
        s2, m2 = direct.step_fn(s2, data.batch(i))
        assert all(torch.equal(m1[k], m2[k]) for k in m2)
    assert _tree_equal(s1, s2)
    assert bundle.in_specs[0].opt.step == P()


@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen2.5-3b"])
def test_build_cell_prefill_and_decode_equal_the_direct_calls(arch):
    cfg = get_config(arch, smoke=True)
    mesh = make_host_mesh(device=CPU)
    shape = SMOKE_SHAPES["prefill_32k"]
    params = lm.init_params(cfg, 0, CPU)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (shape.global_batch, shape.seq_len)),
        dtype=torch.int32)
    logits, cache = build_cell(cfg, shape, mesh).run(params,
                                                     {"tokens": tokens})
    want, wcache = lm.prefill(cfg, params, tokens, shape.seq_len, device=CPU)
    assert torch.equal(logits, want) and _tree_equal(cache, wcache)
    dshape = SMOKE_SHAPES["decode_32k"]
    mine = ttree.tree_map(torch.clone, cache)
    theirs = ttree.tree_map(torch.clone, cache)
    held = ttree.leaves(mine)
    tok = tokens[:, -1:]
    pos = torch.full((shape.global_batch,), shape.seq_len - 1,
                     dtype=torch.int32)
    got, out = build_cell(cfg, dshape, mesh).run(params, tok, pos, mine)
    want, wcache = lm.decode_step(cfg, params, tok, pos, theirs, device=CPU)
    assert torch.equal(got, want) and _tree_equal(out, wcache)
    # donated: the cache it was given holds the new state, in place
    assert all(a is b for a, b in zip(ttree.leaves(out), held))


def test_sharding_and_launch_import_neither_jax_nor_the_reference():
    code = """
import sys
import repro_torch.sharding, repro_torch.launch.mesh
import repro_torch.launch.specs, repro_torch.launch.steps
import repro_torch.launch.dryrun
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------ dry-run artifacts --------
DRYRUN = Path("results/dryrun_torch")


@pytest.mark.skipif(not DRYRUN.exists() or not list(DRYRUN.glob("*.json")),
                    reason="the port's dry-run records are not generated")
def test_dryrun_records_every_cell():
    """Every (arch × shape) record of ``python -m repro_torch.launch.dryrun
    --all`` is there and ok, skips where the arch does not run the shape,
    and its probes extrapolate exactly."""
    for arch in ARCHS:
        for shape in SHAPES:
            p = DRYRUN / f"{arch}__{shape}__sp.json"
            assert p.exists(), f"missing {p.name}"
            rec = json.loads(p.read_text())
            assert rec["ok"], f"{p.name}: {rec.get('error')}"
            if shape not in supported_shapes(arch):
                assert rec.get("skipped"), p.name
            elif "probe_check" in rec:
                assert rec["probe_check"]["exact"], p.name
