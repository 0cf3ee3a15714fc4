"""The port on a mesh of ranks (one process a device over
``torch.distributed``) on the CPU: gloo ranks spawned with
``torch.multiprocessing.spawn`` over a ``FileStore`` under the test's
``tmp_path`` (no port is shared between parallel workers), each rank in
one torch thread.  One spawn a scenario, with several checks inside the
ranks; the ranks write what the parent compares under ``tmp_path``.

* the FleetSim sweep at W = 2 and 3 over 5 configurations (both pad):
  rows and ``grid_hist`` bit-identical to the unsharded run, and
  ``shard_equivalence`` through a SweepSpec;
* the train step at W = 2 on the qwen2.5-3b and deepseek-moe-16b smoke
  configs (float32), 2 steps, against the one-process port step on the
  same global batches and the reference's ``make_train_step`` on its
  one-device host mesh: loss, ``ce``, ``aux`` and ``grad_norm`` within
  ``rtol`` 1e-5, every leaf reassembled from the ranks within
  ``test_torch_train.py``'s AdamW tolerances (``rtol`` 1e-5, ``atol`` 1e-7
  of the leaf's scale); the compression's scales at W = 2 within ``rtol``
  1e-6 of the one-process scales on the same batch, its dequantised
  gradients within one quantum; the training driver at W = 2;
* elastic restore: a state saved at W = 4 restored at W = 2 and W = 1, one
  saved at W = 1 restored at W = 2, every leaf bit-exact;
* a gloo group of one: the hooks run their collectives (every kind is
  issued) and the step's loss, metrics and state are bit-equal to the
  step off a mesh.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.fleetsim as tf
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.fleetsim import EngineOptions, ShardSpec
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import assemble, fsdp_dim, local_shard
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train import tree as ttree
from repro_torch.train.compress import compress_grads, group_scales
from repro_torch.train.step import (
    loss_and_grads,
    make_train_state_shapes,
    state_specs,
)
from test_torch_common import _one_torch_thread  # noqa: F401

CPU = "cpu"
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
           clip_norm=1.0)
ARCHS = ("qwen2.5-3b", "deepseek-moe-16b")
B, S, STEPS = 4, 32, 2


# ------------------------------------------------------------ spawning -----
def _rank_main(rank, w, root, fn, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, f"store_{fn.__name__}_{w}"),
                           w)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=w)
    try:
        fn(rank, w, root, *args)
    finally:
        dist.destroy_process_group()


def _spawn(fn, w, tmp_path, *args):
    torch.multiprocessing.spawn(_rank_main, args=(w, str(tmp_path), fn,
                                                  args), nprocs=w, join=True)


def _data(cfg):
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))


def _whole(state, layout):
    """The whole state from the ranks' blocks (a copy, on every rank)."""
    def join(leaf, spec):
        dim = fsdp_dim(spec)
        leaf = leaf.detach()
        return leaf.clone() if dim is None else collectives.all_gather(
            leaf, dim, layout.mesh.group)
    return ttree.tree_map(join, state, layout.specs)


# --------------------------------------------------------------- sweep -----
def _sweep_cfg():
    return tf.FleetConfig(n_servers=4, n_workers=8, n_ticks=200,
                          service=tf.ServiceSpec.exponential(25.0))


def _grid(g):
    base = tf.make_params(_sweep_cfg(), 2, 0.05, 0)
    return tf.RunParams(*(torch.stack([a] * g) for a in base))._replace(
        seed=torch.arange(g, dtype=torch.int32))


def _sweep_ranks(rank, w, root):
    from repro_torch.fleetsim.shard import ShardedMetrics
    from repro_torch.fleetsim.validate import shard_equivalence
    from repro_torch.scenarios import Scenario, SweepSpec

    cfg, params = _sweep_cfg(), _grid(5)
    assert ShardSpec().mesh(CPU) == [torch.device(CPU)] * w
    with pytest.raises(ValueError, match="ranks"):
        ShardSpec(devices=w + 1).mesh(CPU)
    plain = tf.simulate(cfg, params, device=CPU,
                        options=EngineOptions(backend="staged"))
    for backend in ("staged", "fused"):
        got = tf.simulate(cfg, params, device=CPU, options=EngineOptions(
            backend=backend, shard=ShardSpec()))
        assert isinstance(got, ShardedMetrics)
        for a, b in zip(got.metrics, plain):
            assert a.shape == b.shape and torch.equal(a, b)
        assert torch.equal(got.grid_hist,
                           plain.hist.sum(dim=0, dtype=plain.hist.dtype))
    spec = SweepSpec(
        base=Scenario(name="se", servers=4, workers=8, n_ticks=200),
        policies=("baseline", "netclone", "hedge"), loads=(0.4,),
        seeds=(0,), hedge_delays=(60.0,))
    checks, hist_ok = shard_equivalence(spec, shard=0, device=CPU)
    assert hist_ok and len(checks) == 3
    assert all(c.ok and c.counters_ok and c.stat_rel == 0.0 for c in checks)


@pytest.mark.parametrize("w", [2, 3])
def test_sweep_over_ranks_is_bit_identical(w, tmp_path):
    """5 configurations over 2 and 3 ranks (one and one padded row): every
    counter and histogram of every row, and the all-reduced ``grid_hist``,
    equal to the unsharded run; staged and fused."""
    _spawn(_sweep_ranks, w, tmp_path)


# ---------------------------------------------------------- train step -----
def _reference_start(arch):
    """The reference's initial weights (as the port's tree), its 2 steps'
    metrics on the same batches, and its weights' numpy tree."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.launch.mesh import make_host_mesh as ref_host_mesh
    from repro.sharding import use_mesh as ref_use_mesh
    from repro.train import OptimizerConfig as RefOpt
    from repro.train import make_train_step as ref_make_train_step
    from repro_torch.models import convert

    cfg_r, cfg = ref_get_config(arch, smoke=True), get_config(arch,
                                                              smoke=True)
    data = _data(cfg)
    mesh = ref_host_mesh()
    with jax.threefry_partitionable(False), ref_use_mesh(mesh):
        bundle = ref_make_train_step(cfg_r, mesh, RefOpt(**OPT),
                                     batch_example=data.batch(0))
        st = bundle.init_state_fn(jax.random.PRNGKey(3))
        tree = jax.tree.map(np.asarray, st.params)
        mets = []
        for i in range(STEPS):
            st, m = bundle.step_fn(st, data.batch(i))
            mets.append({k: float(v) for k, v in m.items()})
    return convert.params_from_numpy(cfg, tree), mets, tree


def _state_of(cfg, params, use_compression=False):
    """A fresh train state (zero moments and residuals) around whole
    ``params``, its leaves in the order the step's own init gives them."""
    init = make_train_state_shapes(cfg, use_compression)(0, CPU)
    params = ttree.tree_map(
        lambda _, p: p.detach().clone().requires_grad_(True), init.params,
        params)
    return init._replace(params=params)


def _groups(cfg):
    shapes = make_train_state_shapes(cfg, False)(0, "meta").params
    return [r.members for r in ttree.ref_leaves(cfg, shapes)]


def _host(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _train_ranks(rank, w, root):
    from repro_torch.launch import train as train_mod

    mesh = make_host_mesh(device=CPU)
    assert mesh.ranks and mesh.shape == {"data": w, "model": 1}
    with pytest.raises(NotImplementedError, match="TP part"):
        make_host_mesh(model=2, device=CPU)
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        data = _data(cfg)
        start = torch.load(os.path.join(root, f"start_{arch}.pt"),
                           weights_only=False)
        bundle = make_train_step(cfg, CPU, OptimizerConfig(**OPT), mesh=mesh)
        layout = bundle.layout
        state = bundle.shard_state(_state_of(cfg, start))
        # a sharded leaf is this rank's block
        assert any(a.shape != b.shape for a, b in zip(
            ttree.leaves(state.params), ttree.leaves(start)))
        steps = []
        for i in range(STEPS):
            batch = _host(data.host_batch(i, rank, w))
            before = _whole(state, layout)
            _, _, grads = loss_and_grads(cfg, state.params, batch, layout)
            grads = [g if fsdp_dim(s) is None
                     else collectives.all_gather(g, fsdp_dim(s), mesh.group)
                     for g, s in zip(grads, layout.param_specs)]
            state, m = bundle.step_fn(state, batch)
            steps.append({"mets": {k: float(v) for k, v in m.items()},
                          "before": before, "grads": grads,
                          "after": _whole(state, layout)})
        if arch == ARCHS[0]:
            # the compression's scales and output on the first batch
            comp = make_train_step(cfg, CPU, OptimizerConfig(**OPT), True,
                                   mesh=mesh)
            s0 = comp.shard_state(_state_of(cfg, start, True))
            _, _, grads = loss_and_grads(
                cfg, s0.params, _host(data.host_batch(0, rank, w)),
                comp.layout)
            scales = group_scales(grads, s0.ef, _groups(cfg), mesh.group)
            gq, _ = compress_grads(grads, s0.ef, _groups(cfg), mesh.group)
            gq = [g if fsdp_dim(s) is None
                  else collectives.all_gather(g, fsdp_dim(s), mesh.group)
                  for g, s in zip(gq, layout.param_specs)]
        if rank == 0:
            torch.save({"steps": steps,
                        **({"scales": scales, "gq": gq}
                           if arch == ARCHS[0] else {})},
                       os.path.join(root, f"ranks_{arch}.pt"))
    # the driver on the rank mesh: it trains, checkpoints and resumes
    ck = os.path.join(root, "driver")
    out = train_mod.main(["--device", CPU, "--steps", "4", "--seq-len", "32",
                          "--global-batch", "4", "--ckpt-dir", ck,
                          "--ckpt-every", "2", "--log-every", "100"])
    again = train_mod.main(["--device", CPU, "--steps", "6", "--seq-len",
                            "32", "--global-batch", "4", "--ckpt-dir", ck,
                            "--resume", "--log-every", "100"])
    assert out["start_step"] == 0 and again["start_step"] == 4
    assert np.isfinite(out["losses"] + again["losses"]).all()


#: gradients: per leaf, max |diff| within this share of the leaf's max |g|,
#: or of the model's largest for a leaf whose gradient is rounding noise
#: (``test_torch_train.py``'s gradient tolerance)
GRAD_RTOL, NOISE_RTOL = 1e-4, 1e-6


def _close_grads(got, want):
    top = max(float(g.abs().max()) for g in want)
    for a, b in zip(got, want):
        tol = max(GRAD_RTOL * float(b.abs().max()), NOISE_RTOL * top)
        assert float((a - b).abs().max()) <= tol


def _close_leaves(got, want):
    """``test_torch_train.py``'s AdamW tolerances."""
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-7 * scale + 1e-30)


def _ref_grads(arch, tree, batch):
    """``jax.grad`` of the reference's loss at its weights ``tree`` on
    ``batch``, as the port's leaves in the step's order."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import family_of as ref_family_of
    from repro_torch.models import convert

    cfg_r, cfg = ref_get_config(arch, smoke=True), get_config(arch,
                                                              smoke=True)
    fam = ref_family_of(cfg_r)
    g = jax.jit(jax.grad(lambda p, b: fam.loss_fn(cfg_r, p, b)[0]))(
        tree, batch)
    order = make_train_state_shapes(cfg, False)(0, "meta").params
    return ttree.leaves(ttree.tree_map(
        lambda _, x: x, order, convert.params_from_numpy(
            cfg, jax.tree.map(np.asarray, g))))


def test_train_step_over_two_ranks(tmp_path):
    """qwen2.5-3b and deepseek-moe-16b (smoke, float32) at W = 2, 2 steps.
    Each step's loss, ``ce``, ``aux`` and ``grad_norm`` against the
    one-process port step's and the reference's on the same global batches
    (``rtol`` 1e-5); each step's gradients, reassembled from the ranks,
    against one process's at the same parameters (and the first step's
    against ``jax.grad``), at the gradient tolerance; and each step's
    update against one process's AdamW on the same state and gradients,
    every leaf within the AdamW tolerances.  The parameters after two
    steps are not held leaf by leaf to the whole-batch runs: AdamW divides
    each element by its own root mean square, so an element whose
    gradient nearly cancels over the batch turns a summation-order
    difference into one of order the learning rate, as between the
    one-process port and the reference themselves."""
    from repro_torch.train.optimizer import OptState, adamw_update

    oracles = {}
    for arch in ARCHS:
        start, ref_mets, tree = _reference_start(arch)
        torch.save(start, tmp_path / f"start_{arch}.pt")
        cfg = get_config(arch, smoke=True)
        data = _data(cfg)
        one = make_train_step(cfg, CPU, OptimizerConfig(**OPT))
        state, mets = _state_of(cfg, start), []
        for i in range(STEPS):
            state, m = one.step_fn(state, data.batch(i))
            mets.append({k: float(v) for k, v in m.items()})
        oracles[arch] = (mets, ref_mets, start, tree)
    _spawn(_train_ranks, 2, tmp_path)
    for arch, (mets, ref_mets, start, tree) in oracles.items():
        cfg = get_config(arch, smoke=True)
        data = _data(cfg)
        decay = ttree.decay_mask(cfg, _state_of(cfg, start).params)
        got = torch.load(tmp_path / f"ranks_{arch}.pt", weights_only=False)
        for i, rec in enumerate(got["steps"]):
            for want in (mets[i], ref_mets[i]):
                for k in ("loss", "ce", "aux", "grad_norm"):
                    np.testing.assert_allclose(rec["mets"][k], want[k],
                                               rtol=1e-5, atol=1e-12,
                                               err_msg=f"{arch} {i} {k}")
            before = rec["before"]
            params = ttree.tree_map(
                lambda p: p.detach().clone().requires_grad_(True),
                before.params)
            _, _, grads = loss_and_grads(cfg, params, _host(data.batch(i)))
            _close_grads(rec["grads"], grads)
            if i == 0:
                _close_grads(rec["grads"], _ref_grads(arch, tree,
                                                      data.batch(0)))
            opt = OptState(*(ttree.tree_map(torch.clone, x)
                             for x in before.opt))
            new, opt, _ = adamw_update(
                OptimizerConfig(**OPT), ttree.tree_map(torch.clone,
                                                       before.params),
                [g.clone() for g in rec["grads"]], opt, decay)
            after = rec["after"]
            for a, b in ((after.params, new), (after.opt.mu, opt.mu),
                         (after.opt.nu, opt.nu)):
                _close_leaves(ttree.leaves(a), ttree.leaves(b))
            assert int(after.opt.step) == int(opt.step) == i + 1
        if arch != ARCHS[0]:
            continue
        # the compression on the first batch, against one process's
        s0 = _state_of(cfg, start, True)
        _, _, grads = loss_and_grads(cfg, s0.params, _host(data.batch(0)))
        scales = group_scales(grads, s0.ef, _groups(cfg))
        gq, _ = compress_grads(grads, s0.ef, _groups(cfg))
        np.testing.assert_allclose(got["scales"].numpy(), scales.numpy(),
                                   rtol=1e-6)
        for members, sc in zip(_groups(cfg), got["scales"]):
            for i in members:
                assert float((got["gq"][i] - gq[i]).abs().max()) \
                    <= float(sc) * (1 + 1e-6)


# ----------------------------------------------------- elastic restore -----
CKPT_ARCH = "qwen2.5-3b"


def _ckpt_bundle(mesh):
    cfg = get_config(CKPT_ARCH, smoke=True)
    return cfg, make_train_step(cfg, CPU, OptimizerConfig(**OPT), mesh=mesh)


def _dump(state, root, name, rank):
    torch.save([t.detach() for t in ttree.leaves(state)],
               os.path.join(root, f"{name}_r{rank}.pt"))


def _save_at_four(rank, w, root):
    mesh = make_host_mesh(device=CPU)
    cfg, bundle = _ckpt_bundle(mesh)
    state = bundle.init_state_fn(0)
    state, _ = bundle.step_fn(state, _data(cfg).host_batch(0, rank, w))
    ckpt.save(state, os.path.join(root, "w4"), 1, mesh=mesh,
              specs=bundle.layout.specs)
    _dump(state, root, "saved4", rank)


def _restore_at(rank, w, root, sources):
    from repro_torch.launch.train import restore_state

    mesh = make_host_mesh(device=CPU)
    cfg, bundle = _ckpt_bundle(mesh)
    for src in sources:
        state, step = restore_state(cfg, os.path.join(root, src), CPU,
                                    mesh=mesh)
        assert step == 1
        assert all(p.requires_grad for p in ttree.leaves(state.params))
        _dump(state, root, f"{src}_at{w}", rank)
    if w == 1:
        ckpt.save(state, os.path.join(root, "w1"), 1, mesh=mesh,
                  specs=bundle.layout.specs)
        _one_rank_is_one_process(mesh)


def _one_rank_is_one_process(mesh):
    """At one rank every collective is a copy: the step on the rank mesh
    equals the step off a mesh bit for bit, and each kind was issued."""
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        data = _data(cfg)
        ranked = make_train_step(cfg, CPU, OptimizerConfig(**OPT), mesh=mesh)
        plain = make_train_step(cfg, CPU, OptimizerConfig(**OPT))
        s1, s2 = ranked.init_state_fn(0), plain.init_state_fn(0)
        collectives.calls.clear()
        for i in range(STEPS):
            s1, m1 = ranked.step_fn(s1, data.batch(i))
            s2, m2 = plain.step_fn(s2, data.batch(i))
            assert all(torch.equal(m1[k], m2[k]) for k in m2), (m1, m2)
        assert all(collectives.calls[k] > 0 for k in
                   ("all-gather", "reduce-scatter", "all-reduce"))
        for a, b in zip(ttree.leaves(s1), ttree.leaves(s2)):
            assert torch.equal(a, b)


def _whole_of(directory):
    cfg = get_config(CKPT_ARCH, smoke=True)
    shapes = make_train_state_shapes(cfg, False)(0, "meta")
    state, _ = ckpt.restore(shapes, directory)
    return [t.detach() for t in ttree.leaves(state)]


def _assembled(root, name, w):
    cfg = get_config(CKPT_ARCH, smoke=True)
    shapes = make_train_state_shapes(cfg, False)(0, "meta")
    specs = ttree.spec_list(state_specs(shapes, Mesh({"data": max(w, 2),
                                                      "model": 1})), shapes)
    blocks = [torch.load(os.path.join(root, f"{name}_r{r}.pt"))
              for r in range(w)]
    return [assemble([b[i] for b in blocks], spec)
            for i, spec in enumerate(specs)]


def test_elastic_restore_across_rank_counts(tmp_path):
    """Saved at W = 4 (after a step: the moments are live), restored at
    W = 2 and W = 1; saved again at W = 1 and restored at W = 2: every
    leaf bit-exact, as the reference's elastic reshard; the one-rank
    world's step bit-equal to one process's."""
    _spawn(_save_at_four, 4, tmp_path)
    _spawn(_restore_at, 1, tmp_path, ("w4",))
    _spawn(_restore_at, 2, tmp_path, ("w4", "w1"))
    whole = _whole_of(tmp_path / "w4")
    for got in (_assembled(tmp_path, "saved4", 4),
                _assembled(tmp_path, "w4_at1", 1),
                _assembled(tmp_path, "w4_at2", 2),
                _assembled(tmp_path, "w1_at2", 2),
                _whole_of(tmp_path / "w1")):
        assert len(got) == len(whole)
        for a, b in zip(got, whole):
            assert a.shape == b.shape and torch.equal(a, b)
    # a block is the rules' block: rank 1's of the W = 2 restore
    r1 = torch.load(tmp_path / "w4_at2_r1.pt")
    mesh = Mesh({"data": 2, "model": 1}, rank=1)
    cfg = get_config(CKPT_ARCH, smoke=True)
    shapes = make_train_state_shapes(cfg, False)(0, "meta")
    specs = ttree.spec_list(state_specs(shapes, mesh), shapes)
    assert any(b.shape != w.shape for b, w in zip(r1, whole))
    for b, w, spec in zip(r1, whole, specs):
        assert torch.equal(b, local_shard(w, spec, mesh))
