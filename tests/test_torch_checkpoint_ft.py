"""Checkpointing (``repro_torch.checkpoint``), fault tolerance
(``repro_torch.ft``) and the training launcher's resume, on the CPU: the
reference's ``tests/test_checkpoint_ft.py`` on the port (its elastic
reshard across meshes needs real device placements, ROADMAP
A9-shard-multi), a
reference-written params checkpoint restored by the port, and a train
state restored bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.ft import FailureDetector, FleetSupervisor, \
    StragglerPolicy, SupervisorHooks, plan_remesh
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.train import tree as ttree
from repro_torch.train.step import make_train_state_shapes
from test_torch_common import _one_torch_thread  # noqa: F401


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn((16, 8), generator=g),
                      "b": torch.zeros((8,)),
                      "h": torch.randn((4,), generator=g).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _like(t):
    return ttree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                device="meta"), t)


def _equal(a, b):
    for x, y in zip(ttree.leaves(a), ttree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(t, tmp_path, step=3, metadata={"note": "x"})
    restored, manifest = ckpt.restore(_like(t), tmp_path, step=3)
    assert manifest["step"] == 3 and manifest["metadata"]["note"] == "x"
    assert {m["id"]: m["dtype"] for m in manifest["leaves"]} == {
        "layer__w": "float32", "layer__b": "float32",
        "layer__h": "bfloat16", "step": "int32"}
    _equal(t, restored)


def test_latest_step_and_gc(tmp_path):
    t = _tree()
    for s in (1, 5, 9):
        ckpt.save(t, tmp_path, step=s)
    assert ckpt.latest_step(tmp_path) == 9
    assert ckpt.latest_step(tmp_path / "nothing") is None


def test_restore_shape_mismatch_raises(tmp_path):
    t = _tree()
    ckpt.save(t, tmp_path, step=0)
    bad = _like(t)
    bad["layer"]["w"] = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError):
        ckpt.restore(bad, tmp_path, step=0)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(_like(t), tmp_path / "empty")


def test_async_checkpointer(tmp_path):
    """Three saves keep two; the snapshot is taken when ``save`` returns,
    so updating the tree in place right after changes nothing saved."""
    t = _tree()
    ac = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    want = ttree.tree_map(torch.clone, t)
    for s in (1, 2, 3):
        ac.save(t, step=s)
        t["layer"]["w"].add_(1.0)
    ac.wait()
    assert ckpt.latest_step(tmp_path) == 3
    assert len(sorted(p.name for p in tmp_path.iterdir())) == 2
    restored, _ = ckpt.restore(_like(t), tmp_path, step=3)
    want["layer"]["w"].add_(1.0).add_(1.0)
    _equal(want, restored)


def test_atomic_save_no_partial_dirs(tmp_path):
    ckpt.save(_tree(), tmp_path, step=1)
    assert not list(tmp_path.glob(".tmp_*"))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A params checkpoint the reference wrote (its stacked tree, its leaf
    ids) read back by the port and carried across by
    ``convert.params_from_numpy``: every leaf equal to the reference's."""
    arch = "recurrentgemma-9b"
    cfg_r = ref_get_config(arch, smoke=True)
    with jax.threefry_partitionable(False):
        params_r = jax.jit(lambda k: ref_lm.init_params(cfg_r, k))(
            jax.random.PRNGKey(2))
    ref_ckpt.save(params_r, tmp_path, step=4)
    tree, manifest = ckpt.load_tree(tmp_path)
    assert manifest["step"] == 4
    cfg = get_config(arch, smoke=True)
    params = convert.params_from_numpy(cfg, tree)
    want = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, params_r))
    assert [p for p, _ in ttree.flatten(params)] == \
        [p for p, _ in ttree.flatten(want)]
    _equal(params, want)


def test_train_state_restores_bit_for_bit(tmp_path):
    """The launcher's restore path: a train state saved by the async
    writer comes back equal leaf for leaf, in the fresh state's dtypes,
    its parameters requiring grad."""
    cfg = get_config("qwen2.5-3b", smoke=True)
    state = make_train_state_shapes(cfg, True)(3, "cpu")
    for x in ttree.leaves(state.opt.mu):
        x.normal_()
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(20, dtype=torch.int32)))
    ac = ckpt.AsyncCheckpointer(tmp_path)
    ac.save(state, 20)
    ac.wait()
    back, step = launch_train.restore_state(cfg, tmp_path, "cpu", True)
    assert step == 20 and int(back.opt.step) == 20
    _equal(state, back)
    assert all(p.requires_grad for p in ttree.leaves(back.params))


def test_launcher_resumes_where_it_stopped(tmp_path, capsys):
    """``launch/train.py --resume``: a run of 6 steps checkpointed at 3,
    then a resumed run that starts at step 6 and ends at 8."""
    args = ["--device", "cpu", "--global-batch", "2", "--seq-len", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--log-every", "100"]
    first = launch_train.main(args + ["--steps", "6"])
    assert len(first["losses"]) == 6 and ckpt.latest_step(tmp_path) == 6
    again = launch_train.main(args + ["--steps", "8", "--resume"])
    assert again["start_step"] == 6 and len(again["losses"]) == 2
    assert "resumed from step 6" in capsys.readouterr().out
    assert all(np.isfinite(again["losses"]))


# ---------------------------------------------------------------- ft --------
def test_failure_detector_timeout():
    fd = FailureDetector(4, timeout_s=1.0)
    fd.heartbeat(0, t=100.0)
    fd.heartbeat(1, t=100.0)
    fd.heartbeat(2, t=99.8)
    fd.heartbeat(3, t=98.0)
    assert fd.sweep(now=100.5) == {3}
    fd.heartbeat(3, t=100.6)
    assert fd.sweep(now=100.7) == set()


def test_plan_remesh_shrinks_data_axis():
    plan = plan_remesh(healthy_hosts=list(range(12)), devices_per_host=8,
                       model_parallel=16, prev_hosts=list(range(16)))
    assert plan.data_parallel == 4 and plan.model_parallel == 16
    assert len(plan.hosts) == 8
    assert set(plan.dropped_hosts) == set(range(8, 16))


def test_plan_remesh_insufficient_devices():
    with pytest.raises(RuntimeError):
        plan_remesh(healthy_hosts=[0], devices_per_host=8,
                    model_parallel=16, prev_hosts=[0, 1])


def test_straggler_policy_escalation():
    sp = StragglerPolicy(n_hosts=4, evict_after=3)
    assert sp.observe(np.asarray([1.0, 1.0, 1.0, 1.0])) == {}
    slow = np.asarray([1.0, 1.0, 1.0, 10.0])
    acts = [sp.observe(slow) for _ in range(8)]
    clone_at = next(i for i, a in enumerate(acts) if a.get(3) == "clone")
    evict_at = next(i for i, a in enumerate(acts) if a.get(3) == "evict")
    assert clone_at < evict_at


def test_straggler_policy_recovers():
    sp = StragglerPolicy(n_hosts=3, evict_after=2)
    sp.observe(np.asarray([1.0, 1.0, 8.0]))
    for _ in range(20):
        acts = sp.observe(np.asarray([1.0, 1.0, 1.0]))
    assert acts == {} and sp.strikes[2] == 0


def _mk_supervisor(n_hosts=8, save_every=10):
    saved = {"step": 0}
    meshes = []

    def build_mesh(plan):
        meshes.append(plan)
        return ("mesh", plan.data_parallel, plan.model_parallel)

    def save(step):
        saved["step"] = step

    hooks = SupervisorHooks(build_mesh=build_mesh,
                            train_step=lambda mesh, step: np.ones(n_hosts),
                            save=save, restore=lambda: saved["step"])
    sup = FleetSupervisor(n_hosts=n_hosts, devices_per_host=8,
                          model_parallel=16, hooks=hooks,
                          save_every=save_every)
    return sup, saved, meshes


def test_supervisor_steady_state():
    sup, saved, meshes = _mk_supervisor()
    log = sup.run(n_steps=30)
    assert log.steps_run == 30
    assert not log.remeshes and not log.evictions
    assert saved["step"] == 30 and len(meshes) == 1


def test_supervisor_failure_restores_and_resumes():
    sup, saved, _ = _mk_supervisor()
    log = sup.run(n_steps=40, events={25: [("fail", 3)]})
    assert len(log.remeshes) == 1
    step_at_failure, plan = log.remeshes[0]
    assert 3 not in plan.hosts and plan.model_parallel == 16
    assert log.restores == [20]
    assert log.wasted_steps == step_at_failure - 20
    assert saved["step"] == 40


def test_supervisor_straggler_escalates_to_eviction():
    sup, _, _ = _mk_supervisor()
    log = sup.run(n_steps=60, events={5: [("slow", 2, 10.0)]})
    assert any(h == 2 for _, h in log.clone_masks)
    assert any(h == 2 for _, h in log.evictions)
    assert len(log.remeshes) >= 1
    assert all(2 not in p.hosts for _, p in log.remeshes)


def test_ft_decisions_equal_the_reference():
    """The copied decision code against the reference's on one drill:
    the same remesh plans, clone masks, evictions and restores."""
    from repro.ft import FleetSupervisor as RefSupervisor
    from repro.ft import SupervisorHooks as RefHooks

    def drill(sup_cls, hooks_cls):
        saved = {"step": 0}
        rng = np.random.default_rng(3)
        hooks = hooks_cls(
            build_mesh=lambda plan: plan.data_parallel,
            train_step=lambda mesh, step: 1.0 + rng.random(8) * 0.1,
            save=lambda step: saved.__setitem__("step", step),
            restore=lambda: saved["step"])
        sup = sup_cls(n_hosts=8, devices_per_host=8, model_parallel=16,
                      hooks=hooks, save_every=10)
        log = sup.run(n_steps=60, events={12: [("fail", 5)],
                                          30: [("slow", 1, 6.0)]})
        return (log.steps_run, log.restores, log.wasted_steps,
                [(s, tuple(p.hosts)) for s, p in log.remeshes],
                log.clone_masks, log.evictions)

    assert drill(FleetSupervisor, SupervisorHooks) == \
        drill(RefSupervisor, RefHooks)
