"""The sharded sweep runner (``repro_torch.fleetsim.shard``) and
``validate.shard_equivalence`` on the CPU: the reference's
``tests/test_fleetsim_shard.py`` on the port, with CPU slabs standing in
for the reference's forced XLA host devices, and the sharded rows held to
the reference's (run under ``jax.threefry_partitionable(False)``, the
goldens' stream, ROADMAP C0).

A sharded run must equal the unsharded one exactly: every counter and
histogram, every derived statistic, and the merged ``grid_hist`` equal to
the host-side sum of the per-cell histograms.
"""

import json
import warnings
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import repro.fleetsim as rf
from repro.fleetsim import make_params as ref_make_params
import repro_torch.fleetsim as tf
from repro_torch.fleetsim import EngineOptions, ShardSpec
from repro_torch.fleetsim.shard import as_shard, pad_params, plan_grid
from repro_torch.fleetsim.validate import shard_equivalence
from repro_torch.scenarios import Scenario, SweepSpec, TraceArrival
from test_torch_common import _one_torch_thread  # noqa: F401


SVC = tf.ServiceSpec.exponential(25.0)


def small_cfg(pkg=tf, **kw):
    kw.setdefault("n_servers", 4)
    kw.setdefault("n_workers", 8)
    kw.setdefault("n_ticks", 200)
    kw.setdefault("service", pkg.ServiceSpec.exponential(25.0))
    return pkg.FleetConfig(**kw)


def _grid(g):
    """``g`` netclone rows of the small config, seeds 0 … g-1."""
    base = tf.make_params(small_cfg(), 2, 0.05, 0)
    return tf.RunParams(*(torch.stack([a] * g) for a in base))._replace(
        seed=torch.arange(g, dtype=torch.int32))


# ------------------------------------------------------------- ShardSpec ----
def test_shard_spec_json_roundtrip():
    s = ShardSpec(devices=4, axis="grid")
    assert ShardSpec.from_json(json.loads(json.dumps(s.to_json()))) == s
    assert ShardSpec.from_json({}) == ShardSpec()


def test_shard_spec_rejects_bad_input():
    with pytest.raises(ValueError):
        ShardSpec(devices=-1)
    with pytest.raises(ValueError):
        ShardSpec(axis="")
    with pytest.raises(ValueError):
        ShardSpec.from_json({"device": 2})  # misspelled key
    # more CUDA devices than visible (no card here: CUDA itself is missing)
    with pytest.raises((ValueError, RuntimeError)):
        ShardSpec(devices=4096).resolve_devices()


def test_mesh_is_an_ordered_device_list():
    assert ShardSpec(devices=3).mesh("cpu") == [torch.device("cpu")] * 3
    assert ShardSpec().mesh("cpu") == [torch.device("cpu")]
    if torch.cuda.is_available() and torch.cuda.device_count() == 1:
        assert ShardSpec().mesh() == [torch.device("cuda", 0)]


def test_more_than_one_cuda_device_is_refused(monkeypatch):
    """In one process the sharded runner takes one card: a spec that
    resolves to several CUDA devices (explicitly, or ``devices=0`` on a
    multi-card host) raises, naming the path for several cards, one process
    a card.  Under a process group the mesh is the ranks: ``devices`` must
    be 0 or W (the rank path itself: ``tests/test_torch_ranks.py``)."""
    import repro_torch.fleetsim.shard as shard_mod

    monkeypatch.setattr(shard_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert ShardSpec(devices=1).mesh() == [torch.device("cuda", 0)]
    for spec in (ShardSpec(), ShardSpec(devices=2)):
        with pytest.raises(ValueError, match="one process a card"):
            spec.mesh()
    monkeypatch.undo()
    monkeypatch.setattr(shard_mod, "on_ranks", lambda: True)
    monkeypatch.setattr(shard_mod.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(shard_mod.dist, "get_backend", lambda: "gloo")
    assert ShardSpec().mesh("cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="2 ranks"):
        ShardSpec(devices=3).mesh("cpu")


def test_as_shard_normalization():
    assert as_shard(None) is None
    assert as_shard(2) == ShardSpec(devices=2)
    assert as_shard(True) == ShardSpec()
    assert as_shard(False) is None
    assert as_shard(ShardSpec(devices=3)) == ShardSpec(devices=3)
    with pytest.raises(TypeError):
        as_shard("grid")


# --------------------------------------------------------------- padding ----
@pytest.mark.parametrize("g,n_shards", [(3, 2), (5, 4), (7, 3), (4, 4),
                                        (1, 2), (6, 1)])
def test_pad_params_covers_non_divisible_grids(g, n_shards):
    params = _grid(g)
    padded, mask, n_pad = pad_params(params, n_shards)
    assert n_pad == (-g) % n_shards
    assert padded.policy_id.shape[0] == g + n_pad
    assert (g + n_pad) % n_shards == 0
    assert int(mask.sum()) == g and bool(mask[:g].all())
    if n_pad:
        assert not bool(mask[g:].any())
        # padding repeats the last (valid) row, in every field
        for a, b in zip(padded, params):
            assert torch.equal(a[g:], b[-1:].expand(n_pad, *b.shape[1:]))
    for a, b in zip(padded, params):
        assert torch.equal(a[:g], b)


def test_pad_params_rejects_empty_grid():
    with pytest.raises(ValueError):
        pad_params(tf.RunParams(*(a[:0] for a in _grid(2))), 2)
    with pytest.raises(ValueError):
        pad_params(_grid(2), 0)


def test_plan_splits_into_equal_slabs():
    plan = plan_grid(_grid(5), ShardSpec(devices=3), "cpu")
    assert plan.n_grid == 5 and plan.n_pad == 1 and len(plan.mesh) == 3
    assert plan.params.policy_id.shape[0] == 6


# ------------------------------------------- sharded == unsharded -----------
def test_one_device_shard_matches_plain():
    cfg = small_cfg()
    kw = dict(policies=["baseline", "netclone"], loads=[0.3, 0.7],
              seeds=[0], cfg=cfg, device="cpu")
    plain = tf.sweep_grid(SVC, **kw)
    sharded = tf.sweep_grid(SVC, shard=ShardSpec(devices=1), **kw)
    assert plain.n_devices == 1 and plain.shard is None
    assert sharded.shard == ShardSpec(devices=1) and sharded.n_pad == 0
    assert len(plain.results) == len(sharded.results) == 4
    for a, b in zip(plain.results, sharded.results):
        assert a == b
    np.testing.assert_array_equal(plain.grid_hist, sharded.grid_hist)


@pytest.mark.parametrize("backend", ["staged", "fused"])
def test_two_slabs_of_a_non_divisible_grid_equal_unsharded(backend):
    """3 rows over 2 CPU slabs: pad → split → run → strip → merge, on each
    backend; rows and the merged ``grid_hist`` equal the unsharded run."""
    cfg = small_cfg()
    kw = dict(policies=["netclone"], loads=[0.2, 0.5, 0.8], seeds=[0],
              cfg=cfg, device="cpu", engine=EngineOptions(backend=backend))
    plain = tf.sweep_grid(SVC, **kw)
    sharded = tf.sweep_grid(SVC, shard=2, **kw)
    assert sharded.n_devices == 2 and sharded.n_pad == 1
    assert sharded.backend == plain.backend == backend
    assert sharded.results == plain.results
    np.testing.assert_array_equal(sharded.grid_hist, plain.grid_hist)


def test_simulate_with_shard_options():
    """``simulate(options=EngineOptions(shard=...))`` returns the per-row
    metrics, pad stripped, and the merged histogram."""
    cfg = small_cfg(n_ticks=120)
    params = _grid(3)
    plain = tf.simulate(cfg, params, device="cpu")
    out = tf.simulate(cfg, params, device="cpu",
                      options=EngineOptions(shard=2))
    assert isinstance(out, tf.ShardedMetrics)
    for a, b in zip(out.metrics, plain):
        assert torch.equal(a, b)
    assert torch.equal(out.grid_hist, plain.hist.sum(dim=0,
                                                     dtype=plain.hist.dtype))
    with pytest.raises(ValueError, match="leading sweep axis"):
        tf.simulate(cfg, tf.make_params(cfg, 2, 0.05, 0), device="cpu",
                    options=EngineOptions(shard=1))


def test_simulate_batch_sharded_none_is_plain_batch():
    cfg = small_cfg(n_ticks=120)
    p = tf.make_params(cfg, 2, 0.05, 3)
    batch = tf.RunParams(*(a[None] for a in p))
    with pytest.warns(DeprecationWarning):
        out = tf.simulate_batch_sharded(cfg, batch, shard=None,
                                        device="cpu")
    single = tf.simulate(cfg, p, device="cpu")
    for a, b in zip(out.metrics, single):
        assert torch.equal(a[0], b)
    assert torch.equal(out.grid_hist, single.hist)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        two = tf.simulate_batch_sharded(cfg, batch, shard=2, device="cpu")
    assert torch.equal(two.grid_hist, single.hist)


def test_shard_passed_once():
    with pytest.raises(ValueError, match="once"):
        tf.sweep_grid(SVC, ["baseline"], [0.3], [0], cfg=small_cfg(),
                      shard=1, engine=EngineOptions(shard=ShardSpec()),
                      device="cpu")


# ------------------------------------------------ against the reference -----
def test_sharded_rows_equal_the_references():
    """A two-slab sharded sweep over a 2-rack skewed fabric against the
    reference's unsharded rows, field for field, and its grid_hist."""
    kw = dict(policies=["baseline", "netclone"], loads=[0.3, 0.85],
              seeds=[0, 1])
    tcfg = small_cfg(n_racks=2, queue_cap=64, n_ticks=300)
    rcfg = small_cfg(rf, n_racks=2, queue_cap=64, n_ticks=300)
    weights, slowdown = tf.rack_skew(tcfg, 3.0)
    with jax.threefry_partitionable(False):
        want = rf.sweep_grid(rcfg.service, cfg=rcfg, rack_weights=weights,
                             slowdown=slowdown, **kw)
    got = tf.sweep_grid(tcfg.service, cfg=tcfg, rack_weights=weights,
                        slowdown=slowdown, shard=3, device="cpu", **kw)
    assert got.n_configs == want.n_configs == 8 and got.n_pad == 1
    for a, b in zip(got.results, want.results):
        for field in a.__dataclass_fields__:
            assert getattr(a, field) == pytest.approx(
                getattr(b, field), rel=0, abs=0, nan_ok=True), field
    assert np.array_equal(got.grid_hist, want.grid_hist)


def test_sharded_params_equal_the_references():
    """The padded grid the port splits is the reference's, field for
    field (the reference pads with ``jnp.repeat`` of the last row)."""
    from repro.fleetsim.shard import pad_params as ref_pad

    rcfg = small_cfg(rf)
    base = ref_make_params(rcfg, 2, 0.05, 0)
    ref_grid = jax.tree.map(lambda a: np.broadcast_to(
        np.asarray(a), (3,) + np.shape(a)).copy(), base)
    want, want_mask, want_pad = ref_pad(ref_grid, 2)
    got, mask, n_pad = pad_params(tf.params_from_numpy(ref_grid), 2)
    assert n_pad == want_pad == 1
    assert mask.tolist() == np.asarray(want_mask).tolist()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------ SweepSpec integration -----
@pytest.mark.parametrize("shard", [1, 2])
def test_sweepspec_shard_equivalence_with_hedge_delays(shard):
    """``shard_equivalence`` through the declarative SweepSpec path,
    including the hedge-delay axis: every cell exact, the merge equal."""
    spec = SweepSpec(
        base=Scenario(name="se", servers=4, workers=8, n_ticks=200),
        policies=("baseline", "hedge"), loads=(0.4,), seeds=(0,),
        hedge_delays=(60.0,))
    checks, hist_ok = shard_equivalence(spec, shard=shard, device="cpu")
    assert hist_ok and len(checks) == 2
    assert all(c.ok and c.counters_ok and c.stat_rel == 0.0
               for c in checks), [c.describe() for c in checks]


def test_spec_shard_round_trips_and_runs(tmp_path):
    spec = SweepSpec(base=Scenario(servers=4, workers=8, n_ticks=200),
                     policies=("netclone",), loads=(0.3, 0.6),
                     shard=ShardSpec(devices=2))
    back = SweepSpec.from_file(spec.to_file(tmp_path / "s.json"))
    assert back == spec
    res = back.run_fleetsim(device="cpu")
    assert res.n_devices == 2 and res.shard == ShardSpec(devices=2)
    assert res.results == replace(back, shard=None).run_fleetsim(
        device="cpu").results


# -------------------------------------------------------------- telemetry ---
def test_trace_sweep_rejects_shard():
    spec = SweepSpec(
        base=Scenario(name="t", servers=4, workers=8, n_ticks=8,
                      arrival=TraceArrival(counts=(1, 0, 2, 1))),
        policies=("netclone",), shard=ShardSpec(devices=1))
    with pytest.raises(ValueError, match="Poisson"):
        spec.run_fleetsim(device="cpu")


def test_telemetry_is_refused_sharded():
    cfg = replace(small_cfg(n_ticks=100), telemetry=True, window_ticks=50)
    with pytest.raises(ValueError, match="telemetry sweeps cannot shard"):
        tf.sweep_grid(SVC, ["netclone"], [0.3], [0], cfg=cfg, shard=1,
                      device="cpu")
    with pytest.raises(ValueError, match="telemetry"):
        EngineOptions(shard=1, telemetry=True)
    with pytest.raises(ValueError, match="telemetry"):
        tf.simulate(cfg, _grid(2), device="cpu",
                    options=EngineOptions(shard=1))
