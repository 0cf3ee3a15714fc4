"""The port's ServeSim (the continuous-batching server stage, the
roofline-derived LLM services, ``serve_equivalence``) ≡ the reference's, on
the CPU (mirroring ``tests/test_llmserve.py``).

* one tick of ``stage_server_batch`` from a mid-run reference state (two
  racks, ``batch_coupling`` 0.5): the state and the response lanes;
* ``Metrics`` of the five always-on policies as one batch, at 1 and 2
  racks, ``batch_coupling`` 0 and 0.5, under each filter backend: every
  field bit-identical to the reference (its ``vectorized`` run; the
  reference's filter backends agree bit for bit);
* the batch server equals the FCFS ring at zero coupling and one slot per
  worker; the fused backend equals the staged loop for batch configs;
* ``n_params_active``, ``llm_service`` and ``n_params()`` for all ten
  archs, full width, counted on the ``meta`` device; ``cell_roofline``
  and the table helpers on synthetic dry-run records;
* the library's two llm files give the reference's 300-tick rows;
  ``serve_equivalence`` gives the reference's rows field for field, and
  ``validate.main --serve-ticks`` prints the reference's lines.

Bit-identity is the tolerance throughout.  The reference runs under
``jax.threefry_partitionable(False)`` (ROADMAP C0), set per test.
"""

import functools
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro_torch.fleetsim as tf
from repro_torch.core.switch import group_pairs_array
from repro_torch.fleetsim import chaos as tchaos
from repro_torch.fleetsim import engine
from repro_torch.fleetsim import stages as tst
from repro_torch.fleetsim.engine import batched_params
from repro_torch.fleetsim.options import EngineOptions
from repro_torch.fleetsim.state import to_numpy
from repro_torch.scenarios.service import load_to_rate
from test_torch_common import _one_torch_thread  # noqa: F401


CPU = torch.device("cpu")
POLICIES = ("baseline", "c-clone", "netclone", "racksched",
            "netclone+racksched")
# prefill 30 µs + 4 or 20 tokens at 4 µs: demands of 46 and 110 ticks
SERVICE = dict(prefill=30.0, decode=4.0, gen_short=4.0, gen_long=20.0,
               p_long=0.2)


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's modules, imported on first use."""
    import jax
    import jax.numpy as jnp

    import repro.fleetsim as rf
    from repro.core.switch_jax import group_pairs_array
    from repro.fleetsim import chaos, stages
    from repro.fleetsim.state import init_fleet_state

    return jax, jnp, rf, stages, chaos, init_fleet_state, group_pairs_array


def _cfg(pkg, **kw):
    """The test fabric in ``pkg``: 4 servers of 3 decode slots each (4
    workers, so the slots are not the worker count), the llm service."""
    base = dict(n_servers=4, n_workers=4, batch_slots=3, queue_cap=32,
                max_arrivals=8, n_ticks=300, server_model="batch")
    base.update(kw)
    return pkg.FleetConfig(service=pkg.ServiceSpec.llm(**SERVICE), **base)


def _params(pkg, cfg, policies=POLICIES, load=0.7):
    rate = load_to_rate(load, tf.ServiceSpec.llm(**SERVICE),
                        cfg.n_servers_total, cfg.n_slots)
    runs = [pkg.make_params(cfg, pkg.POLICY_IDS[p], rate, i + 1)
            for i, p in enumerate(policies)]
    if pkg is tf:
        return tf.stack_params(runs)
    jax, jnp = _ref()[:2]
    return jax.tree.map(lambda *a: jnp.stack(a), *runs)


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_metrics_equal(got, want, what=""):
    for name in want._fields:
        a, b = _host(getattr(got, name)), _host(getattr(want, name))
        assert a.shape == b.shape and np.array_equal(a, b), \
            f"{what}: {name} differs"


def _leaves(got, want, path=""):
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, f"{path}{name}"
        elif hasattr(b, "_fields"):
            yield from _leaves(a, b, f"{path}{name}.")
        else:
            yield f"{path}{name}", np.asarray(a), np.asarray(b)


# ------------------------------------------------------------ one tick -----
def test_one_tick_of_the_batch_stage_matches_reference():
    """Both engines start tick 200 from the same mid-run state (busy
    slots, waiting requests) of the five policies on 2 racks at coupling
    0.5 and agree after the arrival, route and server stages: every state
    tensor and every response lane."""
    jax, jnp, rf, rst, rchaos, ref_init_state, ref_gp = _ref()
    kw = dict(n_racks=2, batch_coupling=0.5, n_ticks=400)
    rcfg, tcfg = _cfg(rf, **kw), _cfg(tf, **kw)
    t0, n_raw = 200, 6
    with jax.threefry_partitionable(False):
        rp = _params(rf, rcfg)
        gp = ref_gp(rcfg.n_servers)

        def run_to(p):
            k_pois, k0 = jax.random.split(jax.random.PRNGKey(p.seed))
            counts = jax.random.poisson(k_pois, p.rate_per_us * rcfg.dt_us,
                                        (t0,)).astype(jnp.int32)
            step = rst.build_step(rcfg, p, gp)
            st, _ = jax.lax.scan(step, ref_init_state(rcfg, k0),
                                 (jnp.arange(t0, dtype=jnp.int32), counts))
            return st

        rstate = jax.jit(jax.vmap(run_to))(rp)

        def ref_tick(s, p, xs):
            s, arr = rst.stage_arrival(rcfg, p, s, xs)
            s, arr, _, lanes = rst.stage_route(
                rcfg, p, s, arr, gp, jnp.float32(rcfg.interrack_extra_us))
            s, lanes = rchaos.stage_link_failure(rcfg, p, s, arr, lanes)
            return rst.stage_server(rcfg, p, s, arr, lanes)

        ref = jax.device_get(jax.jit(jax.vmap(ref_tick, (0, 0, None)))(
            rstate, rp, (jnp.int32(t0), jnp.int32(n_raw))))

    tstate = tf.state_from_numpy(tcfg, jax.device_get(rstate))
    tparams, _ = batched_params(tf.params_from_numpy(jax.device_get(rp)),
                                CPU)
    assert tstate.workers.meta.shape[3] == 3          # the decode slots
    assert int((tstate.queues.count > 0).sum()) > 0   # requests waiting
    xs = (t0, torch.full((5,), n_raw, dtype=torch.int32),
          tst.draw_ticks(tcfg, tstate.key, 1)[0])
    ts, tarr = tst.stage_arrival(tcfg, tparams, tstate, xs)
    ts, tarr, _, tl = tst.stage_route(
        tcfg, tparams, ts, tarr, group_pairs_array(tcfg.n_servers).long(),
        tst._f32(tcfg.interrack_extra_us), tst._present(tparams))
    ts, tl = tchaos.stage_link_failure(tcfg, tparams, ts, tarr, tl)
    ts, tresp = tst.stage_server(tcfg, tparams, ts, tarr, tl,
                                 tst.divisors(tcfg, CPU))
    rs, rresp = ref
    for name, a, b in _leaves(to_numpy(ts), rs):
        assert a.shape == b.shape and np.array_equal(a, b), name
    for n in tresp._fields:
        a, b = getattr(tresp, n).numpy(), np.asarray(getattr(rresp, n))
        assert np.array_equal(a, b.astype(a.dtype)), n
    assert bool(tresp.active.any())                  # completions this tick


# ------------------------------------------------- whole runs, the grid ----
@functools.lru_cache(maxsize=None)
def _reference_run(n_racks: int, coupling: float):
    jax, _, rf = _ref()[:3]
    rcfg = _cfg(rf, n_racks=n_racks, batch_coupling=coupling)
    with jax.threefry_partitionable(False):
        return jax.device_get(rf.simulate(rcfg, _params(rf, rcfg)))


@pytest.mark.parametrize("backend",
                         ["vectorized", "scan", "pallas", "tickfuse"])
@pytest.mark.parametrize("coupling", [0.0, 0.5])
@pytest.mark.parametrize("n_racks", [1, 2])
def test_batch_server_metrics_bit_identical(n_racks, coupling, backend):
    """The five policies as one batch on the batch server, 300 ticks:
    every ``Metrics`` field (``n_slot_busy`` included) equals the
    reference's.  At coupling 0.5 the slots' float32 progress is the
    reference's op for op."""
    tcfg = _cfg(tf, n_racks=n_racks, batch_coupling=coupling,
                filter_backend=backend)
    got = tf.simulate(tcfg, _params(tf, tcfg), device="cpu")
    _assert_metrics_equal(got, _reference_run(n_racks, coupling),
                          f"{n_racks} racks, coupling {coupling}, {backend}")
    assert int(got.n_slot_busy.min()) > 0 and int(got.n_completed.min()) > 0
    assert int(got.n_cloned[POLICIES.index("netclone")]) > 0


def test_batch_equals_fcfs_at_zero_coupling():
    """With independent slots (coupling 0) and one slot per worker the
    batch stage's arithmetic is the FCFS ring's: every ``Metrics`` field
    but ``n_slot_busy`` is equal, on 2 racks."""
    fcfs = _cfg(tf, n_racks=2, server_model="fcfs", batch_slots=0)
    batch = replace(fcfs, server_model="batch")
    params = _params(tf, fcfs)
    a = tf.simulate(fcfs, params, device="cpu")
    b = tf.simulate(batch, params, device="cpu")
    for name in a._fields:
        if name != "n_slot_busy":
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(a.n_slot_busy.max()) == 0 and int(b.n_slot_busy.min()) > 0


@pytest.mark.parametrize("k", [1, 7, 256])
def test_fused_equals_staged_for_batch_configs(k):
    """The fused backend (its blocks run eagerly on the CPU) equals the
    staged loop for the batch server on 2 racks at coupling 0.5 under
    B2's plain version, for every chunk length."""
    tcfg = _cfg(tf, n_racks=2, batch_coupling=0.5, filter_backend="tickfuse")
    params = _params(tf, tcfg)
    staged = tf.simulate(tcfg, params, device="cpu",
                         options=EngineOptions(backend="staged"))
    fused, ran = engine.run(tcfg, params, "cpu",
                            EngineOptions(backend="fused",
                                          ticks_per_chunk=k))
    assert ran == "fused"
    _assert_metrics_equal(fused, staged, f"K={k}")


# ------------------------------------------------ roofline and services ----
#: every arch of the registry: the port builds all ten (MoE, MLA and
#: whisper's encoder-decoder since ROADMAP A11)
BUILT = ("gemma-7b", "qwen2.5-3b", "codeqwen1.5-7b", "phi3-mini-3.8b",
         "chameleon-34b", "mamba2-370m", "recurrentgemma-9b",
         "deepseek-moe-16b", "deepseek-v2-lite-16b", "whisper-tiny")


@pytest.mark.parametrize("arch", BUILT)
def test_params_and_service_match_reference(arch, monkeypatch):
    """Full-width parameter counts (total and active; MoE experts at
    ``top_k / n_experts``, whisper's family tree) and the derived ``llm``
    service equal the reference's (its ``jax.eval_shape`` count); the port
    counts shapes built on the ``meta`` device."""
    from repro.analysis import roofline as rroof
    from repro.configs import get_config as rget
    from repro.fleetsim.llmserve import service as rsvc
    from repro_torch.analysis import roofline as troof
    from repro_torch.configs import get_config as tget
    from repro_torch.fleetsim.llmserve import service as tsvc
    from repro_torch.models import registry

    devices = []
    name = "_ENCDEC" if tget(arch).arch_type == "encdec" else "_LM"
    fam = getattr(registry, name)

    def spy(cfg, seed=0, device=None):
        devices.append(str(device))
        return fam.init_params(cfg, seed, device)

    monkeypatch.setattr(registry, name, fam._replace(init_params=spy))
    got = troof.n_params_active(tget(arch))
    assert got == rroof.n_params_active(rget(arch))
    assert devices == ["meta"]
    got, want = tsvc.llm_service(arch), rsvc.llm_service(arch)
    assert got.to_json() == want.to_json() and got.mean == want.mean
    assert tsvc.prefill_us(arch, 4096, smoke=True) \
        == rsvc.prefill_us(arch, 4096, smoke=True)
    assert troof.model_flops(tget(arch), "prefill_32k") \
        == rroof.model_flops(rget(arch), "prefill_32k")


@pytest.mark.parametrize("arch", BUILT)
def test_n_params_matches_reference(arch):
    """``ModelConfig.n_params()`` equals the reference's for every arch;
    for whisper both count ``lm.init_params``' tree (27,005,568), not the
    whisper family's."""
    from repro.configs import get_config as rget
    from repro_torch.configs import get_config as tget

    assert tget(arch).n_params() == rget(arch).n_params()
    if arch == "whisper-tiny":
        assert tget(arch).n_params() == 27_005_568


def test_gemma_service_is_the_library_files_and_moe_raises():
    """``llm_service("gemma-7b")`` is exactly the ``params`` both llm
    library files pin; the MoE, MLA and encoder-decoder archs, which raised
    naming A11 before the port had them, now give the reference's decode
    step; ``prefill_us`` refuses an empty prompt."""
    from repro.fleetsim.llmserve import service as rsvc
    from repro_torch.fleetsim.llmserve import (
        decode_step_us,
        llm_service,
        prefill_us,
    )
    from repro_torch.scenarios import load_any

    spec = llm_service("gemma-7b")
    for name in ("llm_gemma7b", "llm_moe_hetero"):
        sc = load_any(name)
        assert sc.service.params == spec.params
        assert sc.service == replace(spec, jitter_p=sc.service.jitter_p,
                                     jitter_mult=sc.service.jitter_mult)
    for arch in ("deepseek-moe-16b", "deepseek-v2-lite-16b", "whisper-tiny"):
        assert decode_step_us(arch) == rsvc.decode_step_us(arch) > 0
    with pytest.raises(ValueError, match="prompt_len"):
        prefill_us("gemma-7b", 0)


def _dryrun_record(arch, shape, probes=True):
    """A synthetic dry-run record in the reference's layout."""
    def cost(f, b):
        return {"cost": {"flops": f, "bytes": b},
                "collectives": {"all-gather": b / 10, "all-reduce": b / 20}}

    rec = {"arch": arch, "shape": shape, "ok": True, "n_periods": 28,
           "full": {"memory": {"argument_bytes": 6e9, "temp_bytes": 4.5e9},
                    **cost(3.1e15, 2.2e12)}}
    rec["full"]["collectives"] = {"all-gather": 1e9, "reduce-scatter": 2e9}
    if probes:
        rec["probe1"] = cost(2.0e14, 1.0e11)
        rec["probe2"] = cost(3.1e14, 1.6e11)
    return rec


def test_cell_roofline_and_tables_match_reference(tmp_path):
    """``cell_roofline`` on synthetic records (train with the CE
    correction, prefill, decode, no probes, skipped, failed) gives the
    reference's rows, and ``table`` / ``format_table`` /
    ``skipped_cells`` read a directory of them as the reference does."""
    from repro.analysis import roofline as rroof
    from repro_torch.analysis import roofline as troof

    recs = [_dryrun_record("qwen2.5-3b", "train_4k"),
            _dryrun_record("gemma-7b", "prefill_32k"),
            _dryrun_record("mamba2-370m", "decode_32k"),
            _dryrun_record("recurrentgemma-9b", "train_4k", probes=False),
            {"arch": "phi3-mini-3.8b", "shape": "long_500k", "ok": True,
             "skipped": True, "reason": "full attention at 500k"},
            {"arch": "qwen2.5-3b", "shape": "long_500k", "ok": False}]
    for rec in recs:
        got, want = troof.cell_roofline(rec), rroof.cell_roofline(rec)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.__dict__ == want.__dict__
    for i, rec in enumerate(recs):
        (tmp_path / f"{i}__sp.json").write_text(json.dumps(rec))
    got, want = troof.table(tmp_path), rroof.table(tmp_path)
    assert [r.__dict__ for r in got] == [r.__dict__ for r in want]
    assert len(got) == 4
    assert troof.format_table(got) == rroof.format_table(want)
    assert troof.skipped_cells(tmp_path) == rroof.skipped_cells(tmp_path)


# ------------------------------------------------ library files, oracle ----
@pytest.mark.parametrize("name", ["llm_gemma7b", "llm_moe_hetero"])
def test_library_llm_rows_match_reference(name):
    """The two bundled llm scenarios (gemma-7b's derived service, a tick
    per decode step; the second on 2 racks with a slow rack under
    netclone+racksched) give the reference's 300-tick row, every field."""
    jax = _ref()[0]
    from repro.scenarios import load_any as rload
    from repro_torch.scenarios import load_any as tload

    with jax.threefry_partitionable(False):
        want = rload(name).run_fleetsim(n_ticks=300)
    got = tload(name).run_fleetsim(device="cpu", n_ticks=300)
    assert json.dumps(got.__dict__) == json.dumps(want.__dict__)
    assert got.n_completed > 0 and got.mean_slot_occupancy > 0


def test_serve_equivalence_rows_match_reference():
    """``serve_equivalence(loads=(0.4,), horizon=400)``: the port's rows
    (its FleetSim batch sweep beside its DecodeReplica oracle) equal the
    reference's field for field, and every check is ``ok``."""
    jax = _ref()[0]
    from repro.fleetsim.llmserve import serve_equivalence as rserve
    from repro_torch.fleetsim.llmserve import serve_equivalence as tserve

    with jax.threefry_partitionable(False):
        want = rserve(loads=(0.4,), horizon=400)
    stats = {}
    got = tserve(loads=(0.4,), horizon=400, device="cpu", stats=stats)
    assert [c.__dict__ for c in got] == [c.__dict__ for c in want]
    assert all(c.ok for c in got) and len(got) == 2
    assert stats["decode_steps"] > 0


def test_validate_cli_serve_ticks_prints_the_references_lines(capsys):
    """``python -m repro_torch.fleetsim.validate --serve-ticks 200`` (no
    grid, no trace) prints the reference's lines and exit code."""
    jax = _ref()[0]
    from repro.fleetsim import validate as rval
    from repro_torch.fleetsim import validate as tval

    argv = ["--grid", "none", "--trace", "none", "--serve-ticks", "200"]
    with jax.threefry_partitionable(False):
        rc_want = rval.main(argv)
    want = capsys.readouterr().out
    rc_got = tval.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert rc_got == rc_want
    assert got == want and "serve points within tolerance" in got
