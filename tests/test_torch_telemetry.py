"""The port's FleetScope telemetry (the trace ring, the windowed series,
their decode and export) ≡ the reference's, on the CPU (mirroring
``tests/test_telemetry.py``).

* ``emit`` on random masks equals the reference's ring, config by config;
* a pure observer: ``Metrics`` with telemetry on equal those with it off,
  for the seven registered policies (both optional stages on) and for the
  batch server;
* the trace ring and the series equal the reference's, tensor for tensor,
  with both optional stages on at 1 and 2 racks and on the batch server;
  a ring that wraps keeps the reference's latest records;
* event counts reconcile with the run counters, and the series' rates
  decompose the counters exactly;
* the Chrome-trace JSON and ``write_run``'s bundle equal the reference's
  byte for byte, from the CLI's ``--trace-out`` too;
* ``sweep_grid`` decodes each row's telemetry as the reference does, and
  refuses a sharded telemetry sweep.

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
from repro_torch.fleetsim.options import EngineOptions
from repro_torch.fleetsim.telemetry import (
    SERIES_COUNTERS,
    TraceBuffer,
    chrome_trace,
    decode_run,
    emit,
    write_run,
)
from repro_torch.fleetsim.telemetry.events import (
    EV_ARRIVAL,
    EV_CLIENT_COMPLETE,
    EV_CLONE,
    EV_COORD_ENQ,
    EV_FILTER_DROP,
    EV_HEDGE_ARMED,
    EV_SERVER_FINISH,
    EV_SERVER_START,
    REC,
)
from repro_torch.scenarios.service import load_to_rate
from test_torch_common import _one_torch_thread  # noqa: F401


POLICIES = ("baseline", "c-clone", "netclone", "racksched",
            "netclone+racksched", "laedge", "hedge")
LOADS = {"laedge": 0.1}
CAP = 1 << 14          # a ring that does not wrap at this scale
TEL = EngineOptions(telemetry=True)


@functools.lru_cache(maxsize=None)
def _ref():
    import jax
    import jax.numpy as jnp

    import repro.fleetsim as rf
    from repro.fleetsim.options import EngineOptions as ROptions

    return jax, jnp, rf, ROptions


def _cfg(pkg, batch=False, **kw):
    """Both optional stages on (the seven policies), or the batch server
    with the llm service (the five always-on ones); telemetry on."""
    base = dict(n_servers=4, n_workers=8, queue_cap=64, max_arrivals=8,
                n_ticks=600, telemetry=True, trace_cap=CAP,
                window_ticks=200)
    if batch:
        base.update(server_model="batch", batch_slots=3,
                    batch_coupling=0.5)
        svc = pkg.ServiceSpec.llm(prefill=30.0, decode=4.0, gen_short=4.0,
                                  gen_long=20.0, p_long=0.2)
    else:
        base.update(coordinator=True, hedge_timer=True)
        svc = pkg.ServiceSpec.exponential(25.0)
    base.update(kw)
    return pkg.FleetConfig(service=svc, **base)


def _params(pkg, cfg):
    pols = POLICIES[:5] if cfg.server_model == "batch" else POLICIES
    runs = []
    for i, p in enumerate(pols):
        rate = load_to_rate(LOADS.get(p, 0.5), cfg.service,
                            cfg.n_servers_total, cfg.n_slots)
        runs.append(pkg.make_params(cfg, pkg.POLICY_IDS[p], rate, i + 3))
    if pkg is tf:
        return tf.stack_params(runs)
    jax, jnp = _ref()[:2]
    return jax.tree.map(lambda *a: jnp.stack(a), *runs)


@functools.lru_cache(maxsize=None)
def _reference_run(batch: bool, **kw):
    jax, _, rf, ROptions = _ref()
    rcfg = _cfg(rf, batch, **kw)
    with jax.threefry_partitionable(False):
        return jax.device_get(rf.simulate(rcfg, _params(rf, rcfg),
                                          options=ROptions(telemetry=True)))


def _run(batch: bool, **kw):
    tcfg = _cfg(tf, batch, **kw)
    return tcfg, tf.simulate(tcfg, _params(tf, tcfg), device="cpu",
                             options=TEL)


def _equal_tree(got, want, what):
    for name in want._fields:
        a = getattr(got, name)
        a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        b = np.asarray(getattr(want, name))
        assert a.shape == b.shape and np.array_equal(a, b), \
            f"{what}: {name} differs"


def _row(tree, i):
    return type(tree)(*(np.asarray(x)[i] for x in tree))


# ------------------------------------------------------------------ emit ---
def test_emit_matches_reference_ring_per_config():
    """Random masks and fields over 30 emits into a 40-record ring (so it
    wraps), three configs: each config's ring and count equal the
    reference's ``emit`` run on that config alone."""
    jax, jnp = _ref()[:2]
    from repro.fleetsim.telemetry.device import TraceBuffer as RBuf
    from repro.fleetsim.telemetry.device import emit as remit

    rng = np.random.default_rng(5)
    g, cap, n = 3, 40, 6
    tr = TraceBuffer(count=torch.zeros(g, dtype=torch.int32),
                     data=torch.zeros((g, cap, REC), dtype=torch.int32))
    ref = [RBuf(count=jnp.zeros((), jnp.int32),
                data=jnp.zeros((cap, REC), jnp.int32)) for _ in range(g)]
    for tick in range(30):
        mask = rng.random((g, n)) < 0.5
        rid = rng.integers(0, 1000, (g, n)).astype(np.int32)
        arg = rng.integers(0, 9, (g, 1)).astype(np.int32)
        tr = emit(tr, torch.from_numpy(mask), tick=tick, kind=tick % 12 + 1,
                  rid=torch.from_numpy(rid), server=tick % 4,
                  arg=torch.from_numpy(arg))
        for i in range(g):
            ref[i] = remit(ref[i], jnp.asarray(mask[i]), tick=tick,
                           kind=tick % 12 + 1, rid=jnp.asarray(rid[i]),
                           server=tick % 4, arg=jnp.asarray(arg[i, 0]))
    for i in range(g):
        assert int(tr.count[i]) == int(ref[i].count) > cap
        assert np.array_equal(tr.data[i].numpy(), np.asarray(ref[i].data))


# -------------------------------------------------------- pure observer ----
@pytest.mark.parametrize("batch", [False, True])
def test_telemetry_is_a_pure_observer(batch):
    """Turning the trace and series on leaves every ``Metrics`` field of
    every policy bit-identical: telemetry draws no random numbers and
    feeds nothing back."""
    tcfg, (m_on, _, _) = _run(batch, n_racks=2)
    off = replace(tcfg, telemetry=False)
    m_off = tf.simulate(off, _params(tf, off), device="cpu")
    for field, a, b in zip(m_off._fields, m_off, m_on):
        assert torch.equal(a, b), field


# --------------------------------------------------- equal to reference ----
@pytest.mark.parametrize("batch,n_racks", [(False, 1), (False, 2),
                                           (True, 2)])
def test_trace_and_series_match_reference(batch, n_racks):
    """The trace ring (count and records) and every series tensor equal
    the reference's, config by config; so do the metrics and the decoded
    events."""
    tcfg, (m, trace, series) = _run(batch, n_racks=n_racks)
    r_m, r_trace, r_series = _reference_run(batch, n_racks=n_racks)
    _equal_tree(m, r_m, "metrics")
    _equal_tree(trace, r_trace, "trace")
    _equal_tree(series, r_series, "series")
    from repro.fleetsim.telemetry import decode_run as rdecode

    for i in range(trace.count.shape[0]):
        got = decode_run(tcfg, _row(trace, i), _row(series, i))
        want = rdecode(_cfg(_ref()[2], batch, n_racks=n_racks),
                       _row(r_trace, i), _row(r_series, i))
        assert got.events.as_rows() == want.events.as_rows()
        assert got.series.rows() == want.series.rows()
    kinds = set(np.asarray(trace.data[..., 1]).reshape(-1).tolist())
    want_kinds = {EV_ARRIVAL, EV_CLONE, EV_SERVER_START, EV_SERVER_FINISH,
                  EV_CLIENT_COMPLETE, EV_FILTER_DROP}
    if not batch:
        want_kinds |= {EV_COORD_ENQ, EV_HEDGE_ARMED}
    assert want_kinds <= kinds


def test_ring_wrap_keeps_the_references_latest_records():
    """A 256-record ring wraps: the port keeps the reference's latest
    records, decodes them in chronological order and reports the
    overwritten remainder as lost."""
    tcfg, (_, trace, series) = _run(False, trace_cap=256)
    _, r_trace, _ = _reference_run(False, trace_cap=256)
    _equal_tree(trace, r_trace, "trace")
    ev = decode_run(tcfg, _row(trace, 2), _row(series, 2)).events
    assert ev.n_lost > 0 and len(ev) == 256
    assert ev.n_emitted == ev.n_lost + 256
    assert np.all(np.diff(ev.tick) >= 0)


# ------------------------------------------------ counters and series ------
def test_event_counts_reconcile_and_series_decompose_counters():
    """In an unwrapped run, each config's event counts equal its counters
    (arrivals, clones from all three sources, server completions, filter
    drops, first responses), and its windowed series' rates sum to the
    final counters."""
    tcfg, (m, trace, series) = _run(False, n_racks=2)
    for i in range(trace.count.shape[0]):
        tel = decode_run(tcfg, _row(trace, i), _row(series, i))
        ev, ts = tel.events, tel.series
        assert ev.n_lost == 0
        want = {EV_ARRIVAL: m.n_arrivals, EV_CLONE: m.n_cloned,
                EV_SERVER_FINISH: m.n_resp, EV_FILTER_DROP: m.n_filtered,
                EV_CLIENT_COMPLETE: m.n_completed}
        for kind, counter in want.items():
            assert len(ev.select(kind)) == int(counter[i]), (i, kind)
        assert ts.n_windows == 3
        for f in SERIES_COUNTERS:
            assert int(ts.rates[f].sum()) == int(getattr(m, f)[i]), f
        assert int(ts.completed_win.sum()) == int(m.n_completed_win[i])
    assert int(m.n_cloned.min()) >= 0 and int(m.n_filtered.sum()) > 0


# ------------------------------------------------------------- export ------
def test_chrome_trace_and_bundle_equal_the_references(tmp_path):
    """``chrome_trace`` (with the series' counter tracks) and
    ``write_run``'s four files equal the reference's, byte for byte."""
    from repro.fleetsim.telemetry import decode_run as rdecode
    from repro.fleetsim.telemetry import write_run as rwrite
    from repro.fleetsim.telemetry.export import chrome_trace as rchrome

    tcfg, (_, trace, series) = _run(False)
    _, r_trace, r_series = _reference_run(False)
    i = POLICIES.index("hedge")
    got = decode_run(tcfg, _row(trace, i), _row(series, i))
    want = rdecode(_cfg(_ref()[2], False), _row(r_trace, i),
                   _row(r_series, i))
    assert json.dumps(chrome_trace(got.events, "h", got.series)) \
        == json.dumps(rchrome(want.events, "h", want.series))
    a = write_run(tmp_path / "port", "hedge", got, summary={"x": 1})
    b = rwrite(tmp_path / "ref", "hedge", want, summary={"x": 1})
    for key in ("trace", "events", "series", "summary"):
        assert a[key].read_text() == b[key].read_text(), key


def test_cli_trace_out_bundle_equals_the_references(tmp_path, capsys):
    """``python -m repro_torch.scenarios trace_burst --trace-out DIR``
    writes the reference's bundle (1,000 ticks) and the same rows file."""
    jax = _ref()[0]
    from repro.scenarios.__main__ import main as rmain
    from repro_torch.scenarios.__main__ import main as tmain

    argv = ["trace_burst", "--ticks", "1000"]
    with jax.threefry_partitionable(False):
        assert rmain(argv + ["--trace-out", str(tmp_path / "r"),
                             "--out", str(tmp_path / "r.json")]) == 0
    assert tmain(argv + ["--trace-out", str(tmp_path / "t"),
                         "--out", str(tmp_path / "t.json"),
                         "--device", "cpu"]) == 0
    for f in ("trace.json", "events.csv", "series.csv", "summary.json"):
        got = (tmp_path / "t" / "trace_burst" / f).read_text()
        assert got == (tmp_path / "r" / "trace_burst" / f).read_text(), f
    t_rows = json.loads((tmp_path / "t.json").read_text())
    r_rows = json.loads((tmp_path / "r.json").read_text())
    assert t_rows.pop("device") == "cpu"
    assert t_rows.pop("trace_out") == str(tmp_path / "t")
    assert r_rows.pop("trace_out") == str(tmp_path / "r")
    assert t_rows == r_rows and t_rows["rows"]


# --------------------------------------------------------------- sweeps ----
def test_sweep_grid_decodes_telemetry_per_row():
    """A telemetry sweep runs staged and decodes every row as the
    reference's does; the deprecated ``simulate_telemetry`` warns and
    returns the same triple as ``simulate(options=EngineOptions(
    telemetry=True))``; a sharded telemetry sweep is refused."""
    jax, _, rf, _ = _ref()
    kw = dict(n_servers=4, n_workers=8, n_ticks=800, queue_cap=48,
              telemetry=True, trace_cap=CAP, window_ticks=400)
    args = (["baseline", "netclone"], [0.3, 0.6], [0])
    with jax.threefry_partitionable(False):
        want = rf.sweep_grid(rf.ServiceSpec.exponential(25.0), *args, **kw)
    got = tf.sweep_grid(tf.ServiceSpec.exponential(25.0), *args,
                        device="cpu", **kw)
    assert got.backend == "staged" and len(got.telemetry) == 4
    for a, b, r in zip(got.telemetry, want.telemetry, got.results):
        assert a.events.as_rows() == b.events.as_rows()
        assert a.series.rows() == b.series.rows()
        assert len(a.events.select(EV_CLIENT_COMPLETE)) == r.n_completed
    cfg = tf.FleetConfig(n_ticks=100, window_ticks=50, telemetry=True)
    params = tf.make_params(cfg, tf.POLICY_IDS["netclone"], 0.3, 0)
    with pytest.warns(DeprecationWarning, match="simulate_telemetry"):
        old = tf.simulate_telemetry(cfg, params, device="cpu")
    new = tf.simulate(cfg, params, device="cpu", options=TEL)
    for a, b in zip(old, new):
        _equal_tree(a, b, "simulate_telemetry")
    with pytest.raises(ValueError, match="cannot shard"):
        tf.sweep_grid(tf.ServiceSpec.exponential(25.0), ["baseline"],
                      [0.4], [0], n_servers=4, n_workers=8, n_ticks=1000,
                      telemetry=True, shard=2, device="cpu")
    with pytest.raises(ValueError, match="telemetry"):
        tf.simulate(cfg, params, device="cpu",
                    options=EngineOptions(backend="fused", telemetry=True))
