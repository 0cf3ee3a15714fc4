#!/usr/bin/env python3
"""Drive the PyTorch port of FleetSim on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (each fails the run on error; nothing is caught):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and print the card;
2. hold each kernel bit-exact against its plain PyTorch version at the main
   path's shapes, on random and adversarial lanes, and time both;
3. run the 6 golden cases of ``tests/golden/fleetsim_single_tor.json`` as
   one batch under the ``pallas`` (kernel B1), ``tickfuse`` (kernel B2) and
   ``vectorized`` filter backends and compare every field with the JSON;
4. the main path at full width: ``sweep_grid`` over the default
   ``FleetConfig`` (5 policies × 8 loads × 5 seeds = 200 configs) through
   B2, then the first ticks of the same grid under ``scan`` (the plain lane
   loop) held bit-equal to the kernel-backed run;
5. the README's 4-rack fabric with a hot rack and a straggler rack, loads up
   to 0.95, through B1, then the first ticks of the same grid under ``scan``
   held bit-equal to the kernel-backed run.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of ``jax``
and nothing of the reference package ``repro``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "fleetsim_single_tor.json"

# phase 4's tick count: the default config runs 50,000 ticks; the cut is
# forced by the time limit (1,200 s for the whole script, build included)
FULL_TICKS = 50_000
SWEEP_TICKS = 10_000           # the benchmark's own fast cap
SCAN_CHECK_TICKS = 2_000
PROFILE_TICKS = 40
RACK_TICKS = 4_000
RACK_CHECK_TICKS = 1_000
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
SCALAR_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(torch, fn):
    """Run ``fn`` under ``torch.profiler`` and return ``{kernel name:
    (launches, device microseconds)}`` for every kernel on the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (e.count, e.self_device_time_total)
    return out


# the CUDA kernel behind each wrapper, as the profiler names it
DEVICE_SYMBOL = {"fingerprint_filter": "fingerprint_filter_kernel",
                 "tickfuse_response_path": "tickfuse_kernel"}


def device_us_per_launch(kernels: dict, name: str) -> float:
    hits = [(n, us) for key, (n, us) in kernels.items() if name in key]
    if not hits:
        raise AssertionError(f"the profile shows no {name} launch")
    return sum(us for _, us in hits) / sum(n for n, _ in hits)


# (name, configs G, lanes K, tables, slots per table, servers): the default
# single-rack sweep (phase 4) and the 4-rack fabric's 9-config grid (phase
# 5), whose tables 8-9 are the spine's filter group
SHAPES = (("default", 200, 32, 4, 1024, 6),
          ("4-rack", 9, 32, 10, 1024, 24))


def bound_bytes(x: dict, g: int, n_tables: int, n_slots: int,
                n_servers: int, lane_bytes: int, state_t: bool) -> int:
    """Bytes a call must move on ``x``: each lane input read once, ``drop``
    written once (1 B a lane), each distinct (config, table, slot) the lanes
    touch read and written once, and (B2) each distinct (config, server)
    StateT entry written once."""
    from repro_torch.core.tables import fingerprint_hash

    rows = np.broadcast_to(np.arange(g)[:, None], x["rid"].shape)
    hit = (x["clo"] > 0) & (x["idx"] >= 0) & (x["idx"] < n_tables)
    slot = np.asarray(fingerprint_hash(x["rid"].astype(np.int64), n_slots))
    n_slot = len(set(zip(rows[hit].tolist(), x["idx"][hit].tolist(),
                         slot[hit].tolist())))
    nbytes = x["rid"].size * (lane_bytes + 1) + 8 * n_slot
    if state_t:
        ok = x["sid"] < n_servers
        nbytes += 4 * len(set(zip(rows[ok].tolist(), x["sid"][ok].tolist())))
    return nbytes


def check_kernels(torch, inputs_mod, ref, ops):
    """Phase 2: both kernels vs their plain versions, bit-exact, at the
    main path's shapes (``SHAPES``), then timed at the default sweep's."""
    b1 = ("tables", "rid", "idx", "clo")
    b2 = ("server_state", "tables", "rid", "idx", "clo", "sid", "qlen")
    err = {"fingerprint_filter": 0, "tickfuse_response_path": 0}
    for label, g, k, n_tables, n_slots, n_servers in SHAPES:
        for seed in range(4):
            x = inputs_mod.filter_lanes(g, k, n_tables, n_slots, n_servers,
                                        seed)

            def dev(names):
                return [torch.from_numpy(x[n].copy()).cuda() for n in names]

            for name, fn, plain, names in (
                    ("fingerprint_filter", ops.fingerprint_filter,
                     ref.fingerprint_filter_ref, b1),
                    ("tickfuse_response_path", ops.tickfuse_response_path,
                     ref.tickfuse_ref, b2)):
                got = fn(*dev(names))
                torch.cuda.synchronize()
                want = plain(*dev(names))
                for a, b in zip(got, want):
                    d = (a.long() - b.long()).abs().max().item()
                    err[name] = max(err[name], d)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name}: kernel != plain version "
                                         f"({label} shape, seed {seed})")
        log(f"phase 2: both kernels bit-exact vs plain at the {label} shape: "
            f"G={g} K={k} tables=({g},{n_tables},{n_slots}) "
            f"n_servers={n_servers}")

    _, g, k, n_tables, n_slots, n_servers = SHAPES[0]
    x = inputs_mod.filter_lanes(g, k, n_tables, n_slots, n_servers, 99)
    rows = {}
    for name, fn, plain, names, lane_bytes, state_t in (
            ("fingerprint_filter", ops.fingerprint_filter,
             ref.fingerprint_filter_ref, b1, 12, False),
            ("tickfuse_response_path", ops.tickfuse_response_path,
             ref.tickfuse_ref, b2, 20, True)):
        args = [torch.from_numpy(x[n].copy()).cuda() for n in names]
        ms = cuda_ms(lambda: fn(*args), 2000)
        plain_ms = cuda_ms(lambda: plain(*args), 20)
        dev_us = device_us_per_launch(
            device_kernels(torch, lambda: [fn(*args) for _ in range(200)]),
            DEVICE_SYMBOL[name])
        nbytes = bound_bytes(x, g, n_tables, n_slots, n_servers, lane_bytes,
                             state_t)
        n_ops = 12 * g * k            # hash, compare, select per lane
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / SCALAR_OPS_PER_S * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms
                          else "operations",
                          max_abs_err=err[name], bytes=nbytes)
        log(f"phase 2: {name}: kernel {ms:.6f} ms per call (wrapper "
            f"included, CUDA events over 2000 calls), {dev_us:.3f} us on "
            f"the device per launch (profiler), plain {plain_ms:.6f} ms, "
            f"bound {rows[name]['bound_ms']:.8f} ms ({nbytes} B)")
    return rows


def assert_same_state(tf, st_a, st_b, what: str) -> None:
    """Fail unless two final states are equal in every tensor."""
    a, b = tf.to_numpy(st_a), tf.to_numpy(st_b)
    for part in ("switch", "queues", "workers", "metrics"):
        for name in getattr(a, part)._fields:
            if not np.array_equal(getattr(getattr(a, part), name),
                                  getattr(getattr(b, part), name)):
                raise AssertionError(f"{what} at {part}.{name}")
    for name in ("dedup", "client_backlog", "key"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what} at {name}")


def golden_batch(tf, backend):
    from repro_torch.scenarios.service import load_to_rate

    g = json.loads(GOLDEN.read_text())
    cfg = tf.FleetConfig(service=tf.ServiceSpec.exponential(25.0),
                         filter_backend=backend, **g["cfg"])
    runs = []
    for c in g["cases"]:
        rate = load_to_rate(c["load"], cfg.service, cfg.n_servers,
                            cfg.n_workers)
        runs.append(tf.make_params(
            cfg, tf.POLICY_IDS[c["policy"]], rate, c["seed"],
            slowdown=c.get("slowdown"),
            fail_window=tuple(c["fail_window"]) if "fail_window" in c
            else None))
    return cfg, g["cases"], tf.stack_params(runs)


def reset(kernels):
    for fn in kernels.values():
        fn.launches = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.is_file():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "and tests/golden are missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.fleetsim as tf
    from repro_torch.fleetsim import engine
    from repro_torch.fleetsim.sweep import plan_grid
    from repro_torch.kernels import build, inputs, ops, ref

    kernels = {"fingerprint_filter": ops.fingerprint_filter,
               "tickfuse_response_path": ops.tickfuse_response_path}
    t_start = time.perf_counter()

    # -- phase 1: build + device ------------------------------------------
    t0 = time.perf_counter()
    libs = build.build()
    log(f"phase 1: built {sorted(libs)} with nvcc in "
        f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind}")

    # -- phase 2: kernels vs plain -----------------------------------------
    rows = check_kernels(torch, inputs, ref, ops)

    # -- phase 3: goldens on the card --------------------------------------
    for backend, kernel in (("pallas", "fingerprint_filter"),
                            ("tickfuse", "tickfuse_response_path"),
                            ("vectorized", None)):
        cfg, cases, params = golden_batch(tf, backend)
        reset(kernels)
        t0 = time.perf_counter()
        m = tf.simulate(cfg, params)
        m = type(m)(*(x.cpu().numpy() for x in m))
        dt = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in kernels.items()}
        for i, c in enumerate(cases):
            for field, want in c["metrics"].items():
                got = np.asarray(getattr(m, field)[i]).reshape(-1)
                if not np.array_equal(got, np.asarray(want).reshape(-1)):
                    raise AssertionError(f"golden {i} ({c['policy']}) "
                                         f"{field} differs under {backend}")
        want_counts = {n: cfg.n_ticks if n == kernel else 0
                       for n in kernels}
        if counts != want_counts:
            raise AssertionError(f"{backend}: launches {counts}, expected "
                                 f"{want_counts}")
        log(f"phase 3: {backend}: 6 golden cases x 16 fields bit-exact "
            f"({cfg.n_ticks} ticks, {dt:.1f} s, "
            f"{dt / cfg.n_ticks * 1e3:.3f} ms/tick, launches {counts})")

    # -- phase 4: the main path at full width, through B2 -----------------
    policies = ["baseline", "c-clone", "netclone", "racksched",
                "netclone+racksched"]
    loads = [0.1, 0.2, 0.35, 0.5, 0.65, 0.8, 0.9, 0.95]
    seeds = [0, 1, 2, 3, 4]
    cfg = tf.FleetConfig(filter_backend="tickfuse", n_ticks=SWEEP_TICKS)
    log(f"phase 4: n_ticks cut from {FULL_TICKS} to {SWEEP_TICKS} by the "
        f"run's time limit")
    reset(kernels)
    sw = tf.sweep_grid(cfg.service, policies, loads, seeds, cfg=cfg)
    counts = {n: fn.launches for n, fn in kernels.items()}
    sweep_launches = dict(counts)
    if counts != {"fingerprint_filter": 0,
                  "tickfuse_response_path": SWEEP_TICKS}:
        raise AssertionError(f"phase 4 launches {counts}, expected "
                             f"{SWEEP_TICKS} of tickfuse_response_path")
    cticks = sw.n_configs * SWEEP_TICKS
    log(f"phase 4: {sw.n_configs} configs x {SWEEP_TICKS} ticks in "
        f"{sw.wall_clock_s:.2f} s: {cticks / sw.wall_clock_s:.1f} "
        f"config-ticks/s, {sw.wall_clock_s / SWEEP_TICKS * 1e3:.3f} ms/tick, "
        f"B2 launches {counts['tickfuse_response_path']}")
    for r in sw.results:
        # a dedup-table eviction can count a request's second response as
        # a completion too (the reference's n_dedup_evicted), so
        # completions are bounded by arrivals plus evictions
        if not (0 < r.n_completed <= r.n_arrivals + r.n_dedup_evicted
                and math.isfinite(r.p99_us) and r.p99_us >= r.p50_us > 0):
            raise AssertionError(f"phase 4: implausible row {r.row()}")
    for p in policies:
        rs = [r for r in sw.select(policy=p) if r.seed == 0]
        log("phase 4: " + p + " p99_us by load: "
            + ", ".join(f"{r.offered_load}:{r.p99_us:.1f}" for r in rs))

    cfg_k, _, _, params = plan_grid(cfg.service, policies, loads, seeds,
                                    cfg=cfg)
    params, _ = engine.batched_params(params, torch.device("cuda"))
    t0 = time.perf_counter()
    st_k = engine._simulate_core(cfg_k, params, n_steps=SCAN_CHECK_TICKS)
    st_s = engine._simulate_core(replace(cfg_k, filter_backend="scan"),
                                 params, n_steps=SCAN_CHECK_TICKS)
    assert_same_state(tf, st_k, st_s, "phase 4: scan != tickfuse")
    log(f"phase 4: first {SCAN_CHECK_TICKS} ticks of the grid under scan "
        f"bit-equal to tickfuse (whole state and all metrics, "
        f"{time.perf_counter() - t0:.1f} s)")

    # where a tick's time goes: a profiled window of the same grid
    state, step, n_raw = engine.init_run(cfg_k, params)
    state = engine.advance(cfg_k, state, step, n_raw, 0, 5)
    prof = device_kernels(torch, lambda: engine.advance(
        cfg_k, state, step, n_raw, 5, 5 + PROFILE_TICKS))
    busy_ms = sum(us for _, us in prof.values()) / 1e3 / PROFILE_TICKS
    n_launch = sum(n for n, _ in prof.values()) / PROFILE_TICKS
    tick_ms = sw.wall_clock_s / SWEEP_TICKS * 1e3
    b2_us = device_us_per_launch(prof,
                                 DEVICE_SYMBOL["tickfuse_response_path"])
    log(f"phase 4: profile of {PROFILE_TICKS} ticks: {n_launch:.0f} kernel "
        f"launches per tick, {busy_ms:.3f} ms device busy per tick of "
        f"{tick_ms:.3f} ms wall (unprofiled sweep): device idle "
        f"{100 * (1 - busy_ms / tick_ms):.1f}%; B2 {b2_us:.3f} us per "
        f"launch")
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
    for key, (n, us) in top:
        log(f"phase 4:   {us / 1e3 / PROFILE_TICKS:.4f} ms/tick "
            f"{n / PROFILE_TICKS:.0f} launches/tick  {key[:90]}")

    # -- phase 5: the 4-rack fabric through B1 -----------------------------
    cfg = tf.FleetConfig(n_racks=4, n_servers=6, n_workers=15,
                         filter_backend="pallas", n_ticks=RACK_TICKS)
    weights, slowdown = tf.rack_skew(cfg, 3.0, 2.0)
    lam = (0.95 * cfg.n_servers_total * cfg.n_workers
           / cfg.service.effective_mean * cfg.dt_us)
    reset(kernels)
    rack_policies = ["baseline", "netclone", "netclone+racksched"]
    rack_loads = [0.5, 0.8, 0.95]
    rk = tf.sweep_grid(cfg.service, rack_policies, rack_loads, [0], cfg=cfg,
                       rack_weights=weights, slowdown=slowdown)
    counts = {n: fn.launches for n, fn in kernels.items()}
    rack_launches = dict(counts)
    if counts != {"fingerprint_filter": RACK_TICKS,
                  "tickfuse_response_path": 0}:
        raise AssertionError(f"phase 5 launches {counts}")
    for r in rk.results:
        log(f"phase 5: {r.policy} load {r.offered_load}: per-rack p99_us "
            f"{[round(v, 1) for v in r.rack_p99_us]}, inter-rack clones "
            f"{r.n_interrack_cloned}, spine-filtered {r.n_spine_filtered}")
        if not all(math.isfinite(v) for v in r.rack_p99_us):
            raise AssertionError("phase 5: a rack completed nothing")
    hot = [r for r in rk.results if r.policy == "netclone"
           and r.offered_load == 0.95][0]
    if hot.n_interrack_cloned == 0 or hot.n_spine_filtered == 0:
        raise AssertionError("phase 5: no spine filtering at load 0.95")
    log(f"phase 5: 4 racks, lambda at load 0.95 = {lam:.2f} per tick "
        f"(> 10: Poisson rejection branch), {rk.wall_clock_s:.1f} s, "
        f"B1 launches {counts['fingerprint_filter']}")

    # the same grid's first ticks under scan, held bit-equal to B1: the
    # kernel at the fabric's table shape (10 tables, the spine's at 8-9)
    cfg_k, _, _, params = plan_grid(
        cfg.service, rack_policies, rack_loads, [0], cfg=cfg,
        rack_weights=weights, slowdown=slowdown)
    params, _ = engine.batched_params(params, torch.device("cuda"))
    t0 = time.perf_counter()
    st_k = engine._simulate_core(cfg_k, params, n_steps=RACK_CHECK_TICKS)
    st_s = engine._simulate_core(replace(cfg_k, filter_backend="scan"),
                                 params, n_steps=RACK_CHECK_TICKS)
    assert_same_state(tf, st_k, st_s, "phase 5: scan != pallas")
    n_spine = int(st_k.metrics.n_spine_filtered.sum())
    if n_spine == 0:
        raise AssertionError(f"phase 5: no spine filtering in the first "
                             f"{RACK_CHECK_TICKS} ticks")
    log(f"phase 5: first {RACK_CHECK_TICKS} ticks of the grid under scan "
        f"bit-equal to pallas (whole state and all metrics; "
        f"{n_spine} responses spine-filtered; "
        f"{time.perf_counter() - t0:.1f} s)")

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        raise AssertionError(f"imported {bad}")
    replaces = {"fingerprint_filter":
                "src/repro/kernels/fingerprint_filter.py:64",
                "tickfuse_response_path": "src/repro/kernels/tickfuse.py:86"}
    sources = {"fingerprint_filter":
               "src/repro_torch/kernels/csrc/fingerprint_filter.cu",
               "tickfuse_response_path":
               "src/repro_torch/kernels/csrc/tickfuse.cu"}
    launches = {"fingerprint_filter": rack_launches["fingerprint_filter"],
                "tickfuse_response_path":
                sweep_launches["tickfuse_response_path"]}
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": sources[n],
         "replaces": replaces[n], "launches": launches[n],
         "max_abs_err": rows[n]["max_abs_err"], "ms": rows[n]["ms"],
         "plain_ms": rows[n]["plain_ms"], "bound_ms": rows[n]["bound_ms"],
         "bound_by": rows[n]["bound_by"], "library_ms": None}
        for n in kernels]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
