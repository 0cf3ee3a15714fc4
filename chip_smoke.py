#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it: FleetSim's sweep,
the qwen2.5-3b model stack and the NetClone serving tier.

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
   held bit-equal to the kernel-backed run;
6. flash attention (kernel B3) against its plain version at the reference
   test sweep's shapes and at qwen2.5-3b's full prefill shape, timed beside
   its bound, its plain version and PyTorch's SDPA;
7. qwen2.5-3b at full width and depth (36 layers, random weights from
   seed 0, bf16 activations): a 4 x 4,096-token prefill through B3 held to
   the same prefill through the plain attention, 16 decode steps, and
   prefill/decode consistency (255 + 1 tokens against 256);
8. the serving tier at full width: ``launch/serve.py``'s defaults (4
   replicas of 2 slots, 48 requests over 80 ticks, a 20-tick straggler)
   under ``netclone`` (B1 on every tick with completions, each launch
   replayed against the plain filter) and under ``baseline``.

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
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense

# phase 6: the reference's B3 sweep (tests/test_kernels.py:22-32) and
# qwen2.5-3b's prefill shape; tolerances as the reference's test
FA_CASES = (
    (1, 4, 4, 256, 64, True, None, "float32"),
    (2, 8, 2, 256, 64, True, None, "float32"),
    (1, 4, 1, 256, 128, True, None, "float32"),
    (1, 4, 4, 512, 64, False, None, "float32"),
    (1, 2, 2, 512, 64, True, 128, "float32"),
    (1, 2, 2, 256, 64, True, None, "bfloat16"),
    (3, 2, 2, 128, 32, True, None, "float32"),
)
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# phase 7: prefill_32k's 32 x 32,768 tokens cut to 4 x 4,096 by the run's
# time limit; decode steps after it
PREFILL_B, PREFILL_S, DECODE_STEPS = 4, 4096, 16
QWEN_FA = (PREFILL_B, 16, 2, PREFILL_S, 128, True, None, "bfloat16")
# whole-model bf16 comparisons: max |diff| within this share of the
# reference's max |value| (36 layers round to bf16 at different points)
MODEL_RTOL = 5e-2


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


def device_kernels(torch, fn, tries: int = 3):
    """Run ``fn`` under ``torch.profiler`` and return ``{kernel name:
    (launches, device microseconds)}`` for every kernel on the card.  A
    session that records no device event at all (seen once on the card,
    after several earlier sessions in the process) is run again, up to
    ``tries`` times; the result may still be empty."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out[e.key] = (e.count, e.self_device_time_total)
        if out:
            break
    return out


# the CUDA kernel behind each wrapper, as the profiler names it
DEVICE_SYMBOL = {"fingerprint_filter": "fingerprint_filter_kernel",
                 "tickfuse_response_path": "tickfuse_kernel",
                 "flash_attention": "flash_attention"}


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


# ------------------------------------------------------------ phases 6-8 --
DEV = "cuda"   # where phases 6-8 put every tensor and run every entry point


def qkv_on_card(torch, case, seed):
    b, h, hkv, s, d, _, _, dtype = case
    g = torch.Generator(device=DEV).manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=g, device=DEV).to(dt)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def attention_bound(case) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, FLOPs, bytes) of one call: q·kᵀ and P·V
    over the pairs the mask keeps (causal: S(S+1)/2 per head), each input
    read once and the output written once."""
    b, h, hkv, s, d, causal, window, dtype = case
    pairs = s * (s + 1) // 2 if causal else s * s
    if window is not None:
        raise ValueError("the bound is written for the unwindowed cases")
    flops = 4 * b * h * d * pairs
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * d * s * (2 * b * h + 2 * b * hkv)
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def check_flash_attention(torch, ref, ops):
    """Phase 6: B3 vs its plain version at the test sweep's shapes and at
    qwen's prefill shape, then timed there beside the bound, the plain
    version and SDPA."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    err = 0.0
    for i, case in enumerate(FA_CASES + (QWEN_FA,)):
        causal, window, dtype = case[5:]
        q, k, v = qkv_on_card(torch, case, seed=100 + i)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        d = (got.float() - want.float()).abs().max().item()
        if not d <= FA_TOL[dtype]:
            raise AssertionError(f"phase 6: B3 differs from its plain "
                                 f"version by {d} at {case}")
        err = max(err, d)
        log(f"phase 6: B3 vs plain at {case}: max |diff| {d:.3g} "
            f"(tolerance {FA_TOL[dtype]})")
        del got, want
    q, k, v = qkv_on_card(torch, QWEN_FA, seed=7)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), 20)
    prof = device_kernels(torch, lambda: [ops.flash_attention(q, k, v)
                                          for _ in range(5)])
    if any(DEVICE_SYMBOL["flash_attention"] in key for key in prof):
        dev_us = device_us_per_launch(prof, DEVICE_SYMBOL["flash_attention"])
        dev_how = "profiler"
    else:
        dev_us = 1e3 * min(cuda_ms(lambda: ops.flash_attention(q, k, v), 1)
                           for _ in range(5))
        dev_how = "CUDA events around single launches; the profiler " \
            "recorded none"
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), 3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    bound, by, flops, nbytes = attention_bound(QWEN_FA)
    log(f"phase 6: B3 at qwen2.5-3b's prefill shape q {tuple(q.shape)} "
        f"k/v {tuple(k.shape)} bf16 causal: {ms:.4f} ms per call (CUDA "
        f"events over 20 calls), {dev_us:.1f} us on the device per launch "
        f"({dev_how}), bound {bound:.4f} ms ({by}: {flops:.4g} FLOP, "
        f"{nbytes} B) = {100 * bound / ms:.2f}% of it; plain "
        f"{plain_ms:.4f} ms; SDPA {library_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err, library_ms=library_ms, dev_us=dev_us)


def worst_rel(got, want) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def run_model(torch, lm, kernels, get_config):
    """Phase 7: qwen2.5-3b at full width and depth; returns the bf16
    weights (phase 8 serves them) and B3's launches per prefill."""
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    master = lm.init_params(cfg, 0, device=DEV)
    params = lm.cast_params(cfg, master)
    del master
    torch.cuda.synchronize()
    log(f"phase 7: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_params():,} parameters, random init "
        f"(seed 0) in {cfg.param_dtype}, held as a {cfg.dtype} copy "
        f"({time.perf_counter() - t0:.1f} s)")
    g = torch.Generator(device=DEV).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=g, device=DEV)
    s_max = PREFILL_S + DECODE_STEPS
    lm.prefill(cfg, params, tokens[:, :256], s_max=256, device=DEV)
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, params, tokens, s_max=s_max,
                                device=DEV)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in kernels.items()}
    want = {n: cfg.n_layers if n == "flash_attention" else 0
            for n in kernels}
    if counts != want:
        raise AssertionError(f"phase 7: prefill launches {counts}, "
                             f"expected {want}")
    n_tok = PREFILL_B * PREFILL_S
    log(f"phase 7: prefill {PREFILL_B} x {PREFILL_S} tokens (cut from "
        f"prefill_32k's 32 x 32,768 by the run's time limit): "
        f"{prefill_s * 1e3:.1f} ms, {n_tok / prefill_s:,.0f} tokens/s, "
        f"B3 launches {counts['flash_attention']}")

    # the same prefill through the plain attention, on the card
    logits_p, caches_p = lm.prefill(cfg.replace(attn_impl="xla"), params,
                                    tokens, s_max=s_max, device=DEV)
    r_logits = worst_rel(logits, logits_p)
    r_cache = max(max(worst_rel(a.k, b.k), worst_rel(a.v, b.v))
                  for a, b in zip(caches, caches_p))
    agree = (logits.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"phase 7: B3 prefill vs plain-attention prefill: logits max "
        f"|diff| / max |logit| {r_logits:.3g}, KV caches "
        f"({cfg.n_layers} layers) {r_cache:.3g}, argmax agreement "
        f"{agree:.2f} (tolerance {MODEL_RTOL})")
    if not (r_logits <= MODEL_RTOL and r_cache <= MODEL_RTOL):
        raise AssertionError("phase 7: B3 prefill differs from the plain "
                             "prefill")
    del logits_p, caches_p
    if not torch.isfinite(logits).all():
        raise AssertionError("phase 7: non-finite prefill logits")

    # 16 greedy decode steps after the prefill
    nxt = logits[:, -1].argmax(-1)[:, None]
    step_s = []
    for i in range(DECODE_STEPS):
        pos = torch.full((PREFILL_B,), PREFILL_S + i, dtype=torch.int32,
                         device=DEV)
        t0 = time.perf_counter()
        lg, caches = lm.decode_step(cfg, params, nxt, pos, caches,
                                    device=DEV)
        nxt = lg[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if not torch.isfinite(lg).all():
            raise AssertionError(f"phase 7: non-finite logits at step {i}")
    if kernels["flash_attention"].launches != cfg.n_layers:
        raise AssertionError("phase 7: decode launched B3")
    step_ms = 1e3 * sum(step_s[1:]) / (len(step_s) - 1)
    pos = torch.full((PREFILL_B,), PREFILL_S - 1, dtype=torch.int32,
                     device=DEV)
    prof = device_kernels(torch, lambda: [
        lm.decode_step(cfg, params, nxt, pos, caches, device=DEV)
        for _ in range(4)])
    busy_ms = sum(us for _, us in prof.values()) / 1e3 / 4
    n_launch = sum(n for n, _ in prof.values()) / 4
    idle = (f"device idle {100 * (1 - busy_ms / step_ms):.1f}%" if prof
            else "device idle not measured (the profiler recorded no "
            "device event)")
    log(f"phase 7: {DECODE_STEPS} decode steps (batch {PREFILL_B}, cache "
        f"{s_max}): {step_ms:.2f} ms per step (host clock, steps 2-"
        f"{DECODE_STEPS}), {n_launch:.0f} kernel launches and "
        f"{busy_ms:.3f} ms device busy per step (profiler): {idle}")
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:5]
    for key, (n, us) in top:
        log(f"phase 7:   {us / 1e3 / 4:.4f} ms/step {n / 4:.0f} "
            f"launches/step  {key[:90]}")
    del caches

    # prefill/decode consistency at full width: 255 + 1 against 256
    t256 = tokens[:1, :256]
    _, c255 = lm.prefill(cfg, params, t256[:, :255], s_max=256,
                         device=DEV)
    lg_dec, _ = lm.decode_step(cfg, params, t256[:, 255:], torch.full(
        (1,), 255, dtype=torch.int32, device=DEV), c255, device=DEV)
    lg_full, _ = lm.prefill(cfg, params, t256, device=DEV)
    r = worst_rel(lg_dec, lg_full)
    log(f"phase 7: prefill 255 + decode 1 vs prefill 256: logits max "
        f"|diff| / max |logit| {r:.3g} (tolerance {MODEL_RTOL}), same "
        f"argmax {bool(lg_dec.argmax() == lg_full.argmax())}")
    if not r <= MODEL_RTOL:
        raise AssertionError("phase 7: decode disagrees with prefill")
    return cfg, params, counts["flash_attention"]


def serve_workload(cfg, n_requests=48, horizon=80, seed=0):
    """``launch/serve.py``'s workload: 4-token prompts at sorted uniform
    ticks of the arrival window."""
    rng = np.random.default_rng(seed)
    return [(int(t), rng.integers(0, cfg.vocab_size, 4).astype(np.int32))
            for t in np.sort(rng.integers(0, horizon, n_requests))]


def run_serving(torch, cfg, params, kernels, ref):
    """Phase 8: the serving tier at full width under netclone and
    baseline; every B1 launch of the netclone run is replayed against the
    plain filter on the same tables and lanes."""
    from repro_torch.serve import DecodeReplica, NetCloneServer
    from repro_torch.serve import server as server_mod

    real = server_mod.fingerprint_filter
    tokens_by = {}
    for policy in ("netclone", "baseline"):
        reps = [DecodeReplica(cfg, params, sid=i, n_slots=2, s_max=128,
                              device=DEV) for i in range(4)]
        reps[1].inject_slowdown(20)
        srv = NetCloneServer(reps, policy=policy, seed=0, device=DEV)
        done_per_tick: dict[int, int] = {}
        for r in reps:
            def counted(t, _tick=r.tick):
                out = _tick(t)
                done_per_tick[t] = done_per_tick.get(t, 0) + len(out)
                return out
            r.tick = counted
        calls = []

        def recorded(tables, rid, idx, clo):
            calls.append((tables.clone(), rid, idx, clo))
            return real(tables, rid, idx, clo)

        server_mod.fingerprint_filter = recorded
        reset(kernels)
        t0 = time.perf_counter()
        try:
            stats = srv.run(serve_workload(cfg), max_new_tokens=4,
                            max_ticks=80 * 50)
        finally:
            server_mod.fingerprint_filter = real
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in kernels.items()}
        ticks = max(done_per_tick) + 1
        busy = sum(1 for v in done_per_tick.values() if v)
        if not (stats.n_completed == 48 == len(stats.latencies_ticks)
                == len(srv._done)):
            raise AssertionError(f"phase 8: {policy} completed "
                                 f"{stats.n_completed} of 48")
        want_b1 = busy if policy == "netclone" else 0
        if counts != {n: want_b1 if n == "fingerprint_filter" else 0
                      for n in kernels}:
            raise AssertionError(f"phase 8: {policy} launches {counts}, "
                                 f"expected {want_b1} of B1")
        log(f"phase 8: {policy}: 48/48 completed in {ticks} ticks, "
            f"{wall:.1f} s, {ticks / wall:.2f} ticks/s; latency p50 "
            f"{stats.p(50):.0f} p99 {stats.p(99):.0f} ticks; cloned "
            f"{stats.n_cloned} filtered {stats.n_filtered} clone drops "
            f"{stats.n_clone_drops}; B1 launches "
            f"{counts['fingerprint_filter']} ({busy} ticks had "
            f"completions)")
        tokens_by[policy] = sorted(c.tokens.tolist()
                                   for c in srv._done.values())
        if policy == "netclone":
            lanes = sorted({c[1].shape[1] for c in calls})
            for tables, rid, idx, clo in calls:
                got = real(tables.clone(), rid, idx, clo)
                torch.cuda.synchronize()
                want = ref.fingerprint_filter_ref(tables.clone(), rid, idx,
                                                  clo)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError("phase 8: B1 differs from its "
                                         "plain version on the server's "
                                         "lanes")
            log(f"phase 8: B1 bit-exact vs plain on all {len(calls)} of "
                f"the server's launches (tables {tuple(tables.shape)}, "
                f"lanes per tick {lanes})")
            if stats.n_cloned == 0 or stats.n_filtered == 0:
                raise AssertionError("phase 8: netclone cloned or filtered "
                                     "nothing")
    if tokens_by["netclone"] != tokens_by["baseline"]:
        raise AssertionError("phase 8: cloning changed what was generated")
    log("phase 8: netclone and baseline generated the same tokens")


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

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    kernels = {"fingerprint_filter": ops.fingerprint_filter,
               "tickfuse_response_path": ops.tickfuse_response_path,
               "flash_attention": ops.flash_attention}
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
    if counts != {"fingerprint_filter": 0, "flash_attention": 0,
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
    if counts != {"fingerprint_filter": RACK_TICKS, "flash_attention": 0,
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

    # -- phase 6: flash attention vs plain ---------------------------------
    rows["flash_attention"] = check_flash_attention(torch, ref, ops)

    # -- phase 7: qwen2.5-3b prefill + decode at full width ----------------
    cfg, params, prefill_launches = run_model(torch, lm, kernels,
                                              get_config)

    # -- phase 8: the serving tier at full width ---------------------------
    run_serving(torch, cfg, params, kernels, ref)
    del params

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        raise AssertionError(f"imported {bad}")
    replaces = {"fingerprint_filter":
                "src/repro/kernels/fingerprint_filter.py:64",
                "tickfuse_response_path": "src/repro/kernels/tickfuse.py:86",
                "flash_attention": "src/repro/kernels/flash_attention.py:98"}
    sources = {"fingerprint_filter":
               "src/repro_torch/kernels/csrc/fingerprint_filter.cu",
               "tickfuse_response_path":
               "src/repro_torch/kernels/csrc/tickfuse.cu",
               "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu"}
    launches = {"fingerprint_filter": rack_launches["fingerprint_filter"],
                "tickfuse_response_path":
                sweep_launches["tickfuse_response_path"],
                "flash_attention": prefill_launches}
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": sources[n],
         "replaces": replaces[n], "launches": launches[n],
         "max_abs_err": rows[n]["max_abs_err"], "ms": rows[n]["ms"],
         "plain_ms": rows[n]["plain_ms"], "bound_ms": rows[n]["bound_ms"],
         "bound_by": rows[n]["bound_by"],
         "library_ms": rows[n].get("library_ms")}
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
