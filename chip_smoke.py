#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it: FleetSim's sweep,
the model stack (qwen2.5-3b, mamba2-370m, recurrentgemma-9b,
deepseek-moe-16b, deepseek-v2-lite-16b, whisper-tiny), the NetClone
serving tier, ServeSim, FleetScope telemetry, the sharded sweep runner
and training.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (each fails the run on error; nothing is caught):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together), print the card and the
   registers, shared memory and spill bytes of B3's and B4's TMA +
   ``wgmma`` kernels;
2. hold B1, B2 and B2's staged entry point bit-exact against their plain
   PyTorch versions at the main path's shapes (default sweep, 4-rack
   fabric, serving dispatcher), on random lanes and on every edge-lane case
   of ``kernels/inputs.py``; then time each per call, on the device, and
   replayed from a CUDA graph (checked against the plain version applied
   as often), beside the floor: an empty kernel through B1's launch path;
3. run the 6 golden cases of ``tests/golden/fleetsim_single_tor.json`` as
   one batch on the staged engine under the ``tickfuse`` filter backend
   (kernel B2) and compare every field with the JSON (``pallas`` and
   ``vectorized`` run them fused in phase 12a);
4. the main path at full width on the staged engine
   (``engine=EngineOptions(backend="staged")``, one host call a tick, so
   the wrappers count every launch): ``sweep_grid`` over the default
   ``FleetConfig`` (5 policies × 8 loads × 5 seeds = 200 configs) through
   B2's staged entry point, then the first ticks of the same grid under
   ``scan`` (the plain lane loop) held bit-equal to the kernel-backed run,
   both replayed from the fused backend's CUDA graphs;
5. the README's 4-rack fabric with a hot rack and a straggler rack, loads up
   to 0.95, through B1 on the staged engine, then the first ticks of the
   same grid under ``scan`` held bit-equal to the kernel-backed run, as in
   phase 4;
6. flash attention (kernel B3) against its plain version at the reference
   test sweep's shapes, at the TMA + ``wgmma`` kernel's edge cases (head
   dim 256 windowed and ragged, a window narrower than a tile, the model's
   transposed views), at 300 and 384 tokens on both kernels, and at
   qwen2.5-3b's full prefill shape, timed there beside its bound, its plain
   version and PyTorch's SDPA;
7. qwen2.5-3b at full width and depth (36 layers, random weights from
   seed 0, bf16 activations): a 4 x 4,096-token prefill through B3 held to
   the same prefill through the plain attention, a 1 x 300-token prefill
   held the same way, 16 decode steps, and prefill/decode consistency (255
   + 1 tokens against 256);
8. the serving tier at full width: ``launch/serve.py``'s defaults (4
   replicas of 2 slots, a 20-tick straggler; 24 requests over 40 ticks,
   cut from its 48 over 80)
   under ``netclone`` (B1 on every tick with completions, each launch
   replayed against the plain filter) and under ``baseline``;
9. the SSD scan (kernel B4) and the RG-LRU scan (kernel B5) against their
   plain versions at the reference test sweep's shapes, B5 also at (2, 333,
   192) (float32, with h0: B4's step kernel), at B4's chunked kernel's
   edge cases (bf16: ragged lengths, a zero decay mid-chunk) and at
   mamba2-370m's and recurrentgemma-9b's full prefill shapes (bf16, B4's
   b and c broadcast
   over heads: the chunked kernel), each case logging which B4 kernel ran,
   timed beside their bounds and plain versions; B3 at recurrentgemma-9b's
   local-attention shape the same way, beside SDPA with the band as a mask
   and SDPA causal without the window;
10. mamba2-370m at full width and depth (48 layers, random weights from
    seed 0, bf16 activations): a 4 x 16,384-token prefill through B4 (48
    launches, all on the chunked kernel, counted by the wrapper and the
    profiler) held to the same prefill through the plain scan, 16 decode
    steps (no B4), and prefill 128 + decode 8 against the forward over 256
    tokens;
11. recurrentgemma-9b at full width and depth (38 layers: 26 RG-LRU through
    B5, 12 local attention through B3): a 4 x 4,096-token prefill held to
    the plain prefill (logits, LRU states, ring KV caches), 16 decode
    steps, and prefill 255 + decode 1 against prefill 256;
12. the fused backend (each block of 64 ticks replayed from a CUDA graph):
    (a) the 6 golden cases under ``pallas``, ``tickfuse`` and
    ``vectorized`` at K = 512, and under ``tickfuse`` at K = 300 (a
    tail), every field bit-exact;
    (b) phase 4's sweep through ``sweep_grid(engine=EngineOptions(backend=
    "fused"))``, every row and the grid histogram bit-identical to phase
    4's staged sweep; then the same grid fused at 4,000 ticks, timed
    beside phase 4 (config-ticks/s, ms a tick, the graph's capture and
    instantiation, device busy a tick and the idle share from a profile of
    replays, whose B2 launches must equal the ticks replayed); (c) ``cross_validate_spec`` over the bundled
    ``validate_grid.json`` (4 servers × 8 workers, Exp(25 µs) with its 1%
    × 15 jitter, seed 0, the seven two-engine policies — LÆDGE and hedge
    through the optional stages — × loads 0.2, 0.5, 0.8: one G = 21 batch
    on the fused backend, 20,000 DES requests a point): all 21 points
    within the documented tolerances, each printed beside the reference's
    own row (``tools/validate_grid_reference.json``, from
    ``tools/reference_validate.py`` on the CPU);
13. the Scenario layer and the optional stages: (a) the scenario CLI's
    ``--list`` and a JSON round trip of every library file; (b)
    ``golden_single_tor.json`` through ``Scenario`` bit-identical to the
    golden; (c) LÆDGE on one rack of 4 × 8 at load 0.5 (1,500 ticks)
    under B2 and ``vectorized``, and (d) LÆDGE over 2 racks (1,000 ticks)
    under B1 and ``vectorized``, its pairs filtered at the top tier:
    ``Metrics`` bit-identical, fused; (e) ``hedge_vs_netclone.json`` (G =
    6, cut from 40,000 to 2,000 ticks) under B2 and ``vectorized``: rows
    bit-identical, p99s printed; (f) a ``hedge_delays = [25, 75, 150]``
    sweep (1,000 ticks); each of (c)-(e) also runs its first 64 ticks on
    the staged loop, the wrapper counting one B1 or B2 launch a tick, held
    equal to the same ticks replayed from graphs; (g) for (c) and (e): ms a
    tick fused and staged, and for (c) a profile of replays (B2 launches
    counted by the profiler, kernels and device busy a tick, the idle
    share);
14. ServeSim: (a) ``llm_service("gemma-7b")`` from gemma-7b's full config
    counted on the meta device (no device memory allocated) equals both
    llm library files' ``params``; (b) ``llm_gemma7b.json`` (1 rack, B2)
    and ``llm_moe_hetero.json`` (2 racks with a slow rack, B1) at their
    full 4,000 ticks on the batch server, fused, bit-identical to
    ``vectorized``, each row equal to the reference's CPU row
    (``tools/serve_reference.json``), and each one's first 64 ticks
    staged (one B1 or B2 launch a tick, counted by the wrapper) equal to
    the same ticks replayed; then ``llm_gemma7b`` at ``batch_coupling``
    0.5 (the slots' decode speed falls with occupancy: the batch stage's
    float path), fused under B2, bit-identical to ``vectorized`` and its
    row equal to the reference's; (c) a 200-config batch sweep (5 policies × 8
    loads × 5 seeds) on llm_gemma7b's cluster and service, fused through
    B2: config-ticks/s, ms a tick, a profile of 2 replays (kernels and
    device busy a tick, the idle share), its first 500 ticks bit-identical
    to ``vectorized``; (d) ``serve_equivalence`` at the reference's
    defaults with its replicas on the card: every check ``ok`` and equal
    to the reference's row in every field, decode steps and ms a step,
    and the oracle's B1 launches;
15. FleetScope telemetry: ``trace_burst.json`` (cut to 1,000 ticks)
    staged with telemetry on under B2: ``Metrics`` bit-identical to the
    telemetry-off fused run, event counts reconciled with the counters,
    the decoded events and series equal to the reference's (digests,
    counts by kind, the row), ``write_run``'s bundle written to a
    temporary directory, and ms a tick staged with telemetry against
    without it;
16. deepseek-moe-16b at full width and depth (28 layers, 16.4 B
    parameters drawn from seed 0 in float32, each layer cast to bf16 as
    drawn): a 4 x 4,096-token prefill (28 B3 launches), held to the
    plain attention where B3 acts: each layer's attention sublayer on the
    same input and the float32-activation prefill's logits (the whole
    layers, the bf16 whole prefill and the float32 caches reported beside
    the tokens a near top-k tie reroutes); 16 decode steps (dropless
    routing), prefill 255 + decode 1 against prefill 256 (float32 held,
    bf16 reported); B3 at the prefill's MHA shape (4, 16, 4096, 128)
    against its plain version, timed beside its bound and SDPA;
17. deepseek-v2-lite-16b at full width and depth (27 layers, MLA and
    MoE): a 4 x 4,096-token prefill with no B3 launch (MLA pins the plain
    attention), 16 absorbed decode steps and the consistency check as in
    phase 16;
18. whisper-tiny at full width: frames (4, 1500, 384) and a 4 x 64-token
    prompt, prefill through B3 (12 launches: 4 encoder, 4 causal self, 4
    cross) held to the plain-attention prefill, 16 decode steps (4 B3
    launches each: cross-attention at Sq = 1) each held to the plain
    path, prefill 63 + decode 1 against prefill 64, and B3 at the three
    whisper shapes (non-causal over 1,500 frames, a 64-token and a
    1-token query against them) against its plain version, timed beside
    bound and SDPA;
19. the sharded runner: phase 4's 200-config sweep with
    ``shard=ShardSpec(devices=1)`` on the fused backend, every row and the
    merged ``grid_hist`` bit-identical to phase 4's, timed; then
    ``shard_equivalence`` on ``validate_grid.json``'s SweepSpec at 500
    ticks (one card holds one slab);
20. training: B3's backward kernel (``csrc/flash_attention_bwd.cu``: the
    TMA + ``wgmma`` kernels for bf16, the scalar ones for float32, its
    build's registers and spills logged) against autograd through
    ``attention_ref`` at qwen2.5-3b's training shape, whisper-tiny's
    encoder and cross shapes, one float32 case and the tensor-core
    kernels' edge cases (ragged, a window of 16, a group of 8, views TMA
    cannot read in place), two calls bit-equal, each timed beside its
    bound, its plain version and SDPA's backward;
    qwen2.5-3b at full width and depth (float32 master weights, bf16
    activations, remat) through the train cell of ``launch.steps.
    build_cell`` on the card's host mesh: a gradient on every leaf, then 3
    AdamW steps of 2 x 4,096 tokens (72 B3 and 36 backward launches a
    step), ms a step and peak memory; the 0.1 B model of
    ``examples/train_100m.py --full``: its attention gradients held to the plain attention's, 40 steps of 8 x 512
    with an async checkpoint at 20, the loss falling, and a restart
    through ``launch/train.py``'s restore path (state bit-equal, step 20's
    loss bit-equal, later steps within 1e-3); whisper-tiny, 3 steps on
    frames (2, 1500, 384) and 2 x 448 tokens;
21. B4's backward (``csrc/ssd_scan_bwd.cu``, its build's registers and
    spills logged) against autograd through ``ssd_scan_ref`` at
    mamba2-370m's training shape (b and c broadcast over heads), the
    reference's float32 scan-test shapes with h0 and a final-state
    gradient, a zero decay mid-chunk and a length of 100, two calls
    bit-equal, each timed beside its bound and its plain version;
    mamba2-370m at full width and depth through the train cell of
    ``build_cell``: a gradient on every leaf, step 1's loss held to the
    plain scan's (bf16) and each leaf's gradient to the plain scan's (in
    float32 activations), then 3 AdamW steps of 2 x 4,096 tokens (96 B4
    and 48 backward launches a step), ms a step and peak memory; then
    ``build_cell``'s prefill and decode cells at phase 10's shapes,
    bit-equal to ``lm.prefill`` and ``lm.decode_step``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of ``jax``
and nothing of the reference package ``repro``.
"""

from __future__ import annotations

import collections
import json
import math
import statistics
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
# below the benchmark's own fast cap of 10,000: phase 4's staged loop cut
# to 4,000 for phases 12c and 13, and to 1,000 for phases 14 and 15;
# phase 12b times the fused sweep at 4,000 ticks (62 graph replays of 64
# ticks and a 32-tick staged tail), as before the cut
SWEEP_TICKS = 1_000
FUSED_SWEEP_TICKS = 4_000
SCAN_CHECK_TICKS = 500
PROFILE_TICKS = 20
# cut from 4,000 to 2,000 for phases 12c and 13, to 1,000 for 14-15 and
# to 500 (its scan check's length) for 19-20
RACK_TICKS = 500
RACK_CHECK_TICKS = 500
# graph replays (of a sweep's 64-tick graph) in the profiles of phases 12b
# and 14c, cut from 8 to 2 for phases 14-15 (a profiler session of 8 takes
# ~40 s) and to 1 for 19-20; phase 12b profiles a run long enough for up
# to 3 sessions of one
# replay and then its own; validate_grid.json's DES requests a point
# (validate.main's default)
SWEEP_PROFILE_REPLAYS = 1
PROFILE_RUN_TICKS = 3 * (1 + SWEEP_PROFILE_REPLAYS) * 64
XVAL_REQUESTS = 20_000
# the reference's own rows of phase 12c (tools/reference_validate.py, run
# on the CPU in the goldens' PRNG stream)
XVAL_REFERENCE = ROOT / "tools" / "validate_grid_reference.json"
# phase 13: LÆDGE at one rack (4 x 8, load 0.5) and two (load 0.1, where
# its CPU lets it clone), hedge_vs_netclone.json cut from 40,000 ticks by
# the time limit, the hedge-delay sweep, and the staged window each run is
# held to (ticks replayed from graphs against the same ticks staged, the
# wrappers counting every staged launch: one graph's 64, cut from 128 to pay
# for phase 21; phase 14 shares it)
LAEDGE_TICKS = 1_500
LAEDGE_RACK_TICKS = 1_000
HEDGE_TICKS = 2_000
HEDGE_FULL_TICKS = 40_000
DELAY_TICKS = 1_000
HEDGE_DELAYS = (25.0, 75.0, 150.0)
STAGED_WINDOW = 64
# graph replays in phase 13's profiles (~1,000 kernels a tick: a profile
# of 8 replays takes the profiler most of a minute; cut
# from 2 to 1 for phases 14-15)
STAGE_PROFILE_REPLAYS = 1
# the default sweep's grid (phases 4 and 12b), which phase 14's batch sweep
# runs too
SWEEP_POLICIES = ["baseline", "c-clone", "netclone", "racksched",
                  "netclone+racksched"]
SWEEP_LOADS = [0.1, 0.2, 0.35, 0.5, 0.65, 0.8, 0.9, 0.95]
SWEEP_SEEDS = [0, 1, 2, 3, 4]
# phase 14: the library's llm files, each with the kernel its fabric takes
# (B2 on one rack, B1 on two), llm_gemma7b's batch coupling in its coupled
# run, the batch sweep's ticks held to vectorized, and the reference's rows
# of phases 14 and 15 (tools/reference_serve.py, run on the CPU in the
# goldens' PRNG stream)
LLM_FILES = ("llm_gemma7b", "llm_moe_hetero")
LLM_FILES_KERNELS = (("llm_gemma7b", "tickfuse", "tickfuse_response_path"),
                     ("llm_moe_hetero", "pallas", "fingerprint_filter"))
LLM_COUPLING = 0.5
BATCH_CHECK_TICKS = 500
SERVE_REFERENCE = ROOT / "tools" / "serve_reference.json"
# phase 14 (d): serve_equivalence's horizon, its default (at 1,000 ticks
# the reference's own netclone@0.6 check fails); phase 15: trace_burst's
# 40,000 ticks cut by the time limit
SERVE_TICKS = 1_500
TRACE_TICKS = 1_000
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
# the TMA + wgmma kernel's edge cases: head dim 256 MQA with a window and
# ragged, a window narrower than a tile with GQA, bidirectional at a
# longer sequence, and sequences shorter than a CTA's 128 rows (a 4-token
# prompt; one warpgroup's rows), whose other rows lie wholly past Sq
FA_EDGE_CASES = (
    (1, 4, 1, 512, 256, True, 128, "bfloat16"),
    (1, 4, 1, 255, 256, True, None, "bfloat16"),
    (2, 8, 2, 512, 64, True, 16, "bfloat16"),
    (1, 4, 4, 1024, 128, False, None, "bfloat16"),
    (2, 4, 2, 4, 128, True, None, "bfloat16"),
    (1, 4, 1, 64, 256, True, None, "bfloat16"),
)
# the model's (B, S, H, D) tensors transposed to (B, H, S, D), at head dim
# 256 (recurrentgemma-9b's heads) and 128 (qwen2.5-3b's)
FA_VIEW_CASES = ((2, 16, 1, 256, 256, True, None, "bfloat16"),
                 (2, 16, 2, 256, 128, True, None, "bfloat16"))
# prompt lengths no multiple of the Pallas kernel's 256-row blocks, which
# the port takes as the reference's XLA path does (ROADMAP C6): qwen2.5-3b's
# heads on the TMA + wgmma kernel (bf16) and on the scalar kernel (float32)
FA_C6_CASES = ((1, 16, 2, 300, 128, True, None, "bfloat16"),
               (1, 16, 2, 384, 128, True, None, "bfloat16"),
               (1, 16, 2, 300, 128, True, None, "float32"),
               (1, 16, 2, 384, 128, True, None, "float32"))
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# phase 7: prefill_32k's 32 x 32,768 tokens cut to 4 x 4,096 by the run's
# time limit; 16 decode steps after it (every model's)
PREFILL_B, PREFILL_S, DECODE_STEPS = 4, 4096, 16
QWEN_FA = (PREFILL_B, 16, 2, PREFILL_S, 128, True, None, "bfloat16")
# whole-model bf16 comparisons: max |diff| within this share of the
# reference's max |value| (36 layers round to bf16 at different points)
MODEL_RTOL = 5e-2

# phases 16-18: B3 at deepseek-moe-16b's MHA prefill and at whisper-tiny's
# encoder self-attention (non-causal over 1,500 frames) and cross-attention
# of a 64-token prompt and of one decode token against the frames (a
# case's ninth entry is Skv)
MOE_FA = (PREFILL_B, 16, 16, PREFILL_S, 128, True, None, "bfloat16")
WHISPER_PROMPT = 64
WHISPER_FA = (
    (PREFILL_B, 6, 6, 1500, 64, False, None, "bfloat16"),
    (PREFILL_B, 6, 6, WHISPER_PROMPT, 64, False, None, "bfloat16", 1500),
    (PREFILL_B, 6, 6, 1, 64, False, None, "bfloat16", 1500))

# phase 19: shard_equivalence's ticks on validate_grid.json (an exact
# comparison: the reference's CLI defaults to 6,000; cut from 1,000 to 500
# to pay for phase 21)
SHARD_TICKS = 500
# phase 20: B3's backward at qwen2.5-3b's training shape (2 x 4,096 tokens),
# whisper-tiny's encoder and cross-attention (Sq 448, the published
# decoder's context, over 1,500 frames) and one float32 case (GQA, a
# window); tolerances of max |diff| / max |grad| against autograd through
# attention_ref; qwen2.5-3b trains 3 steps of 2 x 4,096 tokens, the 0.1 B
# model of examples/train_100m.py --full 40 steps of 8 x 512 (checkpoint at
# 20), whisper-tiny 3 steps of 2 x 448 tokens
QWEN_TRAIN_B, QWEN_TRAIN_S, QWEN_TRAIN_STEPS = 2, 4096, 3
WHISPER_TRAIN_S = 448
BWD_CASES = (
    (QWEN_TRAIN_B, 16, 2, QWEN_TRAIN_S, 128, True, None, "bfloat16"),
    (QWEN_TRAIN_B, 6, 6, 1500, 64, False, None, "bfloat16"),
    (QWEN_TRAIN_B, 6, 6, WHISPER_TRAIN_S, 64, False, None, "bfloat16", 1500),
    (QWEN_TRAIN_B, 8, 2, 512, 128, True, 128, "float32"),
)
#: the tensor-core backward's edge cases, timed as BWD_CASES: ragged 255
#: rows, a window of 16 (GQA, head dim 64), a group of 8 over one kv head,
#: and qwen2.5-3b's heads as views TMA cannot read in place (a sequence
#: stride of 264 bytes: the wrapper copies them)
BWD_EDGE_CASES = (
    ((1, 16, 2, 255, 128, True, None, "bfloat16"), "transposed"),
    ((2, 8, 2, 512, 64, True, 16, "bfloat16"), "transposed"),
    ((1, 8, 1, 1024, 128, True, None, "bfloat16"), "transposed"),
    ((1, 16, 2, 512, 128, True, None, "bfloat16"), "misaligned"),
)
FA_BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
SMALL_TRAIN = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                   head_dim=64, d_ff=2048, vocab_size=32_000,
                   max_seq_len=1024)
SMALL_B, SMALL_S, SMALL_STEPS, SMALL_SAVE = 8, 512, 40, 20

# phase 21: B4's backward at mamba2-370m's training shape (2 x 4,096 tokens,
# 32 heads of P 64, N 128, b and c broadcast over heads, bf16), at the
# reference's float32 scan-test shapes with h0 and a final-state gradient,
# a zero decay mid-chunk, and a length under 128 that is no multiple of 64
# (bf16, h0 and a final-state gradient): b, s, h, p, n, dtype, h0 and final
# state, zero decay; tolerances of max |diff| / max |grad| as B3's backward;
# mamba2-370m trains 3 steps of 2 x 4,096 tokens (the train_4k batch of 256
# cut by the run's time), its step 1 held to the plain scan's: the loss
# within 1e-2 relative in bf16, each leaf's gradient within 5e-2 of its max
# |grad| in float32 activations, and in bf16 at the same width cut to
# MAMBA_GATE_DEPTH layers each leaf whose plain bf16 gradient lies within
# 5e-2 of the plain float32 one (the others, which bf16 itself moves by
# more than the gate, are listed with their readings; at full depth bf16
# alone moves every leaf by more)
MAMBA_TRAIN_B, MAMBA_TRAIN_S, MAMBA_TRAIN_STEPS = 2, 4096, 3
MAMBA_GATE_DEPTH = 2
SSD_BWD_CASES = (
    (MAMBA_TRAIN_B, MAMBA_TRAIN_S, 32, 64, 128, "bfloat16", False, False),
    (1, 256, 2, 64, 64, "float32", True, False),
    (2, 128, 1, 32, 128, "float32", True, False),
    (1, 512, 3, 16, 32, "float32", True, False),
    (1, 128, 2, 16, 16, "float32", True, False),
    (1, 256, 2, 64, 128, "bfloat16", False, True),
    (2, 100, 3, 64, 128, "bfloat16", True, False),
)
SSD_TRAIN_LOSS_RTOL = 1e-2

# phase 9: the reference's scan test shapes (tests/test_kernels.py:118-188)
# with h0, in float32 at its tolerances, then the full-width shapes in bf16
SSD_CASES = ((1, 256, 2, 64, 64, 64), (2, 128, 1, 32, 128, 128),
             (1, 512, 3, 16, 32, 128), (1, 128, 2, 16, 16, 32))
# B4's chunked kernel at mamba2's P and N (bf16): lengths that are no
# multiple of its 64-step chunks (the C5 contract admits any S below 128),
# and a zero decay mid-chunk: b, s, h, p, n, zero decay
SSD_EDGE_CASES = ((2, 72, 3, 64, 128, False), (2, 100, 3, 64, 128, False),
                  (1, 256, 2, 64, 128, True))
# the LRU cases end with a length and a width the Pallas kernel's blocks
# reject (ROADMAP C6)
LRU_CASES = ((2, 256, 256), (1, 512, 128), (1, 128, 384), (2, 333, 192))
SSD_TOL, LRU_TOL = 2e-3, 1e-4
# mamba2-370m's prefill (x (B, S, H, P), N) and recurrentgemma-9b's (x
# (B, S, D)) at phases 10-11's token counts
MAMBA_B, MAMBA_S, MAMBA_DECODE = 4, 32768, 16
SSD_FULL = (MAMBA_B, MAMBA_S, 32, 64, 128)
# phase 10's prefill, cut from 4 x 32,768 to 4 x 16,384 tokens to pay
# for phases 16-18 (phase 9 still times B4 at 32,768)
MAMBA_PREFILL_S = 16384
LRU_FULL = (PREFILL_B, PREFILL_S, 4096)
GRIFFIN_FA = (PREFILL_B, 16, 1, PREFILL_S, 256, True, 2048, "bfloat16")
# bf16 scans: kernel and plain version compute in float32 from the same
# bf16 inputs and round y once, so they differ by about one bf16 step
# (2^-8 of the value) where the float32 sums straddle a rounding boundary;
# held to 1e-2 of the plain version's max |value|
SCAN_BF16_RTOL = 1e-2


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
    (launches, device microseconds)}`` for every kernel on the card in one
    call of ``fn``.  ``fn`` runs twice: the profiler's warm-up step takes
    the first call (a session can miss its first kernels; one lost a whole
    layer of a prefill) and the second is recorded.  A session that records
    no device event at all (seen on the card after several earlier
    sessions in the process) is run again, up to ``tries`` times; the
    result may still be empty."""
    from torch.profiler import ProfilerActivity, profile, schedule

    out = {}

    def collect(prof):
        # kernels only: the schedule's own step range is listed on the
        # device too, spanning the whole step
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep")):
                out[e.key] = (e.count, e.self_device_time_total)

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=collect) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if out:
            break
    return out


# the CUDA kernel behind each wrapper, as the profiler names it
DEVICE_SYMBOL = {"fingerprint_filter": "fingerprint_filter_kernel",
                 # both entry points of B2 launch tickfuse_kernel<...>
                 "tickfuse_response_path": "tickfuse_kernel",
                 "tickfuse_masked": "MaskedLanes",
                 "filter_floor": "filter_noop_kernel",
                 "flash_attention": "flash_attention",
                 "ssd_scan": "ssd_scan",  # the step and chunked kernels
                 "lru_scan": "lru_scan_kernel"}
SSD_CHUNKED_SYMBOL = "ssd_scan_chunked_kernel"


def launches_in(kernels: dict, name: str) -> int:
    """Launches of ``name``'s CUDA kernel in a profile."""
    return sum(n for key, (n, _) in kernels.items()
               if DEVICE_SYMBOL[name] in key)


def profile_replays(torch, blocks, n_replays: int, kernel: str, what: str,
                    tries: int = 3):
    """A profile (:func:`device_kernels`) of ``n_replays`` replays of
    ``blocks``' CUDA graph, after one marker kernel (a session can miss its
    first kernels); the profiler's warm-up step, whose events are dropped,
    replays the graph once.  ``kernel`` runs once a tick, so its launches
    must equal the ticks replayed; a session whose count falls short (the
    profiler lost a few kernel records) is profiled again, up to
    ``tries`` sessions, and the run fails unless one counts every launch.
    Returns ``(profile, ticks, sessions)``."""
    marker = torch.zeros(1, device="cuda")
    calls = [0]

    def replays():
        marker.add_(1)
        blocks.run(n_replays if calls[0] % 2 else 1)
        calls[0] += 1

    ticks = n_replays * blocks.n
    for session in range(1, tries + 1):
        prof = device_kernels(torch, replays)
        n = launches_in(prof, kernel)
        if n == ticks:
            return prof, ticks, session
        log(f"{what}: profiler session {session} counted {n} {kernel} "
            f"launches in {ticks} replayed ticks; profiling again")
    raise AssertionError(f"{what}: no profile counted {ticks} {kernel} "
                         f"launches in {ticks} replayed ticks")


def device_us(torch, fn, name: str, reps: int) -> tuple[float, str]:
    """Device microseconds per launch of ``name``'s kernel in ``fn`` (one
    launch a call): from the profiler over ``reps`` calls, or, when the
    profiler records none of its launches, from CUDA events around single
    calls (the best of 5)."""
    prof = device_kernels(torch, lambda: [fn() for _ in range(reps)])
    if any(DEVICE_SYMBOL[name] in key for key in prof):
        return device_us_per_launch(prof, DEVICE_SYMBOL[name]), "profiler"
    return (1e3 * min(cuda_ms(fn, 1) for _ in range(5)),
            "CUDA events around single launches; the profiler recorded none")


def device_us_per_launch(kernels: dict, name: str) -> float:
    hits = [(n, us) for key, (n, us) in kernels.items() if name in key]
    if not hits:
        raise AssertionError(f"the profile shows no {name} launch")
    return sum(us for _, us in hits) / sum(n for n, _ in hits)


# (name, configs G, lanes K, tables, slots per table, servers): the default
# single-rack sweep (phase 4), the 4-rack fabric's 9-config grid (phase 5),
# whose tables 8-9 are the spine's filter group, and the serving
# dispatcher's one switch (phase 8: two tables of 4,096 slots, 4 replicas,
# 1-4 lanes a tick)
SHAPES = (("default", 200, 32, 4, 1024, 6),
          ("4-rack", 9, 32, 10, 1024, 24),
          ("serving", 1, 4, 2, 4096, 4))
B1_ARGS = ("tables", "rid", "idx", "clo")
B2_ARGS = ("server_state", "tables", "rid", "idx", "clo", "sid", "qlen")
# bytes a lane reads: rid, idx, clo (B1); sid, qlen too (B2); active (1 B)
# and idx and sid in int64 (B2's staged entry point)
LANE_BYTES = {"fingerprint_filter": 12, "tickfuse_response_path": 20,
              "tickfuse_masked": 29}
# calls a CUDA graph holds in phase 2's replay timing
GRAPH_CALLS = 100
# phase 4's launches per tick measured before B2's staged entry point took
# the lane preparation (two torch.where and two casts) into the kernel
TICK_LAUNCHES_BEFORE = 676


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


def filter_entries(torch, ops, ref, x, seed):
    """The three entry points of B1 and B2 on card copies of ``x``: ``(name,
    kernel call, plain call, the state tensors both update)``, each call
    taking an optional ``out``.  B2's staged entry point gets the lanes as
    the staged engine hands them over: an ``active`` mask (80% of the
    lanes), ``idx`` and ``sid`` in int64."""
    c = {n: torch.from_numpy(a.copy()).cuda() for n, a in x.items()}
    active = torch.from_numpy(
        np.random.default_rng(seed).random(x["rid"].shape) < 0.8).cuda()
    masked = (c["rid"], c["idx"].long(), c["clo"], c["sid"].long(),
              c["qlen"], active)
    b1 = [c[n] for n in B1_ARGS]
    b2 = [c[n] for n in B2_ARGS]
    return (
        ("fingerprint_filter",
         lambda out=None: ops.fingerprint_filter(*b1, out=out),
         lambda: ref.fingerprint_filter_ref(*b1), c),
        ("tickfuse_response_path",
         lambda out=None: ops.tickfuse_response_path(*b2, out=out),
         lambda: ref.tickfuse_ref(*b2), c),
        ("tickfuse_masked",
         lambda out=None: ops.tickfuse_masked(c["server_state"], c["tables"],
                                              *masked, out=out),
         lambda: ref.tickfuse_masked_ref(c["server_state"], c["tables"],
                                         *masked), c))


def diff_from(torch, c, fn, plain) -> int:
    """The largest difference between ``fn``'s and ``plain``'s outputs
    (state tables and drop) from the same starting tables."""
    start = {n: c[n].clone() for n in ("server_state", "tables")}
    got = [t.clone() for t in fn()]
    torch.cuda.synchronize()
    for n, t in start.items():
        c[n].copy_(t)
    want = [t.clone() for t in plain()]
    for n, t in start.items():
        c[n].copy_(t)
    return max((a.long() - b.long()).abs().max().item()
               for a, b in zip(got, want))


def capture(torch, fn, drop):
    """A CUDA graph of :data:`GRAPH_CALLS` calls of ``fn(out=drop)``."""
    fn(out=drop)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn(out=drop)
    return graph


def graph_replay_us(torch, c, fn, plain, drop) -> float:
    """Capture :data:`GRAPH_CALLS` calls of ``fn(out=drop)`` in one CUDA
    graph, replay it once from the current tables and check the result
    against ``plain`` applied as many times; then microseconds per call of
    20 replays (CUDA events)."""
    start = {n: c[n].clone() for n in ("server_state", "tables")}
    graph = capture(torch, fn, drop)
    for n, t in start.items():
        c[n].copy_(t)
    graph.replay()
    torch.cuda.synchronize()
    got = {n: c[n].clone() for n in start}
    got_drop = drop.clone()
    for n, t in start.items():
        c[n].copy_(t)
    for _ in range(GRAPH_CALLS):
        *_, want_drop = plain()
    if not (all(torch.equal(got[n], c[n]) for n in start)
            and torch.equal(got_drop, want_drop)):
        raise AssertionError("phase 2: the graph's replay differs from the "
                             f"plain version applied {GRAPH_CALLS} times")
    return 1e3 * cuda_ms(graph.replay, 20) / GRAPH_CALLS


def check_kernels(torch, inputs_mod, ref, ops):
    """Phase 2: B1, B2 and B2's staged entry point vs their plain versions,
    bit-exact, at the main path's shapes (``SHAPES``) and on every edge-lane
    case of ``inputs.EDGE_CASES``; then, at the default sweep's shape, each
    timed per call (wrapper included, with and without a preallocated
    ``drop``), on the device (profiler) and replayed from a CUDA graph of
    :data:`GRAPH_CALLS` calls (after checking the replay against the plain
    version applied as many times), beside the floor: an empty kernel on
    B1's grid launched through B1's whole path."""
    from repro_torch.kernels.fingerprint_filter import filter_floor

    err = {"fingerprint_filter": 0, "tickfuse_response_path": 0,
           "tickfuse_masked": 0}
    for label, g, k, n_tables, n_slots, n_servers in SHAPES:
        batches = [(f"random lanes, seed {seed}", inputs_mod.filter_lanes(
            g, k, n_tables, n_slots, n_servers, seed)) for seed in range(4)]
        batches += [(f"edge lanes {case}, seed {seed}", inputs_mod.edge_lanes(
            case, g, n_tables, n_slots, n_servers, seed))
            for case in inputs_mod.EDGE_CASES for seed in range(2)]
        for i, (what, x) in enumerate(batches):
            for name, fn, plain, c in filter_entries(torch, ops, ref, x, i):
                d = diff_from(torch, c, fn, plain)
                err[name] = max(err[name], d)
                if d:
                    raise AssertionError(f"phase 2: {name}: kernel != plain "
                                         f"version ({label} shape, {what})")
        log(f"phase 2: B1, B2 and B2's staged entry point bit-exact vs plain "
            f"at the {label} shape (G={g} K={k} tables=({g},{n_tables},"
            f"{n_slots}) n_servers={n_servers}) on {len(batches)} batches: "
            f"random lanes (seeds 0-3) and the edge lanes "
            f"{list(inputs_mod.EDGE_CASES)} (seeds 0-1)")

    _, g, k, n_tables, n_slots, n_servers = SHAPES[0]
    x = inputs_mod.filter_lanes(g, k, n_tables, n_slots, n_servers, 99)
    drop = torch.empty((g, k), dtype=torch.bool, device="cuda")
    entries = filter_entries(torch, ops, ref, x, 99)
    b1 = [entries[0][3][n] for n in B1_ARGS]

    def floor(out=None):
        return filter_floor(*b1, out=out)

    # host-clock timings before any profiler session, which can leave
    # later launches slower; then graph replays, then the profiler
    timed = [(name, fn) for name, fn, _, _ in entries] + [("floor", floor)]
    per_call = {name: (cuda_ms(fn, 2000), cuda_ms(lambda: fn(out=drop), 2000))
                for name, fn in timed}
    graph_us = {name: graph_replay_us(torch, c, fn, plain, drop)
                for name, fn, plain, c in entries}
    graph_us["floor"] = 1e3 * cuda_ms(capture(torch, floor, drop).replay,
                                      20) / GRAPH_CALLS
    dev = {name: device_us(torch, fn, "filter_floor" if name == "floor"
                           else name, 200) for name, fn in timed}
    rows = {}
    for name, fn, plain, c in entries:
        plain_ms = cuda_ms(plain, 20)
        nbytes = bound_bytes(x, g, n_tables, n_slots, n_servers,
                             LANE_BYTES[name], name != "fingerprint_filter")
        n_ops = 12 * g * k            # hash, compare, select per lane
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / SCALAR_OPS_PER_S * 1e3
        ms, ms_out = per_call[name]
        rows[name] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms
                          else "operations",
                          max_abs_err=err[name], bytes=nbytes)
        log(f"phase 2: {name}: kernel {ms:.6f} ms per call (wrapper "
            f"included, CUDA events over 2000 calls), {ms_out:.6f} ms with "
            f"a preallocated drop (out=), {dev[name][0]:.3f} us on the "
            f"device per launch ({dev[name][1]}), {graph_us[name]:.3f} us "
            f"per call replayed from a CUDA graph of {GRAPH_CALLS} calls "
            f"(replay checked against the plain version applied "
            f"{GRAPH_CALLS} times), plain {plain_ms:.6f} ms, bound "
            f"{rows[name]['bound_ms']:.8f} ms ({nbytes} B)")
    log(f"phase 2: floor (an empty kernel on B1's grid through B1's launch "
        f"path): {per_call['floor'][0]:.6f} ms per call, "
        f"{per_call['floor'][1]:.6f} ms with out=, {dev['floor'][0]:.3f} us "
        f"on the device per launch ({dev['floor'][1]}), "
        f"{graph_us['floor']:.3f} us per call replayed from a CUDA graph of "
        f"{GRAPH_CALLS} calls")
    del rows["tickfuse_masked"]
    return rows


def assert_same_state(tf, st_a, st_b, what: str) -> None:
    """Fail unless two final states are equal in every tensor (the
    coordinator's and the hedge wheel's too, when present)."""
    a, b = tf.to_numpy(st_a), tf.to_numpy(st_b)
    parts = ["switch", "queues", "workers", "metrics"]
    parts += [p for p in ("coord", "wheel") if getattr(a, p) is not None]
    for part in parts:
        for name in getattr(a, part)._fields:
            if not np.array_equal(getattr(getattr(a, part), name),
                                  getattr(getattr(b, part), name)):
                raise AssertionError(f"{what} at {part}.{name}")
    for name in ("dedup", "client_backlog", "key"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what} at {name}")


def replayed_state(cfg, params, n_ticks: int):
    """The state of a batched run (``params`` on the card) after its first
    ``n_ticks`` ticks, every tick replayed from the fused backend's CUDA
    graph (blocks of ``graph_ticks(n_ticks)`` ticks)."""
    from repro_torch.fleetsim import engine, fused

    state, step, n_raw = engine.init_run(cfg, params)
    blocks = fused.TickBlocks(cfg, step, n_raw, state,
                              fused.graph_ticks(n_ticks))
    blocks.run(n_ticks // blocks.n)
    return blocks.state


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
        if hasattr(fn, "chunked_launches"):
            fn.chunked_launches = 0


def only(kernels, **want) -> dict:
    """The launch counts expected when only the named kernels ran."""
    return {n: want.get(n, 0) for n in kernels}


# ------------------------------------------------------------ phases 6-8 --
DEV = "cuda"   # where phases 6-8 put every tensor and run every entry point


def seq_lens(case) -> tuple[int, int]:
    """(Sq, Skv) of a B3 case ``(b, h, hkv, sq, d, causal, window, dtype[,
    skv])``: the optional ninth entry is Skv, else Skv = Sq."""
    return case[3], case[8] if len(case) > 8 else case[3]


def qkv_on_card(torch, case, seed, transposed=False, misaligned=False):
    """q, k, v of ``case`` on the card from ``seed``; ``transposed``: as
    the model passes them, (B, S, H, D) tensors transposed to (B, H, S,
    D); ``misaligned``: so, but cut from rows of D + 4 values (strides
    that are no multiple of 16 bytes)."""
    b, h, hkv, _, d, _, _, dtype = case[:8]
    sq, skv = seq_lens(case)
    g = torch.Generator(device=DEV).manual_seed(seed)
    dt = getattr(torch, dtype)
    if misaligned:
        return [torch.randn(shape[:3] + (d + 4,), generator=g,
                            device=DEV).to(dt)[..., :d].transpose(1, 2)
                for shape in ((b, sq, h, d), (b, skv, hkv, d),
                              (b, skv, hkv, d))]
    if transposed:
        return [torch.randn(shape, generator=g, device=DEV).to(dt)
                .transpose(1, 2) for shape in
                ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    return [torch.randn(shape, generator=g, device=DEV).to(dt)
            for shape in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def attention_bound(case) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, FLOPs, bytes) of one call: q·kᵀ and P·V
    over the pairs the mask keeps (non-causal: Sq·Skv per head; causal:
    S(S+1)/2; causal with a window w: min(i, w) + 1 for row i), each input
    read once and the output written once."""
    b, h, hkv, _, d, causal, window, dtype = case[:8]
    sq, skv = seq_lens(case)
    s = sq
    if not causal:
        pairs = sq * skv
    elif window is None:
        pairs = s * (s + 1) // 2
    else:
        pairs = sum(min(i, window) + 1 for i in range(s))
    flops = 4 * b * h * d * pairs
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * d * (2 * b * h * sq + 2 * b * hkv * skv)
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def check_flash_attention(torch, ref, ops):
    """Phase 6: B3 vs its plain version at the test sweep's shapes, at the
    TMA + wgmma kernel's edge cases and at qwen's prefill shape, then timed
    there beside the bound, the plain version and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel_for

    torch.backends.cuda.matmul.allow_tf32 = False
    err = 0.0
    cases = ([(c, False) for c in FA_CASES + FA_EDGE_CASES + FA_C6_CASES]
             + [(c, True) for c in FA_VIEW_CASES] + [(QWEN_FA, False)])
    for i, (case, transposed) in enumerate(cases):
        causal, window, dtype = case[5:]
        q, k, v = qkv_on_card(torch, case, seed=100 + i,
                              transposed=transposed)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        d = (got.float() - want.float()).abs().max().item()
        if not d <= FA_TOL[dtype]:
            raise AssertionError(f"phase 6: B3 differs from its plain "
                                 f"version by {d} at {case}"
                                 f"{' (transposed views)' if transposed else ''}")
        err = max(err, d)
        log(f"phase 6: B3 ({kernel_for(q.dtype, case[4])} kernel) vs plain "
            f"at {case}{' as transposed (B, S, H, D) views' if transposed else ''}"
            f": max |diff| {d:.3g} (tolerance {FA_TOL[dtype]})")
        del got, want
    q, k, v = qkv_on_card(torch, QWEN_FA, seed=7)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), 20)
    dev_us, dev_how = device_us(torch, lambda: ops.flash_attention(q, k, v),
                                "flash_attention", 5)
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
    params = lm.init_params(cfg, 0, device=DEV, cast=True)
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

    # a prompt of 300 tokens, no multiple of the Pallas kernel's blocks
    # (ROADMAP C6): through B3 against the plain attention
    t300 = tokens[:1, :300]
    lg_k, c_k = lm.prefill(cfg, params, t300, device=DEV)
    lg_p, c_p = lm.prefill(cfg.replace(attn_impl="xla"), params, t300,
                           device=DEV)
    r300 = (worst_rel(lg_k, lg_p),
            max(max(worst_rel(a.k, b.k), worst_rel(a.v, b.v))
                for a, b in zip(c_k, c_p)))
    log(f"phase 7: B3 prefill of 1 x 300 tokens vs plain-attention prefill: "
        f"logits max |diff| / max |logit| {r300[0]:.3g}, KV caches "
        f"{r300[1]:.3g} (tolerance {MODEL_RTOL})")
    if not (max(r300) <= MODEL_RTOL and torch.isfinite(lg_k).all()):
        raise AssertionError("phase 7: the 300-token prefill differs from "
                             "the plain prefill")
    del lg_k, c_k, lg_p, c_p

    # 16 greedy decode steps after the prefill
    reset(kernels)
    caches = decode_steps(torch, lm, cfg, params, caches,
                          logits[:, -1].argmax(-1)[:, None], PREFILL_S,
                          DECODE_STEPS, "phase 7")
    if {n: fn.launches for n, fn in kernels.items()} != only(kernels):
        raise AssertionError("phase 7: decode launched a kernel")
    del caches

    # prefill/decode consistency at full width
    r, what = consistency(torch, lm, cfg, params, tokens[:1, :256])
    log(f"phase 7: {what}: logits max |diff| / max |logit| {r:.3g} "
        f"(tolerance {MODEL_RTOL})")
    if not r <= MODEL_RTOL:
        raise AssertionError("phase 7: decode disagrees with prefill")
    return cfg, params, counts["flash_attention"]


# phase 8: launch/serve.py's 48 requests over 80 ticks, cut to 24 over 40
# to pay for phases 16-18
SERVE_REQUESTS, SERVE_HORIZON = 24, 40


def serve_workload(cfg, n_requests=SERVE_REQUESTS, horizon=SERVE_HORIZON,
                   seed=0):
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
                            max_ticks=SERVE_HORIZON * 50)
        finally:
            server_mod.fingerprint_filter = real
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in kernels.items()}
        ticks = max(done_per_tick) + 1
        busy = sum(1 for v in done_per_tick.values() if v)
        if not (stats.n_completed == SERVE_REQUESTS
                == len(stats.latencies_ticks)
                == len(srv._done)):
            raise AssertionError(f"phase 8: {policy} completed "
                                 f"{stats.n_completed} of {SERVE_REQUESTS}")
        want_b1 = busy if policy == "netclone" else 0
        if counts != {n: want_b1 if n == "fingerprint_filter" else 0
                      for n in kernels}:
            raise AssertionError(f"phase 8: {policy} launches {counts}, "
                                 f"expected {want_b1} of B1")
        log(f"phase 8: {policy}: {SERVE_REQUESTS}/{SERVE_REQUESTS} "
            f"completed in {ticks} ticks, "
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


# ----------------------------------------------------------- phases 9-11 --
def scan_inputs(torch, kind, shape, dtype, seed, h0=True, broadcast=False,
                zero_decay=False):
    """Inputs of one scan call, made on the card from ``seed``: x, a in
    [lo, 1) (SSD: ``zero_decay`` zeroes every head's decay at step 100 and
    the last head's at step 37), b, c (SSD; ``broadcast`` gives them as a
    view over heads, as the model does), optional h0 in float32."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEV) * scale

    def decay(lo, *shape):
        return lo + (1 - lo) * torch.rand(shape, generator=g, device=DEV)

    if kind == "ssd":
        b, s, h, p, n = shape
        x, a = rn(b, s, h, p), decay(0.2, b, s, h)
        if zero_decay:
            a[:, 100] = 0.0
            a[:, 37, -1] = 0.0
        if broadcast:
            bc = rn(b, s, 2 * n, scale=0.3).to(dt)
            bm = bc[..., :n][:, :, None, :].expand(b, s, h, n)
            cm = bc[..., n:][:, :, None, :].expand(b, s, h, n)
        else:
            bm, cm = (rn(b, s, h, n, scale=0.3).to(dt) for _ in range(2))
        args = [x.to(dt), a.to(dt), bm, cm]
        return args + [rn(b, h, p, n, scale=0.1) if h0 else None]
    b, s, d = shape
    args = [rn(b, s, d).to(dt), decay(0.5, b, s, d).to(dt)]
    return args + [rn(b, d, scale=0.1) if h0 else None]


def scan_bound(kind, args, ell=128) -> tuple[float, str, float, int]:
    """(bound ms, what bounds it, FLOPs, bytes) of one scan call on
    ``args``: each input read once (b and c by the bytes they hold, one
    head's worth when broadcast), y and the final state written once.
    SSD's operations are its chunked form on the tensor cores at ``ell``-
    step chunks, the chunk length of the kernel that runs (C·Bᵀ and the
    masked product with X, 2L²(N+P) a chunk, the state's contribution and
    update, 4LNP), at the bf16 rate; the LRU's are one FMA an element at
    the float32 rate."""
    x, a = args[0], args[1]
    size = x.element_size()
    nbytes = 2 * x.numel() * size + a.numel() * a.element_size()
    if kind == "ssd":
        b, s, h, p = x.shape
        n = args[2].shape[-1]
        nbytes += sum((t.numel() // h if t.stride(2) == 0 else t.numel())
                      * size for t in args[2:4])
        nbytes += 4 * b * h * p * n * (2 if args[4] is not None else 1)
        ell = min(ell, s)
        flops = b * h * (s // ell) * (2 * ell * ell * (n + p)
                                      + 4 * ell * n * p)
        ops_ms = flops / BF16_OPS_PER_S * 1e3
    else:
        b, s, d = x.shape
        nbytes += 4 * b * d * (2 if args[2] is not None else 1)
        flops = 2 * x.numel()
        ops_ms = flops / SCALAR_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def check_scans(torch, ref, ssd_scan, lru_scan, ops):
    """Phase 9: B4 and B5 against their plain versions at the reference's
    test shapes (float32, with h0: B4's step kernel), at B4's chunked
    kernel's edge cases (bf16: ragged lengths, a zero decay mid-chunk) and
    at the full-width shapes (bf16, B4's b and c as the model's broadcast
    view: the chunked kernel), each B4 case checked to take the kernel
    ``kernel_for`` names; then timed at full width beside the bound and the
    plain version; B3 at recurrentgemma-9b's local-attention shape (window
    2048, head dim 256, one kv head) the same way."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan as ssd_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    rows, err = {}, {"ssd_scan": 0.0, "lru_scan": 0.0}
    # (kind, shape, dtype, chunk, full width, zero decay)
    cases = ([("ssd", c[:5], "float32", c[5], False, False)
              for c in SSD_CASES]
             + [("lru", c, "float32", None, False, False) for c in LRU_CASES]
             + [("ssd", c[:5], "bfloat16", 128, False, c[5])
                for c in SSD_EDGE_CASES]
             + [("ssd", SSD_FULL, "bfloat16", 128, True, False),
                ("lru", LRU_FULL, "bfloat16", None, True, False)])
    for i, (kind, shape, dtype, chunk, full, zero) in enumerate(cases):
        args = scan_inputs(torch, kind, shape, dtype, seed=200 + i,
                           broadcast=full, zero_decay=zero)
        route = ""
        if kind == "ssd":
            kernel = ssd_mod.kernel_for(args[0].dtype, shape[3], shape[4])
            before = ssd_scan.chunked_launches
            got = ssd_scan(*args[:4], args[4], chunk=chunk)
            torch.cuda.synchronize()
            took = ssd_scan.chunked_launches - before
            if took != (kernel == "chunked"):
                raise AssertionError(f"phase 9: B4 at {shape} {dtype} took "
                                     f"{took} chunked launches, routed to "
                                     f"the {kernel} kernel")
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"phase 9: B4 non-finite at {shape}")
            route = f" ({kernel} kernel{', a zero decay' if zero else ''})"
            want = ref.ssd_scan_ref(*args[:4], args[4], chunk=chunk)
        else:
            got = lru_scan(*args)
            torch.cuda.synchronize()
            want = ref.lru_scan_ref(*args)
        name = f"{kind}_scan"
        d = max((g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want))
        if dtype == "bfloat16":
            tol = SCAN_BF16_RTOL * max(w.float().abs().max().item()
                                       for w in want)
            how = f"{SCAN_BF16_RTOL} of max |value|"
        else:
            tol = SSD_TOL if kind == "ssd" else LRU_TOL
            how = "the reference's test tolerance"
        if not d <= tol:
            raise AssertionError(f"phase 9: {name} differs from its plain "
                                 f"version by {d} at {shape} {dtype}")
        err[name] = max(err[name], d)
        log(f"phase 9: {name} vs plain at {shape} {dtype}{route}"
            f"{' (b/c broadcast over heads)' if full and kind == 'ssd' else ''}"
            f": max |diff| {d:.3g} (y and final state; tolerance {tol:.3g}, "
            f"{how})")
        del got, want
        if not full:
            continue
        if kind == "ssd":
            def fn():
                return ssd_scan(*args[:4], chunk=128)

            def plain():
                return ref.ssd_scan_ref(*args[:4], chunk=128)
            reps, plain_reps = 10, 2
        else:
            def fn():
                return lru_scan(*args[:2])

            def plain():
                return ref.lru_scan_ref(*args[:2])
            reps, plain_reps = 50, 3
        timed = args[:4] + [None] if kind == "ssd" else args[:2] + [None]
        ms = cuda_ms(fn, reps)
        dev_us, dev_how = device_us(torch, fn, name, 3)
        plain_ms = cuda_ms(plain, plain_reps)
        chunked = kind == "ssd" and kernel == "chunked"
        bound, by, flops, nbytes = scan_bound(
            kind, timed, ssd_mod.CHUNK if chunked else 128)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, library_ms=None, dev_us=dev_us)
        log(f"phase 9: {name} at {shape} bf16: {ms:.4f} ms per call (CUDA "
            f"events over {reps} calls), {dev_us:.1f} us on the device per "
            f"launch ({dev_how}), bound {bound:.4f} ms ({by}: {flops:.4g} "
            f"FLOP, {nbytes} B) = {100 * bound / ms:.2f}% of it; plain "
            f"{plain_ms:.3f} ms; no single torch call computes the scan")
        del args
    for name in rows:
        rows[name]["max_abs_err"] = err[name]

    # B3 at recurrentgemma-9b's local-attention layers
    q, k, v = qkv_on_card(torch, GRIFFIN_FA, seed=11)
    window = GRIFFIN_FA[6]
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    d = (got.float() - want.float()).abs().max().item()
    if not d <= FA_TOL["bfloat16"]:
        raise AssertionError(f"phase 9: B3 differs from its plain version "
                             f"by {d} at {GRIFFIN_FA}")
    del got, want
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                             window=window), 5)
    dev_us, dev_how = device_us(torch, lambda: ops.flash_attention(
        q, k, v, causal=True, window=window), "flash_attention", 2)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True,
                                                 window=window), 2)
    s = q.shape[2]
    i = torch.arange(s, device=DEV)
    band = (i[None, :] <= i[:, None]) & (i[None, :] >= i[:, None] - window)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=band, enable_gqa=True), 5)
    # a second yardstick: a flash kernel of the library doing the whole
    # causal triangle, more work than the band
    causal_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 5)
    bound, by, flops, nbytes = attention_bound(GRIFFIN_FA)
    log(f"phase 9: B3 at recurrentgemma-9b's local-attention shape q "
        f"{tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal window "
        f"{window}: max |diff| to plain {d:.3g} (tolerance "
        f"{FA_TOL['bfloat16']}); {ms:.4f} ms per call (CUDA events over 5 "
        f"calls), {dev_us:.1f} us on the device per launch ({dev_how}), "
        f"bound {bound:.4f} ms ({by}: {flops:.4g} FLOP, {nbytes} B) = "
        f"{100 * bound / ms:.2f}% of it; plain {plain_ms:.3f} ms; SDPA with "
        f"the band as a boolean mask {library_ms:.4f} ms; SDPA causal "
        f"without the window (the whole triangle) {causal_ms:.4f} ms")
    return rows


def states_rel(got, want) -> float:
    """worst_rel over every tensor field of two lists of caches."""
    return max(worst_rel(a, b) for c, c_p in zip(got, want)
               for a, b in zip(c, c_p) if a is not None)


def profile_prefill(torch, lm, cfg, params, tokens, s_max, label):
    """One prefill under the profiler: launches by kernel and where the
    device time goes."""
    prof = device_kernels(torch, lambda: lm.prefill(
        cfg, params, tokens, s_max=s_max, device=DEV))
    busy = sum(us for _, us in prof.values()) / 1e3
    log(f"{label}: profiled prefill: {sum(n for n, _ in prof.values())} "
        f"kernel launches, {busy:.1f} ms device busy; by kernel:")
    for key, (n, us) in sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"{label}:   {us / 1e3:.2f} ms {n} launches  {key[:90]}")
    return prof


def decode_steps(torch, lm, cfg, params, caches, nxt, start, steps, label,
                 profiled: int = 4):
    """``steps`` greedy decode steps from position ``start``; returns the
    caches and ms per step (host clock, steps after the first), and logs
    the device's share of a profile of ``profiled`` steps."""
    step_s = []
    b = nxt.shape[0]
    for i in range(steps):
        pos = torch.full((b,), start + i, dtype=torch.int32, device=DEV)
        t0 = time.perf_counter()
        lg, caches = lm.decode_step(cfg, params, nxt, pos, caches,
                                    device=DEV)
        nxt = lg[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{label}: non-finite logits at step {i}")
    step_ms = 1e3 * sum(step_s[1:]) / (len(step_s) - 1)
    pos = torch.full((b,), start, dtype=torch.int32, device=DEV)
    prof = device_kernels(torch, lambda: [
        lm.decode_step(cfg, params, nxt, pos, caches, device=DEV)
        for _ in range(profiled)])
    busy_ms = sum(us for _, us in prof.values()) / 1e3 / profiled
    n_launch = sum(n for n, _ in prof.values()) / profiled
    idle = (f"device idle {100 * (1 - busy_ms / step_ms):.1f}%" if prof
            else "device idle not measured (the profiler recorded no "
            "device event)")
    log(f"{label}: {steps} decode steps (batch {b}): {step_ms:.2f} ms per "
        f"step (host clock, steps 2-{steps}), {n_launch:.0f} kernel "
        f"launches and {busy_ms:.3f} ms device busy per step (profiler): "
        f"{idle}")
    for key, (n, us) in sorted(prof.items(), key=lambda kv: -kv[1][1])[:5]:
        log(f"{label}:   {us / 1e3 / profiled:.4f} ms/step "
            f"{n / profiled:.0f} launches/step  {key[:90]}")
    return caches


def run_recurrent(torch, lm, kernels, get_config, arch, batch, seq, label):
    """Phases 10-11: ``arch`` at full width and depth, random weights from
    seed 0 in float32, each layer cast as drawn, bf16 activations: a
    ``batch`` x ``seq`` prefill through the kernels (launches counted by
    the wrappers and by the profiler) held to the plain-kernel prefill,
    decode steps (no scan kernel launched), and the consistency check.
    Returns the scan kernel's launches per prefill."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, 0, device=DEV, cast=True)
    torch.cuda.synchronize()
    log(f"{label}: {cfg.name}: {cfg.n_layers} layers "
        f"({dict(collections.Counter(cfg.layer_kinds))}), d_model "
        f"{cfg.d_model}, {cfg.n_params():,} parameters, random init (seed "
        f"0) in {cfg.param_dtype}, held as cast_params' copy "
        f"({time.perf_counter() - t0:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)")
    scan = "ssd_scan" if cfg.ssm is not None else "lru_scan"
    n_scan = cfg.layer_kinds.count("ssm" if cfg.ssm is not None else "rec")
    n_fa = sum(k.startswith("attn") for k in cfg.layer_kinds)
    want = only(kernels, **{scan: n_scan, "flash_attention": n_fa})
    g = torch.Generator(device=DEV).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device=DEV)
    s_max = seq + DECODE_STEPS
    lm.prefill(cfg, params, tokens[:, :256], s_max=256, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, params, tokens, s_max=s_max,
                                device=DEV)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in kernels.items()}
    if counts != want:
        raise AssertionError(f"{label}: prefill launches {counts}, "
                             f"expected {want}")
    routed = ""
    if scan == "ssd_scan":
        # bf16 mamba2 (P 64, N 128): every B4 launch takes the chunked kernel
        chunked = kernels[scan].chunked_launches
        if chunked != n_scan:
            raise AssertionError(f"{label}: {chunked} of {n_scan} B4 "
                                 "launches took the chunked kernel")
        routed = f" (B4: {chunked} of {n_scan} on the chunked kernel)"
    log(f"{label}: prefill {batch} x {seq} tokens: {prefill_s * 1e3:.1f} "
        f"ms, {batch * seq / prefill_s:,.0f} tokens/s, launches {counts}"
        f"{routed}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    prof = profile_prefill(torch, lm, cfg, params, tokens, s_max, label)
    seen = {n: launches_in(prof, n) for n in (scan, "flash_attention")}
    if prof and seen != {scan: n_scan, "flash_attention": n_fa}:
        raise AssertionError(f"{label}: the profile shows {seen} launches")
    if prof and scan == "ssd_scan":
        on_chunked = sum(n for key, (n, _) in prof.items()
                         if SSD_CHUNKED_SYMBOL in key)
        if on_chunked != n_scan:
            raise AssertionError(f"{label}: the profile shows {on_chunked} "
                                 f"launches of {SSD_CHUNKED_SYMBOL}")
        seen[SSD_CHUNKED_SYMBOL] = on_chunked
    log(f"{label}: the profiler saw {seen} launches in one prefill"
        if prof else f"{label}: the profiler recorded no device event")

    # kernel vs plain: each layer on the same input (the kernel prefill's),
    # then the whole prefill in float32 activations.  In bf16 the two
    # whole prefills drift apart: one bf16 step of difference per layer
    # compounds through the random-weight layers, so that drift is logged,
    # not held to the tolerance
    r_layer = compare_layers(torch, lm, cfg, params, tokens)
    log(f"{label}: kernel vs plain layer by layer on the same input ("
        f"{batch} x {seq}, bf16): worst layer output (residual stream) "
        f"max |diff| / max |value| {r_layer[0]:.3g}, worst cache field "
        f"{r_layer[1]:.3g} "
        f"(tolerance {MODEL_RTOL})")
    cfg32 = cfg.replace(dtype="float32")
    lg_k, c_k = lm.prefill(cfg32, params, tokens[:1], device=DEV)
    lg_p, c_p = lm.prefill(cfg32.replace(attn_impl="xla"), params,
                           tokens[:1], device=DEV)
    r32 = (worst_rel(lg_k, lg_p), states_rel(c_k, c_p))
    log(f"{label}: kernel vs plain prefill in float32 activations (1 x "
        f"{seq}): logits max |diff| / max |logit| {r32[0]:.3g}, caches "
        f"({cfg.n_layers} layers, every field) {r32[1]:.3g} (tolerance "
        f"{MODEL_RTOL})")
    del lg_k, c_k, lg_p, c_p
    if not max(r_layer + r32) <= MODEL_RTOL:
        raise AssertionError(f"{label}: kernel prefill differs from the "
                             "plain prefill")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: non-finite prefill logits")
    logits_p, caches_p = lm.prefill(cfg.replace(attn_impl="xla"), params,
                                    tokens, s_max=s_max, device=DEV)
    agree = (logits.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"{label}: kernel vs plain whole prefill in bf16 (reported, not "
        f"held): logits {worst_rel(logits, logits_p):.3g}, caches "
        f"{states_rel(caches, caches_p):.3g}, argmax agreement {agree:.2f}")
    del logits_p, caches_p

    reset(kernels)
    caches = decode_steps(torch, lm, cfg, params, caches,
                          logits[:, -1].argmax(-1)[:, None], seq,
                          DECODE_STEPS, label)
    if {n: fn.launches for n, fn in kernels.items()} != only(kernels):
        raise AssertionError(f"{label}: decode launched a kernel")
    del caches, logits

    # prefill/decode consistency at full width, in float32 activations
    # (held) and in bf16 (reported)
    for c_cfg in (cfg32, cfg):
        r, what = consistency(torch, lm, c_cfg, params, tokens[:1, :256])
        held = c_cfg is cfg32
        log(f"{label}: {what} in {c_cfg.dtype}: logits max |diff| / max "
            f"|logit| {r:.3g}" + (f" (tolerance {MODEL_RTOL})" if held
                                  else " (reported, not held)"))
        if held and not r <= MODEL_RTOL:
            raise AssertionError(f"{label}: decode disagrees with prefill")
    return counts[scan]


def consistency(torch, lm, cfg, params, t256) -> tuple[float, str]:
    """Decode after a prefill against the full-sequence result: 255 + 1
    against a 256-token prefill, or for mamba2, whose scan needs whole
    128-step chunks, 128 + 8 decode steps against the forward over 256
    tokens at positions 128-135."""
    if cfg.ssm is not None:
        full, _ = lm.forward(cfg, params, t256, device=DEV)
        _, c = lm.prefill(cfg, params, t256[:, :128], s_max=256, device=DEV)
        r = 0.0
        for i in range(128, 136):
            lg, c = lm.decode_step(cfg, params, t256[:, i:i + 1], torch.full(
                (1,), i, dtype=torch.int32, device=DEV), c, device=DEV)
            r = max(r, worst_rel(lg[:, 0], full[:, i]))
        return r, "prefill 128 + decode 8 vs forward 256 at positions 128-135"
    _, c = lm.prefill(cfg, params, t256[:, :255], s_max=256, device=DEV)
    lg, _ = lm.decode_step(cfg, params, t256[:, 255:], torch.full(
        (1,), 255, dtype=torch.int32, device=DEV), c, device=DEV)
    full, _ = lm.prefill(cfg, params, t256, device=DEV)
    return worst_rel(lg, full), "prefill 255 + decode 1 vs prefill 256"


def compare_layers(torch, lm, cfg, params, tokens) -> tuple[float, float]:
    """Each layer of the prefill through the kernels and through the plain
    versions on the same input, the kernel path's: the worst relative
    difference of a layer's output (the residual stream after it) and of
    a cache field."""
    from repro_torch.models.common import embed_tokens

    plain = cfg.replace(attn_impl="xla")
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=DEV)[None].expand(b, s)
    x = embed_tokens(cfg, params["embed"], tokens)
    worst_y = worst_c = 0.0
    for spec, p in zip(lm.layer_specs(cfg), params["blocks"]):
        out_k, c_k, _ = lm._apply_layer(cfg, spec, p, x, positions, None,
                                        "prefill", None)
        out_p, c_p, _ = lm._apply_layer(plain, spec, p, x, positions, None,
                                        "prefill", None)
        worst_y = max(worst_y, worst_rel(out_k, out_p))
        worst_c = max(worst_c, states_rel([c_k], [c_p]))
        x = out_k
    return worst_y, worst_c


# ---------------------------------------------------------------- phase 12 --
def check_golden(m, cases, what: str) -> None:
    m = type(m)(*(x.cpu().numpy() for x in m))
    for i, c in enumerate(cases):
        for field, want in c["metrics"].items():
            got = np.asarray(getattr(m, field)[i]).reshape(-1)
            if not np.array_equal(got, np.asarray(want).reshape(-1)):
                raise AssertionError(f"golden {i} ({c['policy']}) {field} "
                                     f"differs {what}")


def run_fused(torch, tf, sw, staged_busy_ms: float, cfg, policies, loads,
              seeds) -> None:
    """Phase 12: the fused backend, each block of ticks replayed from a CUDA
    graph: the goldens, phase 4's sweep (``sw``, its staged run) and
    ``cross_validate``."""
    from repro_torch.fleetsim import engine, fused
    from repro_torch.fleetsim.options import EngineOptions
    from repro_torch.fleetsim.sweep import plan_grid
    from repro_torch.fleetsim.validate import cross_validate_spec
    from repro_torch.scenarios import load_any

    # (a) the goldens under every filter backend, and with a tail (K = 300:
    # the tail's code is the backends' shared stage code) under B2; B1's
    # and vectorized's K = 300 runs were cut for phases 19-20
    for backend in ("tickfuse", "pallas", "vectorized"):
        for k in ((512, 300) if backend == "tickfuse" else (512,)):
            cfg_g, cases, params = golden_batch(tf, backend)
            st = fused.GraphStats()
            t0 = time.perf_counter()
            m, ran = engine.run(cfg_g, params, "cuda", EngineOptions(
                backend="fused", ticks_per_chunk=k), st)
            check_golden(m, cases, f"under fused {backend} K={k}")
            dt = time.perf_counter() - t0
            if ran != "fused" or st.replays == 0:
                raise AssertionError(f"phase 12: {backend} K={k} ran {ran} "
                                     f"with {st.replays} graph replays")
            log(f"phase 12: goldens under fused, {backend}, K={k}: 6 cases "
                f"x 16 fields bit-exact ({cfg_g.n_ticks} ticks, {dt:.2f} s; "
                f"graph of {st.ticks} ticks replayed {st.replays} times, "
                f"warm-up {st.warmup_s:.3f} s, capture {st.capture_s:.3f} s, "
                f"instantiate {st.instantiate_s:.3f} s)")

    # (b) phase 4's sweep on the fused backend, bit-identical to the staged
    fz = tf.sweep_grid(cfg.service, policies, loads, seeds, cfg=cfg,
                       engine=EngineOptions(backend="fused"))
    if fz.backend != "fused" or len(fz.results) != len(sw.results):
        raise AssertionError(f"phase 12: the sweep ran {fz.backend}")
    for a, b in zip(fz.results, sw.results):
        # every field, floats by their exact repr (NaN equal to NaN)
        if json.dumps(a.__dict__) != json.dumps(b.__dict__):
            raise AssertionError(f"phase 12: fused row {a.row()} != staged "
                                 f"{b.row()}")
    if not np.array_equal(fz.grid_hist, sw.grid_hist):
        raise AssertionError("phase 12: fused grid histogram != staged")
    log(f"phase 12: {fz.n_configs} configs x {cfg.n_ticks} ticks under "
        f"fused: all {len(fz.results)} rows and the grid histogram "
        f"bit-identical to phase 4's staged sweep")
    # the fused sweep timed over FUSED_SWEEP_TICKS, where the staged tail
    # (n_ticks mod 64) is a small share of the run
    cfg = replace(cfg, n_ticks=FUSED_SWEEP_TICKS)
    fz = tf.sweep_grid(cfg.service, policies, loads, seeds, cfg=cfg,
                       engine=EngineOptions(backend="fused"))
    if fz.backend != "fused":
        raise AssertionError(f"phase 12: the timed sweep ran {fz.backend}")
    n_ticks = cfg.n_ticks
    cticks = fz.n_configs * n_ticks
    staged_ms = sw.wall_clock_s / SWEEP_TICKS * 1e3
    fused_ms = fz.wall_clock_s / n_ticks * 1e3
    g = fz.graph
    log(f"phase 12: fused, {fz.n_configs} configs x {n_ticks} ticks "
        f"{fz.wall_clock_s:.2f} s: {cticks / fz.wall_clock_s:.1f} "
        f"config-ticks/s, {fused_ms:.3f} ms/tick (graph set-up apart: "
        f"{fz.compile_s:.3f} s); staged (phase 4, {SWEEP_TICKS} ticks) "
        f"{sw.wall_clock_s:.2f} s: "
        f"{sw.n_configs * SWEEP_TICKS / sw.wall_clock_s:.1f} config-ticks/s, "
        f"{staged_ms:.3f} ms/tick; {staged_ms / fused_ms:.2f}x")
    log(f"phase 12: graph of {g.ticks} ticks replayed {g.replays} times; "
        f"warm-up {g.warmup_s:.3f} s, capture {g.capture_s:.3f} s, "
        f"instantiate {g.instantiate_s:.3f} s; "
        f"{n_ticks - g.replays * g.ticks} ticks on the staged loop")

    # where a replayed tick's time goes: a profile of graph replays on the
    # same grid, after one marker kernel (a session can miss its first
    # kernels; the marker's 1 of ~670 x 512 launches is counted in);
    # B2's launches counted by the profiler.  The profiled run is long
    # enough for every session profile_replays may take, whatever the
    # sweep's cut length
    cfg_k, _, _, params = plan_grid(
        cfg.service, policies, loads, seeds,
        cfg=replace(cfg, n_ticks=max(cfg.n_ticks, PROFILE_RUN_TICKS)))
    params, _ = engine.batched_params(params, torch.device("cuda"))
    state, step, n_raw = engine.init_run(cfg_k, params)
    blocks = fused.TickBlocks(cfg_k, step, n_raw, state, g.ticks)
    prof, ticks, sessions = profile_replays(
        torch, blocks, SWEEP_PROFILE_REPLAYS, "tickfuse_response_path",
        "phase 12")
    n_b2 = launches_in(prof, "tickfuse_response_path")
    busy_ms = sum(us for _, us in prof.values()) / 1e3 / ticks
    n_launch = sum(n for n, _ in prof.values()) / ticks
    b2_us = device_us_per_launch(prof,
                                 DEVICE_SYMBOL["tickfuse_response_path"])
    log(f"phase 12: profile of {SWEEP_PROFILE_REPLAYS} replays ({ticks} "
        f"ticks, profiler session {sessions}): B2 launches {n_b2} (= ticks "
        f"replayed, counted by the profiler), "
        f"{n_launch:.1f} kernels per tick, {busy_ms:.3f} ms device busy per "
        f"tick of {fused_ms:.3f} ms wall (unprofiled sweep): device idle "
        f"{100 * (1 - busy_ms / fused_ms):.1f}% (staged, phase 4: "
        f"{staged_busy_ms:.3f} of {staged_ms:.3f} ms, idle "
        f"{100 * (1 - staged_busy_ms / staged_ms):.1f}%); B2 {b2_us:.3f} us "
        f"per launch")
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
    for key, (n, us) in top:
        log(f"phase 12:   {us / 1e3 / ticks:.4f} ms/tick "
            f"{n / ticks:.0f} launches/tick  {key[:90]}")
    del blocks, state

    # (c) cross_validate_spec over validate_grid.json: the seven two-engine
    # policies (laedge and hedge through the optional stages) x 3 loads as
    # one G = 21 batch on the fused backend, each point beside its DES run
    ref_rows = {}
    if XVAL_REFERENCE.is_file():
        for c in json.loads(XVAL_REFERENCE.read_text())["checks"]:
            ref_rows[(c["policy"], c["load"])] = c
    spec = load_any("validate_grid")
    report = {}
    t0 = time.perf_counter()
    checks = cross_validate_spec(spec, n_requests=XVAL_REQUESTS,
                                 report=report)
    dt = time.perf_counter() - t0
    fl = report["fleet"]
    n_same = 0
    for c in checks:
        log("phase 12: " + ("[PASS] " if c.ok else "[FAIL] ") + c.describe())
        ref = ref_rows.get((c.policy, c.load))
        if ref is not None:
            same = all(ref[k] == v for k, v in c.__dict__.items())
            n_same += same
            log(f"phase 12:   reference (CPU): {ref['detail']}"
                + ("  [every field equal]" if same else ""))
    log(f"phase 12: cross_validate_spec(validate_grid): "
        f"{sum(c.ok for c in checks)}/{len(checks)} points within "
        f"tolerance in {dt:.1f} s, {n_same}/{len(ref_rows)} rows equal to "
        f"the reference's in every field: FleetSim {fl.n_configs} configs "
        f"x {report['n_ticks']} ticks on {fl.backend} in "
        f"{fl.wall_clock_s:.1f} s "
        f"({fl.wall_clock_s / report['n_ticks'] * 1e3:.3f} ms a tick; "
        f"graph set-up {fl.compile_s:.2f} s, {fl.graph.replays} replays of "
        f"{fl.graph.ticks} ticks), DES {report['des_s']:.1f} s on the host "
        f"({XVAL_REQUESTS} requests a point)")
    if len(checks) != 21 or fl.backend != "fused":
        raise AssertionError(f"phase 12: {len(checks)} points on "
                             f"{fl.backend}, expected 21 on fused")
    if not all(c.ok for c in checks):
        raise AssertionError("phase 12: a cross-validation point is out of "
                             "tolerance")


# ---------------------------------------------------------------- phase 13 --
def staged_window(torch, tf, ops, kernels, cfg, params, kernel: str,
                  what: str) -> float:
    """Run a batched run's first ``STAGED_WINDOW`` ticks on the staged loop,
    where the wrappers count every launch (the counts set to 0 just
    before, read just after: ``kernel`` once a tick, nothing else), and
    hold the state to the same ticks replayed from CUDA graphs.  Returns
    the staged ms a tick."""
    from repro_torch.fleetsim import engine

    state, step, n_raw = engine.init_run(cfg, params)
    reset(kernels)
    ops.tickfuse_masked.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = engine.advance(cfg, state, step, n_raw, 0, STAGED_WINDOW)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / STAGED_WINDOW * 1e3
    counts = {n: fn.launches for n, fn in kernels.items()}
    if counts != only(kernels, **{kernel: STAGED_WINDOW}):
        raise AssertionError(f"{what}: staged launches {counts}, "
                             f"expected {STAGED_WINDOW} of {kernel}")
    assert_same_state(tf, state, replayed_state(cfg, params, STAGED_WINDOW),
                      f"{what}: replayed != staged")
    return ms


def replay_profile(torch, cfg, params, what: str, fused_ms: float,
                   kernel: str) -> None:
    """Phase 13 (g): a profile of graph replays of a run's 64-tick block:
    ``kernel``'s launches (the profiler's count, one a tick), kernels and
    device busy a tick, and the idle share against the run's own fused ms
    a tick."""
    from repro_torch.fleetsim import engine, fused

    state, step, n_raw = engine.init_run(cfg, params)
    blocks = fused.TickBlocks(cfg, step, n_raw, state, fused.GRAPH_TICKS)
    prof, ticks, sessions = profile_replays(
        torch, blocks, STAGE_PROFILE_REPLAYS, kernel, f"phase 13: {what}")
    n_k = launches_in(prof, kernel)
    busy_ms = sum(us for _, us in prof.values()) / 1e3 / ticks
    n_launch = sum(n for n, _ in prof.values()) / ticks
    log(f"phase 13: {what}: profile of {STAGE_PROFILE_REPLAYS} replays "
        f"({ticks} ticks, profiler session {sessions}): {kernel} launches "
        f"{n_k} (= ticks replayed, counted by the profiler), "
        f"{n_launch:.1f} kernels per tick, {busy_ms:.3f} ms "
        f"device busy per tick of {fused_ms:.3f} ms wall: device idle "
        f"{100 * (1 - busy_ms / fused_ms):.1f}%; "
        f"{device_us_per_launch(prof, DEVICE_SYMBOL[kernel]):.3f} us per "
        f"{kernel} launch")
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:4]
    for key, (n, us) in top:
        log(f"phase 13:   {us / 1e3 / ticks:.4f} ms/tick "
            f"{n / ticks:.0f} launches/tick  {key[:90]}")


def torch_equal(x, y) -> bool:
    return x.shape == y.shape and bool((x == y).all())


def run_scenario_layer(torch, tf, kernels, ops) -> None:
    """Phase 13: the Scenario layer and the optional stages on the card."""
    import contextlib
    import io

    from repro_torch.fleetsim import engine, fused
    from repro_torch.fleetsim.sweep import plan_grid
    from repro_torch.scenarios import Scenario, SweepSpec, load_any, \
        scenario_library
    from repro_torch.scenarios.__main__ import main as scenarios_main

    cuda = torch.device("cuda")
    t_phase = time.perf_counter()

    # (a) the CLI's listing, and every library file round-trips
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = scenarios_main(["--list"])
    lib = scenario_library()
    missing = [n for n in ["laedge", "hedge", *lib] if n not in buf.getvalue()]
    if rc != 0 or missing or len(lib) != 8:
        raise AssertionError(f"phase 13: --list rc {rc}, missing {missing}")
    for name in lib:
        obj = load_any(name)
        if type(obj).from_json(json.loads(json.dumps(obj.to_json()))) != obj:
            raise AssertionError(f"phase 13: {name} does not round-trip")
    log(f"phase 13: --list names the 8 registered policies and {len(lib)} "
        f"library files; every file round-trips through JSON "
        f"({time.perf_counter() - t_phase:.1f} s)")

    # (b) the golden scenario file through Scenario, fused on the card
    g = json.loads(GOLDEN.read_text())
    case = next(c for c in g["cases"]
                if c["policy"] == "netclone" and c["seed"] == 0)
    st = fused.GraphStats()
    _, m = Scenario.from_file("golden_single_tor").fleet_metrics(
        device=cuda, stats=st)
    for field, want in case["metrics"].items():
        got = getattr(m, field).cpu().numpy().reshape(-1)
        if not np.array_equal(got, np.asarray(want).reshape(-1)):
            raise AssertionError(f"phase 13: golden_single_tor {field}")
    if st.replays == 0:
        raise AssertionError("phase 13: the golden scenario replayed no graph")
    log(f"phase 13: golden_single_tor.json through Scenario: 16 fields "
        f"bit-identical to tests/golden/fleetsim_single_tor.json (fused, "
        f"{st.replays} graph replays; {time.perf_counter() - t_phase:.1f} s "
        f"into the phase)")

    def scenario_pair(sc, backend, **over):
        """The scenario under ``backend`` and under ``vectorized``, fused:
        ``(cfg, metrics, fused ms a tick)`` of the kernel run."""
        out = {}
        for fb in (backend, "vectorized"):
            st = fused.GraphStats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cfg, m = sc.fleet_metrics(device=cuda, stats=st,
                                      filter_backend=fb, **over)
            wall = time.perf_counter() - t0 - st.setup_s
            if st.replays == 0:
                raise AssertionError(f"phase 13: {sc.name} {fb} replayed "
                                     "no graph")
            out[fb] = (cfg, m, wall / cfg.n_ticks * 1e3, st)
        cfg, m, ms, st = out[backend]
        for name, x, y in zip(m._fields, m, out["vectorized"][1]):
            if not torch_equal(x, y):
                raise AssertionError(f"phase 13: {sc.name}: {backend} != "
                                     f"vectorized at {name}")
        return cfg, m, ms, st

    # (c) LÆDGE, one rack of 4 x 8 at load 0.5, under B2
    lae = Scenario(name="laedge_1rack", policy="laedge", load=0.5, servers=4,
                   workers=8, n_ticks=LAEDGE_TICKS)
    cfg_c, m, lae_ms, st = scenario_pair(lae, "tickfuse")
    params_c, _ = engine.batched_params(lae.run_params(cfg_c), cuda)
    lae_staged_ms = staged_window(torch, tf, ops, kernels, cfg_c, params_c,
                                  "tickfuse_response_path",
                                  "phase 13: laedge 1 rack")
    log(f"phase 13: LÆDGE 1 rack (4 x 8, load 0.5, {LAEDGE_TICKS} ticks): "
        f"Metrics bit-identical under B2 (tickfuse) and vectorized, fused; "
        f"queued {int(m.n_coord_queued)}, ring overflow "
        f"{int(m.n_coord_overflow)}, completed {int(m.n_completed)}, clones "
        f"{int(m.n_cloned)} (its CPU saturates: no credit to clone), filtered "
        f"{int(m.n_filtered)} (all at the top tier: "
        f"{int(m.n_spine_filtered)}); the first {STAGED_WINDOW} ticks "
        f"staged ({STAGED_WINDOW} B2 launches counted by the wrapper) "
        f"equal to the same ticks replayed")
    log(f"phase 13: LÆDGE 1 rack: fused {lae_ms:.3f} ms/tick (graph set-up "
        f"{st.setup_s:.2f} s), staged {lae_staged_ms:.3f} ms/tick over "
        f"{STAGED_WINDOW} ticks: {lae_staged_ms / lae_ms:.2f}x")
    if int(m.n_coord_queued) == 0 or int(m.n_completed) == 0:
        raise AssertionError("phase 13: LÆDGE parked or completed nothing")

    log(f"phase 13: (c) done at {time.perf_counter() - t_phase:.1f} s")

    # (d) LÆDGE over 2 racks under B1: its pairs filter at the top tier,
    # table group RK (the spine's), which no always-on 1-rack run touches
    lae2 = Scenario(name="laedge_2rack", policy="laedge", load=0.1, racks=2,
                    servers=4, workers=8, n_ticks=LAEDGE_RACK_TICKS)
    cfg_d, m, ms, st = scenario_pair(lae2, "pallas")
    params_d, _ = engine.batched_params(lae2.run_params(cfg_d), cuda)
    staged_window(torch, tf, ops, kernels, cfg_d, params_d,
                  "fingerprint_filter", "phase 13: laedge 2 racks")
    n_f, n_spine = int(m.n_filtered), int(m.n_spine_filtered)
    log(f"phase 13: LÆDGE 2 racks (load 0.1, {LAEDGE_RACK_TICKS} ticks): "
        f"Metrics bit-identical under B1 (pallas) and vectorized, fused "
        f"({ms:.3f} ms/tick); clones {int(m.n_cloned)}, filtered {n_f}, of "
        f"them at frack = RK (the top tier) {n_spine}; the first "
        f"{STAGED_WINDOW} ticks staged ({STAGED_WINDOW} B1 launches "
        f"counted by the wrapper) equal to the same ticks replayed")
    if n_spine == 0 or n_spine != n_f:
        raise AssertionError(f"phase 13: LÆDGE 2 racks filtered {n_f}, "
                             f"{n_spine} at the top tier")

    log(f"phase 13: (d) done at {time.perf_counter() - t_phase:.1f} s")

    # (e) hedge_vs_netclone.json (G = 6) under B2 and vectorized
    spec = load_any("hedge_vs_netclone")
    sws = {}
    for fb in ("tickfuse", "vectorized"):
        sws[fb] = spec.run_fleetsim(device=cuda, n_ticks=HEDGE_TICKS,
                                    filter_backend=fb)
    sw = sws["tickfuse"]
    for a, b in zip(sw.results, sws["vectorized"].results):
        if json.dumps(a.__dict__) != json.dumps(b.__dict__):
            raise AssertionError(f"phase 13: hedge_vs_netclone row "
                                 f"{a.row()} != vectorized {b.row()}")
    if sw.backend != "fused" or len(sw.results) != 6:
        raise AssertionError(f"phase 13: hedge_vs_netclone ran "
                             f"{len(sw.results)} rows on {sw.backend}")
    hedge_ms = sw.wall_clock_s / HEDGE_TICKS * 1e3
    log(f"phase 13: hedge_vs_netclone.json, n_ticks cut from "
        f"{HEDGE_FULL_TICKS} to {HEDGE_TICKS} by the run's time limit: "
        f"all 6 rows bit-identical under B2 (tickfuse) and vectorized, "
        f"fused {hedge_ms:.3f} ms/tick (graph set-up {sw.compile_s:.2f} s)")
    for ld in spec.resolved_loads():
        p99 = {r.policy: r.p99_us for r in sw.select(load=ld)}
        log(f"phase 13:   load {ld}: p99_us hedge {p99['hedge']:.1f}, "
            f"netclone {p99['netclone']:.1f}, baseline "
            f"{p99['baseline']:.1f}")
    hg = sw.select(policy="hedge")[0]
    if not (hg.n_hedges_armed > 0 and hg.n_cloned > 0
            and math.isfinite(hg.p99_us)):
        raise AssertionError(f"phase 13: implausible hedge row {hg.row()}")
    base = spec.base
    cfg_e = base.fleet_config(n_ticks=HEDGE_TICKS, filter_backend="tickfuse")
    cfg_e, _, _, params_e = plan_grid(base.service, spec.resolved_policies(),
                                      spec.resolved_loads(),
                                      list(spec.seeds), cfg=cfg_e)
    params_e, _ = engine.batched_params(params_e, cuda)
    hedge_staged_ms = staged_window(torch, tf, ops, kernels, cfg_e, params_e,
                                    "tickfuse_response_path",
                                    "phase 13: hedge_vs_netclone")
    log(f"phase 13: hedge_vs_netclone: staged {hedge_staged_ms:.3f} ms/tick "
        f"over its first {STAGED_WINDOW} ticks ({STAGED_WINDOW} B2 launches "
        f"counted by the wrapper; equal to the same ticks replayed): "
        f"{hedge_staged_ms / hedge_ms:.2f}x the fused tick")

    log(f"phase 13: (e) done at {time.perf_counter() - t_phase:.1f} s")

    # (f) the hedge-delay axis: one batch, the wheel deepened to 150 us
    dsw = SweepSpec(base=base, policies=("netclone", "hedge"),
                    loads=spec.loads, seeds=spec.seeds,
                    hedge_delays=HEDGE_DELAYS).run_fleetsim(
                        device=cuda, n_ticks=DELAY_TICKS)
    if [r.hedge_delay_us for r in dsw.select(policy="hedge")] \
            != [d for _ in spec.loads for d in HEDGE_DELAYS]:
        raise AssertionError("phase 13: hedge_delays rows out of order")
    for ld in spec.loads:
        nc = dsw.select(policy="netclone", load=ld)[0]
        log(f"phase 13: hedge_delays sweep ({DELAY_TICKS} ticks, "
            f"{dsw.n_configs} configs on {dsw.backend}) load {ld}: p99_us "
            + ", ".join(f"{r.hedge_delay_us:g} us: {r.p99_us:.1f} "
                        f"({r.n_cloned} fired, {r.n_hedges_cancelled} "
                        "cancelled)"
                        for r in dsw.select(policy="hedge", load=ld))
            + f"; netclone {nc.p99_us:.1f}")
    if not all(math.isfinite(r.p99_us) for r in dsw.results):
        raise AssertionError("phase 13: a hedge_delays row completed nothing")

    log(f"phase 13: (f) done at {time.perf_counter() - t_phase:.1f} s")

    # (g) where the optional-stage tick's time goes: LÆDGE's (the hedge
    # tick's profile was cut for phases 19-20; its ms a tick stays in (e))
    replay_profile(torch, cfg_c, params_c, "LÆDGE 1 rack", lae_ms,
                   "tickfuse_response_path")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 14 --
def take(kernels, total: collections.Counter) -> None:
    """Add the wrappers' counts to ``total`` and set them to 0."""
    for n, fn in kernels.items():
        total[n] += fn.launches
    reset(kernels)


def telemetry_digest(tel) -> dict:
    """sha256 digests of one run's decoded telemetry, as
    ``tools/reference_serve.py`` computes them from the reference's: the
    event arrays (int32, in decode order) and the series' window rows."""
    import hashlib

    ev = tel.events
    h = hashlib.sha256()
    for name in ("tick", "kind", "rid", "server", "client", "arg"):
        h.update(np.ascontiguousarray(getattr(ev, name), np.int32).tobytes())
    rows = json.dumps(tel.series.rows(), sort_keys=True)
    return {"events_sha256": h.hexdigest(),
            "series_sha256": hashlib.sha256(rows.encode()).hexdigest()}


def scenario_row(sc, cfg, m):
    from repro_torch.fleetsim.metrics import summarize

    return summarize(cfg, m, policy=sc.policy,
                     load=sc.effective_load(cfg.n_ticks),
                     rate_per_us=sc.rate_per_us(cfg.n_ticks), seed=sc.seed)


def run_serve_sim(torch, tf, kernels, ops, get_config) -> dict:
    """Phase 14: ServeSim on the card.  Returns the launches of each
    wrapper over the phase (the counts set to 0 at its start; the fused
    runs count their kernels once, at capture)."""
    from repro_torch.analysis.roofline import n_params_active
    from repro_torch.fleetsim import engine, fused
    from repro_torch.fleetsim.llmserve import llm_service, serve_equivalence
    from repro_torch.fleetsim.options import EngineOptions
    from repro_torch.fleetsim.sweep import plan_grid
    from repro_torch.scenarios import load_any

    cuda = torch.device("cuda")
    ref = json.loads(SERVE_REFERENCE.read_text())
    t_phase = time.perf_counter()
    total = collections.Counter()
    reset(kernels)

    # (a) gemma-7b's service from its full config, counted on meta tensors
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    total_p, active_p = n_params_active(get_config("gemma-7b"))
    spec = llm_service("gemma-7b")
    if torch.cuda.memory_allocated() != mem0:
        raise AssertionError("phase 14: counting gemma-7b allocated memory")
    for name in LLM_FILES:
        if load_any(name).service.params != spec.params:
            raise AssertionError(f"phase 14: llm_service('gemma-7b') "
                                 f"{spec.params} != {name}'s params")
    log(f"phase 14: gemma-7b counted on the meta device: {total_p:.0f} "
        f"parameters, {active_p:.0f} active; llm_service('gemma-7b') = "
        f"{spec.params}, equal to both llm library files' params; device "
        f"memory allocated unchanged ({mem0} B)")

    # (b) the two llm library files at their full 4,000 ticks, fused,
    # under B2 (1 rack) and B1 (2 racks) against vectorized, each row equal
    # to the reference's CPU row; then a staged window held to its replay
    for name, backend, kernel in LLM_FILES_KERNELS:
        sc = load_any(name)
        out = {}
        for fb in (backend, "vectorized"):
            st = fused.GraphStats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cfg, m = sc.fleet_metrics(device=cuda, stats=st,
                                      filter_backend=fb)
            wall = time.perf_counter() - t0 - st.setup_s
            if st.replays == 0:
                raise AssertionError(f"phase 14: {name} {fb} replayed no "
                                     "graph")
            out[fb] = (cfg, m, wall / cfg.n_ticks * 1e3, st)
        cfg, m, ms, st = out[backend]
        for field, x, y in zip(m._fields, m, out["vectorized"][1]):
            if not torch_equal(x, y):
                raise AssertionError(f"phase 14: {name}: {backend} != "
                                     f"vectorized at {field}")
        row = scenario_row(sc, cfg, m)
        want = ref["llm_rows"][name]
        if json.dumps(row.__dict__) != json.dumps(want):
            raise AssertionError(f"phase 14: {name}: row {row.row()} != the "
                                 f"reference's {want}")
        params, _ = engine.batched_params(sc.run_params(cfg), cuda)
        take(kernels, total)
        staged_ms = staged_window(torch, tf, ops, kernels, cfg, params,
                                  kernel, f"phase 14: {name}")
        take(kernels, total)
        log(f"phase 14: {name} ({cfg.n_racks} x {cfg.n_servers} x "
            f"{cfg.n_slots} slots, {cfg.n_ticks} ticks of {cfg.dt_us} us): "
            f"Metrics bit-identical under {kernel} ({backend}) and "
            f"vectorized, fused ({ms:.3f} ms/tick, graph set-up "
            f"{st.setup_s:.2f} s); its row equals the reference's CPU row "
            f"in every field (completed {row.n_completed}, cloned "
            f"{row.n_cloned}, filtered {row.n_filtered}, p99 "
            f"{row.p99_us:.1f} us, slot occupancy "
            f"{row.mean_slot_occupancy:.3f}); the first {STAGED_WINDOW} "
            f"ticks staged ({STAGED_WINDOW} {kernel} launches counted by the "
            f"wrapper, {staged_ms:.3f} ms/tick) equal to the same ticks "
            f"replayed")
    # llm_gemma7b at batch_coupling LLM_COUPLING: the slots' speed falls
    # with occupancy, so the stage's float path (speed, REM - dt * speed)
    # decides every completion; at coupling 0 it is exactly 1
    sc = replace(load_any("llm_gemma7b"), batch_coupling=LLM_COUPLING)
    out = {}
    for fb in ("tickfuse", "vectorized"):
        st = fused.GraphStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg, m = sc.fleet_metrics(device=cuda, stats=st, filter_backend=fb)
        wall = time.perf_counter() - t0 - st.setup_s
        if st.replays == 0:
            raise AssertionError(f"phase 14: coupled {fb} replayed no graph")
        out[fb] = (m, wall / cfg.n_ticks * 1e3)
    m, ms = out["tickfuse"]
    for field, x, y in zip(m._fields, m, out["vectorized"][0]):
        if not torch_equal(x, y):
            raise AssertionError(f"phase 14: coupled llm_gemma7b: tickfuse "
                                 f"!= vectorized at {field}")
    row = scenario_row(sc, cfg, m)
    want = ref["coupled_rows"][f"llm_gemma7b@{LLM_COUPLING}"]
    if json.dumps(row.__dict__) != json.dumps(want):
        raise AssertionError(f"phase 14: coupled llm_gemma7b: row "
                             f"{row.row()} != the reference's {want}")
    log(f"phase 14: llm_gemma7b at batch_coupling {LLM_COUPLING} "
        f"({cfg.n_ticks} ticks): Metrics bit-identical under "
        f"tickfuse_response_path (tickfuse) and vectorized, fused ({ms:.3f} "
        f"ms/tick); its row equals the reference's CPU row in every field "
        f"(completed {row.n_completed}, cloned {row.n_cloned}, p99 "
        f"{row.p99_us:.1f} us, slot occupancy "
        f"{row.mean_slot_occupancy:.3f})")
    take(kernels, total)
    log(f"phase 14: (b) done at {time.perf_counter() - t_phase:.1f} s")

    # (c) a 200-config batch sweep on llm_gemma7b's cluster and service
    base = load_any("llm_gemma7b")
    cfg = base.fleet_config(filter_backend="tickfuse")
    sw = tf.sweep_grid(cfg.service, SWEEP_POLICIES, SWEEP_LOADS,
                       SWEEP_SEEDS, cfg=cfg,
                       engine=EngineOptions(backend="fused"))
    take(kernels, total)
    if sw.backend != "fused" or sw.n_configs != 200:
        raise AssertionError(f"phase 14: the batch sweep ran {sw.n_configs} "
                             f"configs on {sw.backend}")
    for r in sw.results:
        if not (0 < r.n_completed <= r.n_arrivals + r.n_dedup_evicted
                and 0 < r.mean_slot_occupancy <= 1):
            raise AssertionError(f"phase 14: implausible row {r.row()}")
    n_ticks = cfg.n_ticks
    ms = sw.wall_clock_s / n_ticks * 1e3
    log(f"phase 14: batch sweep, {sw.n_configs} configs x {n_ticks} ticks "
        f"fused through B2: {sw.wall_clock_s:.2f} s, "
        f"{sw.n_configs * n_ticks / sw.wall_clock_s:.1f} config-ticks/s, "
        f"{ms:.3f} ms/tick (graph set-up {sw.compile_s:.2f} s, "
        f"{sw.graph.replays} replays of {sw.graph.ticks} ticks)")
    for p in SWEEP_POLICIES:
        rs = [r for r in sw.select(policy=p) if r.seed == 0]
        log("phase 14:   " + p + " p99_ms / occupancy by load: "
            + ", ".join(f"{r.offered_load}:{r.p99_us / 1e3:.0f}/"
                        f"{r.mean_slot_occupancy:.2f}" for r in rs))
    cfg_k, _, _, params = plan_grid(cfg.service, SWEEP_POLICIES, SWEEP_LOADS,
                                    SWEEP_SEEDS, cfg=cfg)
    params, _ = engine.batched_params(params, cuda)
    st_k = replayed_state(cfg_k, params, BATCH_CHECK_TICKS)
    st_v = replayed_state(replace(cfg_k, filter_backend="vectorized"),
                          params, BATCH_CHECK_TICKS)
    assert_same_state(tf, st_k, st_v, "phase 14: batch sweep, tickfuse != "
                                      "vectorized")
    take(kernels, total)
    state, step, n_raw = engine.init_run(cfg_k, params)
    blocks = fused.TickBlocks(cfg_k, step, n_raw, state, sw.graph.ticks)
    prof, ticks, sessions = profile_replays(
        torch, blocks, SWEEP_PROFILE_REPLAYS, "tickfuse_response_path",
        "phase 14")
    take(kernels, total)
    busy_ms = sum(us for _, us in prof.values()) / 1e3 / ticks
    n_launch = sum(n for n, _ in prof.values()) / ticks
    log(f"phase 14: batch sweep: first {BATCH_CHECK_TICKS} ticks under "
        f"vectorized bit-equal to tickfuse (whole state, both replayed); "
        f"profile of {SWEEP_PROFILE_REPLAYS} replays ({ticks} ticks, profiler "
        f"session {sessions}): B2 launches "
        f"{launches_in(prof, 'tickfuse_response_path')} (= ticks replayed), "
        f"{n_launch:.1f} kernels per tick, {busy_ms:.3f} ms device busy per "
        f"tick of {ms:.3f} ms wall: device idle "
        f"{100 * (1 - busy_ms / ms):.1f}%")
    del blocks, state
    log(f"phase 14: (c) done at {time.perf_counter() - t_phase:.1f} s")

    # (d) serve_equivalence at the reference's defaults, replicas on the
    # card; the wrappers count the oracle's launches (B1: the dispatcher's
    # filter on every netclone tick with completions)
    take(kernels, total)
    if ref["serve_ticks"] != SERVE_TICKS:
        raise AssertionError("phase 14: the reference's serve rows are not "
                             f"at a {SERVE_TICKS}-tick horizon")
    stats = {}
    t0 = time.perf_counter()
    checks = serve_equivalence(horizon=SERVE_TICKS, device=cuda,
                               stats=stats)
    dt = time.perf_counter() - t0
    serve_counts = {n: fn.launches for n, fn in kernels.items()}
    take(kernels, total)
    want = ref["serve_checks"]
    if len(checks) != len(want):
        raise AssertionError(f"phase 14: {len(checks)} serve checks, the "
                             f"reference has {len(want)}")
    for c, w in zip(checks, want):
        log("phase 14: " + ("[PASS] " if c.ok else "[FAIL] ") + c.describe())
        if not all(w[k] == v for k, v in c.__dict__.items()):
            raise AssertionError(f"phase 14: serve check {c.__dict__} != the "
                                 f"reference's {w}")
    if not all(c.ok for c in checks):
        raise AssertionError("phase 14: a serve check is out of tolerance")
    steps = stats["decode_steps"]
    log(f"phase 14: serve_equivalence (qwen2.5-3b smoke replicas, 3 x 2 "
        f"slots, horizon {SERVE_TICKS}): "
        f"{len(checks)}/{len(checks)} checks ok and "
        f"equal to the reference's rows in every field; {dt:.1f} s, oracle "
        f"{stats['oracle_s']:.1f} s for {steps} decode steps "
        f"({stats['oracle_s'] / steps * 1e3:.3f} ms a step, dispatcher "
        f"included), FleetSim {stats['fleet_s']:.1f} s; launches "
        f"{serve_counts} (B3: none, the replicas prefill token by token "
        f"through decode_step)")
    if serve_counts["fingerprint_filter"] == 0:
        raise AssertionError("phase 14: the oracle's dispatcher launched no "
                             "B1")
    log(f"phase 14: launches over the phase {dict(total)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    for n in ("fingerprint_filter", "tickfuse_response_path"):
        if total[n] == 0:
            raise AssertionError(f"phase 14 launched no {n}")
    return dict(total)


# ---------------------------------------------------------------- phase 15 --
def run_telemetry(torch, tf, kernels, ops) -> dict:
    """Phase 15: FleetScope telemetry on the card: ``trace_burst`` staged
    with telemetry on under B2, against its telemetry-off fused run and
    the reference's decoded trace."""
    import tempfile

    from repro_torch.fleetsim import engine, fused
    from repro_torch.fleetsim.options import EngineOptions
    from repro_torch.fleetsim.telemetry import (
        TelemetrySpec,
        decode_run,
        write_run,
    )
    from repro_torch.scenarios import load_any

    cuda = torch.device("cuda")
    ref_all = json.loads(SERVE_REFERENCE.read_text())
    ref = ref_all["trace_burst"]
    if ref_all["trace_ticks"] != TRACE_TICKS:
        raise AssertionError("phase 15: the reference's rows are not at "
                             f"{TRACE_TICKS} ticks")
    t_phase = time.perf_counter()
    sc = load_any("trace_burst")

    # telemetry off, fused (auto on the card)
    st = fused.GraphStats()
    cfg_off, m_off = sc.fleet_metrics(device=cuda, stats=st,
                                      n_ticks=TRACE_TICKS)
    if st.replays == 0:
        raise AssertionError("phase 15: the telemetry-off run replayed no "
                             "graph")
    # telemetry on, staged, through B2's staged entry point
    sc_on = replace(sc, telemetry=TelemetrySpec())
    cfg_on = sc_on.fleet_config(n_ticks=TRACE_TICKS,
                                filter_backend="tickfuse")
    params = sc_on.run_params(cfg_on)
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_on, trace, series = engine.simulate(
        cfg_on, params, device=cuda, options=EngineOptions(telemetry=True))
    torch.cuda.synchronize()
    on_ms = (time.perf_counter() - t0) / TRACE_TICKS * 1e3
    counts = {n: fn.launches for n, fn in kernels.items()}
    if counts != only(kernels, tickfuse_response_path=TRACE_TICKS):
        raise AssertionError(f"phase 15: launches {counts}, expected "
                             f"{TRACE_TICKS} of tickfuse_response_path")
    for field, x, y in zip(m_on._fields, m_on, m_off):
        if not torch_equal(x, y):
            raise AssertionError(f"phase 15: telemetry on (staged, B2) != "
                                 f"off (fused, vectorized) at {field}")
    tel = decode_run(cfg_on, trace, series)
    ev = tel.events
    kinds = ev.counts_by_kind()
    recon = {"arrival": m_on.n_arrivals, "clone": m_on.n_cloned,
             "server_finish": m_on.n_resp, "filter_drop": m_on.n_filtered,
             "client_complete": m_on.n_completed}
    for kind, counter in recon.items():
        if kinds.get(kind, 0) != int(counter):
            raise AssertionError(f"phase 15: {kinds.get(kind, 0)} {kind} "
                                 f"events against the counter's "
                                 f"{int(counter)}")
    digest = telemetry_digest(tel)
    row = scenario_row(sc, cfg_on, m_on)
    got = {"n_events": len(ev), "n_lost": ev.n_lost,
           "events_by_kind": kinds, "n_windows": tel.series.n_windows,
           **digest}
    for k, v in got.items():
        if ref[k] != v:
            raise AssertionError(f"phase 15: {k} {v} != the reference's "
                                 f"{ref[k]}")
    if json.dumps(row.__dict__) != json.dumps(ref["row"]):
        raise AssertionError(f"phase 15: row {row.row()} != the "
                             f"reference's")
    with tempfile.TemporaryDirectory() as d:
        paths = write_run(d, sc.name, tel, summary=row.row())
        sizes = {k: p.stat().st_size for k, p in paths.items()}
    # the same ticks staged without telemetry, through B2, for the cost
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_st = engine.simulate(replace(cfg_on, telemetry=False), params,
                           device=cuda, options=EngineOptions(
                               backend="staged"))
    torch.cuda.synchronize()
    off_ms = (time.perf_counter() - t0) / TRACE_TICKS * 1e3
    if not all(torch_equal(x, y) for x, y in zip(m_st, m_on)):
        raise AssertionError("phase 15: staged telemetry-off != on")
    log(f"phase 15: trace_burst, n_ticks cut from 40000 to {TRACE_TICKS}: "
        f"Metrics with telemetry on (staged, B2, {TRACE_TICKS} launches "
        f"counted by the wrapper) bit-identical to telemetry off (fused, "
        f"vectorized, {st.replays} graph replays) and to off staged; "
        f"{len(ev)} events ({ev.n_lost} lost) {kinds} reconcile with the "
        f"counters; events and series digests, counts and the row equal "
        f"the reference's ({digest['events_sha256'][:16]}, "
        f"{digest['series_sha256'][:16]}); write_run's bundle {sizes} B")
    log(f"phase 15: staged ms/tick with telemetry {on_ms:.3f}, without "
        f"{off_ms:.3f} ({100 * (on_ms / off_ms - 1):+.1f}%); "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


# ----------------------------------------------------------- phases 16-18 --
def check_attention_case(torch, ref, ops, case, label, seed):
    """B3 against its plain version at ``case`` (contiguous and as the
    model's transposed views), then timed beside its bound, its plain
    version and SDPA; returns the row."""
    import torch.nn.functional as F

    causal, window, dtype = case[5:8]
    err = 0.0
    for transposed in (False, True):
        q, k, v = qkv_on_card(torch, case, seed, transposed=transposed)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        d = (got.float() - want.float()).abs().max().item()
        if not d <= FA_TOL[dtype]:
            raise AssertionError(f"{label}: B3 differs from its plain "
                                 f"version by {d} at {case}"
                                 f"{' (transposed views)' if transposed else ''}")
        err = max(err, d)
        del got, want
    q, k, v = qkv_on_card(torch, case, seed)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal), 20)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=causal), 3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=k.shape[1] < q.shape[1]), 20)
    bound, by, flops, nbytes = attention_bound(case)
    sq, skv = seq_lens(case)
    log(f"{label}: B3 vs plain at q {tuple(q.shape)} k/v {tuple(k.shape)} "
        f"{dtype} {'causal' if causal else 'non-causal'} (Sq {sq}, Skv "
        f"{skv}; contiguous and transposed views): max |diff| {err:.3g} "
        f"(tolerance {FA_TOL[dtype]}); {ms:.4f} ms per call (CUDA events "
        f"over 20 calls), bound {bound:.5f} ms ({by}: {flops:.4g} FLOP, "
        f"{nbytes} B) = {100 * bound / ms:.2f}% of it; plain "
        f"{plain_ms:.4f} ms; SDPA {library_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err, library_ms=library_ms)


def build_cast(torch, lm, family, cfg, label):
    """``cfg``'s weights, random from seed 0 in float32, each layer cast
    to bf16 as it is drawn (``init_params(cast=True)``), after freeing the
    cache; logs the peak device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cfg.arch_type == "encdec":
        params = lm.cast_params(cfg, family.init_params(cfg, 0, device=DEV))
    else:
        params = lm.init_params(cfg, 0, device=DEV, cast=True)
    torch.cuda.synchronize()
    log(f"{label}: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_params():,} parameters, random init (seed "
        f"0) in {cfg.param_dtype}, each layer cast to {cfg.dtype} as drawn "
        f"({time.perf_counter() - t0:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, held "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB)")
    return params


def compare_moe_layers(torch, lm, cfg, params, tokens):
    """Each layer of a MoE model's prefill on the same input (the kernel
    path's), through B3 and through the plain attention.  Returns the
    worst relative difference of the attention sublayer's output (the
    residual after attention: what B3 changes), of the whole layer's
    output, the tokens whose expert set differs between the two (summed
    over layers) and the widest top-k margin (k-th minus (k+1)-th router
    probability, kernel side) among them."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ffn
    from repro_torch.models.common import apply_norm, embed_tokens

    plain = cfg.replace(attn_impl="xla")
    b, s = tokens.shape
    k = cfg.moe.top_k
    positions = torch.arange(s, dtype=torch.int32,
                             device=DEV)[None].expand(b, s)
    x = embed_tokens(cfg, params["embed"], tokens)
    worst_a = worst_y = widest = 0.0
    moved = 0
    for spec, p in zip(lm.layer_specs(cfg), params["blocks"]):
        h = apply_norm(cfg, p["pre_norm"], x)
        a_k, a_p = (x + attn_mod.attention_forward(c, p["attn"], h,
                                                   positions)[0]
                    for c in (cfg, plain))
        worst_a = max(worst_a, worst_rel(a_k, a_p))
        if spec[1] == "moe":
            _, probs, _, ids_k, _ = ffn.route(
                cfg, p["moe"], apply_norm(cfg, p["post_norm"], a_k), True)
            ids_p = ffn.route(
                cfg, p["moe"], apply_norm(cfg, p["post_norm"], a_p), True)[3]
            differ = (ids_k.sort(-1).values
                      != ids_p.sort(-1).values).any(-1)
            moved += int(differ.sum())
            if differ.any():
                top = torch.sort(probs[differ], -1, descending=True).values
                widest = max(widest, (top[:, k - 1] - top[:, k]).max().item())
        out_k, out_p = (lm._apply_layer(c, spec, p, x, positions, None,
                                        "prefill", None)[0]
                        for c in (cfg, plain))
        worst_y = max(worst_y, worst_rel(out_k, out_p))
        x = out_k
    return worst_a, worst_y, moved, widest


def run_deepseek(torch, lm, kernels, get_config, arch, batch, label):
    """Phases 16-17: ``arch`` at full width and depth, bf16 activations:
    a ``batch`` x 4,096-token prefill (B3 launches counted: one a layer
    for MHA, none for MLA, which pins the plain attention), 16 decode
    steps (dropless routing, one token a group) and the consistency check
    (held in float32 activations, reported in bf16, as phase 11's).

    Where B3 ran, the prefill is held to the plain-attention prefill at
    what B3 changes: each layer's attention sublayer on the same input,
    and the float32-activation prefill's logits.  A MoE layer routes each
    token to its top k experts, a step function of the router logits: a
    token within rounding of a top-k tie can take another expert when the
    attention before it rounds differently, and carries another state
    from there on.  So the whole layers, the bf16 whole prefill and the
    float32 caches are reported beside the rerouted tokens and their
    widest top-k margin, not held."""
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    params = build_cast(torch, lm, None, cfg, label)
    n_fa = sum(k == "attn" for k in cfg.layer_kinds)
    g = torch.Generator(device=DEV).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, PREFILL_S),
                           generator=g, device=DEV)
    s_max = PREFILL_S + DECODE_STEPS
    lm.prefill(cfg, params, tokens[:, :256], s_max=256, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, params, tokens, s_max=s_max,
                                device=DEV)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in kernels.items()}
    if counts != only(kernels, flash_attention=n_fa):
        raise AssertionError(f"{label}: prefill launches {counts}, "
                             f"expected {n_fa} of B3")
    log(f"{label}: prefill {batch} x {PREFILL_S} tokens: "
        f"{prefill_s * 1e3:.1f} ms, {batch * PREFILL_S / prefill_s:,.0f} "
        f"tokens/s, B3 launches {counts['flash_attention']}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: non-finite prefill logits")
    if n_fa:
        r_a, r_y, moved, widest = compare_moe_layers(torch, lm, cfg, params,
                                                     tokens)
        n_moe = sum(f == "moe" for _, f in lm.layer_specs(cfg))
        log(f"{label}: B3 vs plain layer by layer on the same input ("
            f"{batch} x {PREFILL_S}, bf16): worst attention sublayer "
            f"{r_a:.3g} (tolerance {MODEL_RTOL}); worst whole layer "
            f"{r_y:.3g} (reported); {moved} of {batch * PREFILL_S * n_moe} "
            f"token-layer routings took another expert set, each within "
            f"{widest:.3g} of a top-{cfg.moe.top_k} tie")
        cfg32 = cfg.replace(dtype="float32")
        lg_k, c_k = lm.prefill(cfg32, params, tokens[:1], device=DEV)
        lg_p, c_p = lm.prefill(cfg32.replace(attn_impl="xla"), params,
                               tokens[:1], device=DEV)
        r32 = (worst_rel(lg_k, lg_p), states_rel(c_k, c_p))
        log(f"{label}: B3 vs plain prefill in float32 activations (1 x "
            f"{PREFILL_S}): logits {r32[0]:.3g} (tolerance {MODEL_RTOL}), "
            f"caches {r32[1]:.3g} (reported)")
        del lg_k, c_k, lg_p, c_p
        logits_p, caches_p = lm.prefill(cfg.replace(attn_impl="xla"),
                                        params, tokens, s_max=s_max,
                                        device=DEV)
        agree = (logits.argmax(-1) == logits_p.argmax(-1)).float().mean()
        log(f"{label}: B3 vs plain whole prefill in bf16 (reported): "
            f"logits {worst_rel(logits, logits_p):.3g}, KV caches "
            f"{states_rel(caches, caches_p):.3g}, argmax agreement "
            f"{agree.item():.2f}")
        del logits_p, caches_p
        if not (r_a <= MODEL_RTOL and r32[0] <= MODEL_RTOL):
            raise AssertionError(f"{label}: B3 prefill differs from the "
                                 "plain prefill")
    reset(kernels)
    caches = decode_steps(torch, lm, cfg, params, caches,
                          logits[:, -1].argmax(-1)[:, None], PREFILL_S,
                          DECODE_STEPS, label, profiled=1)
    if {n: fn.launches for n, fn in kernels.items()} != only(kernels):
        raise AssertionError(f"{label}: decode launched a kernel")
    del caches, logits
    for c_cfg in (cfg.replace(dtype="float32"), cfg):
        r, what = consistency(torch, lm, c_cfg, params, tokens[:1, :256])
        held = c_cfg.dtype == "float32"
        log(f"{label}: {what} in {c_cfg.dtype}: logits max |diff| / max "
            f"|logit| {r:.3g}" + (f" (tolerance {MODEL_RTOL})" if held
                                  else " (reported, not held)"))
        if held and not r <= MODEL_RTOL:
            raise AssertionError(f"{label}: decode disagrees with prefill")
    del params
    torch.cuda.empty_cache()
    log(f"{label}: {time.perf_counter() - t_phase:.1f} s")
    return counts["flash_attention"]


def run_whisper(torch, lm, kernels, get_config):
    """Phase 18: whisper-tiny at full width: a prefill of frames (4, 1500,
    384) and a 4 x 64-token prompt (12 B3 launches: 4 encoder, 4 causal
    self, 4 cross) held to the plain-attention prefill, 16 decode steps
    (4 B3 launches each: cross-attention at Sq = 1), each step's logits
    held to the plain path's, and prefill 63 + decode 1 against prefill
    64."""
    from repro_torch.models import whisper

    cfg = get_config("whisper-tiny")
    plain = cfg.replace(attn_impl="xla")
    params = build_cast(torch, lm, whisper, cfg, "phase 18")
    g = torch.Generator(device=DEV).manual_seed(1)
    frames = torch.randn((PREFILL_B, cfg.encoder.n_frames, cfg.d_model),
                         generator=g, device=DEV)
    tokens = torch.randint(0, cfg.vocab_size,
                           (PREFILL_B, WHISPER_PROMPT + DECODE_STEPS),
                           generator=g, device=DEV)
    prompt = tokens[:, :WHISPER_PROMPT]
    s_max = WHISPER_PROMPT + DECODE_STEPS
    whisper.prefill(cfg, params, frames, prompt, s_max, device=DEV)
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    logits, cache = whisper.prefill(cfg, params, frames, prompt, s_max,
                                    device=DEV)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n_fa = cfg.encoder.n_layers + 2 * cfg.n_layers
    counts = {n: fn.launches for n, fn in kernels.items()}
    if counts != only(kernels, flash_attention=n_fa):
        raise AssertionError(f"phase 18: prefill launches {counts}, "
                             f"expected {n_fa} of B3")
    logits_p, cache_p = whisper.prefill(plain, params, frames, prompt,
                                        s_max, device=DEV)
    r = (worst_rel(logits, logits_p),
         states_rel(cache.self_kv, cache_p.self_kv),
         max(worst_rel(a, b) for a, b in zip(cache.cross_k + cache.cross_v,
                                             cache_p.cross_k
                                             + cache_p.cross_v)))
    log(f"phase 18: prefill of frames {tuple(frames.shape)} and a "
        f"{PREFILL_B} x {WHISPER_PROMPT}-token prompt: "
        f"{prefill_s * 1e3:.1f} ms, B3 launches {counts['flash_attention']}"
        f"; vs the plain-attention prefill: logits {r[0]:.3g}, self KV "
        f"{r[1]:.3g}, cross K/V {r[2]:.3g} (tolerance {MODEL_RTOL})")
    if not (max(r) <= MODEL_RTOL and torch.isfinite(logits).all()):
        raise AssertionError("phase 18: B3 prefill differs from the plain "
                             "prefill")
    reset(kernels)
    worst, step_s = 0.0, []
    for i in range(DECODE_STEPS):
        tok = tokens[:, WHISPER_PROMPT + i:WHISPER_PROMPT + i + 1]
        pos = torch.full((PREFILL_B,), WHISPER_PROMPT + i,
                         dtype=torch.int32, device=DEV)
        t0 = time.perf_counter()
        logits, cache = whisper.decode_step(cfg, params, tok, pos, cache,
                                            device=DEV)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches = kernels["flash_attention"].launches
        logits_p, cache_p = whisper.decode_step(plain, params, tok, pos,
                                                cache_p, device=DEV)
        worst = max(worst, worst_rel(logits, logits_p))
        if launches != cfg.n_layers * (i + 1):
            raise AssertionError(f"phase 18: {launches} B3 launches after "
                                 f"{i + 1} decode steps")
    counts = {n: fn.launches for n, fn in kernels.items()}
    if counts != only(kernels, flash_attention=cfg.n_layers * DECODE_STEPS):
        raise AssertionError(f"phase 18: decode launches {counts}")
    log(f"phase 18: {DECODE_STEPS} decode steps (teacher-forced, batch "
        f"{PREFILL_B}): {1e3 * sum(step_s[1:]) / (len(step_s) - 1):.2f} ms "
        f"per step (host clock, steps 2-{DECODE_STEPS}), B3 launches "
        f"{counts['flash_attention']} ({cfg.n_layers} a step, Sq = 1 "
        f"against {cfg.encoder.n_frames} frames); logits vs the plain path "
        f"worst {worst:.3g} (tolerance {MODEL_RTOL})")
    if not worst <= MODEL_RTOL:
        raise AssertionError("phase 18: B3 decode differs from the plain "
                             "decode")
    n = WHISPER_PROMPT
    _, c = whisper.prefill(cfg, params, frames[:1], prompt[:1, :n - 1], n,
                           device=DEV)
    lg, _ = whisper.decode_step(cfg, params, prompt[:1, n - 1:], torch.full(
        (1,), n - 1, dtype=torch.int32, device=DEV), c, device=DEV)
    full, _ = whisper.prefill(cfg, params, frames[:1], prompt[:1], n,
                              device=DEV)
    r = worst_rel(lg, full)
    log(f"phase 18: prefill {n - 1} + decode 1 vs prefill {n}: logits max "
        f"|diff| / max |logit| {r:.3g} (tolerance {MODEL_RTOL})")
    if not r <= MODEL_RTOL:
        raise AssertionError("phase 18: decode disagrees with prefill")
    return n_fa


# ---------------------------------------------------------------- phase 19 --
def run_shard(torch, tf, sw, cfg, policies, loads, seeds) -> None:
    """Phase 19: the sharded runner on the card's one device: phase 4's
    200-config sweep (``sw``, staged, unsharded) again with
    ``shard=ShardSpec(devices=1)`` on the fused backend, every row and the
    merged histogram bit-identical; then ``shard_equivalence`` on
    ``validate_grid.json``'s SweepSpec.  One H100 holds one slab: a
    multi-device layout needs more cards."""
    from repro_torch.fleetsim.options import EngineOptions
    from repro_torch.fleetsim.validate import shard_equivalence
    from repro_torch.scenarios import load_any

    spec1 = tf.ShardSpec(devices=1)
    sh = tf.sweep_grid(cfg.service, policies, loads, seeds, cfg=cfg,
                       shard=spec1, engine=EngineOptions(backend="fused"))
    if (sh.backend != "fused" or sh.n_devices != 1 or sh.shard != spec1
            or len(sh.results) != len(sw.results)):
        raise AssertionError(f"phase 19: the sharded sweep ran {sh.backend} "
                             f"on {sh.n_devices} devices")
    for a, b in zip(sh.results, sw.results):
        if json.dumps(a.__dict__) != json.dumps(b.__dict__):
            raise AssertionError(f"phase 19: sharded row {a.row()} != "
                                 f"unsharded {b.row()}")
    if not np.array_equal(sh.grid_hist, sw.grid_hist):
        raise AssertionError("phase 19: the merged grid histogram differs")
    log(f"phase 19: {sh.n_configs} configs x {cfg.n_ticks} ticks sharded "
        f"over 1 device (the card's one H100; more need more cards) on the "
        f"fused backend: all {len(sh.results)} rows and the merged "
        f"grid_hist bit-identical to phase 4's unsharded sweep; "
        f"{sh.wall_clock_s / cfg.n_ticks * 1e3:.3f} ms a tick "
        f"({sh.n_configs * cfg.n_ticks / sh.wall_clock_s:.1f} config-ticks/s"
        f"), set-up (slab placement and graph capture) {sh.compile_s:.3f} s")
    spec = load_any("validate_grid")
    t0 = time.perf_counter()
    checks, hist_ok = shard_equivalence(spec, shard=1, n_ticks=SHARD_TICKS)
    dt = time.perf_counter() - t0
    log(f"phase 19: shard_equivalence(validate_grid, shard=1) at "
        f"{SHARD_TICKS} ticks: {sum(c.ok for c in checks)}/{len(checks)} "
        f"cells identical (counters exact, worst stat_rel "
        f"{max(c.stat_rel for c in checks):.3g}), grid_hist merge "
        f"{'equal' if hist_ok else 'DIFFERS'}, {dt:.1f} s for both runs")
    if len(checks) != 21 or not hist_ok or not all(c.ok for c in checks):
        raise AssertionError("phase 19: shard_equivalence failed: "
                             + "; ".join(c.describe() for c in checks
                                         if not c.ok))


# ---------------------------------------------------------------- phase 20 --
def bwd_bound(case) -> tuple[float, str, float, int]:
    """(bound ms, what bounds it, FLOPs, bytes) of B3's backward at
    ``case``: 2.5x the forward's FLOP over the pairs the mask keeps, at
    the bf16 tensor cores' rate (989 TFLOP/s) or float32's (67), against
    q, k, v, O and dO read once and dQ, dK, dV written once."""
    b, h, hkv, _, d, _, _, dtype = case[:8]
    sq, skv = seq_lens(case)
    flops = 2.5 * attention_bound(case)[2]
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * d * (4 * b * h * sq + 4 * b * hkv * skv)
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else SCALAR_OPS_PER_S
    ops_ms = flops / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def band_mask(torch, case):
    """SDPA's boolean mask (True takes part) for a windowed causal case."""
    sq, skv = seq_lens(case)
    i = torch.arange(sq, device=DEV)[:, None]
    j = torch.arange(skv, device=DEV)[None, :]
    return (j <= i) & (j >= i - case[6])


def check_attention_bwd(torch, ref, fa_mod, case, label, seed,
                        view="transposed"):
    """B3's backward kernel against autograd through ``attention_ref`` on
    the same inputs (the model's transposed views, or such views TMA
    cannot read in place), from the forward's log-sum-exp as the train
    step runs it; two calls bit-equal; then timed beside its bound, its
    plain version and SDPA's backward; returns the row."""
    import torch.nn.functional as F

    causal, window, dtype = case[5:8]
    q, k, v = qkv_on_card(torch, case, seed, transposed=True,
                          misaligned=view == "misaligned")
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=DEV).to(q.dtype)
    kernel = fa_mod.bwd_kernel_for(q.dtype, case[4])
    if kernel == "wgmma":
        out, lse = fa_mod.flash_attention_with_lse(q, k, v, causal=causal,
                                                   window=window)
    else:
        out = fa_mod.flash_attention(q, k, v, causal=causal, window=window)
        lse = None

    def call():
        return fa_mod.flash_attention_bwd(q, k, v, out, do, causal=causal,
                                          window=window, lse=lse)
    got, again = call(), call()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = ref.attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    rel = [((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item() for a, b in zip(got, want)]
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    if not max(rel) <= FA_BWD_RTOL[dtype] or not same:
        raise AssertionError(f"{label}: B3's backward ({kernel} kernels) "
                             f"differs from autograd through the plain "
                             f"version at {case} ({view}): dq, dk, dv {rel}; "
                             f"two calls {'equal' if same else 'DIFFER'}")
    del got, want
    reps = 3 if seq_lens(case)[0] >= 4096 else 20
    ms = cuda_ms(call, reps)
    plain_ms = cuda_ms(lambda: ref.attention_bwd_ref(
        q, k, v, do, causal=causal, window=window), 2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    mask = band_mask(torch, case) if window is not None else None
    gqa = k.shape[1] < q.shape[1]

    def sdpa_bwd(enable_gqa):
        """SDPA's backward on these inputs: its backend and ms a call."""
        kw = dict(attn_mask=mask, is_causal=causal and mask is None,
                  enable_gqa=enable_gqa)
        y = F.scaled_dot_product_attention(*leaves, **kw)
        return sdpa_backend(torch, *leaves, **kw), cuda_ms(
            lambda: torch.autograd.grad(y, leaves, do, retain_graph=True),
            reps)

    backend, library_ms = sdpa_bwd(gqa)
    # an MHA shape asked with enable_gqa=True, as the yardstick was
    # before: which backend that picks, and its time, in this same call
    asked = "" if gqa else "; with enable_gqa True {} {:.4f} ms".format(
        *sdpa_bwd(True))
    del leaves
    bound, by, flops, nbytes = bwd_bound(case)
    sq, skv = seq_lens(case)
    log(f"{label}: B3's backward ({kernel} kernels, {view} views) vs "
        f"autograd through attention_ref at q "
        f"{tuple(q.shape)} k/v {tuple(k.shape)} {dtype} "
        f"{'causal' if causal else 'non-causal'}"
        f"{f' window {window}' if window is not None else ''} (Sq {sq}, "
        f"Skv {skv}): dq, dk, dv max |diff| / max |grad| "
        f"{', '.join(f'{r:.3g}' for r in rel)} (tolerance "
        f"{FA_BWD_RTOL[dtype]}), max |diff| {err:.3g}, two calls "
        f"bit-equal; {ms:.4f} ms per call "
        f"(CUDA events over {reps} calls), bound {bound:.5f} ms ({by}: "
        f"{flops:.4g} FLOP, {nbytes} B) = {100 * bound / ms:.2f}% of it; "
        f"plain {plain_ms:.4f} ms; SDPA's backward ({backend}, enable_gqa "
        f"{gqa}) {library_ms:.4f} ms{asked}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err, library_ms=library_ms)


def sdpa_backend(torch, q, k, v, **kw) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs
    and arguments (its own chooser, ``torch._fused_sdp_choice``), by
    name."""
    from torch.nn.attention import SDPBackend

    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "backend not reported by this torch"
    idx = int(choose(q, k, v, kw["attn_mask"], 0.0, kw["is_causal"],
                     enable_gqa=kw["enable_gqa"]))
    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    return names.get(idx, f"backend {idx}")


def train_steps(torch, step, state, batches, kernels, label):
    """Run ``step`` (state, batch) -> (state, metrics) once a batch, each
    synchronised and timed, the kernels' counts reset before each; returns
    ``(state, losses, ms a step, launches of each step)``."""
    losses, step_ms, counts = [], [], []
    for batch in batches:
        reset(kernels)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append({n: fn.launches for n, fn in kernels.items()})
        losses.append(float(m["loss"]))
        if not all(math.isfinite(float(v)) for v in m.values()):
            raise AssertionError(f"{label}: non-finite metrics {m}")
    return state, losses, step_ms, counts


def check_train_launches(counts, n_fwd, n_bwd, label,
                         kernel="flash_attention") -> None:
    """Each step launches ``kernel`` (B3, or B4) ``n_fwd`` times (forward
    and the remat recompute) and its backward ``n_bwd`` times, and nothing
    else."""
    for c in counts:
        want = {n: 0 for n in c}
        want.update({kernel: n_fwd, f"{kernel}_bwd": n_bwd})
        if c != want:
            raise AssertionError(f"{label}: step launches {c}, expected "
                                 f"{want}")


def run_training(torch, kernels, get_config):
    """Phase 20: training on the card.  B3's backward kernel at the
    training shapes; qwen2.5-3b at full width and depth (3 AdamW steps);
    the 0.1 B qwen-style model of ``examples/train_100m.py --full`` for 40
    steps with an async checkpoint at 20, a restart through
    ``launch/train.py``'s restore path, and its gradients held to the
    plain attention's; whisper-tiny (3 steps).  Returns the backward's row
    and the launches of the qwen2.5-3b run."""
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import ref
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import tree as ttree
    from repro_torch.train.step import batch_on, loss_and_grads

    # (a) the backward kernel at the training shapes and its edge cases
    for d in fa_mod.BWD_HEAD_DIMS:
        attrs = fa_mod.bwd_wgmma_attributes(d)
        log(f"phase 20: the backward's TMA + wgmma kernels at head dim {d}: "
            f"{attrs}")
        if any(a["local_bytes"] for a in attrs.values()):
            raise AssertionError(f"phase 20: the backward's kernels spill "
                                 f"at head dim {d}: {attrs}")
    row = None
    cases = [(c, "transposed") for c in BWD_CASES] + list(BWD_EDGE_CASES)
    for i, (case, view) in enumerate(cases):
        r = check_attention_bwd(torch, ref, fa_mod, case, "phase 20",
                                seed=200 + i, view=view)
        row = row or r
    torch.cuda.empty_cache()

    # (b) qwen2.5-3b at full width and depth, the train cell of
    # launch.steps.build_cell on the card's host mesh
    cfg = get_config("qwen2.5-3b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = build_cell(cfg, SHAPES["train_4k"], make_host_mesh())
    state = cell.init_state(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in ttree.leaves(state.params))
    log(f"phase 20: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params:,} float32 master parameters (bf16 "
        f"activations), AdamW moments float32, remat full: state built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB held")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=QWEN_TRAIN_S,
                                  global_batch=QWEN_TRAIN_B, seed=0))
    batches = [data.batch(i) for i in range(QWEN_TRAIN_STEPS)]
    reset(kernels)
    loss, _, grads = loss_and_grads(cfg, state.params,
                                    batch_on(batches[0], DEV))
    paths = [p for p, _ in ttree.flatten(state.params)]
    missing = [p for p, g in zip(paths, grads) if g is None]
    bad = [p for p, g in zip(paths, grads)
           if g is not None and not torch.isfinite(g).all()]
    # attention's leaves, except the key bias, whose true gradient is
    # zero (softmax ignores a shift common to all keys)
    dead = [p for p, g in zip(paths, grads)
            if "attn" in p and p[-1] != "bk" and float(g.abs().max()) == 0]
    fwd, bwd = kernels["flash_attention"].launches, \
        kernels["flash_attention_bwd"].launches
    log(f"phase 20: loss and gradients of one batch ({QWEN_TRAIN_B} x "
        f"{QWEN_TRAIN_S} tokens): loss {float(loss):.4f}; {len(grads)} "
        f"leaves, {len(missing)} without a gradient, {len(bad)} non-finite,"
        f" {len(dead)} attention leaves all-zero; B3 launches {fwd} "
        f"(forward and remat recompute), backward kernel launches {bwd}")
    if missing or bad or dead or (fwd, bwd) != (2 * cfg.n_layers,
                                                cfg.n_layers):
        raise AssertionError(f"phase 20: gradients: missing {missing[:3]}, "
                             f"non-finite {bad[:3]}, zero {dead[:3]}, "
                             f"launches {fwd} / {bwd}")
    del grads
    torch.cuda.empty_cache()
    # the main path: reset, train, read the counts
    reset(kernels)
    state, losses, step_ms, counts = train_steps(
        torch, cell.run, state, batches, kernels, "phase 20")
    check_train_launches(counts, 2 * cfg.n_layers, cfg.n_layers,
                         "phase 20")
    qwen_launches = {n: sum(c[n] for c in counts) for n in counts[0]}
    log(f"phase 20: {QWEN_TRAIN_STEPS} AdamW steps: losses "
        f"{[round(x, 4) for x in losses]}, "
        f"{', '.join(f'{t:.1f}' for t in step_ms)} ms a step (host clock, "
        f"synchronised), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; each step "
        f"{counts[0]['flash_attention']} B3 launches and "
        f"{counts[0]['flash_attention_bwd']} of its backward (the train "
        f"cell of build_cell, host mesh {cell.mesh.shape})")
    del state, cell
    torch.cuda.empty_cache()

    # (c) the 0.1 B model: 40 steps, a checkpoint at 20, a restart
    cfg = get_config("qwen2.5-3b").replace(**SMALL_TRAIN)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10,
                          total_steps=SMALL_STEPS)
    bundle = make_train_step(cfg, DEV, opt)
    state = bundle.init_state_fn(0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=SMALL_S, global_batch=SMALL_B,
                                  seed=0))
    batches = [data.batch(i) for i in range(SMALL_STEPS)]
    b0 = batch_on(batches[0], DEV)
    _, _, g_kernel = loss_and_grads(cfg, state.params, b0)
    _, _, g_plain = loss_and_grads(cfg.replace(attn_impl="xla"),
                                   state.params, b0)
    # attention's leaves but the key bias (its true gradient is zero)
    worst_g = max(((a - b).abs().max() / b.abs().max()).item()
                  for (path, _), a, b in zip(ttree.flatten(state.params),
                                             g_kernel, g_plain)
                  if "attn" in path and path[-1] != "bk")
    del g_kernel, g_plain
    log(f"phase 20: 0.1 B model ({cfg.n_params():,} parameters: "
        f"{SMALL_TRAIN}): attention gradients through B3 and its backward "
        f"vs through the plain attention, worst max |diff| / max |grad| "
        f"{worst_g:.3g} (tolerance {MODEL_RTOL})")
    if not worst_g <= MODEL_RTOL:
        raise AssertionError("phase 20: the model's gradients through B3 "
                             "differ from the plain attention's")
    with tempfile.TemporaryDirectory() as tmp:
        writer = ckpt.AsyncCheckpointer(tmp, keep=2)
        losses, step_ms, snap = [], [], None
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            state, m = bundle.step_fn(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i + 1 == SMALL_SAVE:
                writer.save(state, SMALL_SAVE)
                snap = [x.detach().cpu().clone()
                        for x in ttree.leaves(state)]
        writer.wait()
        first, last5 = losses[0], float(np.mean(losses[-5:]))
        log(f"phase 20: {SMALL_STEPS} steps of {SMALL_B} x {SMALL_S} "
            f"tokens: loss {first:.4f} at step 0, mean of the last five "
            f"{last5:.4f}; {np.median(step_ms):.2f} ms a step (median, host "
            f"clock); checkpoint at step {SMALL_SAVE} by the async writer")
        if not last5 < first:
            raise AssertionError("phase 20: the loss did not fall")
        back, at = launch_train.restore_state(cfg, tmp, DEV)
    same = at == SMALL_SAVE and all(
        torch.equal(a, b.cpu()) and a.dtype == b.dtype
        for a, b in zip(snap, ttree.leaves(back)))
    if not same:
        raise AssertionError("phase 20: the restored state differs from "
                             "the saved one")
    again = []
    for batch in batches[SMALL_SAVE:]:
        back, m = bundle.step_fn(back, batch)
        again.append(float(m["loss"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(again, losses[SMALL_SAVE:])]
    log(f"phase 20: restarted from step {at} through launch/train.py's "
        f"restore_state: state equal to the saved one bit for bit "
        f"({len(snap)} leaves); step {SMALL_SAVE}'s loss "
        f"{'equal' if again[0] == losses[SMALL_SAVE] else 'DIFFERS'} "
        f"({again[0]!r} vs {losses[SMALL_SAVE]!r}); steps "
        f"{SMALL_SAVE + 1}-{SMALL_STEPS - 1} within {max(rel[1:]):.3g} "
        f"relative (tolerance 1e-3)")
    if again[0] != losses[SMALL_SAVE] or max(rel[1:]) > 1e-3:
        raise AssertionError("phase 20: the restarted run drifted")
    del state, back, bundle
    torch.cuda.empty_cache()

    # (d) whisper-tiny at full width
    cfg = get_config("whisper-tiny")
    bundle = make_train_step(cfg, DEV, OptimizerConfig())
    state = bundle.init_state_fn(0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=WHISPER_TRAIN_S,
                                  global_batch=QWEN_TRAIN_B, seed=0))
    rng = np.random.default_rng(0)
    batches = []
    for i in range(3):
        batch = data.batch(i)
        batch["frames"] = rng.standard_normal(
            (QWEN_TRAIN_B, cfg.encoder.n_frames, cfg.d_model)).astype(
                np.float32)
        batches.append(batch)
    state, losses, step_ms, counts = train_steps(
        torch, bundle.step_fn, state, batches, kernels, "phase 20")
    n_attn = cfg.encoder.n_layers + 2 * cfg.n_layers
    check_train_launches(counts, 2 * n_attn, n_attn, "phase 20")
    log(f"phase 20: {cfg.name}: 3 steps on frames ({QWEN_TRAIN_B}, "
        f"{cfg.encoder.n_frames}, {cfg.d_model}) and {QWEN_TRAIN_B} x "
        f"{WHISPER_TRAIN_S} tokens: losses {[round(x, 4) for x in losses]}, "
        f"{', '.join(f'{t:.1f}' for t in step_ms)} ms a step; each step "
        f"{counts[0]['flash_attention']} B3 launches (encoder, causal self "
        f"and cross, forward and recompute) and "
        f"{counts[0]['flash_attention_bwd']} of its backward")
    del state, bundle
    torch.cuda.empty_cache()
    return row, qwen_launches


def ssd_bwd_inputs(torch, case, seed):
    """B4's backward inputs on the card at ``case`` (b, s, h, p, n, dtype,
    h0 and final-state gradient, zero decay), in ``ssd_scan_bwd``'s order:
    x, a (a zero mid-chunk if asked), b and c one head's columns broadcast
    over the heads (the model's views), dy, h0 and the final state's
    gradient."""
    b, s, h, p, n, dtype, with_h0, zero = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=DEV).to(dt)
    a = torch.empty((b, s, h), device=DEV).uniform_(0.6, 1.0,
                                                    generator=g).to(dt)
    if zero:
        a[:, s // 2 + 3] = 0
    bm, cm = ((torch.randn((b, s, 1, n), generator=g, device=DEV)
               * n ** -0.5).to(dt).expand(b, s, h, n) for _ in range(2))
    h0 = torch.randn((b, h, p, n), generator=g, device=DEV) \
        if with_h0 else None
    dy = torch.randn((b, s, h, p), generator=g, device=DEV).to(dt)
    ds = torch.randn((b, h, p, n), generator=g, device=DEV) \
        if with_h0 else None
    return x, a, bm, cm, dy, h0, ds


def ssd_bwd_bound(case) -> tuple[float, str, float, int]:
    """(bound ms, what bounds it, FLOPs, bytes) of B4's backward at
    ``case``, reckoned as :func:`scan_bound` reckons the forward: x, dy, a,
    one head's b and c (broadcast), h0 and the final state's gradient read
    once; dx, da, one head's db and dc (the broadcast inputs' gradient is
    their sum over heads) and dh0 written once.  The operations are the
    chunked form's backward on the tensor cores at 128-step chunks, the
    chunk length of B4's chunked kernel: each of the forward's four
    products (C·Bᵀ, the masked product with X, the state's contribution and
    its update) gives two of its size, 2 × (2L²(N+P) + 4LNP) a chunk, at
    the bf16 rate."""
    b, s, h, p, n, dtype, with_h0, _ = case
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * n)
    if with_h0:
        nbytes += 3 * 4 * b * h * p * n
    ell = min(128, s)
    flops = 2.0 * b * h * -(-s // ell) * (2 * ell * ell * (n + p)
                                          + 4 * ell * n * p)
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def check_ssd_bwd(torch, ref, ssd_mod, case, seed):
    """B4's backward kernel against autograd through ``ssd_scan_ref`` on
    the same inputs, as max |diff| / max |grad| of each gradient; two
    calls bit-equal; then timed beside its bound and its plain version;
    returns the row."""
    ins = ssd_bwd_inputs(torch, case, seed)
    dtype = case[5]

    def call():
        return ssd_mod.ssd_scan_bwd(*ins)
    got, again = call(), call()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None)
    del again
    want = ref.ssd_scan_bwd_ref(*ins)
    names = ("dx", "da", "db", "dc", "dh0")
    rel = {nm: ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
           for nm, a, b in zip(names, got, want) if b is not None}
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want) if b is not None)
    if not max(rel.values()) <= FA_BWD_RTOL[dtype] or not same:
        raise AssertionError(f"phase 21: B4's backward differs from "
                             f"autograd through the plain scan at {case}: "
                             f"{rel}; two calls "
                             f"{'equal' if same else 'DIFFER'}")
    del got, want
    reps = 5 if case[1] >= 4096 else 20
    ms = cuda_ms(call, reps)
    plain_ms = cuda_ms(lambda: ref.ssd_scan_bwd_ref(*ins), 2)
    bound, by, ops, nbytes = ssd_bwd_bound(case)
    b, s, h, p, n, _, with_h0, zero = case
    log(f"phase 21: B4's backward vs autograd through ssd_scan_ref at x "
        f"({b}, {s}, {h}, {p}) b/c ({b}, {s}, {h}, {n}) broadcast over "
        f"heads {dtype}{', h0 and a final-state gradient' if with_h0 else ''}"
        f"{', a zero decay mid-chunk' if zero else ''}: max |diff| / max "
        f"|grad| {', '.join(f'{k} {v:.3g}' for k, v in rel.items())} "
        f"(tolerance {FA_BWD_RTOL[dtype]}), max |diff| {err:.3g}, two calls "
        f"bit-equal; {ms:.4f} ms per call (CUDA events over {reps} calls), "
        f"bound {bound:.5f} ms ({by}: {ops:.4g} FLOP, {nbytes} B) = "
        f"{100 * bound / ms:.2f}% of it; plain {plain_ms:.4f} ms; library: "
        f"none (no torch call computes the scan's backward)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err, library_ms=None)


def run_mamba_training(torch, kernels, get_config):
    """Phase 21 (a)-(b): B4's backward kernel at its cases, then mamba2-370m
    at full width and depth trained through the train cell of
    ``launch.steps.build_cell`` on the host mesh: a gradient on every
    leaf, step 1 held to the plain scan's step (the loss in bf16, each
    leaf in float32 activations, and each leaf in bf16 at
    :data:`MAMBA_GATE_DEPTH` layers by the bf16 gate's rule), 3 AdamW
    steps.  Returns the backward's row and the training run's launches."""
    from repro_torch.configs import SHAPES
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.train import tree as ttree
    from repro_torch.train.step import batch_on, loss_and_grads

    for dtype in (torch.float32, torch.bfloat16):
        a = ssd_mod.bwd_attributes(dtype)
        log(f"phase 21: B4's backward kernel ({dtype}): {a['registers']} "
            f"registers a thread, {a['static_smem']} B static shared "
            f"memory, {a['local_bytes']} B local (spill) a thread")
        if a["local_bytes"]:
            raise AssertionError(f"phase 21: B4's backward spills: {a}")
    row = None
    for i, case in enumerate(SSD_BWD_CASES):
        r = check_ssd_bwd(torch, ref, ssd_mod, case, seed=210 + i)
        row = row or r
    torch.cuda.empty_cache()

    cfg = get_config("mamba2-370m")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = build_cell(cfg, SHAPES["train_4k"], make_host_mesh())
    state = cell.init_state(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in ttree.leaves(state.params))
    log(f"phase 21: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.d_model * cfg.ssm.expand // cfg.ssm.headdim} "
        f"heads of P {cfg.ssm.headdim}, N {cfg.ssm.d_state}, chunk "
        f"{cfg.ssm.chunk}; {n_params:,} float32 master parameters (bf16 "
        f"activations), remat {cfg.remat}; the train cell of build_cell on "
        f"the host mesh {cell.mesh.shape}: state built in "
        f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=MAMBA_TRAIN_S,
                                  global_batch=MAMBA_TRAIN_B, seed=0))
    batches = [data.batch(i) for i in range(MAMBA_TRAIN_STEPS)]
    b0 = batch_on(batches[0], DEV)
    paths = [p for p, _ in ttree.flatten(state.params)]

    def rel(got, want):
        """Each leaf's max |diff| / max |grad|."""
        return [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(got, want)]

    def by_rule(kx, xx, names):
        """The bf16 gate's rule: the leaves whose plain bf16 gradient lies
        within the gate of the plain float32 one are held (the number, the
        worst B4-vs-plain distance among them and its leaf); the others,
        which bf16 alone moves by more, are listed by kind with their
        readings."""
        held = [i for i in range(len(kx)) if xx[i] <= MODEL_RTOL]
        w = max(held, key=kx.__getitem__) if held else None
        left = collections.defaultdict(list)
        for i in range(len(kx)):
            if xx[i] > MODEL_RTOL:
                left[names[i][-1]].append(i)
        out = "; ".join(
            f"{len(ix)} {k} (plain bf16 vs float32 "
            f"{min(xx[i] for i in ix):.3g}-{max(xx[i] for i in ix):.3g}, "
            f"B4 vs plain {min(kx[i] for i in ix):.3g}-"
            f"{max(kx[i] for i in ix):.3g})"
            for k, ix in sorted(left.items())) or "none"
        return (len(held), kx[w] if held else float("nan"),
                names[w] if held else None, out)

    reset(kernels)
    loss, _, grads = loss_and_grads(cfg, state.params, b0)
    fwd, bwd = kernels["ssd_scan"].launches, kernels["ssd_scan_bwd"].launches
    missing = [p for p, g in zip(paths, grads) if g is None]
    bad = [p for p, g in zip(paths, grads)
           if g is not None and not torch.isfinite(g).all()]
    zero = [p for p, g in zip(paths, grads)
            if g is not None and float(g.abs().max()) == 0]
    if missing or bad:
        raise AssertionError(f"phase 21: gradients: missing {missing[:3]}, "
                             f"non-finite {bad[:3]}")
    loss_x, _, grads_x = loss_and_grads(cfg.replace(attn_impl="xla"),
                                        state.params, b0)
    loss_rel = abs(float(loss) - float(loss_x)) / abs(float(loss_x))
    kx = rel(grads, grads_x)
    del grads
    c32 = cfg.replace(dtype="float32")
    _, _, g32 = loss_and_grads(c32, state.params, b0)
    _, _, g32x = loss_and_grads(c32.replace(attn_impl="xla"), state.params,
                                b0)
    k32 = rel(g32, g32x)
    del g32
    xx = rel(grads_x, g32x)
    del g32x, grads_x
    torch.cuda.empty_cache()
    i32 = max(range(len(k32)), key=k32.__getitem__)
    n_full = by_rule(kx, xx, paths)[0]
    # bf16's own rounding grows with depth at random init (PERF.md §6, PR
    # 23): the bf16 step is held leaf by leaf at the same width cut to
    # MAMBA_GATE_DEPTH layers, where the rule holds most leaves
    c2 = cfg.replace(n_layers=MAMBA_GATE_DEPTH)
    s2 = build_cell(c2, SHAPES["train_4k"], make_host_mesh()).init_state(0)
    p2 = [p for p, _ in ttree.flatten(s2.params)]
    g2 = [loss_and_grads(c, s2.params, b0)[2] for c in
          (c2, c2.replace(attn_impl="xla"),
           c2.replace(attn_impl="xla", dtype="float32"))]
    n2, worst2, at2, left2 = by_rule(rel(g2[0], g2[1]), rel(g2[1], g2[2]),
                                     p2)
    del s2, g2
    torch.cuda.empty_cache()
    log(f"phase 21: loss and gradients of one batch ({MAMBA_TRAIN_B} x "
        f"{MAMBA_TRAIN_S} tokens): loss {float(loss):.6f} through B4 and its "
        f"backward, {float(loss_x):.6f} through the plain scan "
        f"(attn_impl='xla'): {loss_rel:.3g} relative (tolerance "
        f"{SSD_TRAIN_LOSS_RTOL}); {len(paths)} leaves, {len(missing)} "
        f"without a gradient, {len(bad)} non-finite, {len(zero)} all-zero; "
        f"B4 launches {fwd} (forward and remat recompute), backward kernel "
        f"launches {bwd}; worst leaf max |diff| / max |grad| in float32 "
        f"activations {k32[i32]:.3g} at {paths[i32]} (tolerance "
        f"{MODEL_RTOL}); in bf16 B4 vs plain median "
        f"{statistics.median(kx):.3g}, max {max(kx):.3g}, plain bf16 vs "
        f"float32 median {statistics.median(xx):.3g}: {n_full} of "
        f"{len(paths)} leaves within {MODEL_RTOL}; at {MAMBA_GATE_DEPTH} "
        f"layers {n2} of {len(p2)} leaves held in bf16, worst {worst2:.3g} "
        f"at {at2} (tolerance {MODEL_RTOL}), left out: {left2}")
    if (fwd, bwd) != (2 * cfg.n_layers, cfg.n_layers) \
            or not loss_rel <= SSD_TRAIN_LOSS_RTOL \
            or not k32[i32] <= MODEL_RTOL or not worst2 <= MODEL_RTOL:
        raise AssertionError(f"phase 21: loss {loss_rel:.3g}, worst leaf in "
                             f"float32 {k32[i32]:.3g} at {paths[i32]}, in "
                             f"bf16 at {MAMBA_GATE_DEPTH} layers "
                             f"{worst2:.3g} at {at2}, launches {fwd} / {bwd}")
    # the main path: reset, train, read the counts
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    state, losses, step_ms, counts = train_steps(
        torch, cell.run, state, batches, kernels, "phase 21")
    check_train_launches(counts, 2 * cfg.n_layers, cfg.n_layers,
                         "phase 21", kernel="ssd_scan")
    launches = {n: sum(c[n] for c in counts) for n in counts[0]}
    log(f"phase 21: {MAMBA_TRAIN_STEPS} AdamW steps: losses "
        f"{[round(x, 4) for x in losses]}, "
        f"{', '.join(f'{t:.1f}' for t in step_ms)} ms a step (host clock, "
        f"synchronised), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; each step "
        f"{counts[0]['ssd_scan']} B4 launches and "
        f"{counts[0]['ssd_scan_bwd']} of its backward")
    del state, cell
    torch.cuda.empty_cache()
    return row, launches


def run_mamba_cells(torch, lm, get_config):
    """Phase 21 (c): the prefill and decode cells of ``build_cell`` for
    mamba2-370m at phase 10's shapes on the host mesh, bit-equal to
    ``lm.prefill`` and ``lm.decode_step`` called directly."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.train import tree as ttree

    cfg = get_config("mamba2-370m")
    mesh = make_host_mesh()
    params = lm.init_params(cfg, 0, device=DEV, cast=True)
    g = torch.Generator(device=DEV).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (MAMBA_B, MAMBA_PREFILL_S),
                           generator=g, device=DEV)
    prefill = build_cell(cfg, ShapeSpec("prefill", "prefill",
                                        MAMBA_PREFILL_S, MAMBA_B), mesh)
    t0 = time.perf_counter()
    logits, cache = prefill.run(params, {"tokens": tokens})
    torch.cuda.synchronize()
    cell_ms = (time.perf_counter() - t0) * 1e3
    want, wcache = lm.prefill(cfg, params, tokens, MAMBA_PREFILL_S,
                              device=DEV)
    same = torch.equal(logits, want) and all(
        torch.equal(a, b) for a, b in zip(ttree.leaves(cache),
                                          ttree.leaves(wcache)))
    del want, wcache
    decode = build_cell(cfg, ShapeSpec("decode", "decode", MAMBA_PREFILL_S,
                                       MAMBA_B), mesh)
    theirs = ttree.tree_map(torch.clone, cache)
    held = ttree.leaves(cache)
    tok = tokens[:, -1:]
    pos = torch.full((MAMBA_B,), MAMBA_PREFILL_S - 1, dtype=torch.int32,
                     device=DEV)
    got, out = decode.run(params, tok, pos, cache)
    want, wcache = lm.decode_step(cfg, params, tok, pos, theirs, device=DEV)
    torch.cuda.synchronize()
    same_d = torch.equal(got, want) and all(
        torch.equal(a, b) for a, b in zip(ttree.leaves(out),
                                          ttree.leaves(wcache)))
    in_place = all(a is b for a, b in zip(ttree.leaves(out), held))
    log(f"phase 21: {cfg.name}'s prefill cell ({MAMBA_B} x "
        f"{MAMBA_PREFILL_S} tokens, {cell_ms:.1f} ms) "
        f"{'bit-equal' if same else 'DIFFERS from'} lm.prefill (logits and "
        f"caches); its decode cell {'bit-equal' if same_d else 'DIFFERS'} "
        f"to lm.decode_step, the cache written in place: {in_place}")
    if not (same and same_d and in_place):
        raise AssertionError("phase 21: build_cell's serve cells differ "
                             "from the direct calls")
    del params, cache, theirs
    torch.cuda.empty_cache()


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
    from repro_torch.fleetsim.options import EngineOptions
    from repro_torch.fleetsim.sweep import plan_grid
    from repro_torch.kernels import build, inputs, ops, ref
    from repro_torch.kernels import lru_scan as lru_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    from repro_torch.kernels import flash_attention as fa_mod

    kernels = {"fingerprint_filter": ops.fingerprint_filter,
               "tickfuse_response_path": ops.tickfuse_response_path,
               "flash_attention": ops.flash_attention,
               "flash_attention_bwd": fa_mod.flash_attention_bwd,
               "ssd_scan": ssd_mod.ssd_scan,
               "ssd_scan_bwd": ssd_mod.ssd_scan_bwd,
               "lru_scan": lru_mod.lru_scan}
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
    from repro_torch.kernels.flash_attention import (WGMMA_HEAD_DIMS,
                                                     wgmma_attributes)
    for d in WGMMA_HEAD_DIMS:
        a = wgmma_attributes(d)
        log(f"phase 1: B3's TMA + wgmma kernel at head dim {d}: "
            f"{a['registers']} registers a thread (before setmaxnreg), "
            f"{a['static_smem']} B static + {a['dynamic_smem']} B dynamic "
            f"shared memory, {a['local_bytes']} B local (spill) a thread")
    for n in ssd_mod.CHUNKED_STATE_DIMS:
        a = ssd_mod.chunked_attributes(n)
        log(f"phase 1: B4's chunked TMA + wgmma kernel at state width {n}: "
            f"{a['registers']} registers a thread (before setmaxnreg), "
            f"{a['static_smem']} B static + {a['dynamic_smem']} B dynamic "
            f"shared memory, {a['local_bytes']} B local (spill) a thread")

    log(f"phase 1 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 2: kernels vs plain -----------------------------------------
    rows = check_kernels(torch, inputs, ref, ops)

    log(f"phase 2 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 3: goldens on the card --------------------------------------
    # phases 3-5 run the staged engine, where every launch is a wrapper
    # call (the default on a card, 'auto', is the fused backend: phase 12)
    staged = EngineOptions(backend="staged")
    # B2 alone, cut from B1, B2 and vectorized for phases 19-20: phase 12a
    # runs all three fused against the same goldens, and phase 5 runs B1
    # on the staged loop (its launches counted, its ticks held to scan)
    for backend, kernel in (("tickfuse", "tickfuse_response_path"),):
        cfg, cases, params = golden_batch(tf, backend)
        reset(kernels)
        t0 = time.perf_counter()
        m = tf.simulate(cfg, params, options=staged)
        check_golden(m, cases, f"under {backend}")
        dt = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in kernels.items()}
        want_counts = {n: cfg.n_ticks if n == kernel else 0
                       for n in kernels}
        if counts != want_counts:
            raise AssertionError(f"{backend}: launches {counts}, expected "
                                 f"{want_counts}")
        log(f"phase 3: {backend}: 6 golden cases x 16 fields bit-exact "
            f"({cfg.n_ticks} ticks, {dt:.1f} s, "
            f"{dt / cfg.n_ticks * 1e3:.3f} ms/tick, launches {counts})")

    log(f"phase 3 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 4: the main path at full width, through B2 -----------------
    policies, loads, seeds = SWEEP_POLICIES, SWEEP_LOADS, SWEEP_SEEDS
    cfg = tf.FleetConfig(filter_backend="tickfuse", n_ticks=SWEEP_TICKS)
    log(f"phase 4: n_ticks cut from {FULL_TICKS} to {SWEEP_TICKS} by the "
        f"run's time limit")
    reset(kernels)
    ops.tickfuse_masked.launches = 0
    sw = tf.sweep_grid(cfg.service, policies, loads, seeds, cfg=cfg,
                       engine=staged)
    counts = {n: fn.launches for n, fn in kernels.items()}
    sweep_launches = dict(counts)
    if counts != only(kernels, tickfuse_response_path=SWEEP_TICKS):
        raise AssertionError(f"phase 4 launches {counts}, expected "
                             f"{SWEEP_TICKS} of tickfuse_response_path")
    if ops.tickfuse_masked.launches != SWEEP_TICKS:
        raise AssertionError(f"phase 4: {ops.tickfuse_masked.launches} of "
                             f"{SWEEP_TICKS} B2 launches through the staged "
                             "entry point")
    cticks = sw.n_configs * SWEEP_TICKS
    log(f"phase 4: {sw.n_configs} configs x {SWEEP_TICKS} ticks in "
        f"{sw.wall_clock_s:.2f} s: {cticks / sw.wall_clock_s:.1f} "
        f"config-ticks/s, {sw.wall_clock_s / SWEEP_TICKS * 1e3:.3f} ms/tick, "
        f"B2 launches {counts['tickfuse_response_path']} (all through its "
        f"staged entry point, tickfuse_masked)")
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
    st_k = replayed_state(cfg_k, params, SCAN_CHECK_TICKS)
    st_s = replayed_state(replace(cfg_k, filter_backend="scan"), params,
                          SCAN_CHECK_TICKS)
    assert_same_state(tf, st_k, st_s, "phase 4: scan != tickfuse")
    log(f"phase 4: first {SCAN_CHECK_TICKS} ticks of the grid under scan "
        f"bit-equal to tickfuse (whole state and all metrics; both replayed "
        f"from CUDA graphs, {time.perf_counter() - t0:.1f} s)")

    # where a tick's time goes: a profiled window of the same grid
    state, step, n_raw = engine.init_run(cfg_k, params)
    state = engine.advance(cfg_k, state, step, n_raw, 0, 5)
    prof = device_kernels(torch, lambda: engine.advance(
        cfg_k, state, step, n_raw, 5, 5 + PROFILE_TICKS))
    busy_ms = sum(us for _, us in prof.values()) / 1e3 / PROFILE_TICKS
    sweep_cfg, staged_busy_ms = cfg, busy_ms
    n_launch = sum(n for n, _ in prof.values()) / PROFILE_TICKS
    tick_ms = sw.wall_clock_s / SWEEP_TICKS * 1e3
    b2_us = device_us_per_launch(prof,
                                 DEVICE_SYMBOL["tickfuse_response_path"])
    log(f"phase 4: profile of {PROFILE_TICKS} ticks: {n_launch:.0f} kernel "
        f"launches per tick ({TICK_LAUNCHES_BEFORE} before B2's staged entry "
        f"point), {busy_ms:.3f} ms device busy per tick of "
        f"{tick_ms:.3f} ms wall (unprofiled sweep): device idle "
        f"{100 * (1 - busy_ms / tick_ms):.1f}%; B2 {b2_us:.3f} us per "
        f"launch")
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
    for key, (n, us) in top:
        log(f"phase 4:   {us / 1e3 / PROFILE_TICKS:.4f} ms/tick "
            f"{n / PROFILE_TICKS:.0f} launches/tick  {key[:90]}")

    log(f"phase 4 ended at {time.perf_counter() - t_start:.1f} s")

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
                       rack_weights=weights, slowdown=slowdown, engine=staged)
    counts = {n: fn.launches for n, fn in kernels.items()}
    rack_launches = dict(counts)
    if counts != only(kernels, fingerprint_filter=RACK_TICKS):
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
    st_k = replayed_state(cfg_k, params, RACK_CHECK_TICKS)
    st_s = replayed_state(replace(cfg_k, filter_backend="scan"), params,
                          RACK_CHECK_TICKS)
    assert_same_state(tf, st_k, st_s, "phase 5: scan != pallas")
    n_spine = int(st_k.metrics.n_spine_filtered.sum())
    if n_spine == 0:
        raise AssertionError(f"phase 5: no spine filtering in the first "
                             f"{RACK_CHECK_TICKS} ticks")
    log(f"phase 5: first {RACK_CHECK_TICKS} ticks of the grid under scan "
        f"bit-equal to pallas (whole state and all metrics; "
        f"{n_spine} responses spine-filtered; both replayed from CUDA "
        f"graphs, {time.perf_counter() - t0:.1f} s)")

    log(f"phase 5 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 6: flash attention vs plain ---------------------------------
    rows["flash_attention"] = check_flash_attention(torch, ref, ops)

    log(f"phase 6 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 7: qwen2.5-3b prefill + decode at full width ----------------
    cfg, params, prefill_launches = run_model(torch, lm, kernels,
                                              get_config)

    log(f"phase 7 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 8: the serving tier at full width ---------------------------
    run_serving(torch, cfg, params, kernels, ref)
    del params
    torch.cuda.empty_cache()

    log(f"phase 8 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 9: the SSD and RG-LRU scans (B4, B5) vs plain ----------------
    rows.update(check_scans(torch, ref, ssd_mod.ssd_scan, lru_mod.lru_scan,
                            ops))

    log(f"phase 9 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 10: mamba2-370m prefill + decode at full width ---------------
    ssd_launches = run_recurrent(torch, lm, kernels, get_config,
                                 "mamba2-370m", MAMBA_B, MAMBA_PREFILL_S,
                                 "phase 10")
    torch.cuda.empty_cache()

    log(f"phase 10 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 11: recurrentgemma-9b prefill + decode at full width ---------
    lru_launches = run_recurrent(torch, lm, kernels, get_config,
                                 "recurrentgemma-9b", PREFILL_B, PREFILL_S,
                                 "phase 11")
    torch.cuda.empty_cache()

    log(f"phase 11 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 12: the fused backend, replayed from CUDA graphs -------------
    run_fused(torch, tf, sw, staged_busy_ms, sweep_cfg, policies, loads,
              seeds)

    log(f"phase 12 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 13: the Scenario layer, LÆDGE and the hedge timer -----------
    run_scenario_layer(torch, tf, kernels, ops)

    log(f"phase 13 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 14: ServeSim (the batch server, llm services, the oracle) ----
    run_serve_sim(torch, tf, kernels, ops, get_config)

    log(f"phase 14 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 15: FleetScope telemetry ---------------------------------------
    run_telemetry(torch, tf, kernels, ops)
    log(f"phase 15 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 16: deepseek-moe-16b (the MoE FFN, B3 on MHA) ----------------
    run_deepseek(torch, lm, kernels, get_config, "deepseek-moe-16b",
                 PREFILL_B, "phase 16")
    check_attention_case(torch, ref, ops, MOE_FA, "phase 16", seed=160)
    log(f"phase 16 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 17: deepseek-v2-lite-16b (MLA and MoE, no B3) ---------------
    run_deepseek(torch, lm, kernels, get_config, "deepseek-v2-lite-16b",
                 PREFILL_B, "phase 17")
    log(f"phase 17 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 18: whisper-tiny (B3 non-causal, cross, Sq = 1) --------------
    run_whisper(torch, lm, kernels, get_config)
    for i, case in enumerate(WHISPER_FA):
        check_attention_case(torch, ref, ops, case, "phase 18", seed=180 + i)
    log(f"phase 18 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 19: the sharded sweep runner (one slab on the one card) -----
    run_shard(torch, tf, sw, sweep_cfg, policies, loads, seeds)
    log(f"phase 19 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 20: training (B3's backward kernel, qwen2.5-3b, 0.1 B,
    # whisper-tiny) ---------------------------------------------------------
    rows["flash_attention_bwd"], train_launches = run_training(
        torch, kernels, get_config)
    for n in ("flash_attention", "flash_attention_bwd"):
        if not train_launches[n]:
            raise AssertionError(f"phase 20: the training run launched no "
                                 f"{n}")
    log(f"phase 20 ended at {time.perf_counter() - t_start:.1f} s")

    # -- phase 21: B4's backward and mamba2-370m training, build_cell's
    # serve cells ----------------------------------------------------------
    rows["ssd_scan_bwd"], mamba_launches = run_mamba_training(
        torch, kernels, get_config)
    for n in ("ssd_scan", "ssd_scan_bwd"):
        if not mamba_launches[n]:
            raise AssertionError(f"phase 21: the training run launched no "
                                 f"{n}")
    run_mamba_cells(torch, lm, get_config)
    log(f"phase 21 ended at {time.perf_counter() - t_start:.1f} s")

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        raise AssertionError(f"imported {bad}")
    replaces = {"fingerprint_filter":
                "src/repro/kernels/fingerprint_filter.py:64",
                "tickfuse_response_path": "src/repro/kernels/tickfuse.py:86",
                "flash_attention": "src/repro/kernels/flash_attention.py:98",
                "flash_attention_bwd":
                "none: jax.grad through src/repro/kernels/ops.py:30-31 "
                "(the XLA attention_ref)",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:76",
                "ssd_scan_bwd":
                "none: jax.grad through src/repro/kernels/ops.py:60-68 "
                "(the XLA ssd_scan_ref)",
                "lru_scan": "src/repro/kernels/lru_scan.py:51"}
    sources = {"fingerprint_filter":
               "src/repro_torch/kernels/csrc/fingerprint_filter.cu",
               "tickfuse_response_path":
               "src/repro_torch/kernels/csrc/tickfuse.cu",
               "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
               "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "ssd_scan_bwd":
               "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
               "lru_scan": "src/repro_torch/kernels/csrc/lru_scan.cu"}
    launches = {"fingerprint_filter": rack_launches["fingerprint_filter"],
                "tickfuse_response_path":
                sweep_launches["tickfuse_response_path"],
                "flash_attention": prefill_launches,
                "flash_attention_bwd": train_launches["flash_attention_bwd"],
                "ssd_scan": ssd_launches,
                "ssd_scan_bwd": mamba_launches["ssd_scan_bwd"],
                "lru_scan": lru_launches}
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
