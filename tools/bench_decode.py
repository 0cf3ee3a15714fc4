#!/usr/bin/env python3
"""Time qwen2.5-3b's decode step on one NVIDIA GPU for one or more trees
of the port, in alternating processes, or with and without the sharding
hooks in one process.

    python tools/bench_decode.py SRC [SRC ...]
    python tools/bench_decode.py --hooks SRC

Each ``SRC`` is a ``src`` directory holding ``repro_torch`` (this tree's
``src``, or another checkout's unpacked with ``git archive`` into
``build/``).  For each, in the order given, a fresh process builds B3,
draws qwen2.5-3b's weights at full width and depth (seed 0, cast to
bf16), prefills 4 x 256 tokens and times 16 decode steps (host clock,
synchronised, the mean of steps 2-16), three rounds; it prints one JSON
line a process.  Give the trees in turns (parent, this, this, parent):
decode steps are host-bound, and the host moves them between processes.

``--hooks`` stays in one process: after one prefill it runs 30 rounds of
three decode steps, one step with the sharding hooks as they are, one
with each hook (``fsdp_use``, ``constrain_batch``, ``constrain_seq``,
``constrain_heads``) replaced by a function returning its input, and one
with the hooks as they are again (a control: what two identical variants
differ by), in an order that rotates from round to round; it prints the
hook calls a step, each variant's median and quartiles of its step times
(host clock, synchronised), the median of the rounds' differences from
the stubbed step and from the control with the count of positive ones,
then the hooks' own host time: ``fsdp_use`` on a layer's weights and
``constrain_batch`` on a tensor, 100,000 calls each, off a mesh.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def one(src: str) -> dict:
    sys.path.insert(0, src)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import lm

    build.build(("flash_attention",))
    cfg = get_config("qwen2.5-3b")
    params = lm.init_params(cfg, 0, device="cuda", cast=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 256), generator=g,
                           device="cuda")
    rounds = []
    with torch.no_grad():
        for _ in range(3):
            logits, cache = lm.prefill(cfg, params, tokens, s_max=256 + 17,
                                       device="cuda")
            tok = logits.argmax(-1).to(torch.int32)
            times = []
            for i in range(16):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pos = torch.full((4,), 256 + i, dtype=torch.int32,
                                 device="cuda")
                logits, cache = lm.decode_step(cfg, params, tok, pos, cache,
                                               device="cuda")
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            rounds.append(sum(times[1:]) / 15)
    return {"src": src, "decode_ms": rounds}


def hooks(src: str, rounds: int = 30) -> dict:
    sys.path.insert(0, src)
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.sharding import context as ctx

    build.build(("flash_attention",))
    cfg = get_config("qwen2.5-3b")
    params = lm.init_params(cfg, 0, device="cuda", cast=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 256), generator=g,
                           device="cuda")
    names = ("fsdp_use", "constrain_batch", "constrain_seq",
             "constrain_heads")
    real = {n: getattr(ctx, n) for n in names}
    stub = {"fsdp_use": lambda p, cast=None: p,
            **{n: (lambda x: x) for n in names[1:]}}
    calls = []

    def counted(fn):
        def call(*a, **kw):
            calls.append(1)
            return fn(*a, **kw)
        return call

    variants = {"hooks": real, "stubbed": stub, "control": real}
    order = list(variants)
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, params, tokens,
                                   s_max=256 + 3 * rounds + 4,
                                   device="cuda")
        state = {"pos": 256, "tok": logits.argmax(-1).to(torch.int32),
                 "cache": cache}

        def step(hooks):
            for n in names:
                setattr(ctx, n, hooks[n])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pos = torch.full((4,), state["pos"], dtype=torch.int32,
                             device="cuda")
            logits, state["cache"] = lm.decode_step(
                cfg, params, state["tok"], pos, state["cache"],
                device="cuda")
            state["tok"] = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            state["pos"] += 1
            return (time.perf_counter() - t0) * 1e3

        step({n: counted(real[n]) for n in names})
        per_step = len(calls)
        step(real)
        got = {v: [] for v in variants}
        for r in range(rounds):
            for v in order[r % 3:] + order[:r % 3]:
                got[v].append(step(variants[v]))
        for n in names:
            setattr(ctx, n, real[n])
    layer = params["blocks"][0]
    x = torch.empty((4, 1, cfg.d_model), device="cuda")
    t0 = time.perf_counter()
    for _ in range(100_000):
        ctx.fsdp_use(layer, cast=torch.bfloat16)
    fsdp_us = (time.perf_counter() - t0) * 10
    t0 = time.perf_counter()
    for _ in range(100_000):
        ctx.constrain_batch(x)
    batch_us = (time.perf_counter() - t0) * 10

    def spread(v):
        q = statistics.quantiles(v, n=4)
        return {"median": statistics.median(v), "q1": q[0], "q3": q[2]}

    def against(other):
        d = [a - b for a, b in zip(got["hooks"], got[other])]
        return {"median_ms": statistics.median(d),
                "positive": sum(x > 0 for x in d), "rounds": len(d)}

    return {"src": src, "hook_calls_a_step": per_step,
            **{f"{v}_ms": spread(t) for v, t in got.items()},
            "hooks_minus_stubbed": against("stubbed"),
            "hooks_minus_control": against("control"),
            "steps_ms": got, "fsdp_use_us": fsdp_us,
            "constrain_batch_us": batch_us}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])))
        return 0
    if len(argv) == 2 and argv[0] == "--hooks":
        print(json.dumps(hooks(argv[1])))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for src in argv:
        out = subprocess.run([sys.executable, __file__, "--one", src],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-2000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
