#!/usr/bin/env python3
"""Time the switch response-path kernels (B1 ``fingerprint_filter``, B2
``tickfuse``) on one NVIDIA GPU, optionally beside the same kernel sources
of another checkout.

    PYTHONPATH=src python tools/bench_filter.py [--parent DIR]

At the default sweep's shape (phase 2 of ``chip_smoke.py``: 200 configs,
32 lanes, tables (200, 4, 1024), 6 servers) it prints the card (name and
power limit), then for each kernel and for the empty kernel on B1's grid
(the floor of a launch): the device microseconds per launch by
``torch.profiler``, the microseconds per launch when 100 launches replay
from one CUDA graph, and the microseconds per launch of 2,000 launches
issued back to back through ``ctypes`` (the C entry point alone, no Python
wrapper).  This tree's wrappers are timed per call before the first
profiler session and again after the last.
``--parent DIR`` names another checkout (say the parent commit, unpacked
with ``git archive``): its ``fingerprint_filter.cu`` and ``tickfuse.cu``
are built with the same flags (they have the same C interface), checked
bit-exact against this tree's kernels on the same lanes, and timed in
turns with them (parent, this, this, parent) in the same process.
``--sweep-ticks N`` also times phase 4's 200-config staged sweep through
B2 for N ticks in a fresh process of each tree, in turns with
``--parent``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build, inputs, ops
from repro_torch.kernels import fingerprint_filter as ff
from repro_torch.kernels import tickfuse as tf

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (200, 32, 4, 1024, 6)        # G, K, n_tables, n_slots, n_servers
GRAPH_CALLS, GRAPH_REPLAYS, BACK_TO_BACK = 100, 20, 2000
#: phase 4's sweep through B2 (``tickfuse``) on the staged engine in a
#: fresh process of one tree: the default grid, one warm-up run of 100
#: ticks, then the timed run of ``argv[1]`` ticks.  A tree without
#: ``EngineOptions`` has only the staged engine.
SWEEP = """
import json, sys
from dataclasses import replace
import repro_torch.fleetsim as tf
from repro_torch.kernels import build
try:
    from repro_torch.fleetsim.options import EngineOptions
    kw = {"engine": EngineOptions(backend="staged")}
except ImportError:
    kw = {}
build.build(("tickfuse",))
grid = (["baseline", "c-clone", "netclone", "racksched", "netclone+racksched"],
        [0.1, 0.2, 0.35, 0.5, 0.65, 0.8, 0.9, 0.95], [0, 1, 2, 3, 4])
cfg = tf.FleetConfig(filter_backend="tickfuse", n_ticks=int(sys.argv[1]))
tf.sweep_grid(cfg.service, *grid, cfg=replace(cfg, n_ticks=100), **kw)
sw = tf.sweep_grid(cfg.service, *grid, cfg=cfg, **kw)
print(json.dumps({"config_ticks_per_s": sw.n_configs * cfg.n_ticks
                  / sw.wall_clock_s,
                  "ms_per_tick": 1e3 * sw.wall_clock_s / cfg.n_ticks}))
"""
#: the profiler's name of each entry's kernel
SYMBOL = {"fingerprint_filter_launch": "fingerprint_filter_kernel",
          "tickfuse_launch": "tickfuse_kernel",
          "filter_noop_launch": "filter_noop_kernel"}


def build_parent(root: Path, name: str) -> ctypes.CDLL:
    """The other checkout's ``<name>.cu``, built with this tree's flags into
    ``build/kernels``."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cuh")) + [csrc / f"{name}.cu"]:
        h.update(src.read_bytes())
    out = build.BUILD_DIR / f"libparent_{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(csrc / f"{name}.cu")], check=True)
    return ctypes.CDLL(str(out))


def entry(lib, name: str, like):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = like.argtypes, ctypes.c_int
    return fn


def cuda_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / reps


def profiled_us(fn, symbol: str, reps: int = 200) -> float | None:
    """Device microseconds per launch of ``symbol`` over ``reps`` calls of
    ``fn`` (the second of two profiled rounds), or None when the profiler
    records none of its launches."""
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    hits = [(e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and symbol in e.key]
    if not hits:
        return None
    return sum(us for _, us in hits) / sum(n for n, _ in hits)


def graph_us(fn) -> float:
    """Microseconds per call of ``fn`` replayed from one CUDA graph of
    :data:`GRAPH_CALLS` calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    return cuda_us(graph.replay, GRAPH_REPLAYS) / GRAPH_CALLS


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", type=Path)
    p.add_argument("--sweep-ticks", type=int, default=0,
                   help="also time phase 4's 200-config sweep through B2 "
                   "for this many ticks, in a fresh process of each tree "
                   "(in turns with --parent)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_filter: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    g, k, n_tables, n_slots, n_servers = SHAPE
    x = inputs.filter_lanes(g, k, n_tables, n_slots, n_servers, seed=99)
    t = {n: torch.from_numpy(a.copy()).cuda() for n, a in x.items()}
    drop = torch.empty((g, k), dtype=torch.bool, device="cuda")
    ptr = {n: v.data_ptr() for n, v in t.items()}
    libs = {"fingerprint_filter": ff._lib(), "tickfuse": tf._lib()}

    def launcher(fn):
        """One launch through ``fn``, a C entry point of either tree, on
        the current stream, as the wrappers make it."""
        if fn.__name__ == "tickfuse_launch":
            def go():
                return fn(ptr["server_state"], ptr["tables"], ptr["rid"],
                          ptr["idx"], ptr["clo"], ptr["sid"], ptr["qlen"],
                          drop.data_ptr(), g, n_servers, n_tables, n_slots,
                          k, ff.raw_stream(0))
        else:
            def go():
                return fn(ptr["tables"], ptr["rid"], ptr["idx"], ptr["clo"],
                          drop.data_ptr(), g, n_tables, n_slots, k,
                          ff.raw_stream(0))
        return go

    def state():
        return t["server_state"].clone(), t["tables"].clone()

    def result(go):
        """server_state, tables and drop after one launch from the start."""
        s0, t0 = state()
        assert go() == 0
        torch.cuda.synchronize()
        out = (t["server_state"].clone(), t["tables"].clone(), drop.clone())
        t["server_state"].copy_(s0)
        t["tables"].copy_(t0)
        return out

    b1 = [t[n] for n in ("tables", "rid", "idx", "clo")]
    b2 = [t[n] for n in ("server_state", "tables", "rid", "idx", "clo",
                         "sid", "qlen")]
    active = torch.from_numpy(
        np.random.default_rng(99).random((g, k)) < 0.8).cuda()
    masked = (t["server_state"], t["tables"], t["rid"], t["idx"].long(),
              t["clo"], t["sid"].long(), t["qlen"], active)
    wrappers = (
        ("fingerprint_filter", lambda: ops.fingerprint_filter(*b1)),
        ("fingerprint_filter out=",
         lambda: ops.fingerprint_filter(*b1, out=drop)),
        ("tickfuse_response_path", lambda: ops.tickfuse_response_path(*b2)),
        ("tickfuse_response_path out=",
         lambda: ops.tickfuse_response_path(*b2, out=drop)),
        ("tickfuse_masked out=", lambda: ops.tickfuse_masked(*masked,
                                                             out=drop)),
        ("filter_floor out=", lambda: ff.filter_floor(*b1, out=drop)))

    def time_wrappers(when: str) -> None:
        s0, t0 = state()
        for label, fn in wrappers:
            print(f"wrapper {label} ({when}): {cuda_us(fn, BACK_TO_BACK):.3f} "
                  f"us per call (CUDA events over {BACK_TO_BACK} calls)",
                  flush=True)
        t["server_state"].copy_(s0)
        t["tables"].copy_(t0)

    # host-clock timings come first: a profiler session can leave later
    # launches slower, which the second round of wrapper timings shows
    time_wrappers("before any profiler session")
    runs = []
    for name, c_entry in (("fingerprint_filter", "fingerprint_filter_launch"),
                          ("tickfuse", "tickfuse_launch"),
                          ("fingerprint_filter", "filter_noop_launch")):
        this = launcher(getattr(libs[name], c_entry))
        if args.parent is None or c_entry == "filter_noop_launch":
            runs.append((c_entry, "this", this))
            continue
        parent = launcher(entry(build_parent(args.parent, name), c_entry,
                                getattr(libs[name], c_entry)))
        if not all(torch.equal(a, b) for a, b in
                   zip(result(parent), result(this))):
            raise AssertionError(f"{c_entry}: the parent's kernel and this "
                                 "one differ on the same lanes")
        print(f"{c_entry}: parent and this bit-exact on the same lanes",
              flush=True)
        runs += [(c_entry, "parent", parent), (c_entry, "this", this),
                 (c_entry, "this", this), (c_entry, "parent", parent)]
    s0, t0 = state()
    for c_entry, label, go in runs:
        print(f"{c_entry} ({label}): {graph_us(go):.3f} us per launch "
              f"replayed from a graph of {GRAPH_CALLS}, "
              f"{cuda_us(go, BACK_TO_BACK):.3f} us per launch issued back to "
              f"back ({BACK_TO_BACK}, ctypes alone)", flush=True)
    for c_entry, label, go in runs:
        dev = profiled_us(go, SYMBOL[c_entry])
        print(f"{c_entry} ({label}): device "
              + ("not recorded" if dev is None else f"{dev:.3f} us")
              + " per launch (profiler)", flush=True)
    t["server_state"].copy_(s0)
    t["tables"].copy_(t0)
    time_wrappers("after the profiler sessions")

    if args.sweep_ticks:
        trees = [("this", ROOT)]
        if args.parent is not None:
            trees = [("parent", args.parent.resolve()), ("this", ROOT),
                     ("this", ROOT), ("parent", args.parent.resolve())]
        for label, root in trees:
            out = subprocess.run(
                [sys.executable, "-c", SWEEP, str(args.sweep_ticks)],
                cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
                capture_output=True, text=True, check=True).stdout
            r = json.loads(out.strip().splitlines()[-1])
            print(f"sweep ({label}): 200 configs x {args.sweep_ticks} ticks "
                  f"through B2: {r['config_ticks_per_s']:.1f} config-ticks/s, "
                  f"{r['ms_per_tick']:.3f} ms/tick", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
