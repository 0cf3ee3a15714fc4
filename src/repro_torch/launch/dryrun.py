"""Dry-run of every (arch × shape × mesh) cell, port of
``repro.launch.dryrun``: the proof that the distribution config is coherent
without the hardware.

The reference lowers and compiles each cell's step for 512 placeholder TPU
devices and reads XLA's memory and cost analyses.  No partitioner runs
here: a cell is *lowered* by running its step once on ``meta`` tensors
(:func:`repro_torch.launch.steps.lower`), over the shape-only production
mesh, with ``attn_impl="xla"`` named by the caller (the reference's
dry-run lowers its plain XLA functions too).  The record keeps the
reference's schema (``full.memory``, ``full.cost``, ``full.collectives``,
``probe1``/``probe2``, ``n_periods``, skips by ``supported_shapes``), with
the port's own numbers:

* ``memory.argument_bytes`` / ``output_bytes`` / ``alias_bytes``: bytes a
  device, exact from the partition specs (each leaf's bytes over the
  product of the sizes of the axes that shard it);
* ``cost.flops_global``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the whole step (forward, remat recompute, backward), and
  ``cost.flops`` that count over the mesh's devices;
* ``collectives``: the bytes a device the sharding hooks record
  (:mod:`repro_torch.sharding.context`);
* ``null``: what is not modelled — ``temp_bytes``, ``code_bytes``,
  ``cost.bytes`` (no compiler schedules the step).

Eager counting sees every layer, so the one- and two-period probes must
extrapolate *exactly* to the full count (``fixed + per_period ×
n_periods``): :func:`run_cell` checks it (``probe_check``).  On ``meta``
the MoE layers take the reference's dense capacity dispatch
(``models/ffn.py::moe_dense_dispatch``), the work the reference lowers.

Usage:
    python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multipod] [--out DIR]

Records go to ``results/dryrun_torch/`` (never the reference's
``results/dryrun/``).
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCHS, SHAPES, SMOKE_SHAPES, get_config, \
    supported_shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models.lm import scan_groups

OUT = "results/dryrun_torch"


def probe_depths(cfg) -> tuple[int, int]:
    """n_layers for the 1- and 2-period probes (prologue/epilogue
    preserved so fixed costs match the full model)."""
    g = scan_groups(cfg)
    period = max(len(g.period), 1)
    n_pro, n_epi = len(g.prologue), len(g.epilogue)
    return n_pro + period + n_epi, n_pro + 2 * period + n_epi


def analyse(cfg, shape, mesh, serve_sharding: str = "fsdp") -> dict:
    bundle = build_cell(cfg, shape, mesh, serve_sharding=serve_sharding)
    t0 = time.time()
    rec = bundle.lowered()
    return {"compile_s": round(time.time() - t0, 2), **rec}


def extrapolate(rec: dict) -> float:
    """fixed + per_period × n_periods from the two probes' FLOP counts."""
    p1 = rec["probe1"]["cost"]["flops_global"]
    p2 = rec["probe2"]["cost"]["flops_global"]
    per = p2 - p1
    return (p1 - per) + per * rec["n_periods"]


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             with_probes: bool = True, overrides: dict | None = None,
             serve_sharding: str = "fsdp", smoke: bool = False,
             mesh=None) -> dict:
    """One cell's record.  ``smoke``: the arch's smoke config at
    :data:`SMOKE_SHAPES`' extents (the CPU tests); ``mesh``: another
    shape-only mesh than the production one."""
    shape = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(v) for v in mesh.shape.values()),
           "ok": False, "overrides": overrides or {},
           "serve_sharding": serve_sharding}
    if shape_name not in supported_shapes(arch):
        rec.update(ok=True, skipped=True,
                   reason="full attention — long-context shape skipped")
        return rec
    try:
        cfg = get_config(arch, smoke=smoke, max_seq_len=shape.seq_len,
                         **(overrides or {}))
        rec["full"] = analyse(cfg, shape, mesh, serve_sharding)
        if with_probes:
            d1, d2 = probe_depths(cfg)
            g = scan_groups(cfg)
            rec["n_periods"] = g.n_periods
            rec["period_len"] = max(len(g.period), 1)
            for name, depth in (("probe1", d1), ("probe2", d2)):
                pcfg = cfg.replace(n_layers=depth, scan_layers=False)
                rec[name] = analyse(pcfg, shape, mesh, serve_sharding)
                rec[name]["n_layers"] = depth
            want = rec["full"]["cost"]["flops_global"]
            got = extrapolate(rec)
            rec["probe_check"] = {"extrapolated_flops": got,
                                  "full_flops": want, "exact": got == want}
            if got != want:
                raise AssertionError(f"the probes extrapolate to {got} "
                                     f"FLOPs, the full step counts {want}")
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def parse_overrides(pairs) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        overrides[k] = v
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--variant", default=None,
                    help="suffix for the output file (perf iterations)")
    ap.add_argument("--serve-tp", action="store_true",
                    help="TP-only parameter sharding for serve cells")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (bool/int/float/str)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]

    failed = 0
    for arch, shape in cells:
        tag = "mp" if args.multipod else "sp"
        if args.variant:
            tag = f"{tag}__{args.variant}"
        path = outdir / f"{arch}__{shape}__{tag}.json"
        if path.exists():
            print(f"[skip] {path} exists")
            continue
        t0 = time.time()
        rec = run_cell(arch, shape, args.multipod,
                       with_probes=not args.no_probes, overrides=overrides,
                       serve_sharding="tp" if args.serve_tp else "fsdp")
        path.write_text(json.dumps(rec, indent=1))
        failed += not rec["ok"]
        status = "OK" if rec["ok"] else f"FAIL ({rec.get('error')})"
        print(f"[{time.time()-t0:6.1f}s] {arch} × {shape} ({tag}): {status}",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
