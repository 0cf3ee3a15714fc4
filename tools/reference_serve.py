#!/usr/bin/env python3
"""The reference's rows for ``chip_smoke.py``'s phases 14 and 15 (ServeSim
and FleetScope telemetry), made on the CPU with the JAX package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_serve.py \
        --out tools/serve_reference.json

writes, under ``jax.threefry_partitionable(False)`` (the goldens' PRNG
stream, ROADMAP C0):

* ``llm_rows``: the ``FleetResult`` of the library's ``llm_gemma7b`` and
  ``llm_moe_hetero`` over their first ``LLM_TICKS`` ticks (1,024 of
  their 4,000; ``Scenario.run_fleetsim``);
* ``coupled_rows``: the same for ``llm_gemma7b`` at ``batch_coupling``
  0.5, the batch stage's float path (its decode speed falls with the
  slots in use; the library files run at coupling 0, where it is 1);
* ``serve_checks``: ``serve_equivalence()`` at its defaults (qwen2.5-3b's
  smoke replicas, baseline and netclone at loads 0.3 and 0.6, a 1,500-tick
  horizon), every ``ServeCheck`` field (at 1,000 ticks the reference's own
  netclone@0.6 check fails, so the horizon is not cut);
* ``trace_burst``: ``trace_burst.json`` traced over its first
  ``--trace-ticks`` ticks (``Scenario.run_traced``): the result row, the
  event count and counts by kind, and :func:`telemetry_digest` of the
  decoded events and series.

The card's machine has no JAX, so the file is committed; ``chip_smoke.py``
compares its own runs with it field for field.  The run takes a few minutes
on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from pathlib import Path

import numpy as np

#: ticks of trace_burst that phase 15 traces (its file runs 40,000)
TRACE_TICKS = 1_000
#: ticks of the llm library files that phase 14 runs (their files run
#: 4,000)
LLM_TICKS = 1_024
#: serve_equivalence's horizon in phase 14: its default
SERVE_TICKS = 1_500
#: the batch coupling of ``coupled_rows``
COUPLING = 0.5


def telemetry_digest(tel) -> dict:
    """sha256 digests of one run's decoded telemetry: the event arrays
    (tick, kind, rid, server, client, arg as int32, in decode order) and
    the series (its per-window rows as JSON).  ``chip_smoke.py`` computes
    the same digests from the port's decode."""
    ev = tel.events
    h = hashlib.sha256()
    for name in ("tick", "kind", "rid", "server", "client", "arg"):
        h.update(np.ascontiguousarray(getattr(ev, name), np.int32).tobytes())
    rows = json.dumps(tel.series.rows(), sort_keys=True)
    return {"events_sha256": h.hexdigest(),
            "series_sha256": hashlib.sha256(rows.encode()).hexdigest()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="tools/serve_reference.json")
    ap.add_argument("--trace-ticks", type=int, default=TRACE_TICKS)
    args = ap.parse_args(argv)

    import jax

    from repro.fleetsim.llmserve import serve_equivalence
    from repro.scenarios import load_any

    out: dict = {"jax": jax.__version__, "trace_ticks": args.trace_ticks,
                 "llm_ticks": LLM_TICKS, "serve_ticks": SERVE_TICKS}
    with jax.threefry_partitionable(False):
        t0 = time.perf_counter()
        out["llm_rows"] = {name: dataclasses.asdict(
            load_any(name).run_fleetsim(n_ticks=LLM_TICKS))
            for name in ("llm_gemma7b", "llm_moe_hetero")}
        out["coupled_rows"] = {f"llm_gemma7b@{COUPLING}": dataclasses.asdict(
            dataclasses.replace(load_any("llm_gemma7b"),
                                batch_coupling=COUPLING).run_fleetsim(
                                    n_ticks=LLM_TICKS))}
        print(f"llm rows: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        checks = serve_equivalence(horizon=SERVE_TICKS)
        out["serve_checks"] = [{**dataclasses.asdict(c), "ok": bool(c.ok),
                                "detail": c.describe()} for c in checks]
        print(f"serve_equivalence: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        result, tel = load_any("trace_burst").run_traced(
            n_ticks=args.trace_ticks)
        out["trace_burst"] = {
            "row": dataclasses.asdict(result),
            "n_events": len(tel.events), "n_lost": tel.events.n_lost,
            "events_by_kind": tel.events.counts_by_kind(),
            "n_windows": tel.series.n_windows,
            **telemetry_digest(tel)}
        print(f"trace_burst: {time.perf_counter() - t0:.1f} s", flush=True)
    for c in out["serve_checks"]:
        print(("[PASS] " if c["ok"] else "[FAIL] ") + c["detail"])
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
