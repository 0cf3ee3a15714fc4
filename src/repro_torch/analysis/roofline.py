"""Roofline assembly from dry-run artifacts, port of
``repro.analysis.roofline``.

Per (arch × shape) cell, derives the three roofline terms in seconds:

    compute    = HLO_FLOPs_per_device / PEAK_FLOPS
    memory     = HLO_bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / ICI_BW

over the reference's dry-run JSON records (``results/dryrun/*__sp.json``):
its lowering counts a scan-over-layers body once, so totals are rebuilt
from the two unrolled depth probes (:func:`_extrapolate`), plus an analytic
correction for the loss scan (:func:`repro_torch.models.lm.
ce_analytic_cost`).  Everything here is host arithmetic over those
records, beside :func:`n_params_active`, which counts a model's parameters
from the shapes the port's ``init_params`` builds on the ``meta`` device:
nothing is allocated, so gemma-7b's full config is counted without
putting its 8.5 B parameters anywhere.

``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``, ``N_CHIPS`` and the 16 GB fit test
are the reference's modelling constants, copied so the derived numbers
(the ServeSim service costs of :mod:`repro_torch.fleetsim.llmserve.
service`, pinned in the scenario library) are the reference's.  They
describe the reference's simulated accelerator, not any device this
package runs on.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.models.common import ModelConfig

# the reference's modelling constants (see the module docstring)
PEAK_FLOPS = 197e12          # FLOP/s a device
HBM_BW = 819e9               # B/s a device
ICI_BW = 50e9                # B/s a link
N_CHIPS = 256                # devices of the roofline mesh
FITS_GB = 16.0               # memory a device, for the ``fits`` column


@dataclass
class Roofline:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float       # 6·N·D (dense) / 6·N_active·D (MoE); fwd-only ÷3
    hlo_total_flops: float   # across chips
    useful_ratio: float      # MODEL_FLOPS / HLO_FLOPS
    bottleneck: str
    step_time_s: float       # max of the three terms (no-overlap bound)
    mfu: float               # model flops / (chips · peak · step_time)
    memory_gb: float         # per-device footprint (args + temps)
    fits: bool
    notes: str = ""


def _leaves(tree, path: str = ""):
    """``(path, tensor)`` for every tensor of a parameter tree (dicts and
    lists), paths joined with ``/`` as the reference's pytree paths are."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    elif tree is not None:
        yield path, tree


def n_params_active(cfg: ModelConfig) -> tuple[float, float]:
    """(total params, active-per-token params) — analytic, embedding-less
    for the FLOPs estimate (embeddings are lookups, the unembed matmul is
    charged separately by ce/logits).  The shapes come from the port's
    ``init_params`` on the ``meta`` device; the reference's path filters
    apply (``embed`` and ``_pos`` leaves are not active, ``moe/`` experts
    count ``top_k / n_experts``).  Whisper's tree is its family's
    (``whisper.init_params``), as in the reference."""
    from repro_torch.models import family_of

    params = family_of(cfg).init_params(cfg, 0, device="meta")
    total = active = 0.0
    for path, leaf in _leaves(params):
        n = 1.0
        for d in leaf.shape:
            n *= d
        total += n
        if "embed" in path or "_pos" in path:
            continue   # lookups, not matmul work (unembed charged via CE)
        if "moe/" in path and "shared" not in path and "router" not in path:
            m = cfg.moe
            active += n * (m.top_k / m.n_experts)
        else:
            active += n
    return total, active


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """6·N_active·D for train, 2·N_active·D for forward-only shapes, plus the
    vocab projection; decode counts one token per sequence."""
    shape = SHAPES[shape_name]
    _, active = n_params_active(cfg)
    tokens = shape.tokens_per_step
    mult = 6.0 if shape.kind == "train" else 2.0
    vocab_proj = 2.0 * tokens * cfg.d_model * cfg.vocab_size
    if shape.kind == "train":
        vocab_proj *= 3.0
    return mult * active * tokens + vocab_proj


def _extrapolate(rec: dict, key_path: tuple[str, ...]) -> float:
    """fixed + per_layer × n_periods from the two unrolled probes."""
    def get(block):
        cur = rec[block]
        for k in key_path:
            cur = cur.get(k, 0.0) if isinstance(cur, dict) else 0.0
        return float(cur or 0.0)

    p1, p2 = get("probe1"), get("probe2")
    per_period = max(p2 - p1, 0.0)
    fixed = max(p1 - per_period, 0.0)
    return fixed + per_period * rec.get("n_periods", 1)


def cell_roofline(rec: dict) -> Roofline | None:
    """One dry-run record's roofline row; ``None`` for a failed or skipped
    cell."""
    if not rec.get("ok") or rec.get("skipped"):
        return None
    arch, shape_name = rec["arch"], rec["shape"]
    cfg = get_config(arch, max_seq_len=SHAPES[shape_name].seq_len)
    shape = SHAPES[shape_name]

    has_probes = "probe1" in rec and "probe2" in rec
    if has_probes:
        flops = _extrapolate(rec, ("cost", "flops"))
        bytes_ = _extrapolate(rec, ("cost", "bytes"))
        coll = sum(
            _extrapolate(rec, ("collectives", k))
            for k in ("all-gather", "all-reduce", "reduce-scatter",
                      "all-to-all", "collective-permute"))
    else:
        flops = rec["full"]["cost"]["flops"]
        bytes_ = rec["full"]["cost"]["bytes"]
        coll = sum(rec["full"]["collectives"].values())

    # analytic correction: the CE loss scan body is counted once
    if shape.kind == "train":
        from repro_torch.models.lm import ce_analytic_cost

        ce = ce_analytic_cost(cfg, shape.tokens_per_step, train=True)
        # probes already contain one scan-body count; add the missing reps
        n_chunks = max(shape.seq_len // 512, 1)
        flops += ce["flops"] / N_CHIPS * (n_chunks - 1) / n_chunks
        bytes_ += ce["bytes"] / N_CHIPS * (n_chunks - 1) / n_chunks

    mf = model_flops(cfg, shape_name)
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_ / HBM_BW
    collective_s = coll / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(terms.values())
    mem = rec["full"]["memory"]
    mem_gb = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
    return Roofline(
        arch=arch,
        shape=shape_name,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        flops_per_dev=flops,
        bytes_per_dev=bytes_,
        coll_bytes_per_dev=coll,
        model_flops=mf,
        hlo_total_flops=flops * N_CHIPS,
        useful_ratio=mf / (flops * N_CHIPS) if flops else 0.0,
        bottleneck=bottleneck,
        step_time_s=step,
        mfu=mf / (N_CHIPS * PEAK_FLOPS * step) if step else 0.0,
        memory_gb=mem_gb,
        fits=mem_gb <= FITS_GB,
    )


def load_results(directory: str | Path = "results/dryrun",
                 mesh_tag: str = "sp") -> list[dict]:
    out = []
    for p in sorted(Path(directory).glob(f"*__{mesh_tag}.json")):
        out.append(json.loads(p.read_text()))
    return out


def table(directory: str | Path = "results/dryrun") -> list[Roofline]:
    rows = []
    for rec in load_results(directory):
        r = cell_roofline(rec)
        if r is not None:
            rows.append(r)
    return rows


def format_table(rows: list[Roofline]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'comp_ms':>8s} {'mem_ms':>8s} "
           f"{'coll_ms':>8s} {'bound':>7s} {'MFU':>6s} {'useful':>7s} "
           f"{'HBM_GB':>7s} fits")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: (r.arch, r.shape)):
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.compute_s*1e3:8.2f} "
            f"{r.memory_s*1e3:8.2f} {r.collective_s*1e3:8.2f} "
            f"{r.bottleneck:>7s} {r.mfu*100:5.1f}% {r.useful_ratio:7.2f} "
            f"{r.memory_gb:7.1f} {'y' if r.fits else 'N'}")
    return "\n".join(lines)


def skipped_cells(directory: str | Path = "results/dryrun") -> list[tuple]:
    out = []
    for rec in load_results(directory):
        if rec.get("skipped"):
            out.append((rec["arch"], rec["shape"], rec.get("reason", "")))
    return out


if __name__ == "__main__":
    rows = table()
    print(format_table(rows))
    for arch, shape, reason in skipped_cells():
        print(f"SKIP {arch} × {shape}: {reason}")
