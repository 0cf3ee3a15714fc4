#!/usr/bin/env python3
"""Profile one train step of a decoder on one NVIDIA GPU: where the device
time goes, by kind of kernel.

    PYTHONPATH=src python tools/profile_train_step.py gemma-7b:12 \\
        codeqwen1.5-7b:16 chameleon-34b:4 deepseek-moe-16b:8 \\
        deepseek-v2-lite-16b:7

For each ``ARCH:LAYERS`` (the depths ``chip_smoke.py``'s phases 24-25
train at), the train cell of ``launch.steps.build_cell`` at full width and
that depth runs two steps of 2 x 4,096 tokens, then one more under
``torch.profiler``; printed: the profiled step's wall time, the device's
busy time, the busy time by kind (B3, B3's backward, GEMMs, the rest:
elementwise kernels, copies and reductions, AdamW's among them) and the
largest kernels.  For a MoE arch, also the share of the GEMMs that the
expert loop's per-expert products take (the ``aten::mm`` calls on a
``d_ff_expert``-wide operand, forward, recompute and backward), and the
count of ``select`` backward nodes and slice writes (``CopySlices``) the
step ran: each would zero-fill or clone a whole tensor.  The profiler's own
cost inflates the wall time, not the device time.  ``chip_smoke.py``'s
phase 25 calls :func:`profile_arch` and :func:`describe`.  Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

#: kernel kinds, each by the substrings of the profiler's kernel names
KINDS = (("B3", ("flash_attention",)),
         ("B3's backward", ("fa_bwd",)),
         ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "gemv")))
TRAIN_B, TRAIN_S = 2, 4096
#: the autograd nodes that each build a whole-tensor gradient for a part
#: of it: a ``select`` backward zero-fills its input's size, a slice write
#: clones the written tensor's gradient
WHOLE_TENSOR_NODES = ("SelectBackward0", "CopySlices")


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "the rest (elementwise, copies, reductions)"


def profile_step(step, state, batch, expert_dim: int | None = None):
    """Run ``step(state, batch)`` once under ``torch.profiler`` (after a
    synchronise); returns ``(state, split)``: the wall ms (profiler on),
    the device's busy ms and kernel launches, ``kinds`` {kind: [ms,
    launches]}, the ten largest kernels ``top`` [(ms, launches, name)],
    ``nodes`` {node: runs} of :data:`WHOLE_TENSOR_NODES`, ``read_s`` the
    seconds the profile took to read and, with
    ``expert_dim``, ``experts`` (ms, calls) of the ``aten::mm`` calls with
    an operand dimension of ``expert_dim`` (their kernels' device time)
    and ``expert_selects``, the ``select`` backward calls whose gradient
    has that dimension (one an expert weight used, were the loop to index
    its stacked weights)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=expert_dim is not None) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    # one pass over the events: kernels group by name, ops by name and
    # input shapes
    events = prof.key_averages(group_by_input_shape=expert_dim is not None)
    rows, launches, kinds = collections.Counter(), collections.Counter(), {}
    nodes = {n: 0 for n in WHOLE_TENSOR_NODES}
    ms = calls = selects = 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] += e.self_device_time_total / 1e3
            launches[e.key] += e.count
            acc = kinds.setdefault(kind_of(e.key), [0.0, 0])
            acc[0] += e.self_device_time_total / 1e3
            acc[1] += e.count
            continue
        for n in WHOLE_TENSOR_NODES:
            if e.key.endswith(n):
                nodes[n] += e.count
        if expert_dim is not None and any(
                expert_dim in sh for sh in e.input_shapes if sh):
            if e.key == "aten::mm":
                ms += e.device_time_total / 1e3
                calls += e.count
            elif e.key == "aten::select_backward":
                selects += e.count
    split = dict(wall_ms=wall, busy_ms=sum(rows.values()),
                 launches=sum(launches.values()), kinds=kinds,
                 top=sorted(((v, launches[k], k) for k, v in rows.items()),
                            reverse=True)[:10],
                 nodes=nodes, read_s=time.perf_counter() - t0)
    if expert_dim is not None:
        split["experts"] = (ms, calls)
        split["expert_selects"] = selects
    return state, split


def describe(what: str, split: dict) -> list[str]:
    """``split`` (:func:`profile_step`'s) as printable lines."""
    busy = split["busy_ms"]
    out = [f"{what}: profiled step {split['wall_ms']:.1f} ms wall "
           f"(profiler on), {busy:.1f} ms device busy, "
           f"{split['launches']} kernel launches (the profile read in "
           f"{split['read_s']:.1f} s)"]
    for kind, (ms, n) in sorted(split["kinds"].items(),
                                key=lambda kv: -kv[1][0]):
        out.append(f"  {kind}: {ms:.1f} ms ({100 * ms / busy:.1f}% of "
                   f"busy), {n} launches")
    if "experts" in split:
        ms, n = split["experts"]
        out.append(f"  of the GEMMs, the expert loop's per-expert products: "
                   f"{ms:.1f} ms ({100 * ms / busy:.1f}% of busy), {n} "
                   f"aten::mm calls")
    out.append("  whole-tensor gradient nodes run: " + ", ".join(
        f"{n} {k}" for k, n in split["nodes"].items()) + (
        f"; select backward calls on an expert weight's rows: "
        f"{split['expert_selects']}" if "expert_selects" in split else ""))
    out += [f"  {ms:9.3f} ms {n:6d} launches  {key[:100]}"
            for ms, n, key in split["top"]]
    return out


def profile_arch(cfg) -> dict:
    """The train cell of ``cfg`` (at its width and depth) on TRAIN_B x
    TRAIN_S tokens: two steps, then :func:`profile_step` of one more (a
    MoE ``cfg``'s expert products and select backward calls counted);
    returns its split."""
    from repro_torch.configs import SHAPES
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell

    cell = build_cell(cfg, SHAPES["train_4k"], make_host_mesh())
    state = cell.init_state(0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B, seed=0))
    for i in range(2):
        state, _ = cell.run(state, data.batch(i))
    state, split = profile_step(
        cell.run, state, data.batch(2),
        cfg.moe.d_ff_expert if cfg.moe is not None else None)
    del state, cell
    torch.cuda.empty_cache()
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+", metavar="ARCH:LAYERS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build()
    from repro_torch.configs import get_config

    for cell in args.cells:
        arch, layers = cell.rsplit(":", 1)
        split = profile_arch(get_config(arch).replace(n_layers=int(layers)))
        print("\n".join(describe(f"{arch} at {layers} layers, {TRAIN_B} x "
                                 f"{TRAIN_S} tokens", split)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
