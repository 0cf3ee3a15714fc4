#!/usr/bin/env python3
"""Profile one train step of a dense decoder on one NVIDIA GPU: where the
device time goes, by kind of kernel.

    PYTHONPATH=src python tools/profile_train_step.py gemma-7b:12 \\
        codeqwen1.5-7b:16 chameleon-34b:4

For each ``ARCH:LAYERS`` (the depths ``chip_smoke.py``'s phase 24 trains
at), the train cell of ``launch.steps.build_cell`` at full width and that
depth runs two steps of 2 x 4,096 tokens, then one more under
``torch.profiler``; printed: the profiled step's wall time, the device's
busy time, the busy time by kind (B3, B3's backward, GEMMs, the rest:
elementwise kernels, copies and reductions, AdamW's among them) and the
largest kernels.  The profiler's own cost inflates the wall time, not
the device time.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
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


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "the rest (elementwise, copies, reductions)"


def profile_arch(arch: str, layers: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell

    cfg = get_config(arch).replace(n_layers=layers)
    cell = build_cell(cfg, SHAPES["train_4k"], make_host_mesh())
    state = cell.init_state(0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B, seed=0))
    for i in range(2):
        state, _ = cell.run(state, data.batch(i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = cell.run(state, data.batch(2))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    print(f"{arch} at {layers} layers, {TRAIN_B} x {TRAIN_S} tokens: "
          f"profiled step {wall:.1f} ms wall (profiler on), {busy:.1f} ms "
          f"device busy, {sum(r[1] for r in rows)} kernel launches")
    by_kind: dict[str, list[float]] = {}
    for ms, n, key in rows:
        acc = by_kind.setdefault(kind_of(key), [0.0, 0])
        acc[0] += ms
        acc[1] += n
    for kind, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind}: {ms:.1f} ms ({100 * ms / busy:.1f}% of busy), "
              f"{n} launches")
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        print(f"  {ms:9.3f} ms {n:6d} launches  {key[:100]}")
    del state, cell
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+", metavar="ARCH:LAYERS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build()
    for cell in args.cells:
        arch, layers = cell.rsplit(":", 1)
        profile_arch(arch, int(layers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
