#!/usr/bin/env python3
"""Count where torch's CUDA division by a Python number differs from true
float32 division, and whether it moves FleetSim's latency bins.

    PYTHONPATH=src python tools/check_scalar_division.py [--n 5000000]

On a card, ``tensor / python_float`` may be computed as a multiply by the
float32 reciprocal of the number, which can differ from ``tensor /
tensor`` (true division, as on the CPU and in the reference's XLA) in the
last bit.  The always-on client stage bins latencies with ``log(lat /
lo) / log_g`` (``repro_torch.fleetsim.stages.stage_client``); this script
draws ``--n`` latencies uniformly over 1-5,000 µs from seed 0 and counts
(1) quotients whose bits differ between the two forms and (2) histogram
bins that differ, on the card, and checks the tensor form against the CPU.
It prints the card's name and power limit.  Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=5_000_000)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("check_scalar_division: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import random as jr
    from repro_torch.fleetsim.config import FleetConfig

    cfg = FleetConfig()
    lo = float(np.float32(cfg.hist_lo_us))
    log_g = float(np.log(cfg.hist_growth))
    lat = np.random.default_rng(0).uniform(1.0, 5000.0, args.n)
    lat = torch.from_numpy(lat.astype(np.float32))

    def bins(x, divisor):
        q = jr.log_f32(torch.clamp(x, min=lo) / lo) / divisor
        return q, torch.clamp(q, 0, cfg.hist_bins - 1).to(torch.int64)

    cuda = lat.cuda()
    q_scalar, b_scalar = bins(cuda, log_g)
    q_tensor, b_tensor = bins(cuda, torch.full_like(cuda, log_g))
    q_cpu, b_cpu = bins(lat, log_g)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    n_q = int((q_scalar != q_tensor).sum())
    n_b = int((b_scalar != b_tensor).sum())
    cpu_q = int((q_tensor.cpu() != q_cpu).sum())
    cpu_b = int((b_tensor.cpu() != b_cpu).sum())
    print(f"{args.n} latencies: on the card, x / python_float and x / "
          f"tensor differ in {n_q} quotients and {n_b} bins; the tensor "
          f"form against the CPU's x / python_float: {cpu_q} quotients, "
          f"{cpu_b} bins")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
