"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Brings up N decode replicas of the chosen architecture's smoke config
behind the NetClone dispatcher, on the CUDA device, and drives a workload
through them, reporting tail latency — the reference's
``repro.launch.serve``, with the same options and defaults.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import family_of
from repro_torch.serve import DecodeReplica, NetCloneServer


def main(argv=None, device=None) -> None:
    """``device`` is for callers in Python (the tests pass ``"cpu"``); the
    command line always runs on CUDA."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2.5-3b")
    ap.add_argument("--policy", default="netclone",
                    choices=["baseline", "netclone", "c-clone"])
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--horizon", type=int, default=80,
                    help="arrival window in ticks")
    ap.add_argument("--new-tokens", type=int, default=4)
    ap.add_argument("--straggler", type=int, default=0,
                    help="inject this many stall ticks into replica 1")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch, smoke=True)
    if cfg.arch_type == "encdec":
        raise SystemExit("serve driver targets decoder-only archs "
                         "(whisper decode serving runs via tests/examples)")
    fam = family_of(cfg)
    params = fam.init_params(cfg, args.seed, device=dev)
    replicas = [DecodeReplica(cfg, params, sid=i, n_slots=args.slots,
                              s_max=128, device=dev)
                for i in range(args.replicas)]
    if args.straggler:
        replicas[min(1, len(replicas) - 1)].inject_slowdown(args.straggler)
    server = NetCloneServer(replicas, policy=args.policy, seed=args.seed,
                            device=dev)

    rng = np.random.default_rng(args.seed)
    workload = [(int(t), rng.integers(0, cfg.vocab_size, 4).astype(np.int32))
                for t in np.sort(rng.integers(0, args.horizon, args.requests))]
    stats = server.run(workload, max_new_tokens=args.new_tokens,
                       max_ticks=args.horizon * 50)
    print(f"policy={args.policy} completed={stats.n_completed}/{args.requests}")
    print(f"latency ticks: p50={stats.p(50):.0f} p95={stats.p(95):.0f} "
          f"p99={stats.p(99):.0f}")
    print(f"cloned={stats.n_cloned} filtered={stats.n_filtered} "
          f"clone_drops={stats.n_clone_drops}")


if __name__ == "__main__":
    main()
