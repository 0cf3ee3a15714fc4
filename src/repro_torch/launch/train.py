"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference's ``repro.launch.train``: the train step
(:func:`repro_torch.train.make_train_step`), the seeded synthetic data
pipeline with prefetch, async checkpointing every ``--ckpt-every`` steps
and ``--resume`` from the latest checkpoint under ``--ckpt-dir``.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain path (``--smoke``, the default, trains the arch's
smoke config).  An encoder-decoder arch trains on zero frames, as in the
reference.

Under ``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.train ...`` (or in a process whose group is already up)
it trains on the rank mesh: NCCL on ``cuda:LOCAL_RANK`` (gloo with
``--device cpu``), each rank its blocks of the state and its rows of every
global batch, checkpoints written whole by rank 0 and restored onto any
number of ranks; rank 0 prints.  Run alone, it trains on one device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, PrefetchingLoader, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import (
    close_ranks,
    init_ranks,
    launched,
    on_ranks,
)
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train.step import make_train_state_shapes


def restore_state(cfg, ckpt_dir, device=None, use_compression: bool = False,
                  step: int | None = None, mesh=None):
    """The train state saved under ``ckpt_dir`` (the latest step unless
    ``step`` is named), restored onto ``device`` in the shapes and dtypes a
    fresh state has; on a rank ``mesh``, this rank's blocks of it on the
    mesh's device.  Returns ``(state, step)``."""
    shapes = make_train_state_shapes(cfg, use_compression)(0, "meta")
    ranks = getattr(mesh, "ranks", False)
    state, manifest = ckpt.restore(
        shapes, ckpt_dir, step=step,
        device=mesh.device if ranks else resolve_device(device),
        mesh=mesh if ranks else None)
    return state, manifest["step"]


def main(argv=None) -> dict:
    """Train; returns ``{"losses": [...], "start_step": n}`` (the loss of
    every step run)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compression", action="store_true",
                    help="int8 gradient compression w/ error feedback")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    args = ap.parse_args(argv)

    own_group = launched() and not on_ranks()
    mesh, rank, w = None, 0, 1
    if launched() or on_ranks():
        dev = init_ranks(args.device)
        mesh = make_host_mesh(device=dev)
        dev, rank, w = mesh.device, mesh.rank, mesh.shape["data"]
        if args.global_batch % w:
            raise ValueError(f"--global-batch {args.global_batch} does not "
                             f"split over {w} ranks")
    else:
        dev = resolve_device(args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch, smoke=args.smoke,
                     max_seq_len=max(args.seq_len, 256))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed)
    source = SyntheticLM(data_cfg)
    frames = None
    if cfg.arch_type == "encdec":
        frames = np.zeros((args.global_batch // w, cfg.encoder.n_frames,
                           cfg.d_model), np.float32)

    opt_cfg = OptimizerConfig(lr=args.lr,
                              warmup_steps=min(20, args.steps // 5),
                              total_steps=args.steps)
    bundle = make_train_step(cfg, dev, opt_cfg,
                             use_compression=args.compression, mesh=mesh)
    specs = None if bundle.layout is None else bundle.layout.specs

    start_step = 0
    if (args.resume and args.ckpt_dir
            and ckpt.latest_step(args.ckpt_dir) is not None):
        state, start_step = restore_state(cfg, args.ckpt_dir, dev,
                                          args.compression, mesh=mesh)
        say(f"resumed from step {start_step}")
    else:
        state = bundle.init_state_fn(args.seed)

    writer = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    loader = PrefetchingLoader(source, start=start_step, host_id=rank,
                               n_hosts=w)
    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        _, batch = next(loader)
        if frames is not None:
            batch["frames"] = frames
        state, metrics = bundle.step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = (time.time() - t0) / max(step - start_step + 1, 1)
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"acc {float(metrics['accuracy']):.3f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
        if writer and (step + 1) % args.ckpt_every == 0:
            writer.save(state, step + 1, mesh=mesh, specs=specs)
    if writer:
        writer.save(state, args.steps, mesh=mesh, specs=specs)
        writer.wait()
        if mesh is not None:
            dist.barrier(group=mesh.group)  # rank 0 has written
    loader.close()
    if losses:
        say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    if own_group:
        close_ranks()
    return {"losses": losses, "start_step": start_step}


if __name__ == "__main__":
    main()
