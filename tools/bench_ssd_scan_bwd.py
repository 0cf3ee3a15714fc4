#!/usr/bin/env python3
"""Check and time B4's backward on one NVIDIA GPU, and profile a
mamba2-370m train step.

    PYTHONPATH=src python tools/bench_ssd_scan_bwd.py [--parent DIR] \\
        [--profile-step] [--bf16-spread]

Prints the card (name and power limit) and the builds of the backward's
two kernels (registers, shared memory, spill bytes): the step kernel
(``csrc/ssd_scan_bwd.cu``) for float32 and bf16 and the chunked one
(``csrc/ssd_scan_bwd_chunked.cu``, two kernels a call) at N 64 and 128.
Then, at mamba2-370m's training shape, x (2, 4096, 32, 64) bf16 with b and
c (2, 4096, 128) broadcast over the 32 heads, the route's kernel (the
chunked one) and the step kernel on the same inputs: their largest
difference from autograd through the plain scan (``ssd_scan_bwd_ref``),
and their times by CUDA events beside the bound (``chip_smoke.py``'s
``ssd_bwd_bound``: the chunked form's backward on the bf16 tensor cores at
989 TFLOP/s, at the chunk length where it is least, or the bytes at 3.35
TB/s) and the plain version's, then each build's host time a call (the
Python wrapper, and its C launch entry alone).  ``--parent DIR`` names
another tree (an
earlier checkout unpacked with ``git archive`` into ``build/``, which
``.gitignore`` lists): its backward for these inputs (its
``ssd_scan_bwd_chunked.cu`` if it has one, else its ``ssd_scan_bwd.cu``,
with the C interface of this tree's file of that name) is built with this
tree's flags, checked against this one, and both are timed in turns
(parent, this, this, parent) in this one process.  ``--profile-step``
runs mamba2-370m at full width and depth through ``build_cell``'s train
cell (2 x 4,096 tokens): two steps' wall time and the host time of their
calls of B4's backward, then one step profiled: wall time, device busy
and the kernels that take the most device time.  ``--bf16-spread`` takes the
same model and batch and holds each leaf's gradient through B4 (bf16
activations) against the plain scan's (``attn_impl="xla"``) in bf16 and
in float32 activations, then looks for what moves the plain path's bf16
gradients from float32's: it reruns the plain bf16 step with the scan's
decay rounded to bf16 but its gradient kept in float32, and with the decay
not rounded at all, and reports how much each layer's ``a_log`` gradient
sum cancels.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import ssd_scan as ssd

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ssd_bwd_bound  # noqa: E402

TRAIN = (2, 4096, 32, 64, 128)
DEPTHS = (1, 2, 4, 8, 16)   # --bf16-spread: mamba2-370m cut to these


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(shape, seed):
    """x, a, b and c broadcast over heads, dy (bf16), as the model's train
    step hands them to the backward."""
    b, s, h, p, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(bf)
    a = torch.empty((b, s, h), device="cuda").uniform_(
        0.6, 1.0, generator=g).to(bf)
    bm, cm = ((torch.randn((b, s, 1, n), generator=g, device="cuda")
               * n ** -0.5).to(bf).expand(b, s, h, n) for _ in range(2))
    dy = torch.randn((b, s, h, p), generator=g, device="cuda").to(bf)
    return x, a, bm, cm, dy


def bound(shape) -> tuple[float, str]:
    """The least time of the backward at ``shape`` in bf16, as
    ``chip_smoke.py``'s ``ssd_bwd_bound`` reckons it."""
    t, by, flops, nbytes, ell = ssd_bwd_bound((*shape, "bfloat16", False,
                                              False))
    return t, (f"{by}: {flops:.4g} FLOP at {ell}-step chunks, {nbytes} B")


def worst(got, want) -> float:
    return max(((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
               for a, b in zip(got, want) if b is not None)


#: a backward source, the loader of this tree's build of it, its C entry
#: points and the function that launches it
KERNELS = {"ssd_scan_bwd_chunked": ("_bwd_chunked_lib",
                                    ("ssd_scan_bwd_chunked_launch",
                                     "ssd_scan_bwd_chunked_scratch"),
                                    "ssd_scan_bwd_chunked"),
           "ssd_scan_bwd": ("_bwd_lib", ("ssd_scan_bwd_launch",
                                         "ssd_scan_bwd_scratch"),
                            "ssd_scan_bwd_step")}


def build_parent(root: Path) -> tuple[str, ctypes.CDLL]:
    """The other tree's backward for bf16 at P 64 (its chunked kernel's
    source if it has one, else its step kernel's), built with this tree's
    flags into ``build/kernels``, its C interface declared as this tree's
    file of that name; returns ``(source name, library)``."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    name = next(n for n in KERNELS if (csrc / f"{n}.cu").is_file())
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cuh")) + [csrc / f"{name}.cu"]:
        h.update(src.read_bytes())
    out = build.BUILD_DIR / f"libparent_{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(csrc / f"{name}.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    loader, entries, _ = KERNELS[name]
    mine = getattr(ssd, loader)()
    for fn in entries:
        getattr(lib, fn).argtypes = getattr(mine, fn).argtypes
        getattr(lib, fn).restype = getattr(mine, fn).restype
    return name, lib


def call_with(kernel, lib, ins):
    """The backward of ``kernel`` (a key of :data:`KERNELS`) on ``ins``
    (bf16 at P 64, ``dy`` contiguous), through ``lib`` (``None``: this
    tree's build)."""
    loader, _, fn = KERNELS[kernel]
    if lib is None:
        return getattr(ssd, fn)(*ins)
    saved = getattr(ssd, loader)
    setattr(ssd, loader, lambda: lib)
    try:
        return getattr(ssd, fn)(*ins)
    finally:
        setattr(ssd, loader, saved)


class _TimedLib:
    """A kernel library whose launch entry point ``entry`` adds its host
    time to ``seconds``."""

    def __init__(self, lib, entry):
        self._lib, self._entry, self.seconds = lib, entry, 0.0

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != self._entry:
            return fn

        def timed(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                self.seconds += time.perf_counter() - t0
        return timed


def host_us(kernel, lib, ins, calls=50) -> tuple[float, float]:
    """Host time a call of ``kernel``'s backward (a key of
    :data:`KERNELS`, through ``lib``; ``None``: this tree's build) on
    ``ins``, in µs: the whole Python wrapper (from the call to its return;
    the launches are asynchronous) and its C launch entry point alone
    (encoding the TMA maps, setting attributes, launching), medians over
    ``calls`` calls."""
    loader, entries, _ = KERNELS[kernel]
    timed = _TimedLib(lib if lib is not None else getattr(ssd, loader)(),
                      entries[0])
    call_with(kernel, timed, ins)
    torch.cuda.synchronize()
    whole, entry = [], []
    for _ in range(calls):
        timed.seconds = 0.0
        t0 = time.perf_counter()
        call_with(kernel, timed, ins)
        whole.append(time.perf_counter() - t0)
        entry.append(timed.seconds)
    torch.cuda.synchronize()
    return (1e6 * sorted(whole)[calls // 2], 1e6 * sorted(entry)[calls // 2])


def profile_step() -> None:
    """One mamba2-370m train step (2 x 4,096 tokens) through build_cell,
    profiled after a warm-up step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell

    cfg = get_config("mamba2-370m")
    cell = build_cell(cfg, SHAPES["train_4k"], make_host_mesh())
    state = cell.init_state(0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN[1], global_batch=TRAIN[0],
                                  seed=0))
    wrapped, host = ssd.ssd_scan_bwd, []

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return wrapped(*args)
        finally:
            host.append(time.perf_counter() - t0)
    for i in range(2):
        host.clear()
        # the wrapper counts its calls on the module's name, here `timed`
        timed.launches = wrapped.launches
        ssd.ssd_scan_bwd = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            state, _ = cell.run(state, data.batch(i))
            torch.cuda.synchronize()
        finally:
            ssd.ssd_scan_bwd, wrapped.launches = wrapped, timed.launches
        print(f"step {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms; B4's "
              f"backward: {len(host)} calls, {1e3 * sum(host):.2f} ms host "
              f"time in all (the wrapper, from call to return)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = cell.run(state, data.batch(2))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows) / 1e3
    print(f"profiled step: {wall:.1f} ms wall (profiler on), {busy:.1f} ms "
          f"device busy, {sum(r[1] for r in rows)} kernel launches")
    for us, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.3f} ms {n:6d} launches  {key[:100]}")


class _RoundedDecay(torch.autograd.Function):
    """The decay's values rounded to bf16 as the model rounds them, its
    gradient passed back in float32 (not rounded)."""

    @staticmethod
    def forward(ctx, a):
        return a.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


def _mamba2_forward_with(decay, seen):
    """``models.recurrent.mamba2_forward`` (training: no cache) through the
    plain scan, its decay handed to the scan as ``decay(a)`` of the float32
    decay ``a``; each layer's float32 decay and the gradient that reaches
    the scan's decay are appended to ``seen``."""
    import torch.nn.functional as F

    from repro_torch.models import recurrent as rec

    def forward(cfg, p, x, *, make_cache=False):
        s = cfg.ssm
        bsz, sl, _ = x.shape
        z, xin, b_c, dt, d_inner, n_heads = rec._mamba2_split(cfg, p, x)
        conv_out, _ = rec._causal_conv(torch.cat([xin, b_c], dim=-1),
                                       p["conv_w"].to(x.dtype))
        conv_out = F.silu(conv_out + p["conv_b"].to(x.dtype))
        xin, b_mat, c_mat = torch.split(
            conv_out, [d_inner, s.d_state, s.d_state], dim=-1)
        dt = F.softplus(dt.float() + p["dt_bias"])
        a = torch.exp(-dt * torch.exp(p["a_log"]))
        xh = xin.reshape(bsz, sl, n_heads, s.headdim)
        xd = (xh.float() * dt[..., None]).to(x.dtype)
        bh = b_mat[:, :, None, :].expand(bsz, sl, n_heads, s.d_state)
        ch = c_mat[:, :, None, :].expand(bsz, sl, n_heads, s.d_state)
        a_in = decay(a)
        if a_in.requires_grad:
            entry = [a.detach(), None]
            seen.append(entry)
            a_in.register_hook(lambda g: entry.__setitem__(1, g.float()))
        y, _ = ref.ssd_scan_ref(xd, a_in, bh, ch, chunk=s.chunk)
        y = y.float() + xh.float() * p["d_skip"][..., None]
        y = y.reshape(bsz, sl, d_inner).to(x.dtype)
        return rec._mamba2_out(cfg, p, y, z, x.dtype), None

    return forward


def bf16_spread() -> None:
    """Phase 21's leaf-by-leaf comparison of mamba2-370m's gradients at
    random init, and what drives the bf16 path's distance from float32."""
    import statistics

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recurrent as rec
    from repro_torch.train import tree as ttree
    from repro_torch.train.step import batch_on, loss_and_grads

    gate = 5e-2
    cfg = get_config("mamba2-370m")
    state = build_cell(cfg, SHAPES["train_4k"], make_host_mesh()).init_state(0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN[1], global_batch=TRAIN[0],
                                  seed=0))
    b0 = batch_on(data.batch(0), "cuda")
    paths = ["/".join(map(str, p)) for p, _ in ttree.flatten(state.params)]
    plain = cfg.replace(attn_impl="xla")

    def grads(c):
        return loss_and_grads(c, state.params, b0)[2]

    def rel(got, want):
        return [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(got, want)]

    kern, xla = grads(cfg), grads(plain)
    x32 = grads(plain.replace(dtype="float32"))
    kx, xx, kx32 = rel(kern, xla), rel(xla, x32), rel(kern, x32)
    del kern

    def q(v):
        v = sorted(v)
        return (f"quartiles {v[len(v) // 4]:.3g} / {statistics.median(v):.3g}"
                f" / {v[3 * len(v) // 4]:.3g}, max {v[-1]:.3g}")

    print(f"{len(paths)} leaves, max |diff| / max |grad| a leaf")
    print(f"B4 path vs plain, both bf16: {q(kx)}; {sum(k > gate for k in kx)}"
          f" over {gate}")
    print(f"B4 path in bf16 vs plain in float32: {q(kx32)}")
    print(f"plain bf16 vs plain float32: {q(xx)}; "
          f"{sum(x <= gate for x in xx)} within {gate}")
    by_kind = {}
    for i, p in enumerate(paths):
        by_kind.setdefault(p.split("/")[-1], []).append(i)
    for k, ix in sorted(by_kind.items()):
        print(f"  '{k}' ({len(ix)} leaves): B4 vs plain median "
              f"{statistics.median(kx[i] for i in ix):.3g} max "
              f"{max(kx[i] for i in ix):.3g}; plain bf16 vs float32 median "
              f"{statistics.median(xx[i] for i in ix):.3g} max "
              f"{max(xx[i] for i in ix):.3g}")

    # by depth: the same width and seed cut to fewer layers
    for depth in DEPTHS:
        c = cfg.replace(n_layers=depth)
        st = build_cell(c, SHAPES["train_4k"],
                        make_host_mesh()).init_state(0)
        cp = c.replace(attn_impl="xla")
        k_, x_ = (loss_and_grads(cc, st.params, b0)[2] for cc in (c, cp))
        x32_ = loss_and_grads(cp.replace(dtype="float32"), st.params, b0)[2]
        kxd, xxd = rel(k_, x_), rel(x_, x32_)
        held = [i for i in range(len(xxd)) if xxd[i] <= gate]
        print(f"depth {depth}: B4 vs plain, both bf16: {q(kxd)}; plain bf16 "
              f"vs float32: {q(xxd)}; {len(held)} of {len(xxd)} leaves "
              f"within {gate} of float32, B4 vs plain over them max "
              f"{max((kxd[i] for i in held), default=float('nan')):.3g}")
        del st, k_, x_, x32_
    torch.cuda.empty_cache()

    saved = rec.mamba2_forward
    variants = {"as the model (decay and its gradient in bf16)":
                lambda a: a.to(torch.bfloat16),
                "decay rounded to bf16, its gradient float32":
                _RoundedDecay.apply,
                "decay float32 both ways": lambda a: a}
    a_log = [i for i, p in enumerate(paths) if p.endswith("a_log")]
    for name, decay in variants.items():
        seen = []
        rec.mamba2_forward = _mamba2_forward_with(decay, seen)
        try:
            g = grads(plain)
        finally:
            rec.mamba2_forward = saved
        r = rel(g, x32)
        same = max(rel(g, xla)) if name.startswith("as the model") else None
        rest = [r[i] for i in range(len(paths)) if i not in a_log]
        print(f"plain bf16 step, {name}: against float32 activations, "
              f"a_log median {statistics.median(r[i] for i in a_log):.3g} "
              f"max {max(r[i] for i in a_log):.3g}; every other leaf "
              f"median {statistics.median(rest):.3g} max {max(rest):.3g}"
              + (f"; against the plain step {same:.3g}" if same is not None
                 else ""))
        if name.startswith("decay rounded"):
            # d a_log[h] = sum over (b, s) of da * a * log(a): how much
            # the sum cancels, and the error bf16 rounding of da alone
            # would give it
            ratio, est = [], []
            for a, da in (e for e in seen if e[1] is not None):
                t = (da * a * torch.log(a)).reshape(-1, a.shape[-1])
                tot = t.sum(0).abs().clamp_min(1e-30)
                ratio += (t.abs().sum(0) / tot).tolist()
                est += (2.0 ** -9 * t.square().sum(0).sqrt() / tot).tolist()
            print(f"  a_log's sums over (batch, step), {len(ratio)} heads: "
                  f"sum |term| / |sum| median {statistics.median(ratio):.3g}, "
                  f"max {max(ratio):.3g}; bf16 rounding of da alone "
                  f"(2^-9 rms, relative to the sum) median "
                  f"{statistics.median(est):.3g}, max {max(est):.3g}")
        del g
    # the float32 step with only the scan's decay rounded to bf16: what
    # rounding the decay alone does to the gradients
    seen = []
    rec.mamba2_forward = _mamba2_forward_with(
        lambda a: a.to(torch.bfloat16).float(), seen)
    try:
        r = rel(grads(plain.replace(dtype="float32")), x32)
    finally:
        rec.mamba2_forward = saved
    print(f"plain float32 step, only the decay rounded to bf16: against "
          f"float32 activations {q(r)}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", type=Path,
                   help="another tree's ssd_scan_bwd.cu to time beside")
    p.add_argument("--profile-step", action="store_true",
                   help="profile one mamba2-370m train step")
    p.add_argument("--bf16-spread", action="store_true",
                   help="mamba2-370m's gradients leaf by leaf in bf16 and "
                        "float32, and what moves bf16's")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_ssd_scan_bwd: no CUDA device", file=sys.stderr)
        return 2
    build.build(("ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_chunked"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    for dt in (torch.float32, torch.bfloat16):
        print(f"step kernel build ({dt}): {ssd.bwd_attributes(dt)}")
    for n in ssd.CHUNKED_STATE_DIMS:
        for k, a in ssd.chunked_bwd_attributes(n).items():
            print(f"chunked build at N {n}, {k} kernel: {a}")
    ins = list(inputs(TRAIN, seed=0)) + [None, None]
    ins[4] = ins[4].contiguous()
    want = ref.ssd_scan_bwd_ref(*ins)
    route = ssd.bwd_kernel_for(torch.bfloat16, TRAIN[3], TRAIN[4])
    got = ssd.ssd_scan_bwd(*ins)
    print(f"at x {TRAIN[:4]}, N {TRAIN[4]} (bf16, b/c broadcast), the "
          f"route's {route} kernel: max |diff| / max |grad| against autograd "
          f"through the plain scan {worst(got, want):.3g}")
    runs = {"this": ("ssd_scan_bwd_chunked", None),
            "step": ("ssd_scan_bwd", None)}
    print(f"the step kernel on the same inputs: "
          f"{worst(call_with('ssd_scan_bwd', None, ins), want):.3g}")
    order = ["step", "this", "this", "step"]
    if args.parent is not None:
        runs["parent"] = build_parent(args.parent)
        print(f"parent ({runs['parent'][0]}.cu) vs this: max |diff| / max "
              f"|grad| {worst(call_with(*runs['parent'], ins), got):.3g}")
        order = ["parent", "this", "this", "parent"] + order
    t_bound, by = bound(TRAIN)
    for name in order:
        reps = 10 if name == "step" or runs[name][0] == "ssd_scan_bwd" \
            else 50
        ms = cuda_ms(lambda: call_with(*runs[name], ins), reps)
        print(f"{name} ({runs[name][0]}.cu): {ms:.4f} ms a call (CUDA "
              f"events over {reps} calls); bound {t_bound:.5f} ms ({by}) = "
              f"{100 * t_bound / ms:.2f}%")
    print(f"plain: {cuda_ms(lambda: ref.ssd_scan_bwd_ref(*ins), 2):.4f} ms "
          f"a call")
    for name in order:
        whole, entry = host_us(*runs[name], ins)
        print(f"{name} ({runs[name][0]}.cu): host time a call {whole:.1f} "
              f"us (the Python wrapper, call to return), of which its C "
              f"launch entry {entry:.1f} us (medians over 50 calls)")
    if args.profile_step:
        profile_step()
    if args.bf16_spread:
        bf16_spread()
    return 0


if __name__ == "__main__":
    sys.exit(main())
