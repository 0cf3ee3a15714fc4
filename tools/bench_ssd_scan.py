#!/usr/bin/env python3
"""Check and time the SSD scan (kernel B4) on one NVIDIA GPU: the chunked
Hopper kernel beside the step kernel.

    PYTHONPATH=src python tools/bench_ssd_scan.py [--check-only] [--parent DIR]

Prints the card (name and power limit) and the chunked kernel's build
(registers, shared memory, spill bytes) at state widths 64 and 128, then
its largest difference from the plain version (``ssd_scan_ref``) on edge
cases: ragged lengths, a zero decay mid-chunk, b and c broadcast over heads
as the model passes them, with and without h0.  Then (unless
``--check-only``) it times both kernels with CUDA events at mamba2-370m's
full prefill shape, x (4, 32768, 32, 64) bf16 with b and c (4, 32768, 128)
broadcast over the 32 heads, in turns (step, chunked, chunked, step) in
this one process, each through the wrapper's internal launch entry, beside
the bound (the bytes the scan moves at 3.35 TB/s, or the chunked form's
FLOP at 989 TFLOP/s, whichever is larger).  ``--parent DIR`` names another
checkout (say the parent commit, unpacked with ``git archive`` into
``build/``): its ``ssd_scan.cu`` is built too, with the same flags and the
same C interface, and its chunked kernel is timed in turns with this one
(parent, this, this, parent) in the same process.  ``--scaling`` also
times the chunked kernel at batch 1, 2 and 4 over the full sequence (32,
64 and 128 CTAs, each walking the same 512 chunks): a time that holds
with the CTA count says a CTA's own chunk loop paces the kernel, one that
grows with it says a shared resource (memory, L2) does.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import ssd_scan as ssd

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
#: (b, s, h, p, n, h0, b/c broadcast over heads, zero decays mid-chunk)
CHECK_CASES = (
    (2, 72, 3, 64, 128, True, False, False),
    (2, 100, 3, 64, 128, False, True, False),
    (1, 8, 2, 64, 128, True, True, False),
    (1, 256, 2, 64, 128, True, False, True),
    (1, 256, 2, 64, 64, True, True, True),
    (2, 1024, 4, 64, 128, True, True, False),
    (1, 4096, 2, 64, 128, False, True, False),
)
FULL = (4, 32768, 32, 64, 128)
#: 1e-2 of max |value|, for y and the final state (bf16, see the tests)
RTOL = 1e-2


def inputs(shape, seed, h0=False, broadcast=True, zero_decay=False):
    b, s, h, p, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(bf)
    a = 0.2 + 0.8 * torch.rand((b, s, h), generator=g, device="cuda")
    if zero_decay:
        a[:, 100] = 0.0
        a[:, 37, -1] = 0.0
    if broadcast:
        bc = (0.3 * torch.randn((b, s, 2 * n), generator=g,
                                device="cuda")).to(bf)
        bm = bc[..., :n][:, :, None, :].expand(b, s, h, n)
        cm = bc[..., n:][:, :, None, :].expand(b, s, h, n)
    else:
        bm, cm = ((0.3 * torch.randn((b, s, h, n), generator=g,
                                     device="cuda")).to(bf)
                  for _ in range(2))
    state = (0.1 * torch.randn((b, h, p, n), generator=g, device="cuda")
             if h0 else None)
    return x, a.to(bf), bm, cm, state


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


def bound(shape) -> tuple[float, str]:
    """The least time for the scan at ``shape`` with b and c broadcast:
    x and a read, one head's b and c read, y and the final state written;
    the chunked form's FLOP at the chunked kernel's chunk length."""
    b, s, h, p, n = shape
    nbytes = 2 * (2 * b * s * h * p + b * s * h + 2 * b * s * n) \
        + 4 * b * h * p * n
    ell = ssd.CHUNK
    flops = b * h * (s // ell) * (2 * ell * ell * (n + p) + 4 * ell * n * p)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_OPS_PER_S * 1e3
    return ((t_bytes, f"bytes: {nbytes} B") if t_bytes >= t_ops
            else (t_ops, f"operations: {flops:.4g} FLOP"))


def build_parent(root: Path) -> ctypes.CDLL:
    """The other checkout's ``ssd_scan.cu``, built with this tree's flags
    into ``build/kernels``."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cuh")) + [csrc / "ssd_scan.cu"]:
        h.update(src.read_bytes())
    out = build.BUILD_DIR / f"libparent_ssd_scan-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(csrc / "ssd_scan.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.ssd_scan_chunked_launch
    fn.argtypes = ssd._lib().ssd_scan_chunked_launch.argtypes
    fn.restype = ctypes.c_int
    return lib


def launch_with(lib, x, a, bm, cm):
    """One call of ``lib``'s chunked kernel as ``ssd._launch`` makes it
    (no h0; x contiguous, b and c TMA-ready views)."""
    bsz, s, h, p = x.shape
    n = bm.shape[3]
    y = torch.empty_like(x)
    h_t = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (x, a, bm, cm)
                                      for i in range(3)))
    err = lib.ssd_scan_chunked_launch(
        x.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(), None,
        y.data_ptr(), h_t.data_ptr(), 1, bsz, s, h, p, n,
        ctypes.cast(strides, ctypes.c_void_p),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent launch failed: {err}")
    return y, h_t


def worst(got, want) -> float:
    """max |diff| over y and the final state, each relative to the plain
    version's max |value|."""
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max()).item() for g, w in zip(got, want))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check-only", action="store_true",
                   help="print the build and check the edge cases; no timing")
    p.add_argument("--parent", type=Path,
                   help="another checkout whose chunked kernel is timed too")
    p.add_argument("--scaling", action="store_true",
                   help="also time the chunked kernel at batch 1, 2 and 4")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_ssd_scan: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    for n in ssd.CHUNKED_STATE_DIMS:
        print(f"chunked kernel N {n}: {ssd.chunked_attributes(n)}",
              flush=True)

    bad = []
    for i, case in enumerate(CHECK_CASES):
        shape, (h0, broadcast, zero) = case[:5], case[5:]
        x, a, bm, cm, state = inputs(shape, i, h0, broadcast, zero)
        route = ssd.kernel_for(x.dtype, shape[3], shape[4])
        before = ssd.ssd_scan.chunked_launches
        got = ssd.ssd_scan(x, a, bm, cm, state)
        torch.cuda.synchronize()
        took = ssd.ssd_scan.chunked_launches - before
        want = ref.ssd_scan_ref(x, a, bm, cm, state)
        step = ssd._launch("step", x, a, bm, cm, state)
        torch.cuda.synchronize()
        err, err_step = worst(got, want), worst(step, want)
        finite = all(torch.isfinite(t).all().item() for t in got)
        print(f"check {case}: {route} kernel ({took} chunked launch), max "
              f"|diff| / max |value| {err:.3g} (step kernel {err_step:.3g}; "
              f"tolerance {RTOL}), finite {finite}", flush=True)
        if not (err <= RTOL and finite and route == "chunked" and took == 1):
            bad.append(case)
    if bad:
        raise AssertionError(f"the chunked kernel fails {bad}")
    if args.check_only:
        return 0

    x, a, bm, cm, _ = inputs(FULL, seed=9)
    want = ssd._launch("step", x, a, bm, cm, None)
    got = ssd._launch("chunked", x, a, bm, cm, None)
    torch.cuda.synchronize()
    print(f"full width {FULL} (b/c broadcast over heads): chunked vs step "
          f"max |diff| / max |value| {worst(got, want):.3g}", flush=True)
    del want, got
    t_bound, by = bound(FULL)
    runs = {"step": (lambda: ssd._launch("step", x, a, bm, cm, None), 5),
            "chunked": (lambda: ssd._launch("chunked", x, a, bm, cm, None),
                        50)}
    order = ["step", "chunked", "chunked", "step"]
    if args.parent is not None:
        parent = build_parent(args.parent)
        runs["parent chunked"] = (lambda: launch_with(parent, x, a, bm, cm),
                                  50)
        err = worst(runs["parent chunked"][0](), ssd._launch(
            "chunked", x, a, bm, cm, None))
        print(f"parent vs this chunked kernel: max |diff| / max |value| "
              f"{err:.3g}", flush=True)
        order = ["step", "parent chunked", "chunked", "chunked",
                 "parent chunked", "step"]
    for name in order:
        fn, reps = runs[name]
        ms = cuda_ms(fn, reps)
        print(f"{name} kernel at {FULL}: {ms:.4f} ms per call (CUDA events "
              f"over {reps}), {100 * t_bound / ms:.2f}% of the "
              f"{t_bound:.4f} ms bound ({by})", flush=True)
    if args.scaling:
        for batch in (1, 2, 4):
            xs, as_, bs, cs = (t[:batch] for t in (x, a, bm, cm))
            ms = cuda_ms(lambda: ssd._launch("chunked", xs, as_, bs, cs,
                                             None), 50)
            shape = (batch,) + FULL[1:]
            t_b, _ = bound(shape)
            print(f"scaling: chunked kernel at batch {batch} ({batch * FULL[2]}"
                  f" CTAs): {ms:.4f} ms per call, {1e3 * ms / (FULL[1] // ssd.CHUNK):.3f}"
                  f" us a chunk, {100 * t_b / ms:.2f}% of its {t_b:.4f} ms "
                  "bound", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
