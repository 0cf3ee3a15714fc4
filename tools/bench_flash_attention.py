#!/usr/bin/env python3
"""Check and time flash attention (kernel B3) on one NVIDIA GPU, optionally
beside the same kernel source of another checkout.

    PYTHONPATH=src python tools/bench_flash_attention.py [--parent DIR]

Prints the card (name and power limit), the TMA + wgmma kernel's build
(registers, shared memory, spill bytes) at head dims 64, 128 and 256, and
its largest difference from the plain version (``attention_ref``) on small
edge cases at each of them.  Then it times B3 with CUDA events at
qwen2.5-3b's and recurrentgemma-9b's prefill shapes beside PyTorch's SDPA
(causal; at recurrentgemma's shape also with the band as a boolean mask),
and at qwen2.5-3b's shape without the causal mask, where every CTA does
the same work.  ``--parent DIR`` names another checkout (say the parent
commit, unpacked with ``git archive``): its ``flash_attention.cu`` is
built too, with the same flags and the same C interface, and timed in
turns with this one (parent, this, this, parent) in the same process.
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
from repro_torch.kernels import flash_attention as fa

BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
#: (b, h, hkv, s, d, causal, window): the edge cases of each head dim
CHECK_CASES = (
    (1, 4, 2, 512, 64, True, None), (2, 8, 2, 512, 64, True, 16),
    (1, 4, 4, 256, 64, False, None), (1, 16, 2, 255, 128, True, None),
    (1, 4, 2, 512, 128, True, 128), (1, 4, 4, 1024, 128, False, None),
    (1, 4, 1, 512, 256, True, 128), (1, 4, 1, 255, 256, True, None),
    (1, 4, 1, 512, 256, False, None), (1, 2, 1, 1024, 256, True, 300))
QWEN = (4, 16, 2, 4096, 128, True, None)
GRIFFIN = (4, 16, 1, 4096, 256, True, 2048)
#: qwen2.5-3b's shape without the causal mask: every CTA does the same
#: work, so per-CTA set-up and the causal tail weigh less
QWEN_BIDIR = (4, 16, 2, 4096, 128, False, None)
TOL = 2e-2


def qkv(case, seed):
    b, h, hkv, s, d = case[:5]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


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


def flops(case):
    b, h, _, s, d, causal, window = case
    if not causal:
        pairs = s * s
    elif window is None:
        pairs = s * (s + 1) // 2
    else:
        pairs = sum(min(i, window) + 1 for i in range(s))
    return 4 * b * h * d * pairs


def build_parent(root: Path) -> ctypes.CDLL:
    """The other checkout's ``flash_attention.cu``, built with this tree's
    flags into ``build/kernels``."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cuh")) + [csrc / "flash_attention.cu"]:
        h.update(src.read_bytes())
    out = build.BUILD_DIR / f"libparent_flash_attention-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(csrc / "flash_attention.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.flash_attention_launch.argtypes = fa._lib().flash_attention_launch.argtypes
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def launch_with(lib, q, k, v, causal, window):
    """One call of ``lib``'s ``flash_attention_launch`` as the wrapper makes
    it, on contiguous bf16 inputs."""
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 9)(*(t.stride(i) for t in (q, k, v)
                                     for i in range(3)))
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, h,
        k.shape[1], sq, k.shape[2], d, ctypes.cast(strides, ctypes.c_void_p),
        d ** -0.5, int(causal), -1 if window is None else window,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", type=Path)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_attention: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    for d in fa.WGMMA_HEAD_DIMS:
        print(f"wgmma kernel D {d}: {fa.wgmma_attributes(d)}", flush=True)

    worst = 0.0
    for i, case in enumerate(CHECK_CASES):
        q, k, v = qkv(case, seed=i)
        causal, window = case[5:]
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        print(f"check {case}: max |diff| {err:.3g} (tolerance {TOL})",
              flush=True)
    if not worst <= TOL:
        raise AssertionError(f"B3 differs from attention_ref by {worst}")

    parent = build_parent(args.parent) if args.parent else None
    for label, case in (("qwen2.5-3b", QWEN), ("recurrentgemma-9b", GRIFFIN),
                        ("qwen2.5-3b bidirectional", QWEN_BIDIR)):
        q, k, v = qkv(case, seed=7)
        causal, window = case[5:]
        bound = flops(case) / BF16_OPS_PER_S * 1e3
        runs = [("this", lambda: fa.flash_attention(q, k, v, causal=causal,
                                                    window=window))]
        if parent is not None:
            runs = ([("parent", lambda: launch_with(parent, q, k, v, causal,
                                                    window))]
                    + runs + runs[::-1]
                    + [("parent", lambda: launch_with(parent, q, k, v,
                                                      causal, window))])
            want = fa.flash_attention(q, k, v, causal=causal, window=window)
            err = (runs[0][1]().float() - want.float()).abs().max().item()
            print(f"{label}: parent vs this max |diff| {err:.3g}")
        reps = 20 if window is None else 5
        for name, fn in runs:
            ms = cuda_ms(fn, reps)
            print(f"{label} {case}: {name} {ms:.4f} ms per call (CUDA events "
                  f"over {reps}), {100 * bound / ms:.2f}% of the "
                  f"{bound:.4f} ms bound", flush=True)
        sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), reps)
        print(f"{label}: SDPA {'causal' if causal else 'bidirectional'} "
              f"{sdpa:.4f} ms", flush=True)
        if window is not None:
            i = torch.arange(q.shape[2], device="cuda")
            band = (i[None, :] <= i[:, None]) & (i[None, :] >= i[:, None]
                                                  - window)
            ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True), reps)
            print(f"{label}: SDPA with the band as a boolean mask {ms:.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
