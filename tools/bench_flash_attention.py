#!/usr/bin/env python3
"""Check and time flash attention (kernel B3) on one NVIDIA GPU, optionally
beside the same kernel source of another checkout.

    PYTHONPATH=src python tools/bench_flash_attention.py [--parent DIR]
    PYTHONPATH=src python tools/bench_flash_attention.py --bwd [--parent DIR]

Prints the card (name and power limit), the TMA + wgmma kernel's build
(registers, shared memory, spill bytes) at head dims 64, 96, 128 and 256,
and its largest difference from the plain version (``attention_ref``) on
small edge cases at each of them.  Then it times B3 with CUDA events at
qwen2.5-3b's, recurrentgemma-9b's and phi3-mini's (head dim 96) prefill
shapes beside PyTorch's SDPA (causal; at recurrentgemma's shape also with
the band as a boolean mask; at phi3-mini's also under its flash and cuDNN
back ends), and at qwen2.5-3b's shape without the causal mask, where every
CTA does the same work.  ``--parent DIR`` names another checkout (say the
parent commit, unpacked with ``git archive``): its ``flash_attention.cu`` is
built too, with the same flags and the same C interface, and timed in
turns with this one (parent, this, this, parent) in the same process
(a parent before the head-dim-96 kernel runs phi3-mini's shape on its
scalar-FMA kernel).

``--bwd`` checks and times B3's backward instead: the tensor-core kernels'
build (registers, shared memory, spill bytes) at head dims 64, 96, 128
and 256, their largest difference from autograd through ``attention_ref``
on edge cases, and two calls held bit-equal; then each of
``chip_smoke.py``'s phase-20 shapes and phi3-mini's training shape (head
dim 96) timed beside SDPA's backward (at phi3-mini's also under its flash
and cuDNN back ends), the bound, and, with ``--parent DIR``, the other
checkout's ``flash_attention_bwd.cu`` (through its own C interface; each
of its bf16 calls also runs the forward for its log-sum-exp and copies
q, k, v contiguous) in turns (parent, this, this, parent), at the head
dims that checkout builds (a parent before this kernel has no backward
at 96).  At qwen2.5-3b's training shape it also profiles one call (device
time by kernel) and times the forward with and without the log-sum-exp
output.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as fa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import sdpa_backends_ms  # noqa: E402

BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
#: (b, h, hkv, s, d, causal, window): the edge cases of each head dim
CHECK_CASES = (
    (1, 4, 2, 512, 64, True, None), (2, 8, 2, 512, 64, True, 16),
    (1, 4, 4, 256, 64, False, None), (1, 16, 2, 255, 128, True, None),
    (1, 4, 2, 512, 128, True, 128), (1, 4, 4, 1024, 128, False, None),
    (1, 4, 1, 512, 256, True, 128), (1, 4, 1, 255, 256, True, None),
    (1, 4, 1, 512, 256, False, None), (1, 2, 1, 1024, 256, True, 300),
    (1, 32, 32, 512, 96, True, None), (1, 4, 4, 300, 96, True, 16),
    (2, 8, 2, 384, 96, False, None))
QWEN = (4, 16, 2, 4096, 128, True, None)
GRIFFIN = (4, 16, 1, 4096, 256, True, 2048)
PHI3 = (4, 32, 32, 4096, 96, True, None)
#: qwen2.5-3b's shape without the causal mask: every CTA does the same
#: work, so per-CTA set-up and the causal tail weigh less
QWEN_BIDIR = (4, 16, 2, 4096, 128, False, None)
TOL = 2e-2
#: backward edge cases (b, h, hkv, sq, skv, d, causal, window): ragged
#: 255 rows, a window of 16, a group of 8, whisper's cross-attention (Sq
#: 448 over 1,500 keys), MHA at D 64, a window wider than a tile
BWD_CHECK_CASES = (
    (1, 16, 2, 255, 255, 128, True, None), (2, 8, 2, 512, 512, 64, True, 16),
    (1, 16, 2, 512, 512, 128, True, None), (2, 6, 6, 448, 1500, 64, False,
                                             None),
    (1, 4, 4, 300, 300, 64, True, None), (1, 2, 2, 512, 512, 128, True, 100),
    (1, 4, 2, 1024, 1024, 128, False, None),
    (1, 32, 32, 384, 384, 96, True, None), (2, 8, 2, 300, 300, 96, True, 16),
    (1, 4, 2, 200, 700, 96, False, None))
#: chip_smoke.py's phase-20 shapes (b, h, hkv, sq, skv, d, causal, window,
#: dtype): qwen2.5-3b's training step, whisper-tiny's encoder and cross,
#: a float32 GQA window; and phase 23's phi3-mini training step
BWD_SHAPES = (
    ("qwen2.5-3b", (2, 16, 2, 4096, 4096, 128, True, None, "bfloat16")),
    ("phi3-mini", (2, 32, 32, 4096, 4096, 96, True, None, "bfloat16")),
    ("whisper encoder", (2, 6, 6, 1500, 1500, 64, False, None, "bfloat16")),
    ("whisper cross", (2, 6, 6, 448, 1500, 64, False, None, "bfloat16")),
    ("float32 window", (2, 8, 2, 512, 512, 128, True, 128, "float32")))
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def build_parent(root: Path, name: str = "flash_attention"):
    """The other checkout's ``<name>.cu``, built with this tree's flags into
    ``build/kernels``; returns the library and its source."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cuh")) + [csrc / f"{name}.cu"]:
        h.update(src.read_bytes())
    out = build.BUILD_DIR / f"libparent_{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(csrc / f"{name}.cu")], check=True)
    return ctypes.CDLL(str(out)), (csrc / f"{name}.cu").read_text()


def parent_forward(root: Path) -> ctypes.CDLL:
    """The other checkout's forward; its ``flash_attention_launch`` takes
    an ``lse`` pointer after ``out`` from the backward's redesign on."""
    lib, src = build_parent(root)
    argtypes = list(fa._lib().flash_attention_launch.argtypes)
    lib.has_lse = "void* lse" in src.split("flash_attention_launch(")[-1]
    if not lib.has_lse:
        del argtypes[4]
    lib.flash_attention_launch.argtypes = argtypes
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def launch_with(lib, q, k, v, causal, window):
    """One call of ``lib``'s ``flash_attention_launch`` as the wrapper makes
    it, on contiguous bf16 inputs."""
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 9)(*(t.stride(i) for t in (q, k, v)
                                     for i in range(3)))
    lse = [None] if lib.has_lse else []
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lse, 1, b,
        h, k.shape[1], sq, k.shape[2], d,
        ctypes.cast(strides, ctypes.c_void_p), d ** -0.5, int(causal),
        -1 if window is None else window,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def parent_backward(root: Path):
    """The other checkout's backward, called as its own wrapper calls it:
    ``fn(q, k, v, out, dout, causal, window) -> (dq, dk, dv)``."""
    lib, src = build_parent(root, "flash_attention_bwd")
    new = "fa_bwd_dkdv_wgmma" in src
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [p] * 10 + [i] * 7 + [
        p, ctypes.c_float, i, i, p]
    lib.flash_attention_bwd_launch.restype = i

    def fn(q, k, v, out, dout, causal, window):
        b, h, sq, d = q.shape
        q, k, v = (t.contiguous() for t in (q, k, v))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if new and q.dtype == torch.bfloat16:
            lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
            fa._forward(q, k, v, causal, window, d ** -0.5, lse)
            pad = -(-sq // 128) * 128
            scratch = torch.empty((2, b, h, pad), dtype=torch.float32,
                                  device="cuda")
        else:
            lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
            scratch = torch.empty_like(lse)
        strides = (ctypes.c_int64 * 9)(*(t.stride(j) for t in (q, k, v)
                                         for j in range(3)))
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(),
            0 if q.dtype == torch.float32 else 1, b, h, k.shape[1], sq,
            k.shape[2], d, ctypes.cast(strides, ctypes.c_void_p), d ** -0.5,
            int(causal), -1 if window is None else window,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent backward failed: {err}")
        return dq, dk, dv
    fn.head_dims = {int(x) for x in re.findall(r"FA_BWD_WGMMA\((\d+)\)",
                                                src)}
    return fn


def profile_kernels(fn) -> dict:
    """Device microseconds of each kernel in one call of ``fn`` (the
    second of two), by ``torch.profiler``; empty if it recorded none."""
    from torch.profiler import ProfilerActivity, profile, schedule

    out = {}

    def collect(prof):
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep")):
                out[e.key[:60]] = round(e.self_device_time_total, 1)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=collect) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return out


def bwd_inputs(case, seed):
    """q, k, v (the model's (B, S, H, D) tensors transposed) and dO."""
    b, h, hkv, sq, skv, d = case[:6]
    dt = getattr(torch, case[8]) if len(case) > 8 else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
               .transpose(1, 2) for shape in ((b, sq, h, d), (b, skv, hkv, d),
                                              (b, skv, hkv, d)))
    return q, k, v, torch.randn((b, h, sq, d), generator=g,
                                device="cuda").to(dt)


def rel_err(got, want):
    """max |diff| / max |grad| of each of dq, dk, dv."""
    return [((a.float() - b.float()).abs().max()
             / b.float().abs().max()).item() for a, b in zip(got, want)]


def bwd_flops(case):
    """2.5x the forward's FLOP over the pairs the mask keeps (the five
    products the backward needs), as chip_smoke.py's bound."""
    b, h, _, sq, skv, d, causal, window = case[:8]
    if not causal:
        pairs = sq * skv
    elif window is None:
        pairs = sq * (sq + 1) // 2
    else:
        pairs = sum(min(i, window) + 1 for i in range(sq))
    return 2.5 * 4 * b * h * d * pairs


def main_bwd(parent_dir) -> int:
    """``--bwd``: B3's backward (see the module's docstring)."""
    for d in fa.BWD_HEAD_DIMS:
        print(f"backward kernels D {d}: {fa.bwd_wgmma_attributes(d)}",
              flush=True)
    worst = 0.0
    for i, case in enumerate(BWD_CHECK_CASES):
        q, k, v, do = bwd_inputs(case, seed=i)
        causal, window = case[6:8]
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                               window=window)
        want = ref.attention_bwd_ref(q, k, v, do, causal=causal,
                                     window=window)
        lse_err = (lse - ref.attention_lse_ref(
            q, k, v, causal=causal, window=window)).abs().max().item()
        got = fa.flash_attention_bwd(q, k, v, out, do, causal=causal,
                                     window=window, lse=lse)
        again = fa.flash_attention_bwd(q, k, v, out, do, causal=causal,
                                       window=window, lse=lse)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        err = rel_err(got, want)
        worst = max(worst, *err)
        print(f"check {case}: dq, dk, dv max |diff| / max |grad| "
              f"{', '.join(f'{e:.3g}' for e in err)} (tolerance "
              f"{BWD_RTOL['bfloat16']}); two calls "
              f"{'bit-equal' if same else 'DIFFER'}; LSE max |diff| "
              f"{lse_err:.3g}", flush=True)
        worst = worst if same else float("inf")
    if not worst <= BWD_RTOL["bfloat16"]:
        raise AssertionError(f"B3's backward differs: {worst}")

    parent = parent_backward(parent_dir) if parent_dir else None
    for label, case in BWD_SHAPES:
        q, k, v, do = bwd_inputs(case, seed=7)
        causal, window, dtype = case[6:9]
        out, lse = (fa.flash_attention_with_lse(q, k, v, causal=causal,
                                                window=window)
                    if dtype == "bfloat16" else
                    (fa.flash_attention(q, k, v, causal=causal,
                                        window=window), None))
        reps = 10 if case[3] >= 4096 else 30

        def this():
            return fa.flash_attention_bwd(q, k, v, out, do, causal=causal,
                                          window=window, lse=lse)
        runs = [("this", this)]
        if parent is not None and case[5] in parent.head_dims:
            par = ("parent", lambda: parent(q, k, v, out, do, causal, window))
            want = this()
            err = rel_err(par[1](), want)
            print(f"{label}: parent vs this max |diff| / max |grad| "
                  f"{', '.join(f'{e:.3g}' for e in err)}", flush=True)
            runs = [par] + runs + runs + [par]
        bound = bwd_flops(case) / (BF16_OPS_PER_S if dtype == "bfloat16"
                                   else 67e12) * 1e3
        for name, fn in runs:
            ms = cuda_ms(fn, 3 if name == "parent" and reps == 10 else reps)
            print(f"{label} {case}: {name} {ms:.4f} ms per call (CUDA events"
                  f"), {100 * bound / ms:.2f}% of the {bound:.4f} ms bound",
                  flush=True)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        mask = None
        if window is not None:
            i = torch.arange(case[3], device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :]
                                                  >= i[:, None] - window)
        y = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=case[2] < case[1])
        sdpa = cuda_ms(lambda: torch.autograd.grad(y, leaves, do,
                                                   retain_graph=True), reps)
        print(f"{label}: SDPA's backward {sdpa:.4f} ms", flush=True)
        if label == "phi3-mini":
            def sdpa_fwd_bwd():
                z = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, is_causal=True)
                return torch.autograd.grad(z, leaves, do)
            fwd = cuda_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(*leaves,
                                                        is_causal=True), reps)
            print(f"{label}: SDPA's forward and backward by back end: "
                  f"{sdpa_backends_ms(torch, sdpa_fwd_bwd, reps)} (the forward "
                  f"alone, default back end, {fwd:.4f} ms)", flush=True)
        if label == "qwen2.5-3b":
            print(f"{label}: one call's kernels (device us, profiler): "
                  f"{profile_kernels(this)}", flush=True)
            plain = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
            with_lse = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v),
                               20)
            print(f"{label}: forward {plain:.4f} ms, with the log-sum-exp "
                  f"{with_lse:.4f} ms", flush=True)
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", type=Path)
    p.add_argument("--bwd", action="store_true",
                   help="check and time B3's backward instead")
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
    if args.bwd:
        return main_bwd(args.parent)
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

    parent = parent_forward(args.parent) if args.parent else None
    for label, case in (("qwen2.5-3b", QWEN), ("recurrentgemma-9b", GRIFFIN),
                        ("phi3-mini", PHI3),
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
        if label == "phi3-mini":
            print(f"{label}: SDPA by back end: " + sdpa_backends_ms(
                torch, lambda: torch.nn.functional
                .scaled_dot_product_attention(q, k, v, is_causal=True),
                reps), flush=True)
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
