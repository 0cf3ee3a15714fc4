#!/usr/bin/env python3
"""Where a chunk's time goes inside B4's chunked kernel, on one NVIDIA GPU.

    PYTHONPATH=src python tools/trace_ssd_scan.py

Copies ``csrc/ssd_scan.cu`` into ``build/trace/`` with ``clock64()`` stamps
at the steps of each role's chunk loop (the state warpgroup, the two y
warpgroups, the producer warp), builds the copy with the kernels' flags,
runs it at mamba2-370m's full prefill shape and prints, for CTA (0, 0) and
chunks 64-79, the SM clock at each stamp relative to the first, then each
step's mean length in cycles.  The copy is a measuring instrument only:
the stamps cost a few cycles each, and nothing of it is kept.  The anchors
below are lines of the kernel's source; the tool stops if one is missing.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as ssd

sys.path.insert(0, str(Path(__file__).resolve().parent))
import bench_ssd_scan as bench  # noqa: E402

FIRST, COUNT = 64, 16
#: (role, the step that ends at the stamp, the source line the stamp goes
#: right before); a role's first step runs from its previous chunk's last
#: stamp
STAMPS_AT = (
    (2, "wait for a free stage",
     "      if (lane == 0) {\n        mbar_expect_tx(bars.full(st),"),
    (2, "TMA issue, cum scan",
     "#pragma unroll\n      for (int i = 0; i + 1 < kStages; ++i) {"),
    (0, "store the bf16 state copy, loop",
     "      const float decay = fast_exp2(cum(st)[kChunk - 1]);"),
    (0, "decay, issue the state product",
     "      const bool more = c + 1 < nc;\n      const int st1"),
    (0, "next chunk's fragments", "      wgmma_wait_all();\n      fence_regs(acc);"),
    (0, "wait for the state product",
     "      release(bars.empty(st), lane);\n      if (more) {  // H"),
    (1, "(loop top: from the chunk before, on the other y warpgroup)",
     "    const int st = c % kStages;\n    mbar_wait(bars.full(st), (c / "
     "kStages) & 1);\n    mbar_wait(bars.state(st)"),
    (1, "wait for the stage and the state",
     "    wgmma_fence();\n#pragma unroll\n    for (int j = 0; j < T::SLABS; "
     "++j)\n#pragma unroll\n      for (int kk = 0; kk < kSlabCols / 16; "
     "++kk)\n        wgmma_ss<kChunk + kP>("),
    (1, "issue [S | C·H_prevᵀ], cum loads",
     "    wgmma_wait_all();\n    fence_regs(sy);"),
    (1, "wait for [S | C·H_prevᵀ]", "    // S⊙M, M_ts"),
    (1, "mask, fragments, y's start", "    wgmma_fence();\n    // ... and takes"),
    (1, "(S⊙M)·X", "    release(bars.empty(st), lane);\n    // y leaves"),
    (1, "staging tile free",
     "    store_tile<kP>(ys, kTile, yl, warp, group, tig);"),
    (1, "stage y, TMA store",
     "  }\n  if (tid == 0) asm volatile(\"cp.async.bulk.wait_group 0;"),
)
ROLES = ("state warpgroup", "y warpgroups (even and odd chunks)",
         "producer warp")
STAMPS = max(sum(r == role for r, *_ in STAMPS_AT) for role in range(3))


def instrumented_source() -> str:
    src = (build.CSRC / "ssd_scan.cu").read_text()
    head = "namespace {\n"
    probe = (f"__device__ long long g_trace[3][{COUNT}][{STAMPS}];\n"
             "#define TR(role, i) do { if (blockIdx.x == 0 && blockIdx.y == "
             "0 && threadIdx.x % 128 == 0 && c >= " f"{FIRST} && c < "
             f"{FIRST + COUNT}) g_trace[role][c - {FIRST}][i] = clock64(); "
             "} while (0)\n")
    src = src.replace(head, head + probe, 1)
    seen = [0, 0, 0]
    for role, _, anchor in STAMPS_AT:
        if src.count(anchor) != 1:
            raise SystemExit(f"trace: anchor not found once: {anchor!r}")
        src = src.replace(anchor, f"TR({role}, {seen[role]});\n" + anchor, 1)
        seen[role] += 1
    return src + ('\nextern "C" int ssd_trace_dump(long long* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_trace, "
                  "sizeof(g_trace));\n}\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_ssd_scan: no CUDA device", file=sys.stderr)
        return 2
    root = build.BUILD_DIR.parent / "trace"
    (root / "csrc").mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        (root / "csrc" / h.name).write_bytes(h.read_bytes())
    (root / "csrc" / "ssd_scan.cu").write_text(instrumented_source())
    lib_path = root / "libtrace_ssd_scan.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(root / "csrc" / "ssd_scan.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.ssd_scan_chunked_launch
    fn.argtypes = ssd._lib().ssd_scan_chunked_launch.argtypes
    fn.restype = ctypes.c_int
    lib.ssd_trace_dump.argtypes = [ctypes.c_void_p]
    x, a, bm, cm, _ = bench.inputs(bench.FULL, seed=9)
    for _ in range(3):
        bench.launch_with(lib, x, a, bm, cm)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (3 * COUNT * STAMPS))()
    if lib.ssd_trace_dump(buf):
        raise RuntimeError("trace: cudaMemcpyFromSymbol failed")
    t = np.array(buf, dtype=np.int64).reshape(3, COUNT, STAMPS)
    t0 = t[0, 0, 0]
    for role in (0, 1, 2):
        labels = [label for r, label, _ in STAMPS_AT if r == role]
        n = len(labels)
        print(f"{ROLES[role]}: SM clock at each stamp, from the state "
              "warpgroup's first", flush=True)
        for c in range(COUNT):
            print(f"  chunk {FIRST + c}: "
                  + " ".join(f"{v - t0:7d}" for v in t[role, c, :n]))
        flat = t[role, :, :n].reshape(-1)
        steps = np.diff(flat).reshape(-1)          # stamp k to stamp k + 1
        print(f"  period {np.diff(t[role, :, 0]).mean():.0f} cycles a "
              "chunk; mean cycles by step:")
        for i, label in enumerate(labels):
            # the step ending at stamp i (stamp 0: from the last stamp of
            # the chunk before)
            print(f"    {steps[(i - 1) % n::n].mean():7.0f}  {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
