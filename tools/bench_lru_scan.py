#!/usr/bin/env python3
"""Check and time B5 (the RG-LRU scan) and its backward on one NVIDIA GPU,
beside another tree's kernels.

    PYTHONPATH=src python tools/bench_lru_scan.py [--parent DIR]

Prints the card (name and power limit) and this tree's builds of
``csrc/lru_scan.cu`` and ``csrc/lru_scan_bwd.cu`` (registers, shared
memory, spill bytes), then, at the four shapes of recurrentgemma-9b's
main path — B5-bwd at its training shape x, a (2, 4096, 4096) in bf16 and
float32, B5 at that shape and at its prefill (4, 4096, 4096) in bf16 —
each kernel's largest difference from its plain chunked version
(``ref.lru_scan_chunked_ref``, ``ref.lru_scan_bwd_chunked_ref``) and its
time by CUDA events beside the bound (``chip_smoke.py``'s ``scan_bound``
and ``lru_bwd_bound``: each input byte read once and each output byte
written once at 3.35 TB/s).  The backward is timed as the train step calls
it, from the starts its forward kept.  Then the carry's serial cost: both
kernels at (64, 128, 4096) bf16, the same bytes and CTAs in chunks that
wait on no other chunk, beside the training shape's 32-chunk chains.

``--parent DIR`` names another tree (an earlier checkout unpacked with
``git archive`` into ``build/``, which ``.gitignore`` lists): its
``lru_scan.cu`` and ``lru_scan_bwd.cu`` are built with this tree's flags,
each called through its own C interface (the earlier sequential walk's,
or this tree's chunked one), checked against this tree's kernels, and
both trees' kernels are timed in turns (parent, this, this, parent) at
each shape in this one process.
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
from repro_torch.kernels import lru_scan as lru

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import lru_bwd_bound, scan_bound  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: (kernel, batch, dtype) at S = D = 4,096: the prediction table's rows
SHAPES = (("bwd", 2, torch.bfloat16), ("bwd", 2, torch.float32),
          ("fwd", 2, torch.bfloat16), ("fwd", 4, torch.bfloat16))
S = D = 4096


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


def build_parent(root: Path) -> dict:
    """The other tree's two LRU sources, built with this tree's flags into
    ``build/kernels`` (both ``nvcc``s at once); returns ``{source name:
    library}``."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    jobs = {}
    for name in ("lru_scan", "lru_scan_bwd"):
        h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
        for src in sorted(csrc.glob("*.cuh")) + [csrc / f"{name}.cu"]:
            h.update(src.read_bytes())
        out = build.BUILD_DIR / f"libparent_{name}-{h.hexdigest()[:16]}.so"
        if not out.exists():
            build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            jobs[name] = (out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                 str(csrc / f"{name}.cu")]))
        else:
            jobs[name] = (out, None)
    libs = {}
    for name, (out, proc) in jobs.items():
        if proc is not None and proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu")
        libs[name] = ctypes.CDLL(str(out))
    return libs


class Parent:
    """The other tree's kernels, each through its own C interface: the
    chunked one of this tree (it exports ``lru_scan_chunk``) through
    this tree's wrappers, else the earlier sequential walk (a thread a
    (batch, channel); its backward keeps a float32 start every 32 steps in
    a scratch)."""

    def __init__(self, libs):
        self.libs = libs
        self.chunked = hasattr(libs["lru_scan"], "lru_scan_chunk")
        if self.chunked:
            for name, mine in (("lru_scan", lru._lib()),
                               ("lru_scan_bwd", lru._bwd_lib())):
                fn = getattr(libs[name], f"{name}_launch")
                fn.argtypes = getattr(mine, f"{name}_launch").argtypes
                fn.restype = _I
            return
        f = libs["lru_scan"].lru_scan_launch
        f.argtypes, f.restype = [_P] * 5 + [_I] * 4 + [_P, _P], _I
        g = libs["lru_scan_bwd"].lru_scan_bwd_launch
        g.argtypes, g.restype = [_P] * 9 + [_I] * 4 + [_P, _P], _I

    def _swap(self, fn, *args, **kw):
        saved = (lru._lib, lru._bwd_lib)
        lru._lib = lambda: self.libs["lru_scan"]
        lru._bwd_lib = lambda: self.libs["lru_scan_bwd"]
        try:
            return fn(*args, **kw)
        finally:
            lru._lib, lru._bwd_lib = saved

    def fwd(self, x, a):
        if self.chunked:
            return self._swap(lru._launch, x, a, None)
        b, s, d = x.shape
        y = torch.empty_like(x)
        h_t = torch.empty((b, d), dtype=torch.float32, device=x.device)
        st = (ctypes.c_int64 * 4)(s * d, d, s * d, d)
        err = self.libs["lru_scan"].lru_scan_launch(
            x.data_ptr(), a.data_ptr(), None, y.data_ptr(), h_t.data_ptr(),
            _CODE[x.dtype], b, s, d, ctypes.cast(st, _P),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent lru_scan_launch: {err}")
        return y, h_t, None

    def bwd(self, x, a, dy, starts):
        if self.chunked:
            return self._swap(lru.lru_scan_bwd, x, a, dy, starts=starts)
        b, s, d = x.shape
        dx, da = torch.empty_like(x), torch.empty_like(x)
        scratch = torch.empty((b, -(-s // 32), d), dtype=torch.float32,
                              device=x.device)
        st = (ctypes.c_int64 * 6)(s * d, d, s * d, d, s * d, d)
        err = self.libs["lru_scan_bwd"].lru_scan_bwd_launch(
            x.data_ptr(), a.data_ptr(), dy.data_ptr(), None, None,
            dx.data_ptr(), da.data_ptr(), None, scratch.data_ptr(),
            _CODE[x.dtype], b, s, d, ctypes.cast(st, _P),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent lru_scan_bwd_launch: {err}")
        return dx, da, None


def inputs(b, s, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, d), generator=g, device="cuda").to(dtype)
    a = (0.5 + 0.5 * torch.rand((b, s, d), generator=g, device="cuda"))
    dy = torch.randn((b, s, d), generator=g, device="cuda").to(dtype)
    return x, a.to(dtype), dy


def worst(got, want) -> float:
    return max(((u.float() - v.float()).abs().max()
                / v.float().abs().max()).item()
               for u, v in zip(got, want) if u is not None and v is not None)


def bound(kind, x) -> tuple[float, str]:
    b, s, d = x.shape
    if kind == "fwd":
        t, by, _, nbytes = scan_bound("lru", [x, x, None])
    else:
        t, by, _, nbytes = lru_bwd_bound(
            (b, s, d, str(x.dtype).split(".")[1], False, False))
    return t, f"{by}: {nbytes} B"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", type=Path,
                   help="another tree whose LRU kernels to time beside")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_lru_scan: no CUDA device", file=sys.stderr)
        return 2
    build.build(("lru_scan", "lru_scan_bwd"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    for dt in (torch.bfloat16, torch.float32):
        print(f"build ({dt}): forward {lru.attributes(dt)}; backward "
              f"{lru.bwd_attributes(dt)}")
    parent = Parent(build_parent(args.parent)) if args.parent else None
    if parent is not None:
        print(f"parent: {args.parent} "
              f"({'chunked' if parent.chunked else 'sequential walk'})")
    for i, (kind, b, dt) in enumerate(SHAPES):
        x, a, dy = inputs(b, S, D, dt, seed=i)
        starts = lru._launch(x, a, None, keep_starts=True)[2]
        if kind == "fwd":
            runs = {"this": lambda: lru._launch(x, a, None)}
            want = ref.lru_scan_chunked_ref(x, a)
            if parent is not None:
                runs["parent"] = lambda: parent.fwd(x, a)
            reps = 100
        else:
            runs = {"this": lambda: lru.lru_scan_bwd(x, a, dy,
                                                     starts=starts)}
            want = ref.lru_scan_bwd_chunked_ref(x, a, dy, starts=starts)
            if parent is not None:
                runs["parent"] = lambda: parent.bwd(x, a, dy, starts)
            reps = 50
        got = runs["this"]()
        what = f"{'B5-bwd' if kind == 'bwd' else 'B5'} at ({b}, {S}, {D}) " \
               f"{str(dt).split('.')[1]}"
        again = runs["this"]()
        same = all(torch.equal(u, v) for u, v in zip(got, again)
                   if u is not None)
        line = (f"{what}: max |diff| / max |value| against the chunked "
                f"plain version {worst(got[:2], want[:2]):.3g}, two calls "
                f"{'bit-equal' if same else 'DIFFER'}")
        if parent is not None:
            line += (f"; parent against this "
                     f"{worst(runs['parent']()[:2], got[:2]):.3g}")
        print(line)
        del want, got, again
        t_bound, by = bound(kind, x)
        order = ["parent", "this", "this", "parent"] if parent else ["this"]
        for name in order:
            ms = cuda_ms(runs[name], reps)
            print(f"  {name}: {ms:.4f} ms a call (CUDA events over {reps} "
                  f"calls); bound {t_bound:.4f} ms ({by}) = "
                  f"{100 * t_bound / ms:.2f}%")
        del x, a, dy, starts, runs
        torch.cuda.empty_cache()
    # the carry's serial cost: the training shape's bytes and CTAs in
    # chunks of 128 steps that wait on no other chunk
    for b, s in ((2, S), (64, lru.CHUNK)):
        x, a, dy = inputs(b, s, D, torch.bfloat16, seed=9)
        starts = lru._launch(x, a, None, keep_starts=True)[2]
        fwd = cuda_ms(lambda: lru._launch(x, a, None), 100)
        bwd = cuda_ms(lambda: lru.lru_scan_bwd(x, a, dy, starts=starts), 50)
        print(f"chains of {lru.n_chunks(s)} chunks, x ({b}, {s}, {D}) bf16: "
              f"B5 {fwd:.4f} ms, B5-bwd {bwd:.4f} ms a call")
        del x, a, dy, starts
    return 0


if __name__ == "__main__":
    sys.exit(main())
