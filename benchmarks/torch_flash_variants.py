"""B4 (flash attention) on the card against variants of its own source.

Each variant is ``csrc/flash_attention.cu``, with the shared header
``csrc/tf32_mma.cuh`` written into it, and a few text substitutions (a
design choice undone, or an ablation that drops part of the work and so
computes a wrong answer on purpose). All are built in parallel with
the port's ``nvcc`` flags into ``kernels/build/variants/`` and timed in
turns in one process, on one card, at granite-8b's shape (B 1, 32/8
heads, S 2048, D 128, causal) with a cold L2, the kernel as it stands
first; each variant's max abs error against the plain version is printed
beside its time. The port never builds or calls a variant.

    python3 benchmarks/torch_flash_variants.py [--reps 2]

Needs an NVIDIA H100 and ``nvcc``; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MMA3 = """  mma(c, alo, bhi);
  mma(c, ahi, blo);
  mma(c, ahi, bhi);"""
SPLIT_PASS = """      split4(reinterpret_cast<uint4*>(kp + rr * PK + c),
             *reinterpret_cast<const float4*>(ks + rr * SD + c));
      split4(reinterpret_cast<uint4*>(vp + rr * PV + c),
             *reinterpret_cast<const float4*>(vs + rr * SD + c));"""

# name -> (what it shows, [(old, new), ...])
VARIANTS = {
    "cvt": ("the split rounded by cvt.rna.tf32.f32 instead of two integer "
            "operations (the same bits)", [(
                "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                "  uint32_t r;\n"
                "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
                "  return r;")]),
    "expf": ("exp instead of exp2 of a log2(e)-scaled argument", [
        ("alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);",
         "alpha[r] = expf(m[r] - mx[r]);"),
        ("s[j][i] = exp2f((s[j][i] - mx[i >> 1]) * kLog2e);",
         "s[j][i] = expf(s[j][i] - mx[i >> 1]);")]),
    "warps12": ("12 warps a block (192 queries) instead of 8", [
        ("constexpr int kWarps = 8;", "constexpr int kWarps = 12;")]),
    "1xTF32": ("ablation: one TF32 product (hi.hi) per product -- the "
               "precision the split buys, and the MMAs' share of the time",
               [(MMA3, "  mma(c, ahi, bhi);")]),
    "no_split_pass": ("ablation: K and V never split into pairs (wrong "
                      "answer) -- the split pass's share of the time",
                      [(SPLIT_PASS, "      (void)rr;\n      (void)c;")]),
}


def build(names):
    from repro_torch.kernels import _build

    header = '#include "tf32_mma.cuh"'
    src = (_build.CSRC / "flash_attention.cu").read_text().replace(
        header, (_build.CSRC / "tf32_mma.cuh").read_text().replace(
            "#pragma once\n", ""))
    out = _build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in ([] if name == "kernel" else VARIANTS[name][1]):
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text it replaces is "
                                   f"not in flash_attention.cu (and its header) once: "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln})
        regs = max(int(ln.split("Used ")[1].split()[0])
                   for ln in log.splitlines() if "registers" in ln)
        print(f"[build] {name}: up to {regs} registers; "
              + " | ".join(spills), flush=True)
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).flash_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2,
                    help="rounds of timing all variants in turn")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    for name, (what, _) in VARIANTS.items():
        print(f"[variant] {name}: {what}", flush=True)
    fns = build(["kernel", *VARIANTS])

    B, hq, hkv, S, D = 1, 32, 8, 2048, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(B, h, S, D, generator=gen, device="cuda")
               for h in (hq, hkv, hkv))
    ref = fa.flash_attention_ref(q, k, v)
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")

    def run(fn):
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, hq, hkv, S, S, D, 0, 1.0 / math.sqrt(D), stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out

    def time_ms(fn, iters=20):
        for _ in range(3):
            run(fn)
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for s, e in ev:
            flush.zero_()
            s.record()
            run(fn)
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / iters

    errs = {name: float((run(fn) - ref).abs().max())
            for name, fn in fns.items()}
    times = {name: [] for name in fns}
    for _ in range(args.reps):
        for name, fn in fns.items():
            times[name].append(time_ms(fn))
    base = min(times["kernel"])
    for name in fns:
        best = min(times[name])
        print(f"[time] {name}: {' / '.join(f'{t:.4f}' for t in times[name])}"
              f" ms (best {best / base:.3f} x the kernel's); max abs err "
              f"{errs[name]:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
