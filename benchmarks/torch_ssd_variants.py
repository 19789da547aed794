"""B5 (the SSD intra-chunk step) on the card against variants of its own
source.

Each variant is ``csrc/ssd_scan.cu`` with a few text substitutions (a
design choice changed, or an ablation that drops part of the work and so
computes a wrong answer on purpose). All are built in
parallel with the port's ``nvcc`` flags into ``kernels/build/variants/``
and timed in turns in one process, on one card, with a cold L2, at
mamba2-130m's two shapes: the serve prompt's head (1 x 24 heads x 2
chunks of 128, head_dim 64, state 128) and the LM forward's (4 x 24 x 8
chunks). Each variant's registers and spills per instantiation, and its
max abs error against the plain version as a share of the largest
output, are printed beside its times. The port never builds or calls a
variant.

    python3 benchmarks/torch_ssd_variants.py [--reps 2] [--only a,b]

Needs an NVIDIA H100 and ``nvcc``; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# the launch's choice of heads a y block
HEADS = ("Layout<NB, PB>::kHeads == 2 && (h / g) % 2 == 0 &&\n"
         "                         units * ny / 2 >= 2LL * sm_count()\n"
         "                     ? 2\n"
         "                     : 1;")
BLOCKS = "const long long blocks = y_units * ny + units * state_blocks(P);"

# name -> (what it shows, [(old, new), ...])
VARIANTS = {
    "one_head": ("one head a y block at every shape (S = C B^T taken for "
                 "each head)", [(HEADS, "1;")]),
    "tile32": ("tiles of 32 positions instead of 16 (twice the staging: "
               "one block an SM)",
               [("constexpr int kBK = 16; ", "constexpr int kBK = 32; ")]),
    "chunk_major": ("blocks numbered chunk-major within each role (a "
                    "chunk's y blocks side by side)",
                    [("    const int j = x / y_units, u = x % y_units;",
                      "    const int j = x % ny, u = x / ny;"),
                     ("  const int j = r / units, head = r % units;",
                      "  const int j = r % ((P + 63) / 64), head = r / ((P + "
                      "63) / 64);")]),
    "exp2": ("the decay as exp2f of a log2(e)-scaled exponent instead of "
             "expf", [("s2[0][jg][i] * expf(d);",
                       "s2[0][jg][i] * exp2f(d * 1.4426950408889634f);")]),
    "no_split_pass": ("ablation: staged tiles never split into pairs "
                      "(wrong answer) -- the split pass's share",
                      [("    split4(reinterpret_cast<uint4*>(dst + r * SD + "
                        "c), v);", "    (void)dst;")]),
    "y_only": ("ablation: the y blocks alone, no state blocks (no state "
               "out) -- the y blocks' share",
               [(BLOCKS, "const long long blocks = y_units * ny;")]),
    "state_only": ("ablation: the state blocks alone (no y out)",
                   [(BLOCKS, "const long long blocks = units * "
                     "state_blocks(P);"),
                    ("  const int x = blockIdx.x;\n",
                     "  const int x = blockIdx.x + ny * y_units;\n")]),
}

SHAPES = (("serve head", 1, 24, 1, 2, 128, 64, 128),
          ("LM forward", 4, 24, 1, 8, 128, 64, 128))


def ptxas_summary(log):
    """'NBxPB: regs, spills' per kernel instantiation in a -Xptxas -v
    log."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*ssd_chunk_kernelILi(\d+)"
                      r"ELi(\d+)E", ln)
        if m:
            name = f"{m.group(1)}x{m.group(2)}"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = f"spill {m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill}")
            name = None
    return out


def build(names):
    from repro_torch.kernels import _build

    src = (_build.CSRC / "ssd_scan.cu").read_text()
    out = _build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in ([] if name == "kernel" else VARIANTS[name][1]):
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text it replaces is "
                                   f"not in ssd_scan.cu once: {old!r}")
            text = text.replace(old, new)
        cu = out / f"ssd_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"libssd_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        print(f"[build] {name}: " + " | ".join(ptxas_summary(log)),
              flush=True)
        fn = ctypes.CDLL(str(out / f"libssd_{name}.so")).ssd_intra_chunk_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2,
                    help="rounds of timing all variants in turn")
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import ssd_scan as ss

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    names = [n for n in VARIANTS if not args.only
             or n in args.only.split(",")]
    for name in names:
        print(f"[variant] {name}: {VARIANTS[name][0]}", flush=True)
    fns = build(["kernel", *names])

    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for label, b, h, g, c, Q, P, N in SHAPES:
        xdt = torch.randn((b, h, c, Q, P), generator=gen, device="cuda")
        dA = -0.5 * torch.rand((b, h, c, Q), generator=gen, device="cuda")
        B = torch.randn((b, g, c, Q, N), generator=gen, device="cuda")
        C = torch.randn((b, g, c, Q, N), generator=gen, device="cuda")
        yr, sr = ss.ssd_intra_chunk_ref(xdt, dA, B, C)

        def run(fn):
            y = torch.empty_like(xdt)
            st = torch.empty((b, h, c, P, N), device="cuda")
            err = fn(xdt.data_ptr(), dA.data_ptr(), B.data_ptr(),
                     C.data_ptr(), y.data_ptr(), st.data_ptr(), b, h, g, c,
                     Q, P, N, stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
            return y, st

        def time_ms(fn, iters=50):
            for _ in range(5):
                run(fn)
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
            for s, e in ev:
                flush.zero_()
                s.record()
                run(fn)
                e.record()
            torch.cuda.synchronize()
            return sum(s.elapsed_time(e) for s, e in ev) / iters

        errs = {}
        for name, fn in fns.items():
            y, st = run(fn)
            errs[name] = max(float((y - yr).abs().max() / yr.abs().max()),
                             float((st - sr).abs().max() / sr.abs().max()))
        times = {name: [] for name in fns}
        for _ in range(args.reps):
            for name, fn in fns.items():
                times[name].append(time_ms(fn))
        base = min(times["kernel"])
        for name in fns:
            best = min(times[name])
            print(f"[time] {label}: {name}: "
                  f"{' / '.join(f'{t:.4f}' for t in times[name])} ms (best "
                  f"{best / base:.3f} x the kernel's); max abs err "
                  f"{errs[name]:.2e} of max|ref|", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
