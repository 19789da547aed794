#!/usr/bin/env python3
"""B1 (grad_agg_reduce, paper eq. 5) on the card beside an earlier version
of its source, both timed by the same harness in one process.

    git show <rev>:src/repro_torch/kernels/csrc/grad_agg.cu \\
        > build/baseline/grad_agg.cu
    python3 tools/grad_agg_vs_baseline.py \\
        --baseline build/baseline/grad_agg.cu

The baseline is a ``grad_agg.cu`` with the earlier C interface, which
takes no plan and picks its own grid. It is built with the port's
``nvcc`` flags into ``kernels/build/baseline/``; the kernel as it stands
is built and launched through the port's wrapper. At ``chip_smoke.py``
phase 3b's B1 cases (the paper CNN's cuts 1 and 2, the LM boundary), on
the same inputs, both are held bit for bit against the plain version and
timed with ``chip_smoke.time_cold_ms`` (cold L2, CUDA events, the card's
spin before each timed series) in the order kernel, baseline, baseline,
kernel, twice over, once with the harness's writing flush and once with
its reading flush (``clean=True``: no dirty lines left in L2); each time
printed is the mean of its four series. The last line is a JSON record of every
time.

Needs an NVIDIA H100 and ``nvcc``; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CASES = ("paper CNN cut 1", "paper CNN cut 2", "LM boundary")


def build_baseline(src):
    from repro_torch.kernels import _build

    out = _build.BUILD / "baseline" / "libgrad_agg_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.grad_agg_f32.argtypes = ([ctypes.c_void_p] * 3
                                 + [ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_void_p])
    lib.grad_agg_f32.restype = ctypes.c_int
    return lib


def baseline_grad_agg(torch, lib, g, rho):
    out = torch.empty(g.shape[1:], dtype=torch.float32, device=g.device)
    err = lib.grad_agg_f32(g.data_ptr(), rho.data_ptr(), out.data_ptr(),
                           g.shape[0], out.numel(),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline grad_agg launch failed: CUDA error "
                           f"{err}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="an earlier grad_agg.cu to time beside the kernel "
                         "as it stands")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import grad_agg as ga

    if not torch.cuda.is_available():
        raise SystemExit("grad_agg_vs_baseline: needs a CUDA device")
    print(cs.nvidia_smi_line(), flush=True)
    base = build_baseline(args.baseline.resolve())
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    record = []
    for label, n, t, d, *_ in cs.agg_shapes():
        if label not in CASES:
            continue
        g = torch.randn((n, t * d), generator=gen, device="cuda") * 3.0
        rho = torch.rand((n,), generator=gen, device="cuda")
        rho = rho / rho.sum()
        ref = ga.grad_agg_ref(g, rho)
        fns = {"kernel": lambda: ga.grad_agg_reduce(g, rho),
               "baseline": lambda: baseline_grad_agg(torch, base, g, rho)}
        for who, fn in fns.items():
            out = fn()
            torch.cuda.synchronize()
            cs.check(torch.equal(out, ref),
                     f"{who} grad_agg is not bit-identical ({label})")
        plan = ga.plan_for(g)
        row = dict(case=label, n=n, m=t * d, plan=plan._asdict())
        for clean in (False, True):
            ms = {"kernel": [], "baseline": []}
            for who in ("kernel", "baseline", "baseline", "kernel") * 2:
                ms[who].append(cs.time_cold_ms(torch, fns[who], flush,
                                               clean=clean))
            mean = {who: sum(v) / len(v) for who, v in ms.items()}
            harness = "clean L2" if clean else "cold L2"
            print(f"grad_agg {label} ({n} x {t * d}; {plan.path} path, "
                  f"{plan.grid} blocks), {harness}: kernel "
                  f"{mean['kernel']:.4f} ms "
                  f"(series {' '.join(f'{v:.4f}' for v in ms['kernel'])})  "
                  f"baseline {mean['baseline']:.4f} ms (series "
                  f"{' '.join(f'{v:.4f}' for v in ms['baseline'])})  ratio "
                  f"{mean['baseline'] / mean['kernel']:.2f}x", flush=True)
            key = "clean" if clean else "cold"
            row[key] = dict(kernel_ms=mean["kernel"],
                            baseline_ms=mean["baseline"], series=ms)
        record.append(row)
        del g, ref
        torch.cuda.empty_cache()
    print(json.dumps({"grad_agg_vs_baseline": record}))


if __name__ == "__main__":
    main()
