#!/usr/bin/env python3
"""B2 (quantize_pack) and B3 (dequant_agg_reduce) on the card beside an
earlier version of their source, both timed by the same harness in one
process.

    git show <rev>:src/repro_torch/kernels/csrc/quantize.cu \\
        > build/baseline/quantize.cu
    python3 tools/quantize_vs_baseline.py \\
        --baseline build/baseline/quantize.cu

The baseline is a ``quantize.cu`` with the earlier C interface, which
takes no plan and picks its own grid. It is built with the port's
``nvcc`` flags into ``kernels/build/baseline/``; the kernels as they
stand are built and launched through the port's wrappers. At
``chip_smoke.py`` phase 3b's paper-CNN and LM-boundary cases, int8 and
int4, on the same inputs, both are held bit for bit against the plain
versions and timed with ``chip_smoke.time_cold_ms`` (cold L2, CUDA
events, the card's spin before each timed series) in the order kernel,
baseline, baseline, kernel; each time printed is the mean of its two
series. The last line is a JSON record of every time.

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

    out = _build.BUILD / "baseline" / "libquantize_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.quantize_pack_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
        + [ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p])
    lib.quantize_pack_f32.restype = ctypes.c_int
    lib.dequant_agg_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dequant_agg_f32.restype = ctypes.c_int
    return lib


def baseline_quantize(torch, lib, g, seed, bits, bt, bd, seeds):
    N, T, D = g.shape
    q = torch.empty((N, T, D // 2 if bits == 4 else D), dtype=torch.int8,
                    device=g.device)
    sc = torch.empty((N, T // bt, D // bd), dtype=torch.float32,
                     device=g.device)
    err = lib.quantize_pack_f32(
        g.data_ptr(), q.data_ptr(), sc.data_ptr(), N, T, D, bt, bd, bits, 1,
        seed, None if seeds is None else seeds.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline quantize launch failed: CUDA error "
                           f"{err}")
    return q, sc


def baseline_dequant(torch, lib, q, sc, rho, bits, bt, bd):
    N, T, Dq = q.shape
    D = 2 * Dq if bits == 4 else Dq
    out = torch.empty((T, D), dtype=torch.float32, device=q.device)
    err = lib.dequant_agg_f32(q.data_ptr(), sc.data_ptr(), rho.data_ptr(),
                              out.data_ptr(), N, T, D, bt, bd, bits,
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline dequant launch failed: CUDA error "
                           f"{err}")
    return out


def interleaved(cs, torch, fns, flush):
    """Mean time of each of two callables over the series kernel,
    baseline, baseline, kernel, and the series themselves."""
    ms = {"kernel": [], "baseline": []}
    for who in ("kernel", "baseline", "baseline", "kernel"):
        ms[who].append(cs.time_cold_ms(torch, fns[who], flush))
    return {who: sum(t) / 2 for who, t in ms.items()}, ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="an earlier quantize.cu to time beside the kernels "
                         "as they stand")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.compress.channel import client_seeds
    from repro_torch.kernels import quantize as qz

    if not torch.cuda.is_available():
        raise SystemExit("quantize_vs_baseline: needs a CUDA device")
    print(cs.nvidia_smi_line(), flush=True)
    base = build_baseline(args.baseline.resolve())
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    record = []
    for label, n, t, d, (bt, bd), per_client, _ in cs.agg_shapes():
        if label not in CASES:
            continue
        g = torch.randn((n, t, d), generator=gen, device="cuda") * 3.0
        g[0, :bt, :bd] = 0.0
        rho = torch.rand((n,), generator=gen, device="cuda")
        rho = rho / rho.sum()
        seed = 0xC0FFEE
        seeds = client_seeds(seed, n, "cuda") if per_client else None
        for bits in (8, 4):
            qr, scr = qz.quantize_ref(g, seed, bits, bt, bd, True, seeds)
            b2 = {"kernel": lambda: qz.quantize_pack(g, seed, bits, bt, bd,
                                                     True, seeds),
                  "baseline": lambda: baseline_quantize(
                      torch, base, g, seed, bits, bt, bd, seeds)}
            for who, fn in b2.items():
                q, sc = fn()
                torch.cuda.synchronize()
                cs.check(torch.equal(q, qr) and torch.equal(sc, scr),
                         f"{who} quantize is not bit-identical ({label}, "
                         f"int{bits})")
            if bt == 1:  # the simulator's decode of K payloads
                dargs = (qr.view(1, n, -1), scr.view(1, n, -1),
                         torch.ones(1, device="cuda"))
            else:
                dargs = (qr, scr, rho)
            ref = qz.dequant_agg_ref(*dargs, bits, bt, bd)
            b3 = {"kernel": lambda: qz.dequant_agg_reduce(*dargs, bits, bt,
                                                          bd),
                  "baseline": lambda: baseline_dequant(torch, base, *dargs,
                                                       bits, bt, bd)}
            for who, fn in b3.items():
                out = fn()
                torch.cuda.synchronize()
                cs.check(torch.equal(out, ref),
                         f"{who} dequant is not bit-identical ({label}, "
                         f"int{bits})")
            row = dict(case=label, bits=bits)
            for name, fns in (("quantize", b2), ("dequant_agg", b3)):
                mean, series = interleaved(cs, torch, fns, flush)
                row[name] = mean
                print(f"{name} int{bits} {label}: kernel "
                      f"{mean['kernel']:.4f} ms (series "
                      f"{series['kernel'][0]:.4f}, "
                      f"{series['kernel'][1]:.4f})  baseline "
                      f"{mean['baseline']:.4f} ms (series "
                      f"{series['baseline'][0]:.4f}, "
                      f"{series['baseline'][1]:.4f})  ratio "
                      f"{mean['baseline'] / mean['kernel']:.2f}x",
                      flush=True)
            record.append(row)
        del g, qr, scr, ref, dargs
        torch.cuda.empty_cache()
    print(json.dumps({"quantize_vs_baseline": record}))


if __name__ == "__main__":
    main()
