#!/usr/bin/env python3
"""B6 (paged decode attention) on the card beside an earlier version of
its own source, both timed by the same harness in one process.

    git show <rev>:src/repro_torch/kernels/csrc/paged_attention.cu \\
        > build/baseline/paged_attention.cu
    python3 tools/paged_vs_baseline.py \\
        --baseline build/baseline/paged_attention.cu

The baseline is a ``paged_attention.cu`` with the earlier C interface,
which takes no cluster size and plans its own grid. It is built with the
port's ``nvcc`` flags into ``kernels/build/baseline/``; the kernel as it
stands is built and launched through the port's wrapper. At
``chip_smoke.py`` phase 3a's serve-run, granite-20b group and long-context
cases, on the same inputs, both are held against the plain version and
timed with ``chip_smoke.time_cold_ms`` (cold L2, CUDA events), once with
the card's spin before each timed series and once without it, in the order
kernel, baseline, baseline, kernel for each; each time printed is the
mean of its two series. The last line is a JSON record of every time.

Needs an NVIDIA H100 and ``nvcc``; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CASES = ("serve-run shapes", "granite-20b group, G=48",
         "granite-8b long context, D=128")
SPINS = {"spin": 20_000_000, "no spin": 0}


def build_baseline(src):
    from repro_torch.kernels import _build

    out = _build.BUILD / "baseline" / "libpaged_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = ctypes.CDLL(str(out)).paged_attention_decode_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def baseline_call(torch, fn, q, pk, pv, table, lens):
    B, Hkv, G, D = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(),
             lens.data_ptr(), out.data_ptr(), B, Hkv, G, D, pk.shape[1],
             pk.shape[2], table.shape[1], 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"baseline kernel launch failed: CUDA error {err}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="an earlier paged_attention.cu to time beside the "
                         "kernel as it stands")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        raise SystemExit("paged_vs_baseline: needs a CUDA device")
    print(cs.nvidia_smi_line(), flush=True)
    base = build_baseline(args.baseline.resolve())
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    record = []
    for name, slots, hkv, g, d, page, lengths in cs.PAGED_CASES:
        if name not in CASES:
            continue
        maxp = cs.paged_maxp(name, page, lengths)
        q, pk, pv, table, lens = cs.paged_inputs(torch, 0, slots, hkv, g, d,
                                                 page, lengths, maxp)
        fns = {"kernel": lambda: pa.paged_attention_decode(
                   q, pk, pv, table, lens),
               "baseline": lambda: baseline_call(torch, base, q, pk, pv,
                                                 table, lens)}
        ref = pa.paged_attention_ref(q, pk, pv, table, lens)
        errs = {}
        for who, fn in fns.items():
            out = fn()
            torch.cuda.synchronize()
            errs[who] = float((out - ref).abs().max())
            cs.check(torch.allclose(out, ref, atol=cs.KERNEL_ATOL,
                                    rtol=cs.KERNEL_RTOL),
                     f"{who} disagrees with the plain version ({name}): "
                     f"max abs err {errs[who]}")
        bound_ms, bound_by = cs.paged_bound_ms(q, pk, table, lens)
        row = dict(case=name, bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=errs)
        for timer, spin in SPINS.items():
            ms = {"kernel": [], "baseline": []}
            for who in ("kernel", "baseline", "baseline", "kernel"):
                ms[who].append(cs.time_cold_ms(torch, fns[who], flush,
                                               spin=spin))
            row[timer] = {who: sum(t) / 2 for who, t in ms.items()}
            print(f"{name} ({timer}): kernel {row[timer]['kernel']:.4f} ms "
                  f"(series {ms['kernel'][0]:.4f}, {ms['kernel'][1]:.4f})  "
                  f"baseline {row[timer]['baseline']:.4f} ms (series "
                  f"{ms['baseline'][0]:.4f}, {ms['baseline'][1]:.4f})  "
                  f"bound {bound_ms:.6f} ms ({bound_by})", flush=True)
        print(f"{name}: max abs err kernel {errs['kernel']:.3e}  baseline "
              f"{errs['baseline']:.3e}", flush=True)
        record.append(row)
        del q, pk, pv, table, lens, ref, out
        torch.cuda.empty_cache()
    print(json.dumps({"paged_vs_baseline": record}))


if __name__ == "__main__":
    main()
