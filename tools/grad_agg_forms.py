#!/usr/bin/env python3
"""What B1's plan rule rests on: the wave path beside the stream path,
timed against each other in one process, at payloads on both sides of
the rule's switch.

    python3 tools/grad_agg_forms.py

``kernels.grad_agg.grad_agg_plan`` gives the wave path payloads whose
grid fits one wave at ``wave_blocks_per_sm(N)`` blocks an SM, and
streams the rest. This script runs both paths at the paper CNN's cuts 1
and 2 and, at N 2, 8, 10 and 16, at payloads of one, two and four such
waves (a few units fewer, so the last block is ragged). Every candidate
is held bit for bit against the plain version, then the two are timed
with ``chip_smoke.time_cold_ms`` in the order wave, stream, stream,
wave, twice over, once with the harness's writing flush and once with
its reading flush (``clean=True``); each time printed is the mean of
four series. The last line is a JSON record of every time.

Needs an NVIDIA H100 and ``nvcc``; imports torch and the port only.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CUTS = [(10, 100_352), (10, 200_704)]
CLIENTS = (2, 8, 10, 16)
WAVES = (1, 2, 4)


def shapes(ga, sms):
    """(N, M): the cuts, then each N at each number of waves."""
    out = list(CUTS)
    for n in CLIENTS:
        units = sms * ga.wave_blocks_per_sm(n) * ga.WAVE_THREADS
        out += [(n, 4 * (w * units - 3)) for w in WAVES]
    return out


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import grad_agg as ga

    if not torch.cuda.is_available():
        raise SystemExit("grad_agg_forms: needs a CUDA device")
    print(cs.nvidia_smi_line(), flush=True)
    sms = _build.sm_count(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    record = []
    for n, m in shapes(ga, sms):
        cands = {"wave": ga.wave_plan(m), "stream": ga.stream_plan(n, m, sms)}
        g = torch.randn((n, m), generator=gen, device="cuda")
        rho = torch.rand((n,), generator=gen, device="cuda")
        ref = ga.grad_agg_ref(g, rho)
        for plan in cands.values():
            out = ga._launch(g, rho, plan)
            torch.cuda.synchronize()
            cs.check(torch.equal(out, ref), f"{plan} is not bit-identical "
                     f"({n} x {m})")
        plan = ga.plan_for(g)
        waves = cands["wave"].grid / (sms * ga.wave_blocks_per_sm(n))
        row = dict(n=n, m=m, waves=waves, plan=plan._asdict())
        for clean in (False, True):
            ms = {name: [] for name in cands}
            for name in ("wave", "stream", "stream", "wave") * 2:
                ms[name].append(cs.time_cold_ms(
                    torch, lambda: ga._launch(g, rho, cands[name]), flush,
                    clean=clean))
            mean = {name: sum(v) / len(v) for name, v in ms.items()}
            print(f"grad_agg {n} x {m} ({waves:.2f} waves; "
                  f"{'clean' if clean else 'cold'} L2; plan {plan.path}, "
                  f"{plan.grid} blocks): " + "; ".join(
                      f"{name} [{cands[name].grid} blocks] {mean[name]:.4f} "
                      f"ms (series {' '.join(f'{v:.4f}' for v in ms[name])})"
                      for name in cands), flush=True)
            row["clean" if clean else "cold"] = mean
        record.append(row)
        del g, ref
        torch.cuda.empty_cache()
    print(json.dumps({"grad_agg_forms": record}))


if __name__ == "__main__":
    main()
