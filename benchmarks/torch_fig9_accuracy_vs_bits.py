"""Fig. 9 (extension) on the port — accuracy vs cut-layer bit-width.

Sweeps the transport codec on SFL-GA's uplink+downlink at a fixed cut
and reports final accuracy against per-round traffic, and the B1/B2/B3
launches of each run (on the card the int codecs run B2/B3 twice a
round). The claim under test: int8 (≈3.9x smaller payloads) matches
fp32 accuracy within noise, int4 costs a little accuracy for ≈7.8x.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig9_accuracy_vs_bits.py
      [--device cpu] [--rounds R]
"""
from __future__ import annotations

import argparse

from benchmarks.torch_common import (FULL, device_arg, device_name,
                                     run_scheme)
from repro_torch import obs

CODECS = ("fp32", "bf16", "fp8", "int8", "int4")


def run(dataset: str = "mnist", rounds: int = None, cut: int = 2,
        device="cuda"):
    rounds = rounds or (150 if FULL else 60)
    out = []
    base_bits = None
    for codec in CODECS:
        r = run_scheme("sfl_ga", cut, rounds, dataset, uplink_codec=codec,
                       downlink_codec=codec, device=device)
        bits = r["comm_bits"]["total_bits"]
        if base_bits is None:
            base_bits = bits
        out.append({"codec": codec, "final_acc": r["final_acc"],
                    "kb_per_round": bits / 8e3,
                    "ratio_vs_fp32": base_bits / bits,
                    "launches": r["launches"],
                    "curve": list(zip(r["rounds"], r["accs"]))})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args(argv)
    datasets = ["mnist", "fmnist"] if FULL else ["mnist"]
    for ds in datasets:
        obs.log(f"# fig9 dataset={ds} (sfl_ga, cut=2) "
                f"[{device_name(args.device)}]")
        for row in run(ds, args.rounds, device=args.device):
            n = row["launches"]
            obs.log(f"  {row['codec']:>5}: final_acc={row['final_acc']:.3f} "
                    f"{row['kb_per_round']:8.1f} kB/round "
                    f"({row['ratio_vs_fp32']:.2f}x vs fp32); launches B1 "
                    f"{n['grad_agg']} B2 {n['quantize']} B3 "
                    f"{n['dequant_agg']}")


if __name__ == "__main__":
    main()
