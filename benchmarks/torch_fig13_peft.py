"""Fig. 13 (extension) on the port: adapters as the unit of federation.

The port's run of ``benchmarks/fig13_peft.py``. The paper's traffic
model (§III, eqs. 12-13) prices model sync at phi(v) parameters and a
cut migration at |delta phi|, which at LLM scale makes traditional SFL's
sync and dynamic splitting expensive. With LoRA adapters as the
federated unit the frozen base never crosses the wire: model sync ships
the adapters' phi-hat(v), and a cut move re-partitions the base locally
(``resplit_base_params``) and ships only adapters. On the FULL
granite-8b config (analytic: the closed forms are exact, and held
against real trees by ``tests/test_torch_peft.py``):

* the wire a round (scheme ``sfl``, the model-sync baseline) over a rank
  sweep x uplink codec, against the full-parameter fp32 baseline;
* the bytes of one v -> v+1 cut move against rank and full parameters.

It asserts the reference's bars: rank-8 wire >= 20x and rank-8
migration >= 50x below full parameters. Then a live run through the
port's launcher (LoRA, a host bank, cuts forced to move, int8 uplink)
reconciles every traffic and migration event exactly (measured ==
modeled, bit for bit); with ``--device cuda`` (the default) it runs on
the card, its boundary through kernels B1-B3.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig13_peft.py [--fast]
          [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Dict, List

from benchmarks.torch_common import FULL, device_arg, device_name
from repro_torch import obs

ARCH = "granite-8b"
RANKS = (4, 8, 16, 32)
CODECS = ("fp32", "int8")
# a representative round: K participants, per-client batch x seq
K, BATCH, SEQ, TAU = 8, 4, 1024, 1
CUT = 6  # mid-stack cut for the wire table; migration prices CUT -> CUT+1


def _plan(cfg, cut, rank=None):
    from repro_torch.configs import PeftSpec
    from repro_torch.models import lm

    peft = None if rank is None else PeftSpec(kind="lora", rank=rank,
                                              alpha=2.0 * rank)
    return lm.build_plan(cfg, cut, peft=peft)


def wire_table(cfg) -> List[Dict]:
    """The sfl wire a round over rank x codec, and the full-param rows."""
    from repro_torch.core import algorithms as alg

    rows = []
    for codec in CODECS:
        for rank in (None,) + RANKS:
            cb = alg.comm_bytes_per_round(cfg, _plan(cfg, CUT, rank), "sfl",
                                          K, BATCH, SEQ, tau=TAU,
                                          bytes_per_elem=4,
                                          uplink_codec=codec)
            rows.append({"rank": rank, "codec": codec,
                         "mb_per_round": cb["total_bytes"] / 1e6})
    base = next(r for r in rows if r["rank"] is None and r["codec"] == "fp32")
    for r in rows:
        r["vs_full_fp32"] = base["mb_per_round"] / r["mb_per_round"]
    return rows


def migration_table(cfg) -> List[Dict]:
    """Bytes to move the cut CUT -> CUT+1 (K participants) against rank."""
    from repro_torch.core.split import (client_adapter_numel,
                                        client_param_numel)
    from repro_torch.sysmodel.traffic import (adapter_migration_bits,
                                              migration_bits)

    full = migration_bits(client_param_numel(_plan(cfg, CUT)),
                          client_param_numel(_plan(cfg, CUT + 1)),
                          n_clients=K, raw_bits_per_elem=32)
    rows = [{"rank": None, "mb_per_move": full["total_bits"] / 8e6,
             "vs_full": 1.0}]
    for rank in RANKS:
        mb = adapter_migration_bits(
            client_adapter_numel(_plan(cfg, CUT, rank)),
            client_adapter_numel(_plan(cfg, CUT + 1, rank)),
            n_clients=K, raw_bits_per_elem=32)
        rows.append({"rank": rank, "mb_per_move": mb["total_bits"] / 8e6,
                     "vs_full": full["total_bits"] / mb["total_bits"]})
    return rows


def live_reconciliation(fast: bool, device: str) -> Dict:
    """A reduced live run (LoRA, host bank, forced cut migrations): every
    traffic and migration event reconciled exactly against the model."""
    from repro_torch.launch.train import main as train_main
    from repro_torch.obs.ledger import reconcile_events
    from repro_torch.obs.recorder import read_events

    steps = 3 if fast else 6
    with tempfile.TemporaryDirectory() as td:
        out = train_main(["--arch", ARCH, "--preset", "smoke", "--layers",
                          "3", "--steps", str(steps), "--peft", "lora",
                          "--lora-rank", "8", "--scheme", "sfl", "--cohort",
                          "4", "--clients", "8", "--batch", "1", "--seq",
                          "32", "--bank", "host", "--dynamic-cut", "1,2",
                          "--uplink-codec", "int8", "--metrics-dir", td,
                          "--device", device, "--quiet"])
        rows, bad = reconcile_events(read_events(td))
    n_mig = sum(r["kind"] == "migration" for r in rows)
    assert rows and n_mig >= 1, "live run produced no migration events"
    assert bad == 0, f"{bad}/{len(rows)} events failed exact reconciliation"
    return {"events": len(rows), "migrations": n_mig, "mismatches": bad,
            "final_loss": out["final_loss"]}


def run(fast: bool = None, device: str = "cuda") -> Dict:
    fast = (not FULL) if fast is None else fast
    from repro_torch.configs import get_config

    cfg = get_config(ARCH)  # the FULL config: the ratios are the headline
    wire = wire_table(cfg)
    mig = migration_table(cfg)
    r8 = next(r for r in wire if r["rank"] == 8 and r["codec"] == "fp32")
    m8 = next(r for r in mig if r["rank"] == 8)
    assert r8["vs_full_fp32"] >= 20.0, \
        f"rank-8 wire only {r8['vs_full_fp32']:.1f}x below full-param fp32"
    assert m8["vs_full"] >= 50.0, \
        f"rank-8 migration only {m8['vs_full']:.1f}x below full-param"
    live = live_reconciliation(fast, device)
    return {"wire": wire, "migration": mig, "live": live,
            "wire_ratio_r8": r8["vs_full_fp32"],
            "migration_ratio_r8": m8["vs_full"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="CI scale for the live reconciliation run")
    device_arg(ap)
    args = ap.parse_args(argv)
    out = run(fast=args.fast or None, device=args.device)
    print("rank,codec,mb_per_round,vs_full_fp32")
    for r in out["wire"]:
        print(f"{r['rank'] or 'full'},{r['codec']},"
              f"{r['mb_per_round']:.2f},{r['vs_full_fp32']:.1f}")
    print("rank,mb_per_move,vs_full")
    for r in out["migration"]:
        print(f"{r['rank'] or 'full'},{r['mb_per_move']:.2f},"
              f"{r['vs_full']:.1f}")
    live = out["live"]
    obs.log(f"# rank-8: wire {out['wire_ratio_r8']:.0f}x and migration "
            f"{out['migration_ratio_r8']:.0f}x below full-param fp32; live "
            f"run [{device_name(args.device)}] reconciled {live['events']} "
            f"events ({live['migrations']} migrations) exactly")
    return out


if __name__ == "__main__":
    main()
