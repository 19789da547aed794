"""Fig. 11 (extension) on the port: round cost against bank size.

The simulator keeps ONE aggregated server model between rounds and
trains a sampled cohort of K participants a round, so server memory and
round time should not depend on how many clients the bank holds. With
``--bank host`` the client bank lives in host memory (pinned) and only
the round's K-slice is on the card, double-buffered behind training, so
device memory for client state is O(K). This run sweeps N at a fixed K
(sfl_ga, the light CNN, cut 1, batch 16: the reference's settings) and
reports per row:

* the round time (host clock to the loss's copy, after a warm-up round)
  and rounds a second, against the N = K full-participation baseline;
* the server bytes (one copy, flat across the sweep) and the bank bytes
  (the only O(N) state);
* from ``ClientBank.stats()``: the peak device-resident client-state
  bytes (the host bank's bar: at most two K-slices, the in-flight one
  and the staged next one), the prefetch hits and misses and the gather
  wait;
* ``replacement_fraction``.

Rows at N >= 100k use ``data.federated.CyclicPartition`` (an O(1)
partition view) and a uniform rho.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig11_scale.py
          [--device cpu] [--fast] [--bank device|host|sharded]
          [--no-prefetch]
``--fast`` sweeps N in {10, 256} at K 8 with 2 timed rounds; ``--bank
host`` adds N = 100k and 1M to the full sweep; ``--smoke`` runs N =
100k, K 16 on the host bank and exits non-zero when the peak device
client-state bytes exceed two K-slices. ``--bank sharded`` runs the
sweep over a one-rank process group (``launch.mesh.make_bank_mesh``),
or over the ranks of ``torchrun``.
"""
from __future__ import annotations

import argparse
import sys
import time
import warnings
from typing import Dict, List

import numpy as np

from benchmarks.torch_common import device_arg, device_name
from repro_torch import obs

CUT = 1  # keeps the O(N) bank small (conv1 only): the sweep is about N
BATCH = 16
HUGE_N = 100_000  # from here on, a lazy partition view


def _bytes(tree) -> int:
    from repro_torch.core.bank import tree_nbytes

    return tree_nbytes(tree)


def run_one(n_clients: int, cohort: int, rounds: int, n_samples: int,
            seed: int = 0, bank: str = "device", prefetch: bool = True,
            device="cuda") -> Dict:
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig
    from repro_torch.data import (CyclicPartition, iid_partition,
                                  make_image_dataset, replacement_fraction,
                                  rho_weights, round_batches)

    huge = n_clients >= HUGE_N
    ds = make_image_dataset("mnist", n=min(n_samples, 4096) if huge
                            else n_samples, seed=seed)
    if huge:
        parts, rho = CyclicPartition(len(ds.x), n_clients), None
    else:
        parts = iid_partition(len(ds.x), n_clients, seed=seed)
        rho = rho_weights(parts)
    full = cohort >= n_clients
    sim = FedSimulator(
        LIGHT_CONFIG,
        SimConfig(scheme="sfl_ga", cut=CUT, n_clients=n_clients, batch=BATCH,
                  cohort=None if full else cohort,
                  sampler="full" if full else "uniform", cohort_seed=seed,
                  bank=bank, bank_prefetch=prefetch),
        rho=rho, seed=seed, device=device)
    rng = np.random.RandomState(seed)

    def one_round():
        idx, _ = sim.cohort_for_round(sim._t)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # replacement is a stat here
            xs, ys = round_batches(ds, parts, BATCH, 1, rng, idx=idx)
        return sim.run_round(xs, ys)  # the loss's float ends in a sync

    one_round()  # warm-up
    times, loss = [], float("nan")
    for _ in range(rounds):
        t0 = time.perf_counter()
        loss = one_round()["loss"]
        times.append(time.perf_counter() - t0)
    sim.close()
    st = sim.bank.stats()
    round_ms = 1e3 * float(np.median(times))
    return {
        "n_clients": n_clients, "cohort": sim.n_participants,
        "round_ms": round_ms, "rounds_per_s": 1e3 / round_ms,
        "server_bytes": _bytes(sim.state["server"]),
        "bank_bytes": st["bank_bytes"], "bank": st["backend"],
        "device_bytes_peak": st["device_bytes_peak"],
        "prefetch_hits": st["prefetch_hits"],
        "prefetch_misses": st["prefetch_misses"],
        "gather_wait_ms": 1e3 * st["gather_wait_s"],
        "replacement_fraction": replacement_fraction(parts, BATCH),
        "loss": loss,
    }


def run(fast: bool = False, bank: str = "device", prefetch: bool = True,
        device="cuda") -> List[Dict]:
    if fast:
        ns, k, rounds = [10, 256], 8, 2
    else:
        ns, k, rounds = [10, 100, 1000, 10000], 16, 3
        if bank != "device":
            ns = ns + [100_000, 1_000_000]

    def samples_for(n):  # every client needs a sample; 2 a client at 10k
        return max(2000, 2 * n)

    rows = [run_one(k, k, rounds, samples_for(k), bank=bank,
                    prefetch=prefetch, device=device)]
    rows[0]["name"] = "baseline_N=K"
    for n in ns:
        r = run_one(n, k, rounds, samples_for(n), bank=bank,
                    prefetch=prefetch, device=device)
        r["name"] = f"N={n}"
        rows.append(r)
    base = rows[0]
    for r in rows:
        r["round_ms_vs_baseline"] = r["round_ms"] / base["round_ms"]
        r["server_bytes_flat"] = r["server_bytes"] == base["server_bytes"]
    return rows


def run_smoke(n_clients: int = 100_000, cohort: int = 16, rounds: int = 4,
              device="cuda") -> Dict:
    """The scale gate: a host-bank run at N = 100k whose obs-reported
    peak device client-state bytes must stay within two K-slices."""
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        row = run_one(n_clients, cohort, rounds, 4096, bank="host",
                      device=device)
    peaks = [e["bank"]["device_bytes_peak"] for e in rec.events
             if e.get("kind") == "round" and e.get("name") == "round"]
    if not peaks:
        raise RuntimeError("no round events recorded: obs wiring broken")
    peak = max(peaks)
    slice_bytes = row["bank_bytes"] // n_clients * cohort
    budget = 2 * slice_bytes
    row.update(device_bytes_peak=peak, slice_bytes=slice_bytes,
               budget_bytes=budget, ok=peak <= budget)
    obs.log(f"# scale smoke: N={n_clients} K={cohort} bank=host: peak "
            f"device client-state {peak} B vs budget {budget} B (2x "
            f"K-slice; a device bank would hold {row['bank_bytes'] / 1e6:.1f}"
            f" MB); round {row['round_ms']:.3f} ms "
            f"({row['rounds_per_s']:.1f} rounds/s); prefetch "
            f"{row['prefetch_hits']} hits / {row['prefetch_misses']} misses,"
            f" gather wait {row['gather_wait_ms']:.3f} ms -> "
            f"{'OK' if row['ok'] else 'OVER BUDGET'} "
            f"[{device_name(device)}]")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--fast", action="store_true",
                    help="N in {10, 256}, K 8, 2 timed rounds")
    ap.add_argument("--bank", default="device",
                    choices=["device", "host", "sharded"],
                    help="client-bank backend (core.bank); 'host' adds "
                         "N = 100k and 1M to the full sweep")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="turn off the host bank's double-buffered prefetch")
    ap.add_argument("--smoke", action="store_true",
                    help="N = 100k on the host bank; exit non-zero when the "
                         "peak device client-state bytes exceed 2 K-slices")
    args = ap.parse_args(argv)
    if args.smoke:
        row = run_smoke(device=args.device)
        sys.exit(0 if row["ok"] else 1)
    rows = run(fast=args.fast, bank=args.bank,
               prefetch=not args.no_prefetch, device=args.device)
    print("name,n_clients,cohort,round_ms,rounds_per_s,server_bytes,"
          "bank_bytes,device_peak_bytes,prefetch_hit_miss,gather_wait_ms,"
          "ratio_vs_baseline,replacement_fraction")
    for r in rows:
        print(f"{r['name']},{r['n_clients']},{r['cohort']},"
              f"{r['round_ms']:.3f},{r['rounds_per_s']:.1f},"
              f"{r['server_bytes']},{r['bank_bytes']},"
              f"{r['device_bytes_peak']},"
              f"{r['prefetch_hits']}/{r['prefetch_misses']},"
              f"{r['gather_wait_ms']:.3f},"
              f"{r['round_ms_vs_baseline']:.2f},"
              f"{r['replacement_fraction']:.2f}")
    worst = max(r["round_ms_vs_baseline"] for r in rows[1:])
    flat = all(r["server_bytes_flat"] for r in rows)
    obs.log(f"# server state one copy across the sweep: {flat}; worst "
            f"round-time ratio vs the N=K baseline: {worst:.2f}x; "
            f"bank={args.bank} prefetch={not args.no_prefetch} "
            f"[{device_name(args.device)}]")
    return rows


if __name__ == "__main__":
    main()
