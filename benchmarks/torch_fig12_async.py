"""Fig. 12 (extension) on the port: buffered-async against the global
barrier, accuracy per unit of virtual wall-clock under stragglers.

The paper's latency model (§IV eq. 29) prices per-client completion
times chi+psi, but a synchronous round costs its slowest client. The
event-driven engine (``repro_torch.core.async_engine``) merges the B
earliest completions instead, staleness-discounting late deltas, so
the model keeps moving while stragglers finish. Per scheme (sfl_ga,
psl, sfl) both loops run over the same heterogeneous completion draw
(``sysmodel.latency.completion_time_fn``, slowest/fastest 8x by
default), and each row reports:

* the sync barrier's virtual clock (max over the cohort a round) and
  the async engine's (event by event), with rounds and merges;
* accuracy at the matched budget (the shorter run's final clock);
* the mean staleness of the merges;
* exact traffic reconciliation for both loops: every obs ``traffic``
  event's measured ledger equals the ``sysmodel.traffic`` model bit for
  bit (the async split prices compute legs at dispatch size and the
  model-sync uplink at merge size); the run exits 1 otherwise.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig12_async.py [--fast]
          [--buffer B] [--straggler X] [--device cpu]
As in the reference, the run is the fast one (N 24, K 6, B 2, 6 sync
rounds a scheme) unless REPRO_BENCH_FULL=1 (N 64, K 8, B 2, 30 rounds).
Each row also gives the host time of the two loops (the first
scheme's sync loop also pays the process's first CUDA calls) and the
B1/B2/B3 launches of the async one.
"""
from __future__ import annotations

import argparse
import time
import warnings
from typing import Dict, List

import numpy as np

from benchmarks.torch_common import (FULL, device_arg, device_name,
                                     kernel_launches)
from repro_torch import obs

CUT = 1
BATCH = 8
SCHEMES = ("sfl_ga", "psl", "sfl")


def _acc_at(curve, budget_s: float) -> float:
    """Step interpolation: last accuracy reached within the budget."""
    acc = 0.0
    for t, a in curve:
        if t <= budget_s:
            acc = a
    return acc


def _check_traffic(events) -> Dict[str, int]:
    ok = bad = 0
    for e in events:
        if e.get("kind") != "traffic":
            continue
        meas, mod = e["measured"], e["modeled"]
        cats = [c for c in meas if c in mod]
        if cats and all(int(meas[c]) == int(mod[c]) for c in cats):
            ok += 1
        else:
            bad += 1
    return {"ok": ok, "bad": bad}


def run_one(scheme: str, *, n_clients: int, cohort: int, buffer: int,
            rounds: int, n_samples: int, straggler: float = 8.0,
            eval_every: int = 2, seed: int = 0, device="cuda") -> Dict:
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.core.protocol import round_seed
    from repro_torch.core.simulator import FedSimulator, SimConfig
    from repro_torch.data import (iid_partition, make_image_dataset,
                                  round_batches)
    from repro_torch.sysmodel.latency import completion_time_fn

    ds = make_image_dataset("mnist", n=n_samples, seed=seed)
    train, test = ds.split(0.9)
    parts = iid_partition(len(train.x), n_clients, seed=seed)
    completion = completion_time_fn(n_clients, seed=seed,
                                    straggler_factor=straggler, batch=BATCH)

    def make_sim(rec):
        with obs.use_recorder(rec):
            return FedSimulator(
                LIGHT_CONFIG,
                SimConfig(scheme=scheme, cut=CUT, n_clients=n_clients,
                          batch=BATCH, cohort=cohort, sampler="uniform",
                          cohort_seed=seed),
                seed=seed, device=device)

    # -- sync barrier: each round waits for its slowest participant ----
    rec_s = obs.Recorder()
    sim = make_sim(rec_s)
    rng = np.random.RandomState(seed)
    clock, sync_curve = 0.0, []
    t0 = time.perf_counter()
    with obs.use_recorder(rec_s), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for t in range(rounds):
            rec_s.set_round(t)
            idx, _ = sim.cohort_for_round(sim._t)
            xs, ys = round_batches(train, parts, BATCH, 1, rng, idx=idx)
            sim.run_round(xs, ys)
            clock += float(np.asarray(completion(t))[idx].max())
            if (t + 1) % eval_every == 0 or t == rounds - 1:
                sync_curve.append((clock, sim.evaluate(test.x, test.y)))
    sync_host_s = time.perf_counter() - t0
    sim.close()
    sync_recon = _check_traffic(rec_s.events)

    # -- buffered async: same completion draw, merge B earliest -------
    rec_a = obs.Recorder()
    sim = make_sim(rec_a)

    def data_fn(d, idx):
        rng_d = np.random.RandomState(int(round_seed(seed, d)) % (2**31 - 1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return round_batches(train, parts, BATCH, 1, rng_d,
                                 idx=np.asarray(idx))

    before = kernel_launches()
    t0 = time.perf_counter()
    with obs.use_recorder(rec_a):
        eng = sim.async_engine(data_fn, buffer=buffer,
                               completion_fn=completion)
        async_curve, merges = [], 0
        # equal virtual-time budget: merge until the sync clock
        while eng.clock < clock:
            eng.step()
            merges += 1
            if merges % eval_every == 0:
                async_curve.append((eng.clock,
                                    sim.evaluate(test.x, test.y)))
        eng.drain()
        async_curve.append((eng.clock, sim.evaluate(test.x, test.y)))
    async_host_s = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    st = eng.stats()
    sim.close()
    async_recon = _check_traffic(rec_a.events)
    stale = [float(e["staleness_mean"]) for e in rec_a.events
             if e.get("kind") == "async" and e.get("name") == "merge"]

    budget = min(clock, async_curve[-1][0])
    return {
        "scheme": scheme,
        "sync_clock_s": clock,
        "async_clock_s": async_curve[-1][0],
        "sync_rounds": rounds,
        "async_merges": st["merges"],
        "sync_acc_at_budget": _acc_at(sync_curve, budget),
        "async_acc_at_budget": _acc_at(async_curve, budget),
        "mean_staleness": float(np.mean(stale)) if stale else 0.0,
        "sync_curve": sync_curve,
        "async_curve": async_curve,
        "sync_host_s": sync_host_s,
        "async_host_s": async_host_s,
        "launches": launches,
        "traffic_ok": (sync_recon["bad"] == 0 and async_recon["bad"] == 0
                       and sync_recon["ok"] > 0 and async_recon["ok"] > 0),
        "traffic_events": {"sync": sync_recon, "async": async_recon},
    }


def run(fast: bool = None, buffer: int = None, straggler: float = 8.0,
        device="cuda") -> List[Dict]:
    fast = (not FULL) if fast is None else fast
    if fast:
        n, k, rounds, n_samples = 24, 6, 6, 600
    else:
        n, k, rounds, n_samples = 64, 8, 30, 2000
    b = buffer or max(1, k // 3)
    return [run_one(s, n_clients=n, cohort=k, buffer=b, rounds=rounds,
                    n_samples=n_samples, straggler=straggler, device=device)
            for s in SCHEMES]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fast", action="store_true",
                    help="N=24, K=6, 6 sync rounds")
    ap.add_argument("--buffer", type=int, default=None,
                    help="async merge buffer B (default K//3)")
    ap.add_argument("--straggler", type=float, default=8.0,
                    help="slowest/fastest completion ratio")
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_name(args.device)
    rows = run(fast=args.fast or None, buffer=args.buffer,
               straggler=args.straggler, device=args.device)
    print(f"# device: {dev}")
    print("scheme,sync_rounds,async_merges,sync_clock_s,async_acc@budget,"
          "sync_acc@budget,mean_staleness,traffic_ok,sync_host_s,"
          "async_host_s,launches_b1_b2_b3")
    for r in rows:
        ln = r["launches"]
        print(f"{r['scheme']},{r['sync_rounds']},{r['async_merges']},"
              f"{r['sync_clock_s']:.1f},{r['async_acc_at_budget']:.3f},"
              f"{r['sync_acc_at_budget']:.3f},{r['mean_staleness']:.2f},"
              f"{r['traffic_ok']},{r['sync_host_s']:.3f},"
              f"{r['async_host_s']:.3f},{ln['grad_agg']}/{ln['quantize']}/"
              f"{ln['dequant_agg']}")
    n_bad = sum(not r["traffic_ok"] for r in rows)
    obs.log(f"# async engine merged {sum(r['async_merges'] for r in rows)} "
            f"buffers across {len(rows)} schemes within the sync budget; "
            f"traffic reconciliation "
            f"{'EXACT on both loops' if not n_bad else f'{n_bad} FAILURES'}")
    if n_bad:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
