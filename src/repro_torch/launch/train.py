"""Training launcher, CNN mode (port of ``repro.launch.train``).

``--arch paper-cnn`` runs the paper's own experiment through the
federated simulator (``core.simulator.FedSimulator``) on the synthetic
MNIST-like data of ``repro_torch.data`` (nothing to download):

* the fixed-cut loop, ``--rounds`` synchronous rounds;
* ``--async``: the event-driven buffered-async engine
  (``core.async_engine``): ``--rounds`` counts merges of ``--buffer``
  earliest completions, staleness-discounted by ``--staleness-lam``,
  over per-client completion times with a ``--straggler`` spread;
* ``--dynamic-cut``: Algorithm 1 executed live (``core.closed_loop``): a
  comma list ("2,1,3") is cycled over rounds, ``ddqn[:EPISODES]`` trains
  the policy first and queries it on the live channel each round; with
  ``--async`` the rounds are async merges and a cut move drains the
  queue first.

``--uplink-codec`` / ``--downlink-codec`` put a lossy transport on the
cut-layer boundary (kernels B2/B3 on the card), ``--tau`` runs tau local
epochs a round, ``--cohort K --sampler S`` trains K of ``--clients`` a
round, ``--bank host`` keeps the client bank in host memory.
``--checkpoint`` saves the run (an async run saves its in-flight queue
too) and ``--resume`` continues one bit for bit. ``--metrics-dir``
writes the reference's event schema (``python -m repro.obs.report DIR``
renders it), ``--profile N`` a ``torch.profiler`` trace of round N.

It runs on the card (``--device cuda``, the default) and exits with an
error when there is none; ``--device cpu`` runs on the CPU, with each
kernel's plain version. The LM mode (an ``--arch`` from the zoo) waits
for the port's LM training stack (ROADMAP A5).

Examples:
  python -m repro_torch.launch.train --arch paper-cnn --rounds 20 \
      --clients 256 --cohort 8 --sampler uniform
  python -m repro_torch.launch.train --arch paper-cnn --scheme sfl_ga \
      --cut 2 --rounds 100 --uplink-codec int8 --downlink-codec int8
  python -m repro_torch.launch.train --arch paper-cnn --clients 24 \
      --cohort 6 --async --buffer 2 --rounds 30
  python -m repro_torch.launch.train --arch paper-cnn --rounds 40 \
      --dynamic-cut ddqn:40
"""
from __future__ import annotations

import argparse
import os
from contextlib import contextmanager

import numpy as np

from repro_torch import obs, require_device


@contextmanager
def _maybe_profile(args, step: int):
    """``--profile N``: a ``torch.profiler`` trace (Chrome format) of the
    one designated round (a single round after the warm-up is what can be
    read; a whole run's trace is noise)."""
    if args.profile is None or step != args.profile:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(args.metrics_dir or ".", "profile")
    os.makedirs(out, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if args.device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(out, f"round_{step}.json")
    prof.export_chrome_trace(path)
    obs.log(f"profiler trace for round {step} -> {path}")


def _parse_dynamic_cut(args):
    """``--dynamic-cut`` -> a ``CutSchedule``, the ``ddqn[:EPISODES]``
    spec (trained by the caller, which owns the env), or None."""
    spec = args.dynamic_cut
    if not spec:
        return None
    from repro_torch.core.closed_loop import CutSchedule

    if spec.startswith("ddqn"):
        return spec
    return CutSchedule.from_sequence(
        [int(v) for v in spec.split(",")], name=f"sequence[{spec}]")


def _data_fn(args, train, parts):
    """Generation ``d``'s batches, pure in ``d`` (unlike the barrier
    loop's sequential rng): the event schedule interleaves generations,
    and a resume replays generation d's batches with no fast-forward."""
    from repro_torch.core.protocol import round_seed
    from repro_torch.data import round_batches

    def data_fn(d, idx):
        rng_d = np.random.RandomState(
            int(round_seed(args.seed, d)) % (2**31 - 1))
        return round_batches(train, parts, args.batch, args.tau, rng_d,
                             idx=np.asarray(idx))

    return data_fn


def train_cnn(args) -> dict:
    if args.peft != "none":
        raise SystemExit("--peft is LM-mode only (the paper CNN trains "
                         "full parameters)")
    device = require_device(args.device)
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig
    from repro_torch.data import (CyclicPartition, iid_partition,
                                  make_image_dataset, replacement_fraction,
                                  rho_weights, round_batches)

    ds = make_image_dataset(args.dataset, n=args.n_samples, seed=args.seed)
    train, test = ds.split(0.9)
    if args.clients > len(train.x):
        # more clients than samples: a cyclic view shares samples across
        # clients (an O(1) partition; a round touches only its K slices)
        parts = CyclicPartition(len(train.x), args.clients)
        rho = None  # equal part sizes: uniform rho without an O(N) list
        obs.log(f"data: cyclic partition view ({args.clients} clients over "
                f"{len(train.x)} samples, {parts.part_size}/client)")
    else:
        parts = iid_partition(len(train.x), args.clients, seed=args.seed)
        rho = rho_weights(parts)
    sim = FedSimulator(LIGHT_CONFIG,
                       SimConfig(scheme=args.scheme, cut=args.cut,
                                 n_clients=args.clients, batch=args.batch,
                                 tau=args.tau, lr=args.lr,
                                 uplink_codec=args.uplink_codec,
                                 downlink_codec=args.downlink_codec,
                                 cohort=args.cohort,
                                 sampler=args.sampler if args.cohort
                                 else "full",
                                 cohort_seed=args.seed,
                                 bank=args.bank),
                       rho=rho, seed=args.seed, device=device)
    if args.bank != "device":
        obs.log(f"client bank: {args.bank} backend "
                f"({sim.bank.nbytes / 1e6:.2f} MB off-device)")
    if args.cohort:
        obs.log(f"cohort: {sim.n_participants}/{args.clients} clients per "
                f"round ({sim.sampler.kind} sampler)")
    rf = replacement_fraction(parts, args.batch)
    if rf:
        obs.log(f"note: {rf:.0%} of client partitions are smaller than the "
                f"batch ({args.batch}); their draws sample with replacement")
    done_rounds = 0
    if args.resume and not args.async_mode:
        sim.restore(args.resume)
        done_rounds = sim._t
        obs.log(f"resumed from {args.resume} at round {sim._t} "
                f"(cut {sim.cut}); --rounds {args.rounds} more to run")
    schedule = _parse_dynamic_cut(args)
    if schedule is not None:
        result = _train_cnn_closed_loop(args, sim, schedule, train, test,
                                        parts, skip_batches=done_rounds)
    elif args.async_mode:
        eng = sim.async_engine(_data_fn(args, train, parts),
                               buffer=args.buffer, lam=args.staleness_lam,
                               straggler_factor=args.straggler)
        obs.log(f"async engine: buffer B={eng.buffer} of "
                f"K={sim.n_participants} in flight, straggler "
                f"x{args.straggler:g}, lam={args.staleness_lam:g}")
        if args.resume:
            eng.restore(args.resume)
            obs.log(f"resumed async schedule from {args.resume} at merge "
                    f"{eng.merge_idx} (clock {eng.clock:.1f}s, "
                    f"{eng.queue_depth} in flight)")
        for r in range(args.rounds):
            with _maybe_profile(args, r):
                m = eng.step()
            if (r + 1) % args.log_every == 0:
                acc = sim.evaluate(test.x, test.y)
                obs.log(f"merge {r+1}/{args.rounds} loss {m['loss']:.4f} "
                        f"acc {acc:.3f} clock {m['clock']:.1f}s queue "
                        f"{m['queue_depth']} stale {m['staleness_mean']:.1f}")
        if args.checkpoint:
            # keep the in-flight queue: the checkpoint is the schedule's
            # state, and a resume replays the identical merge order
            eng.save(args.checkpoint, {"scheme_args": args.scheme})
            obs.log(f"checkpoint -> {args.checkpoint} "
                    f"(merge {eng.merge_idx}, {eng.queue_depth} in flight)")
        else:
            eng.drain()
        st = eng.stats()
        acc = sim.evaluate(test.x, test.y)
        cb = sim.comm_bytes_per_round()
        obs.log(f"final acc {acc:.3f}; virtual clock {st['clock']:.1f}s "
                f"over {st['merges']} merges ({st['dispatches']} "
                f"dispatches, {st['sync_steps']} degenerate-sync); "
                f"comm/round {cb['total_bytes']/1e6:.3f} MB ({args.scheme})")
        result = {"accuracy": acc, "replacement_fraction": rf,
                  "async": st, **cb}
    else:
        rng = np.random.RandomState(args.seed)
        for t in range(done_rounds):
            # fast-forward the data stream past already-trained rounds so
            # a resumed run continues the uninterrupted batch sequence
            idx, _ = sim.cohort_for_round(t)
            round_batches(train, parts, args.batch, args.tau, rng, idx=idx)
        for r in range(args.rounds):
            # tau distinct local-epoch batches per participant; O(K) data
            # a round
            idx, _ = sim.cohort_for_round(sim._t)
            xs, ys = round_batches(train, parts, args.batch, args.tau, rng,
                                   idx=idx)
            with _maybe_profile(args, r):
                m = sim.run_round(xs, ys)
            if (r + 1) % args.log_every == 0:
                acc = sim.evaluate(test.x, test.y)
                obs.log(f"round {r+1}/{args.rounds} loss {m['loss']:.4f} "
                        f"acc {acc:.3f} drift {m['client_drift']:.2e}")
        acc = sim.evaluate(test.x, test.y)
        cb = sim.comm_bytes_per_round()
        obs.log(f"final acc {acc:.3f}; comm/round "
                f"{cb['total_bytes']/1e6:.3f} MB ({args.scheme}, "
                f"{sim.n_participants} participants)")
        result = {"accuracy": acc, "replacement_fraction": rf, **cb}
    if args.bank != "device":
        st = sim.bank.stats()
        obs.log(f"bank[{st['backend']}]: peak device client-state "
                f"{st['device_bytes_peak'] / 1e6:.2f} MB of "
                f"{st['bank_bytes'] / 1e6:.2f} MB bank; prefetch "
                f"{st['prefetch_hits']} hits / {st['prefetch_misses']} "
                f"misses")
        result["bank"] = st
    if args.checkpoint and not (args.async_mode and schedule is None):
        # async runs checkpointed through the engine above (the schedule
        # state rides along with the model state)
        sim.save(args.checkpoint, {"scheme_args": args.scheme})
        obs.log(f"checkpoint -> {args.checkpoint} (round {sim._t})")
    sim.close()
    return result


def _train_cnn_closed_loop(args, sim, schedule, train, test, parts,
                           skip_batches: int = 0) -> dict:
    """CNN mode with ``--dynamic-cut``: the closed loop (live cut
    migration, wall-clock from the P2.1 allocation or, with ``--async``,
    from the engine's virtual clock)."""
    from repro_torch.ccc.env import CuttingPointEnv, cnn_env_config
    from repro_torch.core.closed_loop import run_closed_loop

    def make_env():
        # the env's cohort is the simulator's: the observation and the
        # P2.1 bandwidth split cover the K participants, not the N-bank
        return CuttingPointEnv(cnn_env_config(
            n_clients=args.clients, batch=args.batch, seed=args.seed,
            cohort=args.cohort, async_obs=args.async_mode))

    env = make_env()
    if isinstance(schedule, str):  # "ddqn[:EPISODES]"
        from repro_torch.ccc.strategy import run_algorithm1

        episodes = int(schedule.split(":")[1]) if ":" in schedule else 60
        obs.log(f"training Algorithm 1 policy ({episodes} episodes)...")
        res = run_algorithm1(make_env(), episodes=episodes,
                             device=sim.device)
        schedule = res.cut_schedule(env)
    eng = None
    if args.async_mode:
        if args.resume:
            raise SystemExit("--async --dynamic-cut does not support "
                             "--resume (checkpoint the fixed-cut async "
                             "loop instead)")
        eng = sim.async_engine(_data_fn(args, train, parts),
                               buffer=args.buffer, lam=args.staleness_lam,
                               straggler_factor=args.straggler)
        obs.log(f"async closed loop: buffer B={eng.buffer} of "
                f"K={sim.n_participants}, straggler x{args.straggler:g}; "
                f"policy sees queue depth + staleness "
                f"(state_dim {env.state_dim})")
    r = run_closed_loop(sim, env, schedule, train, test, parts,
                        rounds=args.rounds, eval_every=args.log_every,
                        batch_seed=args.seed, skip_batches=skip_batches,
                        log_every=args.log_every, async_engine=eng)
    obs.log(f"final acc {r.final_acc:.3f}; wall-clock {r.total_latency_s:.2f}s "
            f"({r.n_migrations} migrations, "
            f"{r.migration_bits_total/8e6:.2f} MB migrated); cuts {r.cuts}")
    return {"accuracy": r.final_acc, "wall_clock_s": r.total_latency_s,
            "cuts": r.cuts, "n_migrations": r.n_migrations,
            "migration_bits": r.migration_bits_total,
            "total_bits": r.total_bits}


def main(argv=None):
    """Parse the reference's flags (plus ``--device``) and run the CNN
    mode; returns its result dict."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--scheme", default="sfl_ga",
                   choices=["sfl_ga", "sfl", "psl", "fl"])
    p.add_argument("--preset", default="smoke", choices=["smoke", "100m", "full"],
                   help="LM mode only (ROADMAP A5)")
    p.add_argument("--cut", type=int, default=1)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=128,
                   help="LM mode only (ROADMAP A5)")
    p.add_argument("--steps", type=int, default=50,
                   help="LM mode only (ROADMAP A5)")
    p.add_argument("--rounds", type=int, default=50)
    p.add_argument("--tau", type=int, default=1,
                   help="local epochs per round")
    p.add_argument("--cohort", type=int, default=None,
                   help="partial participation: K clients sampled per round "
                        "out of --clients (default: everyone)")
    p.add_argument("--sampler", default="uniform",
                   choices=["full", "uniform", "rho", "latency"],
                   help="cohort sampler (core.cohort) when --cohort is set: "
                        "uniform (unbiased HT weights), rho (rho-"
                        "proportional with replacement), latency "
                        "(straggler-avoiding)")
    p.add_argument("--async", dest="async_mode", action="store_true",
                   help="event-driven buffered-async rounds: merge the "
                        "--buffer earliest completions per step with "
                        "staleness-discounted weights (--rounds counts "
                        "merges)")
    p.add_argument("--buffer", type=int, default=None, metavar="B",
                   help="async merge buffer B <= K (default K: with a "
                        "zero-spread completion draw this is the sync loop)")
    p.add_argument("--straggler", type=float, default=4.0,
                   help="async completion-time heterogeneity: slowest/"
                        "fastest client speed ratio")
    p.add_argument("--staleness-lam", type=float, default=0.5, metavar="LAM",
                   help="staleness discount exponent: deltas weigh "
                        "(1+tau)^-LAM after tau merges in flight")
    p.add_argument("--dynamic-cut", default=None,
                   help="per-round cut schedule: comma list '1,2,1' "
                        "(cycled) or 'ddqn[:EPISODES]' (train Algorithm 1 "
                        "first, then query the policy on the live channel)")
    p.add_argument("--peft", default="none", choices=["none", "lora"],
                   help="LM mode only (ROADMAP A5)")
    p.add_argument("--lora-rank", type=int, default=8,
                   help="LM mode only (ROADMAP A5)")
    p.add_argument("--lora-alpha", type=float, default=16.0,
                   help="LM mode only (ROADMAP A5)")
    p.add_argument("--layers", type=int, default=None,
                   help="LM mode only (ROADMAP A5)")
    p.add_argument("--resume", default=None,
                   help="resume a checkpoint: restores the simulator "
                        "(params, round counter, cut) or, with --async, the "
                        "engine's schedule (bit-exact continuation)")
    p.add_argument("--bank", default="device",
                   choices=["device", "host", "sharded"],
                   help="client-bank residency (core.bank): device (the "
                        "default) or host (bank in host memory, O(K) device "
                        "bytes + prefetch); sharded waits for ROADMAP A6")
    p.add_argument("--uplink-codec", default="fp32",
                   help="cut-layer uplink codec: fp32|bf16|fp8|int8|int4|topkP")
    p.add_argument("--downlink-codec", default="fp32",
                   help="cut-layer downlink codec (gradient broadcast/unicast)")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--optimizer", default="sgd",
                   help="LM mode only (ROADMAP A5)")
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--n-samples", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--metrics-dir", default=None,
                   help="enable the obs recorder: JSONL events + manifest "
                        "into this directory (render with "
                        "python -m repro.obs.report DIR)")
    p.add_argument("--profile", type=int, default=None, metavar="N",
                   help="capture a torch.profiler trace of round N "
                        "(written under --metrics-dir, or ./profile)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the stderr progress log (events still "
                        "recorded when --metrics-dir is set)")
    args = p.parse_args(argv)
    if not args.arch.startswith("paper-cnn"):
        raise SystemExit(
            f"--arch {args.arch}: the port's launcher runs the CNN mode "
            f"(--arch paper-cnn); the LM mode waits for the port's LM "
            f"training stack (ROADMAP A5)")
    # the recorder before any simulator is built: instrumented objects
    # keep the recorder active when they were made
    rec = None
    if args.metrics_dir:
        rec = obs.Recorder(args.metrics_dir, quiet=args.quiet,
                           append=bool(args.resume), config=vars(args))
        obs.set_recorder(rec)
    obs.set_quiet(args.quiet)
    try:
        return train_cnn(args)
    finally:
        if rec is not None:
            rec.close()
            obs.set_recorder(None)
        obs.set_quiet(False)


if __name__ == "__main__":
    main()
