"""Training launcher (port of ``repro.launch.train``).

Two modes:

* LM mode (``--arch`` any arch of the zoo but paper-cnn: granite-8b,
  granite-20b, command-r-35b, starcoder2-3b, qwen2-vl-2b,
  qwen3-moe-30b-a3b, kimi-k2-1t-a32b, jamba-v0.1-52b, mamba2-130m, and
  whisper-tiny, which trains, as in the reference, as a decoder-only LM
  of whisper's widths with its encoder left out): SFL split
  training of a reduced (``--preset smoke``), ~100M-parameter (``100m``)
  or full-width (``full``) config on synthetic token streams
  (``core.algorithms``). ``--layers`` cuts the depth after the preset.
  ``--peft lora`` federates LoRA adapters (``--lora-rank``,
  ``--lora-alpha``) over a frozen base that never crosses the wire;
  ``--optimizer`` is sgd, momentum or adamw. ``--steps`` counts steps.
  ``--dynamic-cut`` takes a comma list ("1,2,1", cycled over steps) or
  ``ddqn[:EPISODES]`` (Algorithm 1 trained first on the LM's
  ``ccc.env.lm_env_config`` with the agent on ``--device``, its greedy
  rollout then frozen as a cycled schedule, so a ``--resume`` replays
  the same migrations): each change of cut migrates the params and the
  optimizer moments (``resplit_*``), priced by ``migration_bits`` (or,
  under PEFT, ``adapter_migration_bits``). MoE layers add 0.01 x their
  balance loss to the train loss; ``--lora-targets`` picks the
  projection families that get adapters (attention, dense FFNs and SSM
  projections by default, the MoE router on request; the reference's
  launcher has no such flag and always takes the default). ``--async``
  runs the buffered-async engine over the LM (``_LMAsyncExecutor``:
  ``--steps`` counts merges; a generation's server delta folds in,
  staleness-discounted, at the merge where its last member lands; sgd,
  sfl_ga or psl, the device bank, a fixed cut and no resume, as in the
  reference).
* CNN mode (``--arch paper-cnn``): the paper's own experiment through the
  federated simulator (``core.simulator.FedSimulator``) on the synthetic
  MNIST-like data of ``repro_torch.data`` (nothing to download): the
  fixed-cut loop (``--rounds`` synchronous rounds); ``--async``, the
  event-driven buffered-async engine (``core.async_engine``: ``--rounds``
  counts merges of ``--buffer`` earliest completions, staleness-
  discounted by ``--staleness-lam``, over per-client completion times
  with a ``--straggler`` spread); ``--dynamic-cut``, Algorithm 1 executed
  live (``core.closed_loop``: a comma list is cycled over rounds,
  ``ddqn[:EPISODES]`` trains the policy first and queries it on the live
  channel each round; with ``--async`` a cut move drains the queue
  first).

In both modes ``--uplink-codec`` / ``--downlink-codec`` put a lossy
transport on the cut-layer boundary (kernels B2/B3 on the card; the
sfl_ga boundary's backward is eq. 5, kernel B1), ``--tau`` runs tau local
steps a round, ``--cohort K --sampler S`` trains K of ``--clients`` a
round (or step), ``--bank host`` keeps the client bank in host memory
(LM mode: with ``--cohort``, and with ``--dynamic-cut`` only under
``--peft lora``); ``--bank sharded`` (CNN mode) splits it over the ranks
of the default process group (``launch.mesh.make_bank_mesh``: a
one-rank group when the launcher is not run under ``torchrun``).
``--checkpoint`` saves the run in the reference's file format (an async
CNN run saves its in-flight queue too) and ``--resume`` continues one bit
for bit. ``--metrics-dir`` writes the reference's event schema (``python
-m repro_torch.obs.report DIR`` renders it; every LM step's
traffic and every migration's bits against the model), ``--profile N`` a
``torch.profiler`` trace of round or step N.

It runs on the card (``--device cuda``, the default) and exits with an
error when there is none; ``--device cpu`` runs on the CPU, with each
kernel's plain version.

Examples:
  python -m repro_torch.launch.train --arch granite-8b --preset full \
      --layers 4 --cut 2 --clients 4 --batch 1 --seq 256 --steps 3
  python -m repro_torch.launch.train --arch granite-8b --preset smoke \
      --layers 3 --steps 4 --dynamic-cut 1,2 --device cpu
  python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \
      --preset full --layers 3 --clients 2 --batch 1 --seq 256 --steps 3 \
      --uplink-codec int8 --downlink-codec int8 --dynamic-cut 1,2,1
  python -m repro_torch.launch.train --arch granite-8b --preset full \
      --peft lora --optimizer adamw --clients 8 --cohort 2 --bank host \
      --uplink-codec int8 --downlink-codec int8 --dynamic-cut 2,3,2 \
      --batch 1 --seq 256 --steps 3
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
import time
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


def _lm_config(args):
    """The preset's config: ``smoke`` the reference's reduced config,
    ``100m`` ~100M parameters in the family, ``full`` the published
    widths; ``--layers`` then cuts the depth."""
    from repro_torch.configs import get_config, reduced_config

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = reduced_config(cfg)
    elif args.preset == "100m":
        cfg = reduced_config(cfg).with_overrides(
            name=cfg.name + "-100m", num_layers=4, d_model=512,
            num_heads=8 if cfg.num_heads else 0,
            num_kv_heads=4 if cfg.num_kv_heads else 0,
            d_ff=min(cfg.d_ff, 2048) if cfg.d_ff else 0,
            vocab_size=min(cfg.vocab_size, 32768), head_dim=64)
    if args.layers:
        cfg = cfg.with_overrides(num_layers=args.layers)
    return cfg


def lm_state_like(params, opt_state, plan):
    """The structure, shapes and dtypes of ``{"params", "opt"}`` in the
    reference's layout, as meta tensors (nothing is copied): what a
    checkpoint is validated against."""
    import torch

    from repro_torch import convert
    from repro_torch.tree import tree_map

    return tree_map(lambda l: torch.empty(l.shape, dtype=l.dtype,
                                          device="meta"),
                    convert.lm_state_to_jax({"params": params,
                                             "opt": opt_state}, plan))


def load_lm_state(path, like, plan, device):
    """``{"params", "opt"}`` of an LM checkpoint (the reference's layout,
    validated against ``like``) in the port's layout on ``device``."""
    from repro_torch import convert
    from repro_torch.checkpoint import load_checkpoint

    state, _ = load_checkpoint(path, like)
    return convert.lm_state_from_jax(state, plan, device)


def train_lm(args) -> dict:
    """LM mode: SFL split training of the split LM (``core.algorithms``)
    on synthetic token streams; returns the run's losses, traffic and
    migrations."""
    import torch

    device = require_device(args.device)
    from repro_torch import convert
    from repro_torch.checkpoint import load_checkpoint_meta, save_checkpoint
    from repro_torch.configs import PeftSpec, TrainConfig
    from repro_torch.core import algorithms as alg
    from repro_torch.core.protocol import (ProtocolEngine, round_seed,
                                           scheme_spec)
    from repro_torch.core.split import (client_adapter_numel,
                                        client_param_numel)
    from repro_torch.data import synthetic_token_batches
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer
    from repro_torch.sysmodel.traffic import (adapter_migration_bits,
                                              migration_bits)
    from repro_torch.tree import tree_leaves

    cfg = _lm_config(args)
    peft = PeftSpec(kind="lora", rank=args.lora_rank,
                    alpha=args.lora_alpha,
                    targets=tuple(args.lora_targets.split(","))) \
        if args.peft == "lora" else None
    n, b, S, tau = args.clients, args.batch, args.seq, args.tau
    K = args.cohort or n
    sampler = None
    spec = scheme_spec(args.scheme)
    if args.cohort:
        from repro_torch.core.cohort import make_sampler

        sampler = make_sampler(args.sampler, n, K, seed=args.seed)
        obs.log(f"cohort: {K}/{n} clients per step ({args.sampler} sampler)")
    schedule = _parse_dynamic_cut(args)
    if isinstance(schedule, str):  # "ddqn[:EPISODES]": train Algorithm 1
        schedule = _lm_ddqn_schedule(schedule, args, cfg, peft, n, b, S,
                                     device)
    if schedule is not None and not all(1 <= v < cfg.num_layers
                                        for v in schedule.cuts):
        raise SystemExit(f"--dynamic-cut {args.dynamic_cut}: every cut must "
                         f"lie in [1, {cfg.num_layers - 1}] ({cfg.name} has "
                         f"{cfg.num_layers} layers; try --layers 3)")
    # a resume takes its cut from the checkpoint; the schedule replays the
    # same migrations from the absolute step index
    done = 0
    if args.resume:
        rmeta = load_checkpoint_meta(args.resume)
        if str(rmeta.get("peft", "none")) != args.peft:
            raise SystemExit(f"--resume checkpoint was trained with "
                             f"--peft {rmeta.get('peft', 'none')}, "
                             f"run asked for --peft {args.peft}")
        done = int(rmeta["step"])
        cut0 = int(rmeta["cut"])
    else:
        cut0 = schedule(0) if schedule else args.cut
    tcfg = TrainConfig(model=cfg, algo=args.scheme, cut_layer=cut0,
                       compute_dtype="float32", param_dtype="float32",
                       lr=args.lr, remat=False, tau=tau,
                       uplink_codec=args.uplink_codec,
                       downlink_codec=args.downlink_codec,
                       peft=args.peft, lora_rank=args.lora_rank,
                       lora_alpha=args.lora_alpha, seed=args.seed)
    # one engine for the run, owned here so the traffic ledger meters the
    # transport the steps run; float32 compute: 32 raw bits an element
    rec = obs.get_recorder()
    engine = ProtocolEngine(args.scheme, args.uplink_codec,
                            args.downlink_codec, base_seed=args.seed,
                            adapter_sync=peft is not None)
    if rec.enabled:
        engine.attach_ledger(rec.ledger, raw_bits_per_elem=32.0,
                             label_bits_per_epoch=b * S * 32)
    plans = {cut0: lm.build_plan(cfg, cut0, peft=peft)}
    cut = cut0
    # the bank holds all N client stacks; a step sees the K participants
    base_init = lm.init_lm(args.seed, plans[cut0], torch.float32, device)
    if peft is None:
        params = alg.split_lm_params(base_init, n)
    else:
        # client/server hold only adapters; the frozen base rides under
        # params["base"] and never trains
        loras = lm.init_lm_loras(args.seed + 1, plans[cut0], torch.float32,
                                 device)
        params = alg.split_lm_lora_params(base_init, loras, n)
        obs.log(f"peft: lora rank {args.lora_rank} alpha "
                f"{args.lora_alpha:g} -- {client_adapter_numel(plans[cut0])}"
                f" trainable client params/client of "
                f"{client_param_numel(plans[cut0])} resident")
    del base_init
    opt = make_optimizer(args.optimizer, args.lr)
    opt_state = opt.init(alg.trainable_params(params))
    if args.resume:
        # the initial state only gives the structure: dropped before the
        # file's state lands on the device
        like = lm_state_like(params, opt_state, plans[cut0])
        params = opt_state = None
        st = load_lm_state(args.resume, like, plans[cut0], device)
        params, opt_state = st["params"], st["opt"]
        del st, like
        obs.log(f"resumed from {args.resume} at step {done} (cut {cut0}); "
                f"--steps {args.steps} more to run")
    # --bank host: the O(N) client stacks (params and any moments) live in
    # host banks; a step gathers the K-cohort slice onto the device
    pbank, obanks = None, {}
    if args.bank != "device":
        if args.bank != "host":
            raise SystemExit("--bank sharded is CNN-mode only; LM runs "
                             "shard the client bank via launch.shardings "
                             "on real meshes")
        if schedule is not None and peft is None:
            raise SystemExit("--bank host cannot run --dynamic-cut with "
                             "--peft none: a full-parameter resplit would "
                             "round-trip the whole O(N) bank through the "
                             "device every migration. Run --peft lora: "
                             "only the adapters migrate")
        if sampler is None:
            raise SystemExit("--bank host needs --cohort in LM mode (the "
                             "identity cohort re-gathers the whole bank "
                             "every step)")
    if args.async_mode:  # refused before the bank allocates anything
        _refuse_lm_async(args, schedule, engine)
    if args.bank != "device":
        from repro_torch.core.bank import ClientBank

        pbank = ClientBank(params["client"], n_clients=n, stacked=True,
                           backend="host", device=device)
        params = dict(params, client=None)  # the bank owns the client side
        for mk in ("m", "v", "mu"):
            if mk in opt_state:
                obanks[mk] = ClientBank(opt_state[mk]["client"], n_clients=n,
                                        stacked=True, backend="host",
                                        device=device)
                opt_state[mk] = dict(opt_state[mk], client=None)
        off = pbank.nbytes + sum(bk.nbytes for bk in obanks.values())
        obs.log(f"client bank: host backend ({off / 1e6:.2f} MB params"
                f"{' + moments' if obanks else ''} off-device)")
    steps_by_cut = {cut0: alg.make_train_step(plans[cut0], tcfg, opt, K,
                                              engine=engine)}
    if args.async_mode:
        gen_fn = alg.make_gen_step(plans[cut0], tcfg, opt, K, engine=engine)
        return _run_lm_async(args, cfg, plans[cut0], tcfg, engine, params,
                             opt_state, steps_by_cut[cut0], gen_fn, rec,
                             n, K, b, S, tau, device)

    def per_client_numel(client_tree):
        return sum(int(l.numel()) for l in tree_leaves(client_tree)) // n

    it = synthetic_token_batches(cfg.vocab_size, K * b * tau, S,
                                 seed=args.seed)
    for _ in range(done):
        next(it)  # a resume continues the uninterrupted batch sequence
    shape = (K, b, S) if tau == 1 else (K, tau, b, S)
    losses = []
    mig_total_bits = 0
    n_migrations = 0
    t0 = time.time()
    for i in range(done, done + args.steps):
        if rec.enabled:
            rec.set_round(i)
        if schedule is not None:
            v = schedule(i)
            if v != cut:
                # migrate the boundary layers and the optimizer moments;
                # under PEFT only the adapters move and the frozen base is
                # a relayout
                if v not in plans:
                    plans[v] = lm.build_plan(cfg, v, peft=peft)
                    steps_by_cut[v] = alg.make_train_step(
                        plans[v], tcfg, opt, K, engine=engine)
                # the whole bank migrates; the K participants of the step
                # pay the wire
                if pbank is None:
                    per_old = per_client_numel(params["client"])
                    params = alg.resplit_lm_params(params, plans[cut],
                                                   plans[v])
                    opt_state = alg.resplit_opt_state(opt_state, plans[cut],
                                                      plans[v])
                    per_new = per_client_numel(params["client"])
                else:
                    # host bank (LoRA only): the adapter rows resplit,
                    # and the banks take the new contents (a staged
                    # prefetch is dropped); the pending scatters land first
                    for bk in [pbank, *obanks.values()]:
                        bk.flush()
                    fp = dict(params, client=pbank.tree)
                    fo = dict(opt_state)
                    for mk, bk in obanks.items():
                        fo[mk] = dict(opt_state[mk], client=bk.tree)
                    per_old = per_client_numel(fp["client"])
                    fp = alg.resplit_lm_params(fp, plans[cut], plans[v])
                    fo = alg.resplit_opt_state(fo, plans[cut], plans[v])
                    per_new = per_client_numel(fp["client"])
                    pbank.replace(fp["client"])
                    params = dict(fp, client=None)
                    opt_state = fo
                    for mk, bk in obanks.items():
                        bk.replace(fo[mk]["client"])
                        opt_state[mk] = dict(fo[mk], client=None)
                if peft is None:
                    mb = migration_bits(client_param_numel(plans[cut]),
                                        client_param_numel(plans[v]),
                                        n_clients=K, raw_bits_per_elem=32)
                else:
                    mb = adapter_migration_bits(
                        client_adapter_numel(plans[cut]),
                        client_adapter_numel(plans[v]),
                        n_clients=K, raw_bits_per_elem=32)
                mig_total_bits += mb["total_bits"]
                n_migrations += 1
                if rec.enabled:
                    # measured from the bank tensors that moved sides
                    payload = abs(per_new - per_old) * 32 * K
                    rec.event(
                        "migration", name="resplit", scheme=args.scheme,
                        cut=v, cut_from=cut, participants=K,
                        peft=args.peft,
                        measured={
                            "up_bits": payload if per_new < per_old else 0,
                            "down_bits": payload if per_new > per_old else 0,
                            "total_bits": payload},
                        modeled=mb)
                obs.log(f"step {i}: cut {cut} -> {v} "
                        f"(migrated {mb['total_bits']/8e6:.2f} MB)")
                cut = v
        toks, labels = next(it)
        batch = {"tokens": torch.from_numpy(toks.reshape(shape)).to(device),
                 "labels": torch.from_numpy(labels.reshape(shape)).to(device),
                 "seed": round_seed(args.seed, i)}
        with _maybe_profile(args, i), rec.span("step", cut=cut):
            if sampler is None:
                params, opt_state, m = steps_by_cut[cut](params, opt_state,
                                                         batch)
            else:
                # partial participation: gather the step's cohort (params
                # and moments), train with its weights, scatter back (sfl
                # broadcasts its new global client model)
                idx, w = sampler.cohort(i)
                nxt = None
                if pbank is None:
                    cp = alg.gather_cohort(params, idx)
                    cop = alg.gather_cohort_opt(opt_state, idx)
                else:
                    cp = dict(params, client=pbank.gather(idx, t=i))
                    cop = dict(opt_state)
                    for mk, bk in obanks.items():
                        cop[mk] = dict(opt_state[mk],
                                       client=bk.gather(idx, t=i))
                    # a disjoint next cohort is staged while this step
                    # trains; sfl broadcast-scatters (every row rewrites),
                    # so it always prefetches after the scatter
                    nxt, _ = sampler.peek(i + 1)
                    if not spec.client_aggregate \
                            and np.intersect1d(idx, nxt).size == 0:
                        pbank.prefetch(i + 1, nxt)
                        for bk in obanks.values():
                            bk.prefetch(i + 1, nxt)
                        nxt = None
                cp, cop, m = steps_by_cut[cut](cp, cop, dict(batch, rho=w))
                if pbank is None:
                    params = alg.scatter_cohort(
                        params, cp, idx,
                        broadcast_client=spec.client_aggregate)
                    opt_state = alg.scatter_cohort_opt(opt_state, cop, idx)
                else:
                    pbank.scatter(idx, cp["client"],
                                  broadcast=spec.client_aggregate)
                    params = dict(cp, client=None)
                    opt_state = dict(cop)
                    for mk, bk in obanks.items():
                        # moments scatter per row even under sfl
                        bk.scatter(idx, cop[mk]["client"])
                        opt_state[mk] = dict(cop[mk], client=None)
                    if nxt is not None:
                        pbank.prefetch(i + 1, nxt)
                        for bk in obanks.values():
                            bk.prefetch(i + 1, nxt)
            losses.append(float(m["loss"]))  # the sync point, in the span
        if rec.enabled:
            rec.event(
                "traffic", name="step_traffic", scheme=args.scheme, cut=cut,
                tau=tau, participants=K, uplink_codec=args.uplink_codec,
                downlink_codec=args.downlink_codec,
                measured=rec.ledger.snapshot_and_reset(),
                modeled=alg.comm_breakdown_per_round(
                    cfg, plans[cut], args.scheme, K, b, S, tau=tau,
                    bytes_per_elem=4, uplink_codec=args.uplink_codec,
                    downlink_codec=args.downlink_codec))
            rec.event("round", name="lm_step", loss=losses[-1], cut=cut,
                      participants=K)
        if (i + 1) % args.log_every == 0:
            obs.log(f"step {i+1}/{done+args.steps} loss {losses[-1]:.4f} "
                    f"({(time.time()-t0)/(i+1-done):.2f} s/step)")
    bank_stats = None
    if pbank is not None:
        # close() drains the pipeline and releases the worker; the banks
        # stay readable for the checkpoint below
        pbank.close()
        for bk in obanks.values():
            bk.close()
        bank_stats = pbank.stats()
        obs.log(f"bank[host]: peak device client-state "
                f"{bank_stats['device_bytes_peak'] / 1e6:.2f} MB of "
                f"{bank_stats['bank_bytes'] / 1e6:.2f} MB bank; prefetch "
                f"{bank_stats['prefetch_hits']} hits / "
                f"{bank_stats['prefetch_misses']} misses")
        if rec.enabled:
            rec.event("bank", name="bank", **bank_stats)
    if args.checkpoint:
        # params and optimizer state with the full-bank client trees, in
        # the reference's layout: the reference's file, under any bank
        pl = params if pbank is None else dict(params, client=pbank.tree)
        ol = dict(opt_state)
        for mk, bk in obanks.items():
            ol[mk] = dict(opt_state[mk], client=bk.tree)
        save_checkpoint(args.checkpoint, convert.lm_state_to_jax(
            {"params": pl, "opt": ol}, plans[cut]),
            {"arch": cfg.name, "algo": args.scheme, "cut": cut,
             "step": done + args.steps, "peft": args.peft,
             "lora_rank": args.lora_rank, "lora_alpha": args.lora_alpha,
             "final_loss": losses[-1], "bank_backend": args.bank})
        obs.log(f"checkpoint -> {args.checkpoint} (step {done + args.steps})")
    # per-step traffic for the K participants, at 4 bytes an element
    cb = alg.comm_bytes_per_round(
        cfg, plans[cut], args.scheme, K, b, S, tau=tau, bytes_per_elem=4,
        uplink_codec=args.uplink_codec, downlink_codec=args.downlink_codec)
    msg = (f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
           f"comm/round {cb['total_bytes']/1e6:.2f} MB "
           f"(up {cb['up_bytes']/1e6:.2f} / down {cb['down_bytes']/1e6:.2f}, "
           f"codecs {args.uplink_codec}/{args.downlink_codec})")
    if schedule is not None:
        msg += (f"; {n_migrations} cut migrations, "
                f"{mig_total_bits/8e6:.2f} MB migrated")
    obs.log(msg)
    out = {"first_loss": losses[0], "final_loss": losses[-1], "comm": cb,
           "migration_bits": mig_total_bits, "n_migrations": n_migrations,
           "losses": losses}
    if bank_stats is not None:
        out["bank"] = bank_stats
    return out


def _refuse_lm_async(args, schedule, engine):
    """The reference's refusals of ``--async`` in LM mode, in its order."""
    if schedule is not None:
        raise SystemExit("--async cannot run --dynamic-cut in LM mode: "
                         "in-flight payload shapes are cut-static")
    if args.resume:
        raise SystemExit("--async LM mode does not support --resume "
                         "(the event schedule is not checkpointed; "
                         "resume the barrier loop instead)")
    if args.bank != "device":
        raise SystemExit("--async LM mode needs --bank device")
    if engine.spec.client_aggregate:
        raise SystemExit("--async LM mode covers sfl_ga/psl (schemes "
                         "without round-end client aggregation)")
    if args.optimizer != "sgd":
        raise SystemExit("--async LM mode needs --optimizer sgd: "
                         "staleness-discounting per-client optimizer "
                         "moments is not defined")


class _LMAsyncExecutor:
    """``core.async_engine`` executor over the LM train loop.

    Dispatch runs ``algorithms.make_gen_step`` against the live models.
    The LM step's joint loss yields one server gradient per generation
    (per-client server deltas do not exist: the tau local steps compound
    the joint update), so server merges are generation-granular: a
    generation's delta folds in, staleness-discounted, at the merge where
    its last member lands. Client rows (sfl_ga and psl personalize the
    client sides) scatter back job by job as they complete; a client
    merged twice in one buffer keeps its later row.

    Traffic: a generation's compute taps the ledger as a step does, at
    the generation's size; each merge's ``async_traffic`` event holds the
    ledger's bits since the last merge against the sum of
    ``comm_breakdown_per_round`` over the generations dispatched since."""

    def __init__(self, state, gen_fn, sync_step, data_fn, engine,
                 modeled_fn, rec):
        self.state = state  # {"params", "opt_state"}, shared with the run
        self.gen_fn = gen_fn
        self.sync_step = sync_step
        self.data_fn = data_fn
        self.engine = engine
        self.modeled_fn = modeled_fn
        self.rec = rec
        self._left = {}      # generation -> members not yet merged
        self._dispatch = []  # generation sizes since the last merge

    def run_sync(self, d, idx, w):
        from repro_torch.core import algorithms as alg

        batch = self.data_fn(d, idx)
        cp = alg.gather_cohort(self.state["params"], idx)
        cp, self.state["opt_state"], m = self.sync_step(
            cp, self.state["opt_state"], dict(batch, rho=w))
        self.state["params"] = alg.scatter_cohort(
            self.state["params"], cp, idx)
        return {"loss": float(m["loss"])}

    def run_generation(self, d, idx, w):
        from repro_torch.core import algorithms as alg

        idx = np.asarray(idx, np.int64)
        batch = self.data_fn(d, idx)
        cp = alg.gather_cohort(self.state["params"], idx)
        out, self.state["opt_state"] = self.gen_fn(
            cp, self.state["opt_state"], dict(batch, rho=w))
        self._left[d] = int(idx.size)
        self._dispatch.append(int(idx.size))
        return {"idx": idx, "loss": out["loss"],
                "server_delta": out["server_delta"],
                "client": out["client"]}

    def apply_merge(self, items, taus, lam, merge_idx):
        import torch

        from repro_torch.core.bank import _last_occurrence
        from repro_torch.core.protocol import merge_async
        from repro_torch.tree import tree_map

        params = self.state["params"]
        idx = np.asarray([it["client"] for it in items], np.int64)
        uniq, last = _last_occurrence(idx)
        keep = range(len(items)) if last is None else last.tolist()
        rows = [tree_map(lambda x, p=items[k]["pos"]: x[p],
                         items[k]["payload"]["client"]) for k in keep]
        stacked = tree_map(lambda *xs: torch.stack(xs), *rows)
        didx = None

        def put(b, u):
            # in place: the bank is this run's own (a dispatch gathers
            # copies of its rows), and a full-width bank is too large to
            # hold twice
            nonlocal didx
            if didx is None:
                didx = torch.as_tensor(uniq, device=b.device)
            return b.index_copy_(0, didx, u.to(b.dtype))

        with torch.no_grad():
            client = tree_map(put, params["client"], stacked)
        del rows, stacked
        # generation-granular server merge: a generation's delta folds in
        # when its last member completes, at that merge's staleness
        done = []
        for it, t in zip(items, taus):
            g = it["gen"]
            self._left[g] -= 1
            if self._left[g] == 0:
                done.append((it["payload"]["server_delta"], float(t)))
                del self._left[g]
        server = params["server"]
        if done:
            deltas = tree_map(lambda *xs: torch.stack(xs),
                              *[dl for dl, _ in done])
            server = merge_async(server, deltas,
                                 np.ones((len(done),), np.float32),
                                 np.asarray([t for _, t in done],
                                            np.float32), lam)
        self.state["params"] = dict(params, client=client, server=server)
        loss = float(np.mean([float(it["payload"]["loss"])
                              for it in items]))
        out = {"loss": loss, "merged_gens": len(done)}
        if self.rec.enabled:
            self.rec.event(
                "traffic", name="async_traffic",
                scheme=self.engine.spec.name, participants=len(items),
                dispatched=list(self._dispatch),
                measured=self.rec.ledger.snapshot_and_reset(),
                modeled=self.modeled_fn(self._dispatch, len(items)))
        self._dispatch = []
        return out


def _run_lm_async(args, cfg, plan, tcfg, engine, params, opt_state,
                  sync_step, gen_fn, rec, n, K, b, S, tau, device) -> dict:
    """LM mode under ``--async``: the event-driven engine replaces the
    barrier step loop; ``--steps`` counts merges."""
    import torch

    from repro_torch import convert
    from repro_torch.core import algorithms as alg
    from repro_torch.core.async_engine import AsyncRoundEngine
    from repro_torch.core.cohort import AdmissionSampler, make_sampler
    from repro_torch.core.protocol import round_seed
    from repro_torch.data import synthetic_token_batches
    from repro_torch.obs.ledger import LEDGER_CATEGORIES
    from repro_torch.sysmodel.latency import completion_time_fn

    buffer = args.buffer or K
    base = make_sampler(args.sampler if args.cohort else "uniform", n, K,
                        seed=args.seed)
    admission = AdmissionSampler(base, buffer)
    completion = completion_time_fn(
        n, seed=args.seed, straggler_factor=args.straggler, batch=b)

    def data_fn(d, idx):
        g = len(idx)
        seed = int(round_seed(args.seed, d))
        # pure in d: a fresh stream a generation
        toks, labels = next(synthetic_token_batches(cfg.vocab_size,
                                                    g * b * tau, S,
                                                    seed=seed))
        shape = (g, b, S) if tau == 1 else (g, tau, b, S)
        return {"tokens": torch.from_numpy(toks.reshape(shape)).to(device),
                "labels": torch.from_numpy(labels.reshape(shape)).to(device),
                "seed": round_seed(args.seed, d)}

    def modeled_fn(dispatch_sizes, merged):
        acc = {c: 0 for c in LEDGER_CATEGORIES}
        for g in dispatch_sizes:
            bd = alg.comm_breakdown_per_round(
                cfg, plan, args.scheme, g, b, S, tau=tau, bytes_per_elem=4,
                uplink_codec=args.uplink_codec,
                downlink_codec=args.downlink_codec)
            for c in acc:
                acc[c] += bd[c]
        return acc

    state = {"params": params, "opt_state": opt_state}
    del params, opt_state
    ex = _LMAsyncExecutor(state, gen_fn, sync_step, data_fn, engine,
                          modeled_fn, rec)
    eng = AsyncRoundEngine(ex, admission, completion, buffer=buffer,
                           lam=args.staleness_lam)
    obs.log(f"async engine: buffer B={buffer} of K={K} in flight, "
            f"straggler x{args.straggler:g}, lam={args.staleness_lam:g}")
    losses, t0 = [], time.time()
    for i in range(args.steps):
        if rec.enabled:
            rec.set_round(i)
        with _maybe_profile(args, i), rec.span("step", cut=tcfg.cut_layer):
            m = eng.step()
        losses.append(float(m["loss"]))
        if rec.enabled:
            rec.event("round", name="lm_step", loss=losses[-1],
                      cut=tcfg.cut_layer, participants=m["merged"])
        if (i + 1) % args.log_every == 0:
            obs.log(f"merge {i+1}/{args.steps} loss {losses[-1]:.4f} "
                    f"clock {m['clock']:.1f}s stale "
                    f"{m['staleness_mean']:.1f} "
                    f"({(time.time()-t0)/(i+1):.2f} s/step)")
    eng.drain()
    st = eng.stats()
    if args.checkpoint:
        from repro_torch.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, convert.lm_state_to_jax(
            {"params": state["params"], "opt": state["opt_state"]}, plan),
            {"arch": cfg.name, "algo": args.scheme, "cut": tcfg.cut_layer,
             "step": args.steps, "peft": args.peft,
             "lora_rank": args.lora_rank, "lora_alpha": args.lora_alpha,
             "final_loss": losses[-1], "bank_backend": "device"})
        obs.log(f"checkpoint -> {args.checkpoint}")
    cb = alg.comm_bytes_per_round(
        cfg, plan, args.scheme, K, b, S, tau=tau, bytes_per_elem=4,
        uplink_codec=args.uplink_codec, downlink_codec=args.downlink_codec)
    obs.log(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
            f"virtual clock {st['clock']:.1f}s over {st['merges']} merges "
            f"({st['dispatches']} dispatches)")
    return {"first_loss": losses[0], "final_loss": losses[-1], "comm": cb,
            "async": st, "migration_bits": 0, "n_migrations": 0,
            "losses": losses}


def _lm_ddqn_schedule(spec: str, args, cfg, peft, n: int, b: int, S: int,
                      device):
    """LM ``--dynamic-cut ddqn[:EPISODES]``: train Algorithm 1 on the LM's
    φ(v)/X(v) MDP (with cut-migration pricing, adapter-priced under PEFT),
    the agent on ``device``, then freeze the greedy rollout as a cycled
    schedule. The policy is not queried live each step: a frozen sequence
    is deterministic in the step index, so ``--resume`` replays the same
    migrations."""
    from repro_torch.ccc.env import CuttingPointEnv, lm_env_config
    from repro_torch.ccc.strategy import run_algorithm1

    if cfg.num_layers < 2:
        raise SystemExit(f"--dynamic-cut ddqn needs >= 2 layers to have a "
                         f"cut to move ({cfg.name} has {cfg.num_layers}; "
                         f"try --layers 3)")
    episodes = int(spec.split(":")[1]) if ":" in spec else 30
    ecfg = lm_env_config(cfg, seq=S, peft=peft, n_clients=n, batch=b,
                         seed=args.seed, cohort=args.cohort)
    mig = "adapter-priced (lora)" if peft is not None else "full-φ-priced"
    obs.log(f"training Algorithm 1 policy on the LM MDP ({episodes} "
            f"episodes, {len(ecfg.phis)} cuts, migration {mig})...")
    res = run_algorithm1(CuttingPointEnv(ecfg), episodes=episodes,
                         device=device)
    sched = res.cut_schedule()  # the frozen greedy rollout, cycled
    obs.log(f"ddqn schedule: {res.greedy_policy}")
    return sched


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
    """Parse the reference's flags (plus ``--device``) and run the CNN or
    the LM mode; returns its result dict."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--scheme", default="sfl_ga",
                   choices=["sfl_ga", "sfl", "psl", "fl"])
    p.add_argument("--preset", default="smoke", choices=["smoke", "100m", "full"],
                   help="LM mode: the reduced config, ~100M params, or the "
                        "published widths")
    p.add_argument("--cut", type=int, default=1)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=128,
                   help="LM mode: tokens a sequence")
    p.add_argument("--steps", type=int, default=50,
                   help="LM mode: train steps (merges with --async)")
    p.add_argument("--rounds", type=int, default=50)
    p.add_argument("--tau", type=int, default=1,
                   help="local steps per round (both modes)")
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
                        "first; CNN mode queries the policy on the live "
                        "channel, LM mode freezes the greedy rollout)")
    p.add_argument("--peft", default="none", choices=["none", "lora"],
                   help="LM mode: federate LoRA adapters over a frozen "
                        "base instead of full client layers")
    p.add_argument("--lora-rank", type=int, default=8,
                   help="LoRA rank r per targeted projection (--peft lora)")
    p.add_argument("--lora-alpha", type=float, default=16.0,
                   help="LoRA scale numerator: adapters apply at alpha/r")
    p.add_argument("--lora-targets", default="attn,mlp,ssm",
                   help="projection families that get adapters (--peft "
                        "lora): a comma list of attn, mlp, ssm and router "
                        "(the MoE router); the default is PeftSpec's")
    p.add_argument("--layers", type=int, default=None,
                   help="LM mode: override num_layers after the preset")
    p.add_argument("--resume", default=None,
                   help="resume a checkpoint: CNN mode restores the "
                        "simulator (params, round counter, cut) or, with "
                        "--async, the engine's schedule; LM mode restores "
                        "params and optimizer state and fast-forwards the "
                        "data stream (bit-exact continuation)")
    p.add_argument("--bank", default="device",
                   choices=["device", "host", "sharded"],
                   help="client-bank residency (core.bank): device (stacked "
                        "pytree, the default), host (bank in host memory, "
                        "O(K) device bytes + prefetch; LM mode needs "
                        "--cohort and a static cut), sharded (bank over a "
                        "device mesh; CNN mode)")
    p.add_argument("--uplink-codec", default="fp32",
                   help="cut-layer uplink codec: fp32|bf16|fp8|int8|int4|topkP")
    p.add_argument("--downlink-codec", default="fp32",
                   help="cut-layer downlink codec (gradient broadcast/unicast)")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "momentum", "adamw"],
                   help="LM mode: the optimizer (repro_torch.optim)")
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--n-samples", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--metrics-dir", default=None,
                   help="enable the obs recorder: JSONL events + manifest "
                        "into this directory (render with "
                        "python -m repro_torch.obs.report DIR)")
    p.add_argument("--profile", type=int, default=None, metavar="N",
                   help="capture a torch.profiler trace of round/step N "
                        "(written under --metrics-dir, or ./profile)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the stderr progress log (events still "
                        "recorded when --metrics-dir is set)")
    args = p.parse_args(argv)
    # the recorder before any simulator is built: instrumented objects
    # keep the recorder active when they were made
    rec = None
    if args.metrics_dir:
        rec = obs.Recorder(args.metrics_dir, quiet=args.quiet,
                           append=bool(args.resume), config=vars(args))
        obs.set_recorder(rec)
    obs.set_quiet(args.quiet)
    try:
        if args.arch.startswith("paper-cnn"):
            return train_cnn(args)
        return train_lm(args)
    finally:
        if rec is not None:
            rec.close()
            obs.set_recorder(None)
        obs.set_quiet(False)


if __name__ == "__main__":
    main()
