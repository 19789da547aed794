"""Serving launcher: continuous-batching split decode (DESIGN.md §18).

  python -m repro_torch.launch.serve --arch granite-8b --preset smoke \
      --users 8 --slots 4 --prompt-len 16 --gen 24 --codec int8 \
      --page-size 16 --slo-ms 200 --cut 1

Port of ``repro.launch.serve``. ``U`` users queue for ``B`` decode slots
of :class:`repro_torch.core.serve_engine.ServeEngine`: prefill-on-admit,
per-step backfill, per-slot retirement over the paged KV cache, with
boundary activations crossing the priced codec wire. With
``--metrics-dir`` it writes the reference's event schema: one
``serve_token`` event per decode step, per-step ``traffic`` events
reconciling the measured ledger against ``sysmodel.traffic``, and a
``serve_summary`` event (p50/p99/mean latency, tok/s, SLO attainment).

``--arch`` takes every decoder of the zoo: granite-8b, granite-20b,
command-r-35b, qwen2-vl-2b (M-RoPE), qwen3-moe-30b-a3b and kimi-k2-1t-a32b
(MoE), jamba-v0.1-52b (Mamba-2 + attention + MoE) and mamba2-130m, at
the reference's presets (``smoke``: the reduced config; ``full``: the
published widths); ``--layers`` then cuts the depth, which the
reference's launcher does not offer. Paged serving is full-causal only,
so a sliding-window model (starcoder2-3b) is refused, as in the
reference; it decodes through ``lm.prefill``/``lm.decode_step``.

It runs on the card (``--device cuda``, the default) and exits with an
error when there is none; ``--device cpu`` runs the plain PyTorch path on
the CPU. Weights are random, drawn on the device from ``--seed``, or
restored with ``--checkpoint`` from a file of the port's ``init_lm`` tree
(``repro_torch.checkpoint``, the reference's format) before the engine
is built; the file's meta is logged.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import obs, require_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--preset", default="smoke", choices=["smoke", "full"],
                   help="the reduced config or the published widths")
    p.add_argument("--layers", type=int, default=None,
                   help="override num_layers after the preset")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--users", type=int, default=8,
                   help="queued requests (U > slots exercises backfill)")
    p.add_argument("--slots", type=int, default=4,
                   help="decode batch width B")
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=32,
                   help="max new tokens per request")
    p.add_argument("--codec", default="fp32",
                   help="boundary activation codec (repro_torch.compress)")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--slo-ms", type=float, default=None,
                   help="per-token latency SLO (compute + modeled comm)")
    p.add_argument("--sample", type=float, default=0.0, metavar="TEMPERATURE",
                   help="0 = greedy (argmax); >0 = temperature sampling")
    p.add_argument("--cut", type=int, default=1,
                   help="split layer: client = embed + layers[:cut]")
    p.add_argument("--no-backfill", action="store_true",
                   help="fixed-batch sequential baseline (drain barrier)")
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="load the model's params from this checkpoint")
    p.add_argument("--metrics-dir", default=None,
                   help="record per-token latency events (repro_torch.obs)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    device = require_device(args.device)

    rec = None
    if args.metrics_dir:
        rec = obs.Recorder(args.metrics_dir, quiet=args.quiet,
                           config=vars(args))
        obs.set_recorder(rec)
    obs.set_quiet(args.quiet)
    try:
        return _serve(args, device)
    finally:
        if rec is not None:
            rec.close()
            obs.set_recorder(None)
        obs.set_quiet(False)


def _serve(args, device):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.serve_engine import ServeEngine, make_requests
    from repro_torch.models import lm

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = reduced_config(cfg)
    if args.layers:
        cfg = cfg.with_overrides(num_layers=args.layers)
    plan = lm.build_plan(cfg, args.cut)
    params = lm.init_lm(args.seed, plan, torch.float32, device)
    if args.checkpoint:
        from repro_torch.checkpoint import load_checkpoint
        from repro_torch.tree import tree_map

        params, meta = load_checkpoint(args.checkpoint, params)
        params = tree_map(lambda x: x.to(device), params)
        obs.log(f"restored checkpoint meta={meta}")

    engine = ServeEngine(
        params, plan, slots=args.slots,
        max_len=args.prompt_len + args.gen, page_size=args.page_size,
        codec=args.codec, temperature=args.sample, eos_id=args.eos_id,
        backfill=not args.no_backfill, slo_ms=args.slo_ms, seed=args.seed,
        device=device)
    for req in make_requests(args.users, args.prompt_len, args.gen,
                             vocab_size=cfg.vocab_size, seed=args.seed):
        engine.submit(req)
    obs.log(f"serving {args.users} users over {args.slots} slots on "
            f"{device} (cut {args.cut}, codec {args.codec}, "
            f"page {args.page_size}, backfill {not args.no_backfill})")
    completions = engine.run()
    s = engine.emit_summary()
    obs.log(f"served {s['users']} users / {s['tokens']} tokens in "
            f"{s['steps']} steps ({s['wall_s']:.2f}s, "
            f"{s['tok_per_s']:.1f} tok/s)  "
            f"p50 {s['p50_s'] * 1e3:.1f}ms p99 {s['p99_s'] * 1e3:.1f}ms"
            + (f"  SLO({args.slo_ms:.0f}ms) {s['slo_attainment']:.1%}"
               if args.slo_ms is not None else ""))
    obs.log("sample generations (token ids):")
    for c in completions[: min(4, len(completions))]:
        obs.log(f"   uid {c.uid}: {np.asarray(c.tokens)[:16].tolist()} ...")
    return engine


if __name__ == "__main__":
    main()
