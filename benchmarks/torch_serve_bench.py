"""Serving benchmark on the port: continuous batching against the
fixed-batch baseline (port of ``benchmarks/serve_bench.py``, DESIGN.md
§18).

One ``repro_torch.core.serve_engine.ServeEngine`` per scheduling policy,
with the same model, slots, paged cache, codec and request stream: the
baseline is the engine with ``backfill=False`` (the slots fill together
and the batch runs until it drains), so the comparison isolates the
scheduler. The stream is heavy-tailed (generation lengths cycle 48, 3, 3,
2): under the drain barrier every batch runs at the pace of its 48-token
straggler while three slots idle. The gate is >= 2x the aggregate decode
tok/s at equal slots with more queued users than slots.

It sweeps concurrent users against p50/p99 per-token latency (measured
step wall clock plus the modeled per-user comm latency, ``SLO_MS``
attainment) and reconciles every step's decode/prefill traffic event
against ``sysmodel.traffic`` exactly over the whole run. The schedule is
set by integers (no EOS, fixed lengths), so the users, tokens and steps
of each row are the reference's on any device.

``preset="smoke"`` (the default) serves the reference's reduced
granite-8b; ``preset="full"`` the published widths and depth (36
layers, f32, about 33 GB on the card). On the card every decode step
launches the paged-attention kernel (B6) once a layer and the int8
boundary B2/B3; ``--device cpu`` runs their plain versions.

    PYTHONPATH=src:. python benchmarks/torch_serve_bench.py [--preset full]
        [--device cpu]
"""
from __future__ import annotations

import argparse

SLOTS = 4
PROMPT_LEN = 16
GEN_PATTERN = (48, 3, 3, 2)   # heavy tail: one straggler per 4 users
MAX_LEN = PROMPT_LEN + max(GEN_PATTERN)
PAGE_SIZE = 16
CODEC = "int8"
SLO_MS = 200.0
USER_SWEEP = (4, 8, 16)
WARMUP_USERS = 4


def _measure(engine, reqs):
    """Run ``reqs`` to completion on ``engine``; stats over THIS segment
    only (earlier warm-up and segments excluded)."""
    from repro_torch import obs

    l0 = len(engine.step_latencies_s)
    c0 = len(engine.completions)
    for r in reqs:
        engine.submit(r)
    engine.run()
    comps = engine.completions[c0:]
    wall = sum(engine.step_latencies_s[l0:])
    tokens = sum(c.num_tokens for c in comps)
    lat = [t for c in comps for t in c.token_latencies_s]
    slo_tokens = sum(len(c.token_latencies_s) for c in comps)
    hits = sum(c.slo_hits for c in comps)
    return {
        "users": len(comps),
        "tokens": tokens,
        "steps": len(engine.step_latencies_s) - l0,
        "wall_s": wall,
        "tok_per_s": tokens / max(wall, 1e-9),
        "p50_s": obs.percentile(lat, 0.50),
        "p99_s": obs.percentile(lat, 0.99),
        "slo_attainment": hits / max(slo_tokens, 1),
    }


def run(arch: str = "granite-8b", preset: str = "smoke", device="cuda",
        params=None, plan=None):
    """The sweep and the baseline on ``arch`` at cut 1, random f32
    weights drawn on ``device`` from seed 0; ``params``/``plan`` (on
    ``device``, cut 1) replace the draw, so a caller that holds the
    weights needs no second one. Returns ``rows``, ``speedup``,
    ``traffic_events``, ``traffic_mismatches``, ``decode_steps`` (every
    decode step of both engines, warm-ups included) and ``finite`` (both
    engines' last logits finite)."""
    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.serve_engine import ServeEngine, make_requests
    from repro_torch.models import lm
    from repro_torch.obs.ledger import reconcile_events

    if params is None:
        cfg = get_config(arch)
        if preset == "smoke":
            cfg = reduced_config(cfg)
        plan = lm.build_plan(cfg, 1)
        params = lm.init_lm(0, plan, torch.float32, device)
    vocab = plan.cfg.vocab_size

    def build(backfill: bool) -> ServeEngine:
        return ServeEngine(params, plan, slots=SLOTS, max_len=MAX_LEN,
                           page_size=PAGE_SIZE, codec=CODEC,
                           backfill=backfill, slo_ms=SLO_MS, seed=0,
                           device=device)

    def warm(engine) -> int:
        # the first prefill at PROMPT_LEN and the first decode steps
        # (kernel loads, allocator growth) stay out of the timed segments
        return _measure(engine, make_requests(
            WARMUP_USERS, PROMPT_LEN, 2, vocab_size=vocab,
            seed=99))["steps"]

    rec = obs.Recorder(None)
    rows = []
    with obs.use_recorder(rec):
        cont = build(backfill=True)
        steps = warm(cont)
        for users in USER_SWEEP:
            reqs = make_requests(users, PROMPT_LEN, GEN_PATTERN,
                                 vocab_size=vocab, seed=1)
            rows.append({"scheduler": "continuous", "slots": SLOTS,
                         **_measure(cont, reqs)})
        seq = build(backfill=False)
        steps += warm(seq)
        users = max(USER_SWEEP)
        reqs = make_requests(users, PROMPT_LEN, GEN_PATTERN,
                             vocab_size=vocab, seed=1)
        rows.append({"scheduler": "sequential", "slots": SLOTS,
                     **_measure(seq, reqs)})

    _, bad = reconcile_events(rec.events)
    n_traffic = sum(1 for e in rec.events if e.get("kind") == "traffic")
    cont_row = next(r for r in rows
                    if r["scheduler"] == "continuous"
                    and r["users"] == max(USER_SWEEP))
    seq_row = next(r for r in rows if r["scheduler"] == "sequential")
    return {
        "rows": rows,
        "speedup": cont_row["tok_per_s"] / max(seq_row["tok_per_s"], 1e-9),
        "traffic_events": n_traffic,
        "traffic_mismatches": bad,
        "decode_steps": steps + sum(r["steps"] for r in rows),
        "finite": all(bool(torch.isfinite(e.last_logits).all())
                      for e in (cont, seq)),
    }


def main(argv=None):
    from benchmarks.torch_common import device_arg, device_name

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"],
                    help="the reduced config or the published widths")
    device_arg(ap)
    args = ap.parse_args(argv)
    out = run(args.arch, args.preset, args.device)
    print(f"# {args.arch} ({args.preset}) [{device_name(args.device)}]")
    print("scheduler,users,slots,tokens,steps,tok_per_s,p50_ms,p99_ms,slo")
    for r in out["rows"]:
        print(f"{r['scheduler']},{r['users']},{r['slots']},{r['tokens']},"
              f"{r['steps']},{r['tok_per_s']:.1f},{r['p50_s'] * 1e3:.1f},"
              f"{r['p99_s'] * 1e3:.1f},{r['slo_attainment']:.3f}")
    print(f"# continuous vs sequential speedup: {out['speedup']:.2f}x  "
          f"traffic events {out['traffic_events']} "
          f"mismatches {out['traffic_mismatches']}")
    return out


if __name__ == "__main__":
    main()
