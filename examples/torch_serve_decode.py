"""Serving example on the port: the continuous-batching split decode
engine for two architecture families (port of ``examples/serve_decode.py``)
-- a dense GQA model (the paged KV cache and the paged-attention kernel,
B6) and an attention-free Mamba-2 (whose decode state is O(1) in context
length).

The GQA model goes through the port's serve launcher
(``repro_torch.launch.serve``); the Mamba-2 model drives
:class:`repro_torch.core.serve_engine.ServeEngine` directly -- launcher
and example share one engine. Each arch writes the per-token latency
schema (``serve_token`` / ``serve_summary`` events and per-step
``traffic`` reconciliation, repro.obs.v1) into its own metrics directory
when ``--metrics-dir`` is given; render one with ``python -m
repro_torch.obs.report DIR`` (the reference's ``repro.obs.report`` reads
it too).

Both run on the card (``--device cuda``, the default) and fail without
one; ``--device cpu`` runs the kernels' plain versions on the CPU.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py
          [--metrics-dir DIR] [--device cpu]
"""
import argparse
import os

from repro_torch import obs
from repro_torch.launch import serve as serve_mod


def _engine_api_demo(arch: str, metrics_dir=None, quiet: bool = False,
                     device="cuda"):
    """Drive the ServeEngine directly (what the launcher wraps)."""
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.serve_engine import ServeEngine, make_requests
    from repro_torch.models import lm

    rec = None
    if metrics_dir:
        rec = obs.Recorder(metrics_dir, quiet=quiet, config={"arch": arch})
        obs.set_recorder(rec)
    obs.set_quiet(quiet)
    try:
        cfg = reduced_config(get_config(arch))
        plan = lm.build_plan(cfg, 1)
        params = lm.init_lm(0, plan, torch.float32, device)
        engine = ServeEngine(params, plan, slots=2, max_len=48,
                             page_size=16, codec="fp32", slo_ms=500.0,
                             device=device)
        for req in make_requests(4, 32, 12, vocab_size=cfg.vocab_size):
            engine.submit(req)
        engine.run()
        s = engine.emit_summary()
        print(f"  {arch}: {s['users']} users, {s['tokens']} tokens, "
              f"{s['tok_per_s']:.1f} tok/s, p50 {s['p50_s'] * 1e3:.1f}ms")
        return engine
    finally:
        if rec is not None:
            rec.close()
            obs.set_recorder(None)
        obs.set_quiet(False)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--metrics-dir", default=None,
                   help="per-arch metrics land in DIR/<arch>/")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    print("\n=== granite-8b (reduced config, via the serve launcher) ===")
    extra = ["--device", args.device]
    if args.metrics_dir:
        extra += ["--metrics-dir", os.path.join(args.metrics_dir, "granite-8b")]
    if args.quiet:
        extra += ["--quiet"]
    granite = serve_mod.main(["--arch", "granite-8b", "--preset", "smoke",
                              "--users", "4", "--slots", "2",
                              "--prompt-len", "32", "--gen", "12",
                              "--codec", "int8"] + extra)

    print("\n=== mamba2-130m (reduced config, via the engine API) ===")
    mamba = _engine_api_demo(
        "mamba2-130m",
        metrics_dir=(os.path.join(args.metrics_dir, "mamba2-130m")
                     if args.metrics_dir else None),
        quiet=args.quiet, device=args.device)
    return {"granite-8b": granite, "mamba2-130m": mamba}


if __name__ == "__main__":
    main()
