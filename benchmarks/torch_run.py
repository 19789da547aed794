"""Benchmark driver on the port (port of ``benchmarks/run.py``): one
function per paper figure or table, each calling the port's script.

Prints ``name,us_per_call,derived`` CSV. Each "call" is the whole
benchmark routine; ``derived`` carries the headline numbers the paper's
figure reports, in the reference's format.

A machine-readable ``BENCH_*.json`` is always written (default
``BENCH_torch_local.json``, so a port run never overwrites the
reference's ``BENCH_local.json``; ``--json OUT`` to change it, ``--json
-`` to disable). It carries a manifest (schema, timestamp, git SHA,
platform, python, torch and CUDA versions, the device, and on the card
the ``nvidia-smi`` name and power-limit line) and each entry's wall
clock and status. ``--only a,b`` keeps the entries whose names contain
one of the substrings.

Every entry runs on the card unless ``--device cpu`` is passed (the
roofline table reads the dry run's rows and runs nothing). Fast mode by
default; REPRO_BENCH_FULL=1 for the paper-scale rounds, episodes and
datasets. An entry that raises is recorded as ``status: error``, as the
reference records it; the driver then exits non-zero, where the
reference exits 0.

    PYTHONPATH=src:. python benchmarks/torch_run.py [--only fig8,serve]
        [--device cpu] [--json OUT]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback


def _bench(name, fn, results):
    t0 = time.time()
    try:
        derived = fn()
        wall = time.time() - t0
        us = wall * 1e6
        print(f"{name},{us:.0f},{derived}", flush=True)
        results[name] = {"us_per_call": round(us), "wall_s": round(wall, 3),
                         "derived": derived, "status": "ok"}
    except Exception as e:  # the driver's boundary: record, go on
        traceback.print_exc()
        print(f"{name},-1,ERROR:{type(e).__name__}", flush=True)
        results[name] = {"us_per_call": -1,
                         "wall_s": round(time.time() - t0, 3),
                         "derived": f"ERROR:{type(e).__name__}",
                         "status": "error"}


def bench_fig3(device):
    from benchmarks import torch_fig3_convergence_vs_cut as f

    rows = f.run(device=device)
    accs = {r["scheme"]: r["final_acc"] for r in rows}
    drifts = {r["scheme"]: r["drift"] for r in rows}
    return ("acc_v1=%.3f acc_v4=%.3f sfl_ref=%.3f drift_v1=%.1e drift_v4=%.1e"
            % (accs["sfl_ga_v1"], accs["sfl_ga_v4"], accs["sfl_ref"],
               drifts["sfl_ga_v1"], drifts["sfl_ga_v4"]))


def bench_fig4(device):
    from benchmarks import torch_fig4_comm_overhead as f

    rows = {r["scheme"]: r for r in f.run(device=device)}
    return ("MB/round sfl_ga=%.3f psl=%.3f sfl=%.3f fl=%.3f"
            % tuple(rows[s]["mb_per_round"]
                    for s in ("sfl_ga", "psl", "sfl", "fl")))


def bench_fig5(device):
    from benchmarks import torch_fig5_latency_schemes as f

    rows = {r["scheme"]: r for r in f.run(device=device)}
    return ("s/round sfl_ga=%.3f sfl=%.3f psl=%.3f fl=%.3f"
            % tuple(rows[s]["latency_per_round_s"]
                    for s in ("sfl_ga", "sfl", "psl", "fl")))


def bench_fig6(device):
    from benchmarks import torch_fig6_resource_strategies as f

    rows = {r["strategy"]: r for r in f.run(device=device)}
    a1 = next(v for k, v in rows.items() if k.startswith("algorithm1"))
    fx = rows["fixed_cut_v2_fixed_alloc"]
    rd = rows["random_cut_opt_alloc"]
    return ("latency alg1=%.2f fixed_alloc_v2=%.2f random=%.2f"
            % (a1["latency"], fx["latency"], rd["latency"]))


def bench_fig7(device):
    from benchmarks import torch_fig7_ddqn_convergence as f

    rows = f.run(device=device)
    return " ".join("eps=%g:%.1f->%.1f" % (r["epsilon"], r["first_rewards"],
                                           r["last_rewards"]) for r in rows)


def bench_fig8(device):
    from benchmarks import torch_fig8_latency_vs_bandwidth as f

    rows = f.run(device=device)
    lo, hi = rows[0], rows[-1]
    return ("sfl_ga@5MHz=%.3fs sfl_ga@40MHz=%.3fs fl@40MHz=%.3fs"
            % (lo["sfl_ga"], hi["sfl_ga"], hi["fl"]))


def bench_roofline(device):
    from benchmarks import torch_roofline as f

    rows = f.load()
    ok = [r for r in rows if r.get("status") == "ok"]
    sk = [r for r in rows if r.get("status") == "skipped"]
    er = [r for r in rows if r.get("status") == "error"]
    if not rows:
        return "no dryrun results (run repro_torch.launch.dryrun --all)"
    bn = {}
    for r in ok:
        bn[r["bottleneck"]] = bn.get(r["bottleneck"], 0) + 1
    return f"cells ok={len(ok)} skipped={len(sk)} err={len(er)} bottlenecks={bn}"


def bench_fig9(device):
    from benchmarks import torch_fig9_accuracy_vs_bits as f

    rows = {r["codec"]: r for r in f.run(device=device)}
    return ("acc fp32=%.3f int8=%.3f int4=%.3f int8_ratio=%.2fx"
            % (rows["fp32"]["final_acc"], rows["int8"]["final_acc"],
               rows["int4"]["final_acc"], rows["int8"]["ratio_vs_fp32"]))


def bench_fig10(device):
    from benchmarks import torch_fig10_closed_loop as f

    rows = {r["strategy"]: r for r in f.run(device=device)}
    dyn = rows["dynamic_ddqn"]
    fx = next(v for k, v in rows.items() if k.startswith("fixed_alloc"))
    return ("acc@budget dyn=%.3f fixed_alloc=%.3f dyn_wall=%.1fs "
            "fixed_alloc_wall=%.1fs migrations=%d migrated_mb=%.1f"
            % (dyn["acc_at_budget"], fx["acc_at_budget"],
               dyn["wall_clock_s"], fx["wall_clock_s"],
               dyn["n_migrations"], dyn["migration_mb"]))


def bench_fig11(device):
    from benchmarks import torch_fig11_scale as f

    rows = f.run(device=device)
    worst = max(r["round_ms_vs_baseline"] for r in rows[1:])
    flat = all(r["server_bytes_flat"] for r in rows)
    big = rows[-1]
    return ("server_one_copy=%s worst_ratio=%.2fx N=%d round_ms=%.0f "
            "server_kb=%d" % (flat, worst, big["n_clients"],
                              big["round_ms"], big["server_bytes"] // 1024))


def bench_fig11_bank_host(device):
    """Host-resident bank scale gate (DESIGN.md §15): N=100k, K=16 --
    peak device client-state bytes must stay within 2x the K-slice."""
    from benchmarks import torch_fig11_scale as f

    r = f.run_smoke(device=device)
    if not r["ok"]:
        raise AssertionError(
            f"peak device client-state {r['device_bytes_peak']} B over the "
            f"{r['budget_bytes']} B budget (2x K-slice)")
    return ("N=%d K=%d peak_device_b=%d budget_b=%d bank_mb=%.0f "
            "prefetch_hit=%d miss=%d round_ms=%.0f"
            % (r["n_clients"], r["cohort"], r["device_bytes_peak"],
               r["budget_bytes"], r["bank_bytes"] / 1e6,
               r["prefetch_hits"], r["prefetch_misses"], r["round_ms"]))


def bench_fig12(device):
    """Buffered-async against the barrier (DESIGN.md §16): accuracy at
    the matched virtual-clock budget, exact traffic reconciliation on
    both loops."""
    from benchmarks import torch_fig12_async as f

    rows = {r["scheme"]: r for r in f.run(device=device)}
    if any(not r["traffic_ok"] for r in rows.values()):
        raise AssertionError("async/sync traffic reconciliation mismatch")
    ga = rows["sfl_ga"]
    return ("acc@budget async=%.3f sync=%.3f merges=%d sync_clock=%.1fs "
            "staleness=%.2f traffic_exact=True"
            % (ga["async_acc_at_budget"], ga["sync_acc_at_budget"],
               ga["async_merges"], ga["sync_clock_s"],
               ga["mean_staleness"]))


def bench_fig13(device):
    """PEFT federation (DESIGN.md §17): full granite-8b wire and
    migration ratios against the LoRA rank (rank 8 must clear the 20x
    wire and 50x migration bars) and a live reduced LoRA run reconciled
    exactly."""
    from benchmarks import torch_fig13_peft as f

    out = f.run(device=device)
    live = out["live"]
    return ("r8_wire=%.0fx r8_migration=%.0fx live_events=%d "
            "live_migrations=%d reconcile_exact=True"
            % (out["wire_ratio_r8"], out["migration_ratio_r8"],
               live["events"], live["migrations"]))


def bench_kernels(device):
    from benchmarks import torch_kernels_bench as f

    rows = f.run(device=device)
    return " ".join(f"{n}={us:.0f}us" for n, us in rows)


def bench_serve(device):
    """Continuous-batching split decode (DESIGN.md §18): aggregate tok/s
    against the fixed-batch sequential baseline at equal slots with a
    heavy-tailed queue -- must clear 2x -- plus p50/p99 per-token latency
    and exact decode/prefill traffic reconciliation."""
    from benchmarks import torch_serve_bench as f

    out = f.run(device=device)
    if out["traffic_mismatches"]:
        raise AssertionError(
            f"serve traffic ledger mismatches: {out['traffic_mismatches']}")
    if out["speedup"] < 2.0:
        raise AssertionError(
            f"continuous batching speedup {out['speedup']:.2f}x < 2x gate")
    cont = next(r for r in out["rows"] if r["scheduler"] == "continuous"
                and r["users"] == max(r2["users"] for r2 in out["rows"]))
    return ("speedup=%.2fx cont_tok_s=%.0f p50_ms=%.1f p99_ms=%.1f "
            "slo=%.3f traffic_events=%d reconcile_exact=True"
            % (out["speedup"], cont["tok_per_s"], cont["p50_s"] * 1e3,
               cont["p99_s"] * 1e3, cont["slo_attainment"],
               out["traffic_events"]))


BENCHES = [
    ("kernels_micro", bench_kernels),
    ("fig8_latency_vs_bandwidth", bench_fig8),
    ("roofline_table", bench_roofline),
    ("fig6_resource_strategies", bench_fig6),
    ("fig7_ddqn_convergence", bench_fig7),
    ("fig3_convergence_vs_cut", bench_fig3),
    ("fig4_comm_overhead", bench_fig4),
    ("fig5_latency_schemes", bench_fig5),
    ("fig9_accuracy_vs_bits", bench_fig9),
    ("fig10_closed_loop", bench_fig10),
    ("fig11_scale", bench_fig11),
    ("fig11_scale_bank_host", bench_fig11_bank_host),
    ("fig12_async", bench_fig12),
    ("fig13_peft", bench_fig13),
    ("serve_continuous_batching", bench_serve),
]


def _manifest(device) -> dict:
    """Provenance header with the fields of ``repro_torch.obs`` manifests,
    so a BENCH_*.json and a metrics dir from the same commit line up."""
    import platform

    import torch

    from repro_torch.obs import recorder as _rec

    man = {"schema": "repro.bench.v1",
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "git_sha": _rec.git_sha(),
           "platform": platform.platform(),
           "python": sys.version.split()[0],
           "torch_version": torch.__version__,
           "cuda": torch.version.cuda,
           "device": str(device)}
    if torch.device(device).type == "cuda":
        import chip_smoke

        man["nvidia_smi"] = chip_smoke.nvidia_smi_line()
    return man


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="BENCH_torch_local.json", metavar="OUT",
                    help="JSON artifact path (default BENCH_torch_local."
                         "json; '-' disables)")
    ap.add_argument("--only", default=None,
                    help="comma-separated substrings: run matching benches "
                         "only")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    from repro_torch import require_device

    require_device(args.device)
    wanted = [w for w in (args.only or "").split(",") if w]
    results = {}
    print("name,us_per_call,derived", flush=True)
    for name, fn in BENCHES:
        if wanted and not any(w in name for w in wanted):
            continue
        _bench(name, lambda fn=fn: fn(args.device), results)
    if args.json and args.json != "-":
        with open(args.json, "w") as f:
            json.dump({"manifest": _manifest(args.device),
                       "results": results}, f, indent=2, sort_keys=True)
        print(f"# json -> {args.json}")
    failed = sorted(k for k, v in results.items() if v["status"] != "ok")
    if failed:
        print(f"# failed: {', '.join(failed)}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
