#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Runs from the root of a checkout and imports the port from ``src/``
(``repro_torch``; nothing of JAX or of the JAX package). Phases, in
order; any failure raises, exits non-zero and prints no result line:

1. device -- the card's name, and its name and power limit from
   ``nvidia-smi``;
2. build -- every CUDA kernel of the port from the sources in the
   checkout, one ``nvcc`` per source, all started together;
3. kernels -- each kernel's wrapper on the card against its plain PyTorch
   version on the same inputs: the paged-decode attention kernel at
   granite-8b decode shapes (slots 8, 32 query / 8 kv heads, head_dim 128
   and 64, page 16, ragged lengths with a dead slot, one token, a page
   boundary and several pages) and at the shapes of the serve run below;
   times of the kernel, the plain version and one PyTorch call as a
   yardstick;
4. serve -- the port's main path at full width: granite-8b, 36 layers,
   f32 weights drawn on the card from a seed (about 33 GB), cut 1,
   8 users over 4 slots, prompt 16, gen 16, int8 boundary codec, page
   16. Every request completes, the kernel's launches equal 36 x the
   decode steps, every step's traffic event reconciles exactly, the
   logits are finite. Then a few more steps under ``torch.profiler``
   show the device's busy share and the kernels that take the time;
5. card against CPU -- the same path at full width and 2 layers, served
   on the card (kernel) and on the CPU (plain version): identical greedy
   token streams and first-step logits within the stated tolerance.

The second-to-last lines are the kernels' JSON record and the
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 rate and
# float32 outside the tensor cores -- the kernel computes in plain f32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# kernel against its plain version, both f32 on the card: they sum the D
# products and the positions in different orders, so they differ by a few
# f32 ulps of outputs of order one
KERNEL_ATOL = KERNEL_RTOL = 1e-5
# card against CPU at full width: two f32 GEMM libraries reduce over
# d_model = 4096 and d_ff = 14336 in different orders; logits are of order
# one, so 1e-3 holds that rounding with margin and still catches any
# wrong kernel (whose errors are of order one)
LOGITS_ATOL = LOGITS_RTOL = 1e-3

SERVE = dict(users=8, slots=4, prompt_len=16, gen=16, codec="int8", page=16)


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cold_ms(torch, fn, flush, iters=50, warmup=5):
    """Mean device time of ``fn`` with the L2 cache flushed before each
    run, as the decode step finds it (the weights it streams between two
    attention layers evict it). CUDA events bracket ``fn`` alone."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def paged_inputs(torch, seed, slots, hkv, g, d, page, lengths, maxp):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P = slots * maxp

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, pk, pv = randn(slots, hkv, g, d), randn(hkv, P, page, d), \
        randn(hkv, P, page, d)
    table = torch.randperm(P, generator=gen, device="cuda").reshape(
        slots, maxp).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, pk, pv, table, lens


def paged_bound_ms(q, pk, table, lens):
    """Least time on the card for these inputs: each byte it must move
    once (q, the live K/V rows, the table rows it reads, lengths, out)
    against the HBM rate, and its flops (4*G*D per live position per kv
    head) against the f32 rate; the larger of the two."""
    B, Hkv, G, D = q.shape
    live = int(lens.sum())
    kv_bytes = live * Hkv * D * 4 * 2
    byts = 2 * q.numel() * 4 + kv_bytes + table.numel() * 4 + B * 4
    flops = live * Hkv * 4 * G * D
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    cases = [
        ("granite-8b decode, D=128", 8, 8, 4, 128, 16,
         [0, 1, 16, 17, 40, 100, 127, 64]),
        ("granite-8b decode, D=64", 8, 8, 4, 64, 16,
         [0, 1, 16, 17, 40, 100, 127, 64]),
        ("serve-run shapes", SERVE["slots"], 8, 4, 128, SERVE["page"],
         [17, 21, 26, 31]),
    ]
    max_err = 0.0
    record = None
    for name, slots, hkv, g, d, page, lengths in cases:
        maxp = -(-(SERVE["prompt_len"] + SERVE["gen"]) // page) \
            if name == "serve-run shapes" else -(-max(lengths) // page) + 1
        q, pk, pv, table, lens = paged_inputs(torch, 0, slots, hkv, g, d,
                                              page, lengths, maxp)
        out = pa.paged_attention_decode(q, pk, pv, table, lens)
        torch.cuda.synchronize()
        ref = pa.paged_attention_ref(q, pk, pv, table, lens)
        err = float((out - ref).abs().max())
        check(torch.allclose(out, ref, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
              f"paged attention kernel disagrees with its plain version "
              f"({name}): max abs err {err}")
        dead = lens == 0
        check(torch.equal(out[dead], torch.zeros_like(out[dead])),
              f"dead slots are not exact zeros ({name})")
        max_err = max(max_err, err)

        ms = time_cold_ms(torch, lambda: pa.paged_attention_decode(
            q, pk, pv, table, lens), flush)
        plain_ms = time_cold_ms(torch, lambda: pa.paged_attention_ref(
            q, pk, pv, table, lens), flush, iters=20)
        # yardstick: one SDPA call on the dense gathered view, with the
        # gather and the GQA head repeat done before the timing
        T = maxp * page
        kd = pk[:, table.long()].reshape(hkv, slots, T, d).transpose(0, 1)
        vd = pv[:, table.long()].reshape(hkv, slots, T, d).transpose(0, 1)
        kd = kd.repeat_interleave(g, dim=1).contiguous()
        vd = vd.repeat_interleave(g, dim=1).contiguous()
        qd = q.reshape(slots, hkv * g, 1, d)
        mask = (torch.arange(T, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        library_ms = time_cold_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask), flush)
        bound_ms, bound_by = paged_bound_ms(q, pk, table, lens)
        log(f"[kernels] paged_attention {name}: max_abs_err {err:.3e}  "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"sdpa {library_ms:.4f} ms  bound {bound_ms:.6f} ms ({bound_by})")
        if name == "serve-run shapes":
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
    return max_err, record


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def serve(torch, params, plan, device, codec, recorder=None):
    from repro_torch import obs
    from repro_torch.core.serve_engine import ServeEngine, make_requests

    rec = recorder or obs.null_recorder
    with obs.use_recorder(rec):
        engine = ServeEngine(params, plan, slots=SERVE["slots"],
                             max_len=SERVE["prompt_len"] + SERVE["gen"],
                             page_size=SERVE["page"], codec=codec, seed=0,
                             device=device)
        for r in make_requests(SERVE["users"], SERVE["prompt_len"],
                               SERVE["gen"], vocab_size=plan.cfg.vocab_size,
                               seed=0):
            engine.submit(r)
        engine.step()
        first_logits = engine.last_logits.float().cpu()
        engine.run()
    return engine, first_logits


def phase_serve(torch):
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import lm
    from repro_torch.obs.ledger import reconcile_events

    cfg = get_config("granite-8b")
    plan = lm.build_plan(cfg, 1)
    t0 = time.perf_counter()
    params = lm.init_lm(0, plan, torch.float32, "cuda")
    torch.cuda.synchronize()
    log(f"[serve] granite-8b full width, {cfg.num_layers} layers, f32 "
        f"weights on the card in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB allocated)")

    rec = obs.Recorder()
    pa.paged_attention_decode.launches = 0
    engine, _ = serve(torch, params, plan, "cuda", SERVE["codec"], rec)
    launches = pa.paged_attention_decode.launches
    decode_steps = len(engine.step_latencies_s)

    check(len(engine.completions) == SERVE["users"] and all(
        c.num_tokens == SERVE["gen"] for c in engine.completions),
        "not every request completed with its token budget")
    n_attn = sum(g.repeat * len(g.period) for g in lm.all_groups(plan))
    check(launches == n_attn * decode_steps,
          f"paged attention kernel launched {launches} times, expected "
          f"{n_attn} x {decode_steps} decode steps")
    rows, bad = reconcile_events(rec.events)
    check(rows and bad == 0, f"{bad} of {len(rows)} traffic events do not "
          "reconcile with sysmodel.traffic")
    check(bool(torch.isfinite(engine.last_logits).all()),
          "non-finite logits")
    s = engine.summary()
    steps_ms = sorted(1e3 * t for t in engine.step_latencies_s)
    p50 = obs.percentile(steps_ms, 0.5)
    p99 = obs.percentile(steps_ms, 0.99)
    log(f"[serve] {s['users']} users, {s['tokens']} tokens, {s['steps']} "
        f"steps ({decode_steps} decode), {s['tok_per_s']:.1f} tok/s; decode "
        f"step p50 {p50:.2f} ms p99 {p99:.2f} ms; "
        f"{launches} kernel launches; {len(rows)} traffic events reconcile "
        f"[{torch.cuda.get_device_name(0)}]")
    profile_steps(torch, engine)
    del engine, params
    torch.cuda.empty_cache()
    return launches


def profile_steps(torch, engine, n=4):
    """Where a full-width decode step's time goes: a few steps under
    ``torch.profiler`` after the measured run (its counts and times are
    already read). Prints the device's busy share of the wall clock and
    the kernels that took most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.serve_engine import make_requests

    for r in make_requests(engine.slots, SERVE["prompt_len"], n + 2,
                           vocab_size=engine.cfg.vocab_size, seed=1):
        engine.submit(r)
    engine.step()  # admissions and their prefills stay outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    # device work is the kernels' own events; an operator's device time
    # repeats its kernels' and is left out
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    log(f"[profile] {n} decode steps at {engine.slots} slots: wall "
        f"{wall_ms:.2f} ms/step (profiled), device busy {dev_ms:.2f} "
        f"ms/step ({100 * dev_ms / wall_ms:.1f} % of wall), "
        f"{sum(e.count for e in kernels) // n} kernels/step")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
            f"{e.count // n:5d} calls/step  {e.key[:90]}")
    cpu_ops = sorted((e for e in events if e.device_type != DeviceType.CUDA),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    log("[profile] host self time/step: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / n:.2f} ms "
        f"({e.count // n} calls)" for e in cpu_ops))


def phase_card_vs_cpu(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    plan = lm.build_plan(cfg, 1)
    params = lm.init_lm(1, plan, torch.float32, "cuda")
    cpu_params = tree_to(params, "cpu")
    gpu, gpu_logits = serve(torch, params, plan, "cuda", "fp32")
    t0 = time.perf_counter()
    cpu, cpu_logits = serve(torch, cpu_params, plan, "cpu", "fp32")
    cpu_s = time.perf_counter() - t0
    err = float((gpu_logits - cpu_logits).abs().max())
    check(torch.allclose(gpu_logits, cpu_logits, atol=LOGITS_ATOL,
                         rtol=LOGITS_RTOL),
          f"first-step logits: card and CPU differ by up to {err}")
    streams = [{c.uid: c.tokens for c in e.completions} for e in (gpu, cpu)]
    check(streams[0] == streams[1], "card and CPU greedy token streams differ")
    top2 = cpu_logits.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    log(f"[card-vs-cpu] granite-8b width, 2 layers: {len(streams[0])} "
        f"identical greedy streams; first-step logits max abs diff "
        f"{err:.3e} (tolerance {LOGITS_ATOL}); smallest first-step top-2 "
        f"margin {margin:.3e}; CPU run {cpu_s:.1f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 as the reference
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())} "
        f"(wall {time.perf_counter() - t0:.1f} s)")
    for src in secs:
        log(f"[build] {src}: " + " | ".join(
            ln.strip() for ln in _build.build_log(src).splitlines()
            if "registers" in ln or "spill" in ln))

    max_err, rec = phase_kernels(torch)
    launches = phase_serve(torch)
    phase_card_vs_cpu(torch)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [dict(
        name="paged_attention_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:85",
        launches=launches, max_abs_err=max_err, **rec)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
