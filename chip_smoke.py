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
   version on the same inputs, with times of the kernel, the plain
   version and, where one exists, one PyTorch call as a yardstick:
   a. B6, the paged-decode attention, at granite-8b decode shapes (slots
      8, 32 query / 8 kv heads, head_dim 128 and 64, page 16, ragged
      lengths with a dead slot, one token, a page boundary and several
      pages), at the shapes of the serve run below, at granite-20b's
      group of 48 query heads over one kv head, and at granite-8b's full
      context (16 slots up to 4,096 tokens); each case logs the plan's
      cluster size and grid and the kernel's time at every cluster size
      1 to 8, each held to the plain version, and B6's ptxas report may
      show no spill;
   b. B1 (eq. 5 aggregation), B2 (int8/int4 quantize) and B3 (dequantize
      + aggregate) at the paper CNN's cut-layer shapes (10 clients x
      batch 32: 200,704 f32 per client at cut 1, 100,352 at cut 2, as
      the simulator calls them) and at an LM boundary (8 x 2048 x 4096
      f32), then B2 and B3 on two single payloads: sfl_ga's downlink
      broadcast (100,352 f32) and granite-8b's serve-step boundary (4 x
      4,096), and B1 on one client of 4,096 (its launch floor); each
      logs the path its plan picked; all three bit for bit; B1 also on
      every other path of its source (the wave, the stream, the general
      walk), each bit for bit, and timed beside ``rho @ g``; B2 and B3
      each timed beside a same-bytes cast (``g.to(torch.int8)``,
      ``q.to(torch.float32)``) as the harness's floor; the ptxas reports
      may show no spill;
   c. B5, the Mamba-2 SSD intra-chunk step, at the SSM serve run's
      prompt head (1 x 24 heads x 2 chunks of 128, head_dim 64, state
      128) and at the LM forward's shape (4 x 24 x 8 chunks), and B4,
      the flash attention, at granite-8b's full sequence (32 query / 8
      kv heads, S 2048, head_dim 128, causal) and at a small windowed
      head_dim-64 case; SDPA in f32 is B4's yardstick; both bounds are
      the kernels' 3xTF32 tensor-core work, with the f32-SIMT figure
      printed beside, and neither kernel's ptxas report may show a
      spill;
   d. G1, the 3xTF32 GEMM of the model's ``linear``, at granite-8b's
      gate/up at M 4,096 in each form (Y, dX, dW), at its head (4,096
      x 4,096 x 49,152) and at mamba2-130m's in_proj at M 8,192: each
      held to an f64 product (within 3x cuBLAS f32's error), timed cold
      beside its bound (3 x its flops over the TF32 rate), its plain
      version and ``torch.matmul`` f32 as the yardstick; the ptxas
      report may show no spill;
   e. M1, the MoE layer's combine, at granite-4.0-h-small's shapes (k
      10 of 72 experts, 9 held, d 4,096, its router and dispatch on
      random tokens): the server's 4,096 tokens (C 712) and the clients'
      4 x 1,024 under ``vmap`` (C 178, the 4 clients folded into rows as
      the op's rule does): the forward and the backward held to the
      plain version (y within 2e-6 of the sum of |terms|, dye bit for
      bit, dgates within 2e-6 of the sum of |dy ye| of float64 and 0 on
      a skipped pair), each timed cold beside its bound (bytes over the
      HBM rate), the plain version, and as the yardstick the PyTorch
      expression it replaced (a zero row appended, ``flat[slot]``, the
      ``einsum``) forward and backward through autograd; the ptxas
      report may show no spill;
   f. M2, the MoE layer's position-in-expert count, at granite-4.0-h-
      small's routes (k 10 of 72 experts, its router on random tokens):
      the server's 4,096 tokens (40,960 pairs over 72 experts) and the
      clients' 4 x 1,024 folded as the op's ``vmap`` rule folds them
      (40,960 pairs over 288), held to the plain version bit for bit
      and timed cold beside its bound (12 bytes a pair over the HBM
      rate), the plain version (the one-hot, ``cumsum``, gather) and as
      the yardstick ``torch.cumsum`` over dim 0 of the one-hot alone;
      the ptxas report may show no spill;
4. serve -- the split decode server at full width: granite-8b, 36
   layers, f32 weights drawn on the card from a seed (about 33 GB), cut
   1, 8 users over 4 slots, prompt 16, gen 16, int8 boundary codec, page
   16. Every request completes, the kernel's launches equal 36 x the
   decode steps, every step's traffic event reconciles exactly, the
   logits are finite. Then a few more steps under ``torch.profiler``
   show the device's busy share and the kernels that take the time;
5. serve, card against CPU -- the same path at full width and 2 layers,
   on the card (kernel) and on the CPU (plain version): identical greedy
   token streams and first-step logits within the stated tolerance;
6. train -- the paper's main path at full width: ``FedSimulator`` on the
   paper CNN ``CONFIG`` (conv 32/64, fc 512, 28x28x1) over the port's
   synthetic MNIST-like data, 10 clients, batch 32, cut 2, lr 0.05.
   Every scheme x {fp32, int8, int4} for 3 rounds: every round's traffic
   event reconciles exactly, losses are finite, and the B1/B2/B3 launch
   counts equal the counts predicted per scheme and codec. Then
   sfl_ga/int8 for 100 rounds: round time p50/p99, rounds/s and the test
   accuracy, which must rise above chance; then a few rounds under
   ``torch.profiler``;
7. train, card against CPU -- 3 rounds of sfl_ga at fp32 and int8 from
   the same params and batches on the card (kernels) and on the CPU
   (plain versions): losses and params within the stated tolerances; a
   second card run bit-identical to the first; and every int8 uplink and
   downlink of the card's run replayed on the CPU from the card's own
   inputs, bit for bit;
8. SSM serve -- the same server on mamba2-130m at full width (24
   layers, f32 weights drawn on the card from a seed), cut 1, 8 users
   over 4 slots, prompt 320 (two chunks of 128 through B5, then a
   64-token tail through the sequential recurrence), gen 32, int8
   boundary codec. Every request completes, B5 launches 24 x the
   admitted prefills, every step's traffic event reconciles exactly,
   the logits are finite. Then a prefill and a few decode steps under
   ``torch.profiler``: the device's busy share, B5's share of the
   prefill, and the sequential tail's cost;
9. SSM serve, card against CPU -- the same path at full width and 2
   layers, prompt 160, gen 8: identical greedy streams and first-step
   logits within the stated tolerance;
10. the split LM forward with ``impl="flash"`` under ``torch.no_grad``:
   granite-8b at full width and depth (phase 4's weights), B 1, S 2048,
   with 36 B4 launches, and mamba2-130m, B 4, S 1024, with 24 B5
   launches. The loss is finite, and the flash and jnp paths' logits and
   losses agree on the card within the stated tolerance; the forward's
   time is recorded;
11. ccc -- the CCC strategy (paper Algorithm 1) on the card at fig. 7's
   setting (the paper CNN's env, four cuts, 10 clients, batch 16,
   horizon 10, 32 batched envs, the §V-A constants): (a) the batched
   P2.1 solve in f32 against the numpy float64 solver on the same gains
   (32 rounds of 10 clients, and a tight-bandwidth set at 200 kHz):
   equal feasibility, chi and psi within the stated tolerance; (b) the
   batched env's step against the scalar env's ``cost_terms`` on the
   same gains for every action (one codec and four); (c) 80 episodes of
   ``run_algorithm1_batched``: every reward finite, every greedy cut in
   [1, V-1] and private, and the greedy policy's cost on the scalar env
   within the stated slack of random cuts. Logs ms per batched solve,
   env step and fused step, the numpy scalar env step, and the kernel
   launches and device busy share of an env step and a fused step
   (``torch.profiler``). This path runs no hand-written kernel; the
   six counters are read around it;
12. bank -- cohorts and the client bank at full width: the paper CNN
   (conv 32/64, fc 512), sfl_ga, cut 2, int8 up and down, 4,096
   registered clients (a bank of 853.5 MB at cut 2), a cohort of 32
   drawn by the ``uniform`` sampler, batch 32, tau 1, 6 rounds. Runs
   with ``bank="device"``, ``bank="host"`` (prefetch on) and
   ``bank="sharded"`` (DTensors over ``launch.mesh.make_bank_mesh``: a
   one-rank nccl group over a ``HashStore``, so the gather is an nccl
   ``all_gather``), from the same params and batches, give a
   bit-identical client bank and server model after every round; so do
   psl over 3 rounds, and the ``rho`` sampler at N 64, K 32 (duplicate
   draws, on the card); Gamma is exact on every bank there, so the
   rounds' metrics agree too. The host and the sharded runs, saved after
   round 3 and each restored into a fresh simulator of its backend, end
   rounds 4-6 bit for bit where the uninterrupted runs do. Then each
   backend runs 12 rounds alone, Gamma off: its peak device memory
   (``max_memory_allocated`` after ``reset_peak_memory_stats``) and its
   round time p50; the host run's peak must sit at least 0.9 x the
   bank's bytes below the device run's, and its bank's
   ``device_bytes_peak`` at most two K-slices; the sharded bank's
   ``device_bytes_peak`` is the whole bank (one rank holds every
   shard). Logs the gather wait, the prefetch hits and misses, and the
   B1/B2/B3 launches against the phase's predicted counts. Last, the
   CNN launcher (``python -m repro_torch.launch.train``, the light CNN)
   runs ``--bank sharded`` for 3 synchronous rounds and for 3 merges
   with ``--async``, each with ``--metrics-dir``; the launches equal the
   prediction (rounds, or dispatched generations), and the port's
   report (``repro_torch.obs.report``) reads each run's directory and
   exits 0, every traffic event reconciled.
13. async and closed loop -- the paper CNN ``CONFIG`` at full width,
   sfl_ga/int8, cut 2, batch 32, 64 clients, a uniform cohort of K 16,
   merges of B 4, straggler spread 4, staleness exponent 0.5: (a) with
   B = K and zero-spread completion times 5 engine steps give the
   params of 5 ``run_round`` calls bit for bit; (b) 30 merges of the
   buffered-async engine: every merge's traffic event reconciles
   exactly, and each merge's B1/B2/B3 launches equal the count that its
   dispatched generations predict (B1's path logged for each (N, M)
   it aggregates); the engine step's host time p50/p99, the virtual clock, the
   staleness and the host bank's prefetch hits and misses; (c) the same
   run on the ``device``, the ``host`` and the ``sharded`` bank bit for
   bit after every merge, and the engine saved after merge 15, restored into a fresh
   simulator and run to merge 30, bit for bit; (d) 4 merges on the card
   and on the CPU from the same params and data: the same merge order,
   params within phase 7's int8 tolerance; (e) the closed loop in fig.
   10's comm-bound env (1 MHz uplink band, 1 GHz clients): a constant
   schedule over 6 rounds equals the fixed-cut loop bit for bit; the
   cycled schedule (2, 1, 3) over 6 rounds migrates at every change of
   cut, its migration bits equal ``sysmodel.traffic.migration_bits``,
   its wall-clock adds each move's ``migration_latency``, and with the
   async engine the queue is empty at every migration. Throughout, the
   first CUDA call of B1, B2 and B3 at each distinct input (shape and
   codec arguments) is held bit for bit to its plain version on the same
   inputs, and after the phase ``b1_case`` runs at each (N, M) that B1
   took. Its kernel launches are logged on a line of their own.
14. LM training -- SFL-GA training of the split LM through the port's
   launcher (``python -m repro_torch.launch.train`` in LM mode, driven
   as ``main(argv)``) on the synthetic token stream: (a) granite-8b at
   full width (d_model 4096, 32/8 heads, d_ff 14336, vocab 49152) cut to
   4 layers, cut 2, sfl_ga fp32, sgd, N 4, b 1, S 256, 3 steps; (b) the
   same with int8 both ways, tau 2, cohorts of 2 of 4 (uniform) and the
   cut schedule 2, 1, 2 on the device bank (two full-parameter
   migrations); (c) LoRA (rank 8, alpha 16) on granite-8b at full width
   and depth (36 layers), adamw, sfl_ga int8/int8, 8 clients, cohorts of
   2 on the host bank, cuts 2, 3, 2, 3 steps, saved; then 2 steps saved
   and a resume of 1 step, whose file is the uninterrupted run's byte
   for byte (two of the three 33 GB files are hashed through a FIFO as
   they are written, never stored); (d) card against CPU: granite-8b at
   full width and 2 layers, cut 1, N 2, b 1, S 32, 2 adamw steps at
   sfl_ga fp32 and int8 (the int case carries the CPU's state in before
   each step); (e) mamba2-130m at full width and depth, sfl_ga fp32, cut
   2, N 4, b 2, S 256, 3 steps (its backward through the plain
   ``ssd_chunked``). Every step's traffic event and every migration's
   bits reconcile exactly, every step's B1/B2/B3 launches equal
   ``predicted_launches``, the first CUDA call of B1, B2 and B3 at each
   distinct input is held bit for bit to its plain version (B1's path
   and blocks logged per (N, M), then ``b1_case`` at each), losses are
   finite and fall over (a) and (c). Logs each part's step times, p50,
   tokens/s, peak device memory and one profiled step's device-busy
   share, and the phase's launches on a line of their own.
15. the decoder zoo -- MoE, Jamba's hybrid and the sliding-window ring
   cache at full width, f32 weights drawn on the card from a seed, each
   model freed before the next is built. First B6 (qwen3-moe's G 8,
   qwen2-vl's G 6, Jamba's G 4 at its serve lengths), B4 (qwen3-moe at S
   2048; starcoder2-3b's 24/2 heads at S 8192 with its window of 4,096)
   and B5 (Jamba's 128 heads of 64, state 16) against their plain
   versions, timed with their bounds. (a) qwen3-moe-30b-a3b (d 2048,
   32/4 heads of 128, 128 experts top-8 of width 768, vocab 151,936) cut
   to 24 of 48 layers (62.3 GB) serves as phase 4 does: every request
   completes, B6 launches 24 x the decode steps, traffic reconciles, a
   profiled decode step; (b) its split forward with impl="flash" at B 1,
   S 2048: 24 B4, 24 M1 forward and 24 M2 launches, logits within
   phase 10's tolerance of impl="jnp", every MoE layer's routing equal
   to the jnp run's but at near-ties (ROUTE_TIE), where the flash run
   takes the jnp run's choice;
   (c) card against CPU at full width and 2 layers: the serve path's
   greedy streams identical and first-step logits within phase 5's
   tolerance (routes pinned likewise), then 2 sfl_ga steps (fp32) as
   phase 14 (d) holds them; (d) training through the launcher:
   full-parameter sfl_ga int8 on 3 layers, N 2, b 1, S 256, sgd, cuts 1,
   2, 1 (a 2.49 GB MoE layer migrates each way), then LoRA r 8 on
   attention and the router over a 16-layer frozen base, adamw, int8,
   cohorts of 2 of 4 on the host bank, cuts 2, 3, 2; every step's
   traffic and every migration reconcile, B1-B3 launch as predicted and
   hold bit for bit to their plain versions; (e) jamba-v0.1-52b, one
   period of 8 layers (1 attention, 7 Mamba-2, 4 MoE of 16 x 14,336):
   the split forward (1 B4, 7 B5, 4 M1 and 4 M2 launches) as in (b), and
   the server at prompt 320 (B5 on the 256-token head, 7 launches a
   prefill), gen 16, int8; (f) starcoder2-3b at full width and depth:
   the windowed split forward at S 8192 (30 B4 launches) as in (b), and
   the ring cache: a prefill of 4,200 tokens and 16 greedy decode steps,
   each step's logits within phase 10's tolerance of the windowed
   forward over prompt and fed tokens. M1 and M2 launch over the phase's
   checked paths and leave no MoE combine or position count on the
   plain version. Logs step p50, tokens/s, peak memory and profiled
   steps' busy shares, and the phase's launches on a line of their own.
16. whisper, the LM async loop and the LM DDQN schedule -- (a)
   whisper-tiny at full width and depth (4 + 4 layers, d 384, 1,500
   frames, vocab 51,865; weights drawn on the card from a seed), split at
   cut 1, N 4, b 2, 64 decoder tokens, sfl_ga with sgd, 5 steps at fp32
   and 5 at int8 both ways: each step sends two tensors across the
   boundary (the decoder's residual and the encoder's states, 1,152,000
   f32 a client), so B1 launches twice a step and, with int8, B2 and B3
   four times each; the ledger holds both boundaries' bits exactly; the
   losses are finite; the step p50 and the peak memory are logged; (b)
   the same config served: a prefill of 4 prompts of 16 tokens over
   1,500 frames and 16 greedy steps on the dense cache, tokens and logits
   finite, no kernel launched (the reference's whisper reaches none);
   (c) card against CPU at full width, 1 + 2 layers: 2 steps at fp32 and
   int8 within phase 14 (d)'s tolerances (the CPU's state carried in
   before each int8 step), and a greedy stream of 8 tokens identical,
   its logits within phase 5's tolerance; (d) the LM launcher's
   ``--async`` on granite-8b at full width and 2 layers, sfl_ga
   int8/int8, sgd, N 8, K 4, merges of 2, straggler spread 8, 4 merges
   and the drain, on the card and then on the CPU with the same flags:
   the merge order, the staleness, the clock and the dispatches equal,
   every ``async_traffic`` event reconciles, every generation launches
   B1 once and B2/B3 twice, the losses within phase 14's tolerance; (e)
   ``--dynamic-cut ddqn:4`` on granite-8b at full width and 3 layers,
   with and without LoRA, the agent on the card, at the first seed
   whose frozen rollout moves the cut: the run's cuts follow the
   rollout, each migration's bits are ``migration_bits`` (or
   ``adapter_migration_bits``); then ``lm_env_config`` of the full
   36-layer granite-8b is logged. Throughout (a), (d) and (e) the first
   CUDA call of B1, B2 and B3 at each distinct input is held bit for bit
   to its plain version; the phase's launches are logged on a line of
   their own.
17. roofline -- (a) the dry run (``python -m repro_torch.launch.dryrun``'s
   ``run_case``) of granite-8b x train_4k on the (16, 16) mesh under
   sfl_ga and under sfl, in a subprocess on the CPU (fake tensors over a
   fake 256-rank group; it runs while (b) runs on the card): both rows
   ``ok``, printed, and their all-reduce bytes over the client axis
   ("data") differ by exactly sfl_ga's eq. 5 all-reduce of X(v) (b S d
   f32) less sfl's client-model average (each client leaf's rank shard
   in f32), every other collective equal; (b) a real granite-8b step on
   the card at full width, 4 layers, cut 2, sfl_ga fp32 in full f32, N
   4, b 1, S 1,024: one warm-up, whose B1 launch at (4, b S d) is held
   bit for bit to its plain version, and 5 timed steps; the same step
   counted on fake tensors by ``analysis.roofline.OpCounter`` gives
   t_compute at a third of the card's TF32 peak (from the peaks table,
   by the card's name: the step's products run on G1's 3xTF32) and
   t_memory; the timed p50 must not fall below t_compute; the counter
   over one more card step (under a dispatch mode the products stay on
   ``torch.matmul``) counts the same FLOPs exactly (its bytes
   differ by B1's plain loop against its ctypes launch: both printed),
   and B1 launches once in each of those 6 steps (the counts set to 0
   after the warm-up); (c) remat: the (b) step at b 2 with
   ``remat=False`` and with ``remat=True`` (``TrainConfig.remat``: each
   layer checkpointed), from the same params and batch, a warm-up and 2
   timed steps each: the warm-up's B1 launch at (4, b S d) held bit for
   bit to its plain version, the params bit for bit equal, B1 once a
   timed step in both, each run's step p50 and the peak memory of its
   timed steps (``max_memory_allocated`` after
   ``reset_peak_memory_stats``; remat's must be lower), and one more remat step counted over the card whose
   FLOPs equal its fake count, which exceeds (b)'s by the recomputed
   forward (the layers' forward less each MLP down projection, whose
   output no backward saves);
18. the reference's scripts on the card -- (a) the serve bench
   (``benchmarks/torch_serve_bench.py``) on granite-8b at full width and
   depth with phase 4's weights (run after phase 10): continuous
   batching over 4, 8 and 16 users and the fixed-batch baseline at 16,
   4 slots, int8: the rows' users, tokens and decode steps equal the
   reference's, 342 traffic events reconcile, the speedup clears 2x, the
   logits are finite and B6 launches 36 x the decode steps, warm-ups
   included; (b) ``examples/torch_serve_decode.py`` with
   ``--metrics-dir``: 4 users and 48 tokens on each arch, B6 once a
   layer a granite decode step, and the port's report exits 0 on both
   directories, every traffic event reconciled; (c)
   ``benchmarks/torch_kernels_bench.py``: the reference's seven rows,
   each kernel held to its plain version (B1-B3 bit for bit, B4 and B5
   within ``KERNEL_ATOL``) and timed beside it; (d)
   ``benchmarks/torch_run.py --only kernels_micro,fig8,roofline,fig4``:
   every entry ``ok``, exit 0, the roofline table reading phase 17
   (a)'s rows (one cell: the table keys a row by arch x shape x mesh),
   the manifest naming the card and its power limit.

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

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.roofline import device_peaks  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit; the port's one
# table, ``analysis.roofline.PEAKS``): HBM3 rate, float32 outside the
# tensor cores (where the kernels compute in plain f32) and dense TF32 on
# the tensor cores (B4's and B5's 3xTF32 products)
_H100 = device_peaks("NVIDIA H100 80GB HBM3")
HBM_BYTES_PER_S = _H100.hbm_bytes_per_s
F32_FLOP_PER_S = _H100.f32_flop_per_s
TF32_FLOP_PER_S = _H100.tf32_flop_per_s

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
# phase 8: prompt 320 = two chunks of 128 through B5 + a 64-token tail
SSM_SERVE = dict(users=8, slots=4, prompt_len=320, gen=32, codec="int8",
                 page=16)
# phase 9: one chunk + a 32-token tail, 2 layers, on the card and the CPU
SSM_CHECK = dict(users=4, slots=2, prompt_len=160, gen=8, codec="fp32",
                 page=16)
# phase 10: the split LM forward's batches
LM_FORWARD = {"granite-8b": (1, 2048), "mamba2-130m": (4, 1024)}
# B5 against its plain version: f32 sums of up to 128 products in other
# orders (the cumsum too) differ by a few ulps of the largest output
SSD_REL_TOL = 1e-5
# B4 against its plain version: the reference's own kernel-vs-oracle
# bound in f32 (outputs are softmax averages of unit-normal values)
FLASH_TOL = 2e-5
# phase 10, flash against jnp on the card: the two attention (and SSD)
# paths sum in other orders, by ~1e-7 relative a layer; through 36
# layers and a 4096-wide head the logits (of order one) keep that well
# inside 1e-3, which any wrong kernel (errors of order one) exceeds
LM_LOGITS_TOL = 1e-3
LM_LOSS_RTOL = 1e-4

# the paper's main path (phase 6): full-width CNN, 10 clients, batch 32
TRAIN = dict(n_clients=10, batch=32, cut=2, lr=0.05)
TRAIN_LONG_ROUNDS = 100
# B1, B2 and B3 against their plain versions: the same IEEE operations
# in the same order (B2's codes and scales from them), so each must agree
# bit for bit.
# train, card against CPU, 3 rounds of sfl_ga at full width from the same
# params and batches. fp32: cuDNN (TF32 off) and oneDNN sum the
# convolutions in other orders, by about 1e-7 relative; three SGD steps at
# lr 0.05 keep the params within about 1e-5. int8: a value that the two
# devices put on either side of a rounding boundary takes the neighbouring
# code (one quantum, absmax/127 of its tile), and training amplifies
# those flips, as it amplifies the run-to-run noise of cuDNN's default
# backward (the simulator makes cuDNN deterministic for that reason). So
# the int8 trajectory is held loosely against the CPU, and the codec on
# the main path bit for bit instead: each round's uplink and downlink on
# the card, replayed on the CPU's plain versions from the card's own
# inputs, must give the same bits.
TRAIN_TOL = {"fp32": (1e-5, 1e-4), "int8": (2e-3, 2e-3)}  # loss rtol, atol

# phase 11, the CCC strategy at fig. 7's setting: the paper CNN's env (V
# 5: four cuts), 10 clients, batch 16, horizon 10, privacy epsilon 1e-3,
# 80 episodes over 32 batched envs, the §V-A constants
CCC = dict(n_envs=32, n_clients=10, batch=16, horizon=10, epsilon=0.001,
           episodes=80, seed=3)
# the batched P2.1 solve in f32 on the card against the numpy float64
# solver: the reference's own f32-against-f64 bound
# (tests/test_ccc_batched.py); the batched env against the scalar env on
# the same gains: the reference's bound for that pair
CCC_SOLVE_RTOL = 1e-4
CCC_ENV_RTOL = 1e-3
# the greedy policy after training may cost at most this much more than
# random cuts on the scalar env (the reference's test_ccc.py slack)
CCC_GREEDY_SLACK = 1.15

# phase 12, cohorts and the client bank: the paper CNN at full width, a
# bank of 4,096 clients, cohorts of 32; each client owns 64 samples of a
# cyclic partition of the synthetic train set. Rounds: the lockstep
# parity run, where the host run is saved, the psl and rho runs, and the
# timed runs of each backend alone
BANK = dict(n_clients=4096, cohort=32, batch=32, cut=2, lr=0.05,
            part_size=64, rounds=6, save_after=3, psl_rounds=3,
            rho_clients=64, rho_rounds=3, timed_rounds=12)
# the host run's peak device memory sits at least this share of the
# bank's bytes below the device run's
BANK_PEAK_SHARE = 0.9

# phase 13, the buffered-async engine and the closed loop: the paper CNN
# at full width, sfl_ga/int8, cut 2, batch 32, 64 clients (iid shares of
# the train set), a uniform cohort of K 16 in flight, merges of B 4, a
# straggler spread of 4, staleness exponent 0.5; the closed loop in
# fig. 10's comm-bound corner (1 MHz uplink band, 1 GHz clients)
ASYNC = dict(n_clients=64, cohort=16, buffer=4, batch=32, cut=2, lr=0.05,
             straggler=4.0, lam=0.5, merges=30, save_after=15,
             degenerate_steps=5, cpu_merges=4, loop_rounds=6,
             loop_cuts=(2, 1, 3), bandwidth=1e6, client_cpu=1e9)

# phase 14, SFL-GA training of the split LM through the launcher (LM
# mode), every part on the synthetic token stream: (a) granite-8b at full
# width cut to 4 layers; (b) the same with int8 both ways, tau 2, cohorts
# of 2 of 4 and a cut that migrates 2 -> 1 -> 2; (c) LoRA (rank 8, alpha
# 16) at full width and depth, adamw, int8, cohorts of 2 of 8 on the host
# bank, cuts 2 -> 3 -> 2, then a resume; (d) card against CPU at full
# width and 2 layers; (e) mamba2-130m at full width and depth
_GRANITE4 = dict(arch="granite-8b", preset="full", layers=4, cut=2,
                 clients=4, batch=1, seq=256, steps=3, optimizer="sgd",
                 lr=0.05)
LM_TRAIN = {
    "a": _GRANITE4,
    "b": dict(_GRANITE4, codec="int8", tau=2, cohort=2,
              dynamic_cut="2,1,2", migrations=2, lr=0.01),
    "c": dict(arch="granite-8b", preset="full", scheme="sfl_ga",
              codec="int8", lora=(8, 16.0), optimizer="adamw", lr=1e-3,
              clients=8, cohort=2, bank="host", dynamic_cut="2,3,2",
              batch=1, seq=256, steps=3, resume_after=2, migrations=2),
    "d": dict(arch="granite-8b", layers=2, cut=1, clients=2, batch=1,
              seq=32, steps=2, optimizer="adamw", lr=1e-3),
    "e": dict(arch="mamba2-130m", preset="full", cut=2, clients=4, batch=2,
              seq=256, steps=3, optimizer="sgd", lr=0.05),
}
# (d): adamw steps an element by about lr * g / (|g| + eps) whatever the
# size of g, so an element whose gradient nearly cancels (the two
# devices' float32 sums differ in its last bits) may step anywhere in
# [-lr, lr] on either device. The params are held to this atol on all but
# a share of their elements, and every element to 2 lr a step; the loss
# to LM_LOSS_RTOL. The share is wider with int8: a code the two devices
# round apart (C3) moves its tile's cotangent by a quantum, which reaches
# every client gradient upstream, and adamw turns that into up-to-lr
# steps of the small ones (int8 on an H100 at step 1: a share of 1.33e-3)
LM_TRAIN_PARAM_ATOL = 1e-5
LM_TRAIN_ADAM_SHARE = {"fp32": 1e-3, "int8": 1e-2}


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


def time_cold_ms(torch, fn, flush, iters=50, warmup=5, spin=20_000_000,
                 clean=False):
    """Mean device time of ``fn`` with the L2 cache flushed before each
    run, as the decode step finds it (the weights it streams between two
    attention layers evict it). CUDA events bracket ``fn`` alone. The card
    first spins for ``spin`` cycles (about 10 ms) while the host queues
    the runs: where the host fell behind the card, the host's own time
    between the two events (the wrapper's Python) was counted as the
    kernel's. ``spin=0`` times without it. The flush writes the buffer,
    so the L2 holds up to its size of dirty lines, and ``fn`` pays their
    write-back as it evicts them; ``clean=True`` flushes by reading the
    buffer instead (``flush.max()``), which leaves clean lines."""
    flush_op = flush.max if clean else flush.zero_
    for _ in range(warmup):  # the flush too: its first launch loads it
        flush_op()
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    if spin:
        torch.cuda._sleep(spin)  # cycles
    for s, e in zip(starts, ends):
        flush_op()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# phase 3a's B6 cases: (name, slots, Hkv, G, D, page, lengths)
PAGED_CASES = [
    ("granite-8b decode, D=128", 8, 8, 4, 128, 16,
     [0, 1, 16, 17, 40, 100, 127, 64]),
    ("granite-8b decode, D=64", 8, 8, 4, 64, 16,
     [0, 1, 16, 17, 40, 100, 127, 64]),
    ("serve-run shapes", SERVE["slots"], 8, 4, 128, SERVE["page"],
     [17, 21, 26, 31]),
    # the same with every slot dead: no page is read, so this times
    # the launch, the trip for the table and q, and the combine
    ("serve-run shapes, every slot dead", SERVE["slots"], 8, 4, 128,
     SERVE["page"], [0, 0, 0, 0]),
    # granite-20b's group, 48 query heads over one kv head
    ("granite-20b group, G=48", 8, 1, 48, 128, 16,
     [0, 1, 16, 17, 40, 100, 127, 64]),
    # granite-8b's decode layout at its trained context of 4,096
    # (arXiv:2405.04324): a dead slot, one token, page boundaries and
    # a full context; 32,030 live tokens, 262 MB of live K/V
    ("granite-8b long context, D=128", 16, 8, 4, 128, 16,
     [0, 1, 17, 256, 511, 1024, 1500, 2048, 2049, 2500, 3000, 3333,
      3600, 4000, 4095, 4096]),
]


def paged_maxp(name, page, lengths):
    """Table width of a phase-3a case: the serve run's own (prompt + gen
    tokens) for its shapes, else one page past the longest slot."""
    if name.startswith("serve-run shapes"):
        return -(-(SERVE["prompt_len"] + SERVE["gen"]) // page)
    return -(-max(lengths) // page) + 1


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
    return roofline_ms(byts, live * Hkv * 4 * G * D)


def phase_kernels(torch):
    from repro_torch.kernels import _build

    regs = [ln.strip() for ln in _build.build_log("paged_attention")
            .splitlines() if "registers" in ln or "spill" in ln]
    log("[kernels] paged_attention ptxas (one line pair per head_dim x "
        "row layout): "
        + " | ".join(regs))
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in regs if "spill" in ln),
          "paged attention kernel spills registers")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_err = 0.0
    record = None
    for name, slots, hkv, g, d, page, lengths in PAGED_CASES:
        maxp = paged_maxp(name, page, lengths)
        err, rec = paged_case(torch, name, slots, hkv, g, d, page, lengths,
                              maxp, flush, sms)
        max_err = max(max_err, err)
        if name == "serve-run shapes":
            record = rec
    torch.cuda.empty_cache()  # the long context's dense view is 2.2 GB
    return max_err, record


def paged_case(torch, name, slots, hkv, g, d, page, lengths, maxp, flush,
               sms):
    """B6 at one shape: held to its plain version (at the plan's cluster
    size and at every other), then timed beside the plain version and
    one SDPA call. Returns the max abs error and the timing record."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa

    q, pk, pv, table, lens = paged_inputs(torch, 0, slots, hkv, g, d,
                                          page, lengths, maxp)
    cluster = pa.split_plan(slots, hkv, g, maxp, page, sms)
    log(f"[kernels] paged_attention {name}: maxp {maxp}, cluster "
        f"{cluster}, grid {cluster * slots * hkv} blocks on {sms} SMs")
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

    ms = time_cold_ms(torch, lambda: pa.paged_attention_decode(
        q, pk, pv, table, lens), flush)
    # the other cluster sizes, each held to the plain version too
    by_cluster = {}
    for c in range(1, pa.MAX_CLUSTER + 1):
        alt = pa._launch(q, pk, pv, table, lens, c)
        torch.cuda.synchronize()
        check(torch.allclose(alt, ref, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
              f"paged attention kernel at cluster {c} disagrees with "
              f"its plain version ({name})")
        by_cluster[c] = time_cold_ms(torch, lambda: pa._launch(
            q, pk, pv, table, lens, c), flush)
    log(f"[kernels] paged_attention {name}: kernel ms by cluster size "
        + ", ".join(f"{c}: {t:.4f}" for c, t in by_cluster.items()))
    # the plain version walks every page of the table, a few kernels
    # a page: the long context's 257 pages take few runs
    plain_ms = time_cold_ms(torch, lambda: pa.paged_attention_ref(
        q, pk, pv, table, lens), flush, iters=3 if maxp > 100 else 20,
        warmup=1 if maxp > 100 else 5)
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
    return err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms)


def roofline_ms(byts, flops):
    """The larger of the bytes over the HBM rate and the flops over the
    f32 rate, in ms, and which of the two it is."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def agg_shapes():
    """(label, N, T, D, quantize tile, per-client seeds, B1 too): the
    simulator's per-client uplink at cuts 1 and 2 of the paper CNN (K
    clients x one flat payload, as ``IntQuantCodec.encode_clients`` calls
    the kernels), an LM boundary (N, T, D) in the reference kernels'
    default 256 x 256 tile, and two single payloads of one seed, as
    ``codec.encode`` calls B2: sfl_ga's downlink broadcast of the cut-2
    aggregate and granite-8b's serve-step boundary (4 slots x d_model
    4,096, the int8 boundary codec of phases 4 and 8). Both are
    latency-bound; B1 does not run on them."""
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.models import cnn

    k, b = TRAIN["n_clients"], TRAIN["batch"]
    d_model = get_config("granite-8b").d_model
    return [(f"paper CNN cut {v}", k, 1, cnn.smashed_numel(CONFIG, v) * b,
             (1, 256), True, True) for v in (1, 2)] + [
        ("LM boundary", 8, 2048, 4096, (256, 256), False, True),
        ("sfl_ga downlink broadcast", 1, 1,
         cnn.smashed_numel(CONFIG, 2) * b, (1, 256), False, False),
        ("granite-8b serve-step boundary", 1, 1, SERVE["slots"] * d_model,
         (1, 256), False, False)]


def kernel_name(symbol):
    """A mangled entry function as ``name<a,b>``: the last of its nested
    names, with its integer template arguments."""
    import re

    mangled = re.match(r"_ZN?", symbol)
    if not mangled:  # an extern "C" kernel keeps its own name
        return symbol
    i, names = len(mangled.group()), []
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        names.append(symbol[j:j + int(symbol[i:j])])
        i = j + int(symbol[i:j])
    args = re.match(r"I((?:Li-?\d+E)+)E", symbol[i:])
    args = re.findall(r"Li(-?\d+)E", args.group(1)) if args else []
    return (names[-1] if names else symbol) + (
        f"<{','.join(args)}>" if args else "")


def ptxas_report(text):
    """(kernel, registers, spill bytes) of each entry function in an
    ``-Xptxas -v`` report (names by ``kernel_name``)."""
    import re

    rows, name = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = kernel_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def b1_paths(ga, n, m, sms):
    """Every path of B1's source at (n, m): the wave, the stream and the
    general walk (the first two only where they take the shape)."""
    out = {"general": ga.general_plan(m, sms, vec=m % 4 == 0)}
    if m % 4 == 0 and 1 <= n <= ga.MAX_CLIENTS:
        out["wave"] = ga.wave_plan(m)
        out["stream"] = ga.stream_plan(n, m, sms)
    return out


def b1_case(torch, label, g, rho, flush, sms):
    """B1 at one (N, M): the wrapper on its plan's path, timed with the
    harness's writing flush and with a reading one, then every other path
    of the source held bit for bit to the plain version (per-path times
    are ``tools/grad_agg_forms.py``'s); beside them the plain version,
    ``rho @ g`` (cuBLAS GEMV) and the bound. Returns the max abs error
    and the record of the plan's path."""
    from repro_torch.kernels import grad_agg as ga

    n, m = g.shape
    plan = ga.plan_for(g)
    ref = ga.grad_agg_ref(g, rho)
    out = ga.grad_agg_reduce(g, rho)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref),
          f"grad_agg kernel is not bit-identical to its plain version "
          f"({label}, {plan}): max abs err {err}")
    ms = time_cold_ms(torch, lambda: ga.grad_agg_reduce(g, rho), flush)
    clean_ms = time_cold_ms(torch, lambda: ga.grad_agg_reduce(g, rho), flush,
                            clean=True)
    others = [alt for alt in b1_paths(ga, n, m, sms).values() if alt != plan]
    for alt in others:
        out = ga._launch(g, rho, alt)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"grad_agg on {alt} is not "
              f"bit-identical to its plain version ({label})")
    plain_ms = time_cold_ms(torch, lambda: ga.grad_agg_ref(g, rho), flush,
                            iters=10)
    library_ms = time_cold_ms(torch, lambda: rho @ g, flush)
    # the same bytes through one PyTorch reduction, as the harness's floor
    sum_ms = time_cold_ms(torch, lambda: g.sum(0), flush)
    bound_ms, bound_by = roofline_ms((n + 1) * m * 4 + n * 4, 2 * n * m)
    log(f"[kernels] grad_agg {label} ({n} x {m}; {plan.path} path, "
        f"{plan.grid} blocks): bit-identical, and on "
        f"{', '.join(f'{p.path} ({p.grid} blocks)' for p in others)} too  "
        f"kernel {ms:.4f} ms (clean L2 {clean_ms:.4f})  plain "
        f"{plain_ms:.4f} ms  rho@g {library_ms:.4f} ms  same-bytes floor "
        f"g.sum(0) {sum_ms:.4f} ms  bound {bound_ms:.6f} ms ({bound_by})")
    return err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms)


def phase_agg_kernels(torch):
    """B1, B2 and B3 on the card against their plain versions, bit for
    bit, with times; B1 on each path of its source (``b1_case``); B2 and
    B3 each beside a same-bytes PyTorch cast timed by the same harness
    (``g.to(torch.int8)``, ``q.to(torch.float32)``), printed as the
    harness's floor for that many bytes, not as a call that computes the
    same function. Returns the max abs
    errors and the records at the main path's shape (cut 2, int8)."""
    from repro_torch.compress.channel import client_seeds
    from repro_torch.kernels import _build
    from repro_torch.kernels import quantize as qz

    regs = [ln.strip() for ln in _build.build_log("quantize").splitlines()
            if "registers" in ln or "spill" in ln]
    log("[kernels] quantize ptxas (one line pair per kernel instance): "
        + " | ".join(regs))
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in regs if "spill" in ln),
          "quantize / dequant_agg kernels spill registers")
    report = ptxas_report(_build.build_log("grad_agg"))
    log("[kernels] grad_agg ptxas registers (kernel<N>: registers): "
        + ", ".join(f"{name} {r}" for name, r, _ in report))
    check(report and all(spill == 0 for _, _, spill in report),
          "grad_agg kernels spill registers: "
          + ", ".join(f"{name} {sp} B" for name, _, sp in report if sp))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {"grad_agg": 0.0, "quantize": 0.0, "dequant_agg": 0.0}
    records = {}
    for label, n, t, d, (bt, bd), per_client, b1 in agg_shapes():
        g = torch.randn((n, t, d), generator=gen, device="cuda") * 3.0
        g[0, :bt, :bd] = 0.0  # an all-zero tile
        rho = torch.rand((n,), generator=gen, device="cuda")
        rho = rho / rho.sum()
        m = t * d
        main = label == "paper CNN cut 2"

        if b1:  # eq. 5 over the (N, M) view
            err, rec = b1_case(torch, label, g.view(n, m), rho, flush, sms)
            errs["grad_agg"] = max(errs["grad_agg"], err)
            if main:
                records["grad_agg"] = rec

        floor_b2_ms = time_cold_ms(torch, lambda: g.to(torch.int8), flush)
        for bits in (8, 4):
            # B2: the simulator's form (one seed per client, flat tiles)
            # for the CNN uplinks; one seed, client index hashed, for the
            # rest (the reference kernel's form; codec.encode at N = 1)
            seeds = client_seeds(0xC0FFEE, n, "cuda") if per_client else None
            args = (0xC0FFEE, bits, bt, bd, True, seeds)
            plan = qz.quantize_plan(n, t, d, bt, bd, bits, sms,
                                    aligned=g.data_ptr() % 16 == 0)
            q, sc = qz.quantize_pack(g, *args)
            qr, scr = qz.quantize_ref(g, *args)
            torch.cuda.synchronize()
            check(torch.equal(q, qr) and torch.equal(sc, scr),
                  f"quantize kernel (int{bits}) is not bit-identical to its "
                  f"plain version ({label}): {int((q != qr).sum())} codes, "
                  f"{int((sc != scr).sum())} scales differ")
            check(float(sc[0, 0, 0]) == 1.0, "all-zero tile scale is not 1")
            ms = time_cold_ms(torch, lambda: qz.quantize_pack(g, *args),
                              flush)
            plain_ms = time_cold_ms(torch, lambda: qz.quantize_ref(g, *args),
                                    flush, iters=5)
            qbytes = q.numel()
            bound_ms, bound_by = roofline_ms(
                n * m * 4 + qbytes + sc.numel() * 4, 5 * n * m)
            log(f"[kernels] quantize int{bits} {label} ({n} x {t} x {d}, "
                f"tile {bt}x{bd}; {plan.path} path, {plan.grid} blocks, "
                f"cluster {plan.cluster}, {plan.values} values a thread): "
                f"bit-identical  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                f"  same-bytes floor g.to(int8) {floor_b2_ms:.4f} ms ("
                f"{n * m * 5 / 1e6:.2f} MB)  library: none (no single "
                f"PyTorch call quantizes per tile with a counter hash)  "
                f"bound {bound_ms:.6f} ms ({bound_by})")
            if main and bits == 8:
                records["quantize"] = dict(ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound_ms,
                                           bound_by=bound_by,
                                           library_ms=None)

            # B3: the simulator decodes K payloads as one client-free
            # (1, K, M) view at rho = 1; the LM boundary aggregates N
            if bt == 1:
                qd, sd = q.view(1, n, -1), sc.view(1, n, -1)
                rd = torch.ones(1, device="cuda")
            else:
                qd, sd, rd = q, sc, rho
            dargs = (qd, sd, rd, bits, bt, bd)
            out = qz.dequant_agg_reduce(*dargs)
            dplan = qz.dequant_plan(qd.shape[0], *out.shape, bt, bd, bits,
                                    aligned=qd.data_ptr() % 16 == 0)
            ref = qz.dequant_agg_ref(*dargs)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            check(torch.equal(out, ref),
                  f"dequant_agg kernel (int{bits}) is not bit-identical to "
                  f"its plain version ({label}): max abs err {err}")
            errs["dequant_agg"] = max(errs["dequant_agg"], err)
            ms = time_cold_ms(torch, lambda: qz.dequant_agg_reduce(*dargs),
                              flush)
            plain_ms = time_cold_ms(torch, lambda: qz.dequant_agg_ref(*dargs),
                                    flush, iters=5)
            floor_ms = time_cold_ms(torch, lambda: q.to(torch.float32), flush)
            bound_ms, bound_by = roofline_ms(
                qd.numel() + sd.numel() * 4 + out.numel() * 4,
                3 * qd.shape[0] * out.numel())
            log(f"[kernels] dequant_agg int{bits} {label} (N={qd.shape[0]}, "
                f"out {tuple(out.shape)}; {dplan.path} path, {dplan.grid} "
                f"blocks): bit-identical  kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  same-bytes floor q.to(float32) "
                f"{floor_ms:.4f} ms ({q.numel() * 5 / 1e6:.2f} MB)  "
                f"library: none (no single PyTorch call unpacks int4 and "
                f"scales per tile)  bound {bound_ms:.6f} ms ({bound_by})")
            if main and bits == 8:
                records["dequant_agg"] = dict(ms=ms, plain_ms=plain_ms,
                                              bound_ms=bound_ms,
                                              bound_by=bound_by,
                                              library_ms=None)
        del g, q, qr, out, ref
        torch.cuda.empty_cache()
    # B1's launch floor: one client of 4,096 f32
    g = torch.randn((1, 4096), generator=gen, device="cuda")
    err, _ = b1_case(torch, "launch floor", g, torch.ones(1, device="cuda"),
                     flush, sms)
    errs["grad_agg"] = max(errs["grad_agg"], err)
    return errs, records


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def serve(torch, params, plan, device, codec, recorder=None, spec=SERVE):
    from repro_torch import obs
    from repro_torch.core.serve_engine import ServeEngine, make_requests

    rec = recorder or obs.null_recorder
    with obs.use_recorder(rec):
        engine = ServeEngine(params, plan, slots=spec["slots"],
                             max_len=spec["prompt_len"] + spec["gen"],
                             page_size=spec["page"], codec=codec, seed=0,
                             device=device)
        for r in make_requests(spec["users"], spec["prompt_len"],
                               spec["gen"], vocab_size=plan.cfg.vocab_size,
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
    del engine
    torch.cuda.empty_cache()
    return launches, params, plan


def profile_steps(torch, engine, n=4, prompt_len=SERVE["prompt_len"]):
    """Where a full-width decode step's time goes: a few steps under
    ``torch.profiler`` after the measured run (its counts and times are
    already read). Prints the device's busy share of the wall clock and
    the kernels that took most device time; returns the step's wall and
    busy ms and its kernel count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.serve_engine import make_requests

    for r in make_requests(engine.slots, prompt_len, n + 2,
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
    return dict(wall_ms=wall_ms, busy_ms=dev_ms,
                kernels=sum(e.count for e in kernels) // n)


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


def predicted_launches(scheme, codec, tau=1):
    """B1/B2/B3 launches of one simulator round: sfl_ga aggregates the
    cotangents once per local epoch (B1); an int codec on a split scheme
    encodes and decodes the uplink (all clients in one launch each) and
    the downlink (one broadcast, or all unicasts in one launch) once per
    local epoch (2 x B2, 2 x B3); fl has no cut and runs none."""
    from repro_torch.core.protocol import scheme_spec

    spec = scheme_spec(scheme)
    b1 = tau if spec.gradient_broadcast else 0
    bq = 2 * tau if spec.split and codec != "fp32" else 0
    return {"grad_agg": b1, "quantize": bq, "dequant_agg": bq}


def launch_counts():
    from repro_torch.kernels import grad_agg as ga
    from repro_torch.kernels import quantize as qz

    return {"grad_agg": ga.grad_agg_reduce.launches,
            "quantize": qz.quantize_pack.launches,
            "dequant_agg": qz.dequant_agg_reduce.launches}


def reset_launch_counts():
    from repro_torch.kernels import grad_agg as ga
    from repro_torch.kernels import quantize as qz

    ga.grad_agg_reduce.launches = 0
    qz.quantize_pack.launches = 0
    qz.dequant_agg_reduce.launches = 0


def train_data():
    from repro_torch.data import iid_partition, make_image_dataset

    ds = make_image_dataset("mnist", n=4000, seed=0)
    train, test = ds.split(0.9)
    parts = iid_partition(len(train.x), TRAIN["n_clients"], seed=0)
    return train, test, parts


def make_sim(torch, scheme, codec, device, params=None, seed=0):
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig

    cfg = SimConfig(scheme=scheme, uplink_codec=codec, downlink_codec=codec,
                    **TRAIN)
    return FedSimulator(CONFIG, cfg, seed=seed, device=device, params=params)


def phase_train(torch):
    """The paper's main path on the card: every scheme x codec with exact
    traffic reconciliation and the predicted launch counts, then the long
    sfl_ga/int8 run. Returns the launch counts of the whole phase."""
    from repro_torch import obs
    from repro_torch.data import client_batches
    from repro_torch.obs.ledger import reconcile_events

    train, test, parts = train_data()
    rng = np.random.RandomState(0)
    reset_launch_counts()
    for scheme in ("sfl_ga", "sfl", "psl", "fl"):
        for codec in ("fp32", "int8", "int4"):
            rec = obs.Recorder()
            with obs.use_recorder(rec):
                sim = make_sim(torch, scheme, codec, "cuda")
            before = launch_counts()
            losses = []
            for _ in range(3):
                xs, ys = client_batches(train, parts, TRAIN["batch"], rng)
                losses.append(sim.run_round(xs[:, None], ys[:, None])["loss"])
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in launch_counts().items()}
            want = {k: 3 * v for k, v in
                    predicted_launches(scheme, codec).items()}
            check(got == want, f"{scheme}/{codec}: launches {got}, "
                  f"predicted {want}")
            rows, bad = reconcile_events(rec.events)
            check(len(rows) == 3 and bad == 0,
                  f"{scheme}/{codec}: {bad} of {len(rows)} traffic events do "
                  "not reconcile with sysmodel.traffic")
            check(all(np.isfinite(losses)), f"{scheme}/{codec}: non-finite "
                  f"loss {losses}")
            bits = sim.comm_bits_per_round()
            log(f"[train] {scheme:>6}/{codec}: losses "
                f"{' '.join(f'{x:.4f}' for x in losses)}; "
                f"{bits['total_bits'] / 8e6:.4f} MB/round; launches/round "
                f"B1 {got['grad_agg'] // 3} B2 {got['quantize'] // 3} "
                f"B3 {got['dequant_agg'] // 3}; traffic reconciles")

    sim = make_sim(torch, "sfl_ga", "int8", "cuda")
    acc0 = sim.evaluate(test.x, test.y)
    before = launch_counts()
    times = []
    for _ in range(TRAIN_LONG_ROUNDS):
        xs, ys = client_batches(train, parts, TRAIN["batch"], rng)
        t0 = time.perf_counter()
        out = sim.run_round(xs[:, None], ys[:, None])  # ends in a sync
        times.append(time.perf_counter() - t0)
    got = {k: v - before[k] for k, v in launch_counts().items()}
    want = {k: TRAIN_LONG_ROUNDS * v for k, v in
            predicted_launches("sfl_ga", "int8").items()}
    check(got == want, f"long run: launches {got}, predicted {want}")
    acc = sim.evaluate(test.x, test.y)
    check(np.isfinite(out["loss"]), "long run: non-finite loss")
    check(acc > 1.5 / 10, f"test accuracy {acc:.3f} after "
          f"{TRAIN_LONG_ROUNDS} rounds is not above chance (0.1)")
    ms = sorted(1e3 * t for t in times)
    p50, p99 = obs.percentile(ms, 0.5), obs.percentile(ms, 0.99)
    mb = sim.comm_bits_per_round()["total_bits"] / 8e6
    log(f"[train] sfl_ga/int8 paper CNN full width, {TRAIN_LONG_ROUNDS} "
        f"rounds: round p50 {p50:.3f} ms p99 {p99:.3f} ms (first "
        f"{times[0] * 1e3:.1f} ms), {len(times) / sum(times):.1f} "
        f"rounds/s; test accuracy {acc0:.3f} -> {acc:.3f}; last loss "
        f"{out['loss']:.4f}; {mb:.4f} MB/round "
        f"[{torch.cuda.get_device_name(0)}]")
    profile_rounds(torch, sim, train, parts, rng)
    return launch_counts()


def profile_rounds(torch, sim, train, parts, rng, n=5):
    """Where a full-width training round's time goes: a few rounds under
    ``torch.profiler`` after the measured run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import client_batches

    batches = [client_batches(train, parts, TRAIN["batch"], rng)
               for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for xs, ys in batches:
            sim.run_round(xs[:, None], ys[:, None])
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    log(f"[profile] {n} sfl_ga/int8 rounds: wall {wall_ms:.3f} ms/round "
        f"(profiled), device busy {dev_ms:.3f} ms/round "
        f"({100 * dev_ms / wall_ms:.1f} % of wall), "
        f"{sum(e.count for e in kernels) // n} kernels/round")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:8.4f} ms/round "
            f"{e.count // n:5d} calls/round  {e.key[:90]}")
    cpu_ops = sorted((e for e in events if e.device_type != DeviceType.CUDA),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    log("[profile] host self time/round: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / n:.2f} ms "
        f"({e.count // n} calls)" for e in cpu_ops))


def phase_train_card_vs_cpu(torch):
    """3 rounds of sfl_ga at fp32 and int8, full width, from the same
    params and batches on the card (kernels) and the CPU (plain
    versions); for int8 the card's channels are also replayed on the CPU
    from the card's own inputs, bit for bit."""
    from repro_torch.compress import broadcast_channel, uplink_channel
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.data import client_batches
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

    train, _, parts = train_data()
    params = cnn.init_cnn(torch.Generator().manual_seed(7), CONFIG)
    rng = np.random.RandomState(1)
    batches = [client_batches(train, parts, TRAIN["batch"], rng)
               for _ in range(3)]
    for codec, (loss_rtol, param_atol) in TRAIN_TOL.items():
        sims = {dev: make_sim(torch, "sfl_ga", codec, dev, params=params)
                for dev in ("cuda", "cpu")}
        wire = []
        proto = sims["cuda"].proto
        up, down = proto.encode_uplink, proto.downlink_cotangent

        def spy_up(smashed, seed):
            out = up(smashed, seed)
            wire.append(("up", smashed.cpu(), None, seed, out.cpu()))
            return out

        def spy_down(s_n, w, seed):
            out = down(s_n, w, seed)
            wire.append(("down", s_n.cpu(), w.cpu(), seed, out.cpu()))
            return out

        proto.encode_uplink, proto.downlink_cotangent = spy_up, spy_down
        sims["again"] = make_sim(torch, "sfl_ga", codec, "cuda",
                                 params=params)
        losses = {dev: [sim.run_round(xs[:, None], ys[:, None])["loss"]
                        for xs, ys in batches] for dev, sim in sims.items()}
        check(losses["again"] == losses["cuda"] and all(
            torch.equal(a[k], b[k])
            for side in ("client", "server")
            for a, b in zip(sims["cuda"].state[side],
                            sims["again"].state[side]) for k in a),
            f"train {codec}: two runs on the card differ")
        for a, b in zip(losses["cuda"], losses["cpu"]):
            check(abs(a - b) <= loss_rtol * abs(b),
                  f"train {codec}: losses differ: card {losses['cuda']}, "
                  f"cpu {losses['cpu']}")
        err = 0.0
        for side in ("client", "server"):
            for gb, cb in zip(sims["cuda"].state[side],
                              sims["cpu"].state[side]):
                for k in gb:
                    err = max(err, float((gb[k].cpu() - cb[k]).abs().max()))
        check(err <= param_atol, f"train {codec}: params differ by up to "
              f"{err} (tolerance {param_atol})")
        replayed = 0
        if codec != "fp32":
            codec_ = proto.uplink
            for leg, x, w, seed, out in wire:
                if leg == "up":
                    want = uplink_channel(codec_, x, seed)
                else:
                    want = broadcast_channel(codec_, ops.grad_agg(x, w),
                                             seed)
                check(torch.equal(out[0] if leg == "down" else out, want),
                      f"train {codec}: the card's {leg}link differs from "
                      f"the CPU's plain versions on the same inputs")
                replayed += 1
        log(f"[train-card-vs-cpu] sfl_ga/{codec} full width, 3 rounds: "
            f"losses card {' '.join(f'{x:.6f}' for x in losses['cuda'])} "
            f"/ cpu {' '.join(f'{x:.6f}' for x in losses['cpu'])} (rtol "
            f"{loss_rtol}); params max abs diff {err:.3e} (tolerance "
            f"{param_atol}); a second card run bit-identical"
            + (f"; {replayed} channel calls replayed on the CPU bit for bit"
               if replayed else ""))


def ssd_bound_ms(b, h, g, c, Q, P, N):
    """B5's least time: each input read once and each output written once
    (B and C per group) against its tensor-core work. The flops these
    shapes need are the lower triangles of C B^T (2N each) and of the
    score-weighted sum of xdt (2P each), and the chunk state (2PN per
    position); the 3xTF32 split issues three TF32 products per product,
    so 3 x the flops over the TF32 rate. Also returns the f32-SIMT figure
    (the flops over the plain f32 rate), which bounds a kernel without
    tensor cores."""
    byts = 4 * (2 * b * h * c * Q * P + b * h * c * Q + 2 * b * g * c * Q * N
                + b * h * c * P * N)
    flops = b * h * c * (Q * (Q + 1) * (N + P) + 2 * Q * P * N)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, 3 * flops / TF32_FLOP_PER_S
    simt_ms, _ = roofline_ms(byts, flops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", simt_ms)


def flash_flops(B, hq, S, D, window):
    """4D flops (q.k and p.v) per query head for each key the masks let
    through (causal, and the window where there is one)."""
    keys = sum(min(i + 1, window or i + 1) for i in range(S))
    return 4 * D * B * hq * keys


def flash_bound_ms(B, hq, hkv, S, D, window):
    """B4's least time: q, k, v read once and out written once against
    its tensor-core work -- the 3xTF32 split issues three TF32 products
    per product, so 3 x the flops over the TF32 rate. Also returns the
    f32-SIMT figure (the flops over the plain f32 rate), which bounds a
    kernel without tensor cores."""
    byts = 4 * (2 * B * hq * S * D + 2 * B * hkv * S * D)
    flops = flash_flops(B, hq, S, D, window)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, 3 * flops / TF32_FLOP_PER_S
    simt_ms, _ = roofline_ms(byts, flops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", simt_ms)


def phase_lm_kernels(torch):
    """B5 and B4 on the card against their plain versions, with times and
    bounds. Returns the max abs errors and the records at the main
    paths' shapes (B5: the SSM serve prompt's head; B4: granite-8b's
    full-sequence forward)."""
    from repro_torch.kernels import _build

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, records = {}, {}

    regs = [ln.strip() for ln in _build.build_log("ssd_scan").splitlines()
            if "registers" in ln or "spill" in ln]
    log("[kernels] ssd_scan ptxas (one line pair per N x P bucket): "
        + " | ".join(regs))
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in regs if "spill" in ln),
          "ssd kernel spills registers")

    # (label, b, h, g, c, Q, P, N): mamba2-130m's 24 heads of 64, one
    # group, state 128, chunk 128
    for label, b, h, g, c, Q, P, N in (
            ("SSM serve prompt head", 1, 24, 1, 2, 128, 64, 128),
            ("LM forward", 4, 24, 1, 8, 128, 64, 128)):
        err, rec = ssd_case(torch, label, b, h, g, c, Q, P, N, gen, flush,
                            sms)
        errs["ssd"] = max(errs.get("ssd", 0.0), err)
        if label == "SSM serve prompt head":
            records["ssd"] = rec

    regs = [ln.strip() for ln in _build.build_log("flash_attention")
            .splitlines() if "registers" in ln or "spill" in ln]
    log("[kernels] flash_attention ptxas (one line pair per head_dim / 8): "
        + " | ".join(regs))
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in regs if "spill" in ln),
          "flash attention kernel spills registers")
    # (label, B, Hq, Hkv, S, D, window)
    for label, B, hq, hkv, S, D, window in (
            ("granite-8b S=2048", 1, 32, 8, 2048, 128, None),
            ("windowed D=64", 1, 8, 2, 512, 64, 128)):
        err, rec = flash_case(torch, label, B, hq, hkv, S, D, window, gen,
                              flush)
        errs["flash"] = max(errs.get("flash", 0.0), err)
        if label == "granite-8b S=2048":
            records["flash"] = rec
    torch.cuda.empty_cache()
    return errs, records


# phase 3d's G1 cases: (label, form, batch, M, K, N) of Y (M, N) = X (M, K)
# W, batch None for 2-d operands; the batched ones are granite-4.0-h's
# experts as the MoE layer runs them (the server's 9 held experts at C
# 712, the 4 clients' 36 at C 178), timed against torch.bmm
GEMM_CASES = [
    ("granite-8b gate/up", "y", None, 4096, 4096, 14336),
    ("granite-8b gate/up", "dx", None, 4096, 4096, 14336),
    ("granite-8b gate/up", "dw", None, 4096, 4096, 14336),
    ("granite-8b head", "y", None, 4096, 4096, 49152),
    ("mamba2-130m in_proj", "y", None, 8192, 768, 3352),
] + [(f"granite-4.0-h {who} experts {prod}", form, batch, C, K, N)
     for who, batch, C in (("server", 9, 712), ("client", 36, 178))
     for prod, K, N in (("gate/up", 4096, 768), ("down", 768, 4096))
     for form in ("y", "dx", "dw")]


def gemm_bound_ms(M, K, N, batch=1):
    """G1's least time: its three TF32 products a product on the tensor
    cores (3 x 2MNK over the TF32 rate), against its operands read once
    and its output written once. Also returns the f32-SIMT figure."""
    byts = 4 * batch * (M * K + K * N + M * N)
    flops = 2 * batch * M * K * N
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, 3 * flops / TF32_FLOP_PER_S
    simt_ms, _ = roofline_ms(byts, flops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", simt_ms)


def phase_gemm(torch):
    """Phase 3d: G1 at the main path's shapes, the experts' batched
    products against ``torch.bmm``. Returns the record at granite-8b's
    gate/up forward."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm as gm

    regs = [ln.strip() for ln in _build.build_log("gemm").splitlines()
            if "registers" in ln or "spill" in ln]
    log("[kernels] gemm ptxas (one line pair per operand layout): "
        + " | ".join(regs))
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in regs if "spill" in ln), "gemm kernel spills registers")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(32)
    record = None
    for label, form, batch, M, K, N in GEMM_CASES:
        lead = () if batch is None else (batch,)

        def randn(*shape):
            return torch.randn(lead + shape, generator=gen, device="cuda")

        x, w = randn(M, K), randn(K, N)
        a, b = {"y": (x, w), "dx": (randn(M, N), w),
                "dw": (x, randn(M, N))}[form]
        del x, w
        c = gm.gemm(a, b, form)
        ref = gm.gemm_ref(a.double(), b.double(), form)
        f32 = gm.gemm_ref(a, b, form)
        err = float((c.double() - ref).norm() / ref.norm())
        err32 = float((f32.double() - ref).norm() / ref.norm())
        max_err = float((c.double() - ref).abs().max())
        check(err <= 3 * err32, f"gemm {label} {form}: normwise error "
              f"{err:.3e} against cuBLAS f32's {err32:.3e}")
        del c, ref, f32
        ms = time_cold_ms(torch, lambda: gm.gemm(a, b, form), flush,
                          iters=10)
        plain_ms = time_cold_ms(torch, lambda: gm.gemm_ref(a, b, form),
                                flush, iters=10)
        mm, name = (torch.matmul, "torch.matmul") if batch is None else \
            (torch.bmm, "torch.bmm")
        lib = {"y": lambda: mm(a, b),
               "dx": lambda: mm(a, b.transpose(-1, -2)),
               "dw": lambda: mm(a.transpose(-1, -2), b)}[form]
        library_ms = time_cold_ms(torch, lib, flush, iters=10)
        n = batch or 1
        bms, by, simt_ms = gemm_bound_ms(M, K, N, n)
        flops = 2 * n * M * K * N
        log(f"[kernels] gemm {label} {form} (batch {n}, M {M}, K {K}, N "
            f"{N}): normwise err {err:.3e} (cuBLAS f32 {err32:.3e})  kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{library_ms / ms:.3f}x {name})  plain {plain_ms:.4f} ms  "
            f"library {library_ms:.4f} ms ({name} f32, "
            f"{flops / library_ms / 1e9:.1f} TFLOP/s)  bound {bms:.4f} ms "
            f"({by}, 3xTF32 on the tensor cores; f32 SIMT figure "
            f"{simt_ms:.4f} ms)")
        if record is None:
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by, library_ms=library_ms,
                          max_err=max_err)
        del a, b
    torch.cuda.empty_cache()
    return record


# phase 3e's M1 cases: (label, clients, tokens a client)
COMBINE_CASES = [("granite-4.0-h server", 1, 4096),
                 ("granite-4.0-h clients (vmap)", 4, 1024)]
COMBINE_CONFIG = dict(d=4096, experts=72, top_k=10, held=9,
                      capacity_factor=1.25)
COMBINE_TOL = 2e-6  # of sum_j |g_j ye_j|: two sums of <= 10 f32 roundings
# of sum_i |dy_i ye_i| against float64: <dy, ye> over 4,096 products is
# summed along at most 29 f32 roundings (16 fmaf in a thread, 5 shuffles,
# 8 warps), 29 u < 2e-6
COMBINE_DGATES_TOL = 2e-6


def combine_bytes(T, k, R, d, kept, tokens_kept):
    """M1's least bytes: forward reads the kept rows and the slots and
    gates and writes y; backward reads dy once a token with a kept pair
    and ye once a kept pair, the slots and gates, writes every row of
    dye and dgates."""
    fwd = 4 * d * (kept + T) + 12 * T * k
    bwd = 4 * d * (tokens_kept + kept + R) + 16 * T * k
    return fwd, bwd


def combine_routing(torch, clients, T, seed):
    """ye (R, d) rows and the (T, k) slots and gates of ``clients``
    routings, folded as the op's ``vmap`` rule folds them."""
    from repro_torch.configs import MoEConfig
    from repro_torch.models import moe

    c = COMBINE_CONFIG
    m = MoEConfig(num_experts=c["experts"], top_k=c["top_k"],
                  d_ff_expert=8, capacity_factor=c["capacity_factor"],
                  experts_held=c["held"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    router = {"w": torch.randn(c["d"], c["experts"], generator=gen,
                               device="cuda") / c["d"] ** 0.5}
    Cg = moe._capacity(m, T)
    R = c["held"] * Cg
    slots, gates = [], []
    with torch.no_grad():
        for b in range(clients):
            x = torch.randn(T, c["d"], generator=gen, device="cuda")
            _, s, g, _, _ = moe._dispatch({"router": router}, m, x, Cg)
            slots.append(torch.where(s < R, s + b * R, clients * R))
            gates.append(g)
    rows = torch.randn(clients * R, c["d"], generator=gen, device="cuda")
    return rows, torch.cat(slots), torch.cat(gates)


def phase_moe_combine(torch):
    """Phase 3e: M1 at the main path's shapes. Returns the record at the
    server's shape."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_combine as mc

    regs = [ln.strip() for ln in _build.build_log("moe_combine").splitlines()
            if "registers" in ln or "spill" in ln]
    log("[kernels] moe_combine ptxas: " + " | ".join(regs))
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in regs if "spill" in ln),
          "moe_combine kernel spills registers")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    record = None
    for label, clients, T in COMBINE_CASES:
        rows, slot, gates = combine_routing(torch, clients, T, 35)
        R, d = rows.shape
        Tk, k = slot.shape
        kept = int((slot < R).sum())
        tokens_kept = int((slot < R).any(1).sum())
        dy = torch.randn(Tk, d, device="cuda")
        y = mc.moe_combine(rows, slot, gates)
        y_ref = mc.moe_combine_ref(rows, slot, gates)
        scale = mc.moe_combine_ref(rows.abs(), slot, gates.abs())
        err = float(((y - y_ref).abs() / scale.clamp_min(1e-30)).max())
        check(err <= COMBINE_TOL, f"moe_combine {label}: y off the plain "
              f"version by {err:.3e} of the sum of |terms|")
        dye, dgates = mc.moe_combine_grad(dy, rows, slot, gates)
        dye_ref, dgates_ref = mc.moe_combine_grad_ref(dy, rows, slot, gates)
        check(torch.equal(dye, dye_ref), f"moe_combine {label}: dye is not "
              f"the plain version's bit for bit")
        dg_err = float((dgates - dgates_ref).abs().max())
        # dgates against float64, per pair, over sum_i |dy_i ye_i|; exact
        # zeros for the skipped pairs
        dg_want = mc.moe_combine_grad_ref(dy.double(), rows.double(), slot,
                                          gates.double())[1]
        dg_scale = mc.moe_combine_grad_ref(dy.double().abs(),
                                           rows.double().abs(), slot,
                                           gates.double())[1]
        dg_rel = float(((dgates.double() - dg_want).abs()
                        / dg_scale.clamp_min(1e-300)).max())
        check(dg_rel <= COMBINE_DGATES_TOL, f"moe_combine {label}: dgates "
              f"off float64 by {dg_rel:.3e} of the sum of |dy ye|")
        check(bool((dgates[slot == R] == 0).all()), f"moe_combine {label}: "
              f"a skipped pair's dgates is not 0")
        del y, y_ref, scale, dye, dye_ref, dgates, dgates_ref, dg_want, \
            dg_scale

        def expression():  # the layer's combine before M1, through autograd
            ye = rows.detach().requires_grad_(True)
            g = gates.detach().requires_grad_(True)
            out = mc.moe_combine_ref(ye, slot, g)
            torch.autograd.grad(out, (ye, g), dy)

        fwd_ms = time_cold_ms(torch, lambda: mc.moe_combine(rows, slot, gates),
                              flush, iters=20)
        bwd_ms = time_cold_ms(torch, lambda: mc.moe_combine_grad(
            dy, rows, slot, gates), flush, iters=20)
        plain_fwd = time_cold_ms(torch, lambda: mc.moe_combine_ref(
            rows, slot, gates), flush, iters=5)
        plain_bwd = time_cold_ms(torch, lambda: mc.moe_combine_grad_ref(
            dy, rows, slot, gates), flush, iters=5)
        library_ms = time_cold_ms(torch, expression, flush, iters=5)
        fb, bb = combine_bytes(Tk, k, R, d, kept, tokens_kept)
        bound_f, bound_b = fb / HBM_BYTES_PER_S * 1e3, bb / HBM_BYTES_PER_S \
            * 1e3
        log(f"[kernels] moe_combine {label} (T {Tk}, k {k}, R {R}, d {d}, "
            f"{kept} kept, {tokens_kept} tokens with one): y err {err:.3e} "
            f"of sum |terms|, dgates {dg_rel:.3e} of sum |dy ye| off float64 "
            f"(max abs diff from the plain version {dg_err:.3e}), dye bit "
            f"for bit; kernel fwd {fwd_ms:.4f} "
            f"ms (bound {bound_f:.4f}, {100 * bound_f / fwd_ms:.1f} %), "
            f"bwd {bwd_ms:.4f} ms (bound {bound_b:.4f}, "
            f"{100 * bound_b / bwd_ms:.1f} %); plain fwd {plain_fwd:.4f} "
            f"ms, bwd {plain_bwd:.4f} ms; library {library_ms:.4f} ms "
            f"(flat[slot] + einsum, forward and backward through autograd; "
            f"{library_ms / (fwd_ms + bwd_ms):.1f}x the kernel's two)")
        if record is None:
            record = dict(ms=fwd_ms + bwd_ms, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                          plain_ms=plain_fwd + plain_bwd,
                          bound_ms=bound_f + bound_b, bound_by="bytes",
                          library_ms=library_ms, max_err=err)
        del rows, slot, gates, dy
    torch.cuda.empty_cache()
    return record


# phase 3f's M2 cases: (label, clients, tokens a client)
COUNT_CASES = [("granite-4.0-h server", 1, 4096),
               ("granite-4.0-h clients (vmap fold)", 4, 1024)]


def count_routes(torch, clients, T, seed):
    """The (clients T, k) expert ids of ``clients`` routings of T tokens
    each through granite-4.0-h-small's router on random tokens, folded
    as the op's ``vmap`` rule folds them (client b's ids + b E), and the
    folded expert count."""
    from repro_torch.configs import MoEConfig
    from repro_torch.models import moe

    c = COMBINE_CONFIG
    m = MoEConfig(num_experts=c["experts"], top_k=c["top_k"],
                  d_ff_expert=8, capacity_factor=c["capacity_factor"],
                  experts_held=c["held"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    router = {"w": torch.randn(c["d"], c["experts"], generator=gen,
                               device="cuda") / c["d"] ** 0.5}
    ids = []
    with torch.no_grad():
        for b in range(clients):
            x = torch.randn(T, c["d"], generator=gen, device="cuda")
            ids.append(moe.route({"router": router}, m, x)[0]
                       + b * c["experts"])
    return torch.cat(ids).contiguous(), clients * c["experts"]


def phase_moe_count(torch):
    """Phase 3f: M2 at the main path's shapes. Returns the record at the
    server's shape."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_count as mcount

    regs = [ln.strip() for ln in _build.build_log("moe_count").splitlines()
            if "registers" in ln or "spill" in ln]
    log("[kernels] moe_count ptxas: " + " | ".join(regs))
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in regs if "spill" in ln),
          "moe_count kernel spills registers")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    record = None
    for label, clients, T in COUNT_CASES:
        ids, E = count_routes(torch, clients, T, 37)
        P = ids.numel()
        pos = mcount.moe_positions(ids, E)
        check(torch.equal(pos, mcount.moe_positions_ref(ids, E)),
              f"moe_count {label}: positions are not the plain version's")
        hits = (ids.reshape(-1)[:, None] == torch.arange(
            E, device="cuda")).to(torch.int32)
        ms = time_cold_ms(torch, lambda: mcount.moe_positions(ids, E), flush)
        plain_ms = time_cold_ms(torch, lambda: mcount.moe_positions_ref(
            ids, E), flush, iters=10)
        library_ms = time_cold_ms(torch, lambda: torch.cumsum(
            hits, dim=0, dtype=torch.int32), flush, iters=10)
        bound_ms = 12 * P / HBM_BYTES_PER_S * 1e3
        log(f"[kernels] moe_count {label} (P {P}, E {E}): positions bit "
            f"for bit; kernel {ms:.4f} ms (bound {bound_ms:.6f}, "
            f"{100 * bound_ms / ms:.2f} %); plain {plain_ms:.4f} ms; "
            f"library {library_ms:.4f} ms (torch.cumsum over dim 0 of the "
            f"(P, E) int32 one-hot alone; {library_ms / ms:.0f}x the "
            f"kernel)")
        if record is None:
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by="bytes", library_ms=library_ms)
        del ids, pos, hits
    torch.cuda.empty_cache()
    return record


def ssd_case(torch, label, b, h, g, c, Q, P, N, gen, flush, sms):
    """B5 at one shape on random inputs: held to its plain version, timed
    beside it, with its bound. Returns the max abs error and the
    record."""
    from repro_torch.kernels import ssd_scan as ss

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    args = (randn(b, h, c, Q, P),
            -0.5 * torch.rand((b, h, c, Q), generator=gen, device="cuda"),
            randn(b, g, c, Q, N), randn(b, g, c, Q, N))
    y, st = ss.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    yr, str_ = ss.ssd_intra_chunk_ref(*args)
    err, shares = 0.0, []
    for out, ref in ((y, yr), (st, str_)):
        e = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        check(e <= SSD_REL_TOL * scale,
              f"ssd kernel disagrees with its plain version ({label}): "
              f"max abs err {e} against {SSD_REL_TOL} x {scale}")
        err = max(err, e)
        shares.append(e / scale)
    ms = time_cold_ms(torch, lambda: ss.ssd_intra_chunk(*args), flush)
    plain_ms = time_cold_ms(torch, lambda: ss.ssd_intra_chunk_ref(*args),
                            flush, iters=10)
    bms, by, simt_ms = ssd_bound_ms(b, h, g, c, Q, P, N)
    log(f"[kernels] ssd_intra_chunk {label} ({b}, {h}, {c}, {Q}, {P}), "
        f"N={N}, g={g}: max_abs_err {err:.3e} (y {shares[0]:.2e}, state "
        f"{shares[1]:.2e} of max|ref|; tolerance {SSD_REL_TOL})  kernel "
        f"{ms:.4f} ms ({ms / plain_ms:.3f} x plain)  plain {plain_ms:.4f} "
        f"ms  library: none (no single PyTorch call computes the SSD "
        f"chunk)  bound {bms:.6f} ms ({by}, 3xTF32 on the tensor cores; "
        f"f32 SIMT figure {simt_ms:.6f} ms); {b * h * c} chunks on {sms} "
        f"SMs")
    return err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None)


def flash_case(torch, label, B, hq, hkv, S, D, window, gen, flush):
    """B4 at one shape on random inputs: held to its plain version, timed
    beside it and one SDPA call, with its bound. Returns the max abs
    error and the record."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v = randn(B, hq, S, D), randn(B, hkv, S, D), randn(B, hkv, S, D)
    out = fa.flash_attention_bhsd(q, k, v, window)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, window)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=FLASH_TOL, rtol=FLASH_TOL),
          f"flash attention kernel disagrees with its plain version "
          f"({label}): max abs err {err}")
    ms = time_cold_ms(torch, lambda: fa.flash_attention_bhsd(
        q, k, v, window), flush, iters=20)
    plain_ms = time_cold_ms(torch, lambda: fa.flash_attention_ref(
        q, k, v, window), flush, iters=5)
    # yardstick: one SDPA call, f32, with the GQA head repeat (and the
    # window's mask) made before the timing
    ke = k.repeat_interleave(hq // hkv, dim=1).contiguous()
    ve = v.repeat_interleave(hq // hkv, dim=1).contiguous()
    if window is None:
        def sdpa():
            return F.scaled_dot_product_attention(q, ke, ve, is_causal=True)
    else:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                             - window)

        def sdpa():
            return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
    sdpa_err = float((sdpa() - ref).abs().max())
    library_ms = time_cold_ms(torch, sdpa, flush, iters=20)
    bms, by, simt_ms = flash_bound_ms(B, hq, hkv, S, D, window)
    tflops = flash_flops(B, hq, S, D, window) / (ms * 1e-3) / 1e12
    log(f"[kernels] flash_attention {label} (B {B}, {hq}/{hkv} heads, "
        f"S {S}, D {D}, window {window}): max_abs_err {err:.3e}  kernel "
        f"{ms:.4f} ms ({tflops:.1f} TFLOP/s of f32-accurate work; "
        f"{ms / library_ms:.3f} x sdpa)  plain {plain_ms:.4f} ms  sdpa "
        f"{library_ms:.4f} ms (its max abs diff from the plain version "
        f"{sdpa_err:.1e})  bound {bms:.6f} ms ({by}, 3xTF32 on the "
        f"tensor cores; f32 SIMT figure {simt_ms:.6f} ms)")
    return err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=library_ms)


def phase_ssm_serve(torch):
    """mamba2-130m at full width through the split server: B5 launches
    24 x the admitted prefills, traffic reconciles, then a profile."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import lm
    from repro_torch.obs.ledger import reconcile_events

    cfg = get_config("mamba2-130m")
    plan = lm.build_plan(cfg, 1)
    params = lm.init_lm(0, plan, torch.float32, "cuda")
    rec = obs.Recorder()
    ss.ssd_intra_chunk.launches = 0
    qz.quantize_pack.launches = qz.dequant_agg_reduce.launches = 0
    engine, _ = serve(torch, params, plan, "cuda", SSM_SERVE["codec"], rec,
                      SSM_SERVE)
    launches = ss.ssd_intra_chunk.launches
    b2, b3 = qz.quantize_pack.launches, qz.dequant_agg_reduce.launches
    decode_steps = len(engine.step_latencies_s)
    check(len(engine.completions) == SSM_SERVE["users"] and all(
        c.num_tokens == SSM_SERVE["gen"] for c in engine.completions),
        "SSM serve: not every request completed with its token budget")
    n_ssm = sum(g.repeat * len(g.period) for g in lm.all_groups(plan))
    check(launches == n_ssm * SSM_SERVE["users"],
          f"SSM serve: B5 launched {launches} times, expected {n_ssm} "
          f"layers x {SSM_SERVE['users']} prefills")
    # one B2 and one B3 a step and a prefill: the int8 boundary codec
    check(b2 == b3 == decode_steps + SSM_SERVE["users"],
          f"SSM serve: B2/B3 launched {b2}/{b3} times, expected "
          f"{decode_steps} decode steps + {SSM_SERVE['users']} prefills")
    rows, bad = reconcile_events(rec.events)
    check(rows and bad == 0, f"SSM serve: {bad} of {len(rows)} traffic "
          "events do not reconcile with sysmodel.traffic")
    check(bool(torch.isfinite(engine.last_logits).all()),
          "SSM serve: non-finite logits")
    s = engine.summary()
    steps_ms = sorted(1e3 * t for t in engine.step_latencies_s)
    log(f"[ssm-serve] mamba2-130m full width, {cfg.num_layers} layers: "
        f"{s['users']} users, {s['tokens']} tokens, {s['steps']} steps "
        f"({decode_steps} decode), {s['tok_per_s']:.1f} tok/s; step p50 "
        f"{obs.percentile(steps_ms, 0.5):.2f} ms p99 "
        f"{obs.percentile(steps_ms, 0.99):.2f} ms; B5 {launches} launches, "
        f"B2/B3 {b2}/{b3}; {len(rows)} traffic events reconcile "
        f"[{torch.cuda.get_device_name(0)}]")
    profile_prefill(torch, engine)
    profile_steps(torch, engine, prompt_len=SSM_SERVE["prompt_len"])
    del engine, params
    torch.cuda.empty_cache()
    return launches


def profile_prefill(torch, engine, reps=3):
    """A full-width SSM prefill: its time at prompt 320 (two chunks through
    B5 and a 64-token sequential tail) against 256 (the chunks alone), and
    one 320-token prefill under ``torch.profiler``: device busy share and
    B5's share of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(2)
    P = SSM_SERVE["prompt_len"]
    Q = engine.cfg.ssm.chunk_size
    toks = torch.as_tensor(rng.randint(0, engine.cfg.vocab_size, (1, P)),
                           device="cuda")

    def timed(n_tok):
        engine._prefill(toks[:, :n_tok], 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._prefill(toks[:, :n_tok], 0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    head = (P // Q) * Q
    ms_full, ms_head = timed(P), timed(head)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine._prefill(toks, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    b5_ms = sum(e.self_device_time_total for e in kernels
                if "ssd_chunk_kernel" in e.key) / 1e3
    log(f"[profile] SSM prefill of {P} tokens: {ms_full:.2f} ms; of {head} "
        f"(chunks only) {ms_head:.2f} ms, so the {P - head}-token "
        f"sequential tail costs {ms_full - ms_head:.2f} ms; profiled: wall "
        f"{wall_ms:.2f} ms, device busy {dev_ms:.3f} ms "
        f"({100 * dev_ms / wall_ms:.1f} % of wall), "
        f"{sum(e.count for e in kernels)} kernels, B5 {b5_ms:.3f} ms "
        f"({100 * b5_ms / max(dev_ms, 1e-9):.1f} % of device time)")


def phase_ssm_card_vs_cpu(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=2)
    plan = lm.build_plan(cfg, 1)
    params = lm.init_lm(1, plan, torch.float32, "cuda")
    cpu_params = tree_to(params, "cpu")
    codec = SSM_CHECK["codec"]
    gpu, gpu_logits = serve(torch, params, plan, "cuda", codec,
                            spec=SSM_CHECK)
    t0 = time.perf_counter()
    cpu, cpu_logits = serve(torch, cpu_params, plan, "cpu", codec,
                            spec=SSM_CHECK)
    cpu_s = time.perf_counter() - t0
    err = float((gpu_logits - cpu_logits).abs().max())
    check(torch.allclose(gpu_logits, cpu_logits, atol=LOGITS_ATOL,
                         rtol=LOGITS_RTOL),
          f"SSM first-step logits: card and CPU differ by up to {err}")
    streams = [{c.uid: c.tokens for c in e.completions} for e in (gpu, cpu)]
    check(streams[0] == streams[1],
          "SSM: card and CPU greedy token streams differ")
    top2 = cpu_logits.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    log(f"[ssm-card-vs-cpu] mamba2-130m width, 2 layers, prompt "
        f"{SSM_CHECK['prompt_len']}: {len(streams[0])} identical greedy "
        f"streams; first-step logits max abs diff {err:.3e} (tolerance "
        f"{LOGITS_ATOL}); smallest first-step top-2 margin {margin:.3e}; "
        f"CPU run {cpu_s:.1f} s")


def lm_forward(torch, params, plan, toks, labels, impl, reps=2):
    """(logits, loss, ms per forward) of client_forward -> server_forward
    under no_grad; the time is the mean of ``reps`` runs after a warm-up,
    host clock around work that ends in a synchronise."""
    from repro_torch.models import lm

    def run():
        with torch.no_grad():
            sm, _ = lm.client_forward(params, plan, toks, impl=impl)
            logits, _ = lm.server_forward(params, plan, sm, impl=impl)
            return logits, lm.cross_entropy(logits, labels)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        logits, loss = run()
    torch.cuda.synchronize()
    return logits, float(loss), (time.perf_counter() - t0) * 1e3 / reps


def phase_lm_forward(torch, granite_params, granite_plan):
    """The split LM's forward with impl="flash" at full width: B4 on
    granite-8b (phase 4's weights), B5 on mamba2-130m. Returns the
    launches of each kernel in its model's flash forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import lm

    out = {}
    for arch, counter in (("granite-8b", fa.flash_attention_bhsd),
                          ("mamba2-130m", ss.ssd_intra_chunk)):
        if arch == "granite-8b":
            params, plan = granite_params, granite_plan
        else:
            plan = lm.build_plan(get_config(arch), 1)
            params = lm.init_lm(2, plan, torch.float32, "cuda")
        B, S = LM_FORWARD[arch]
        gen = torch.Generator(device="cuda").manual_seed(6)
        toks = torch.randint(0, plan.cfg.vocab_size, (B, S), generator=gen,
                             device="cuda")
        labels = torch.randint(0, plan.cfg.vocab_size, (B, S),
                               generator=gen, device="cuda")
        counter.launches = 0
        with torch.no_grad():
            total, (loss, _) = lm.lm_loss(params, plan, toks, labels,
                                          impl="flash")
        torch.cuda.synchronize()
        launches = counter.launches
        n_layers = plan.cfg.num_layers
        check(launches == n_layers, f"{arch} LM forward: the kernel "
              f"launched {launches} times, expected one per layer "
              f"({n_layers})")
        check(np.isfinite(float(loss)) and float(total) == float(loss),
              f"{arch} LM forward: loss {float(loss)}, total "
              f"{float(total)}")
        flash, flash_loss, flash_ms = lm_forward(torch, params, plan, toks,
                                                 labels, "flash")
        plain, plain_loss, plain_ms = lm_forward(torch, params, plan, toks,
                                                 labels, "jnp")
        err = float((flash - plain).abs().max())
        check(torch.allclose(flash, plain, atol=LM_LOGITS_TOL,
                             rtol=LM_LOGITS_TOL),
              f"{arch} LM forward: flash and jnp logits differ by {err}")
        check(abs(flash_loss - plain_loss) <= LM_LOSS_RTOL * abs(plain_loss),
              f"{arch} LM forward: flash loss {flash_loss}, jnp "
              f"{plain_loss}")
        log(f"[lm-forward] {arch} full width, {n_layers} layers, B {B} S "
            f"{S}: loss {flash_loss:.6f} (jnp {plain_loss:.6f}); logits max "
            f"abs diff flash vs jnp {err:.3e} (tolerance {LM_LOGITS_TOL}); "
            f"{launches} kernel launches; forward {flash_ms:.1f} ms with "
            f"impl=flash, {plain_ms:.1f} ms with impl=jnp "
            f"[{torch.cuda.get_device_name(0)}]")
        out[arch] = launches
        del flash, plain
        if arch != "granite-8b":
            del params
        torch.cuda.empty_cache()
    return out


def all_launch_counts():
    """Every kernel's launch counter (B1-B6, M1, M2), and
    ``combine_passed`` and ``count_passed``, the MoE combines and
    position counts left on the plain version on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import moe_count as mcount
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ss

    return {**launch_counts(), "paged": pa.paged_attention_decode.launches,
            "flash": fa.flash_attention_bhsd.launches,
            "ssd": ss.ssd_intra_chunk.launches,
            "combine": mc.moe_combine.launches,
            "combine_passed": mc.moe_combine.passed,
            "count": mcount.moe_positions.launches,
            "count_passed": mcount.moe_positions.passed}


def reset_all_launch_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import moe_count as mcount
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ss

    reset_launch_counts()
    pa.paged_attention_decode.launches = 0
    fa.flash_attention_bhsd.launches = 0
    ss.ssd_intra_chunk.launches = 0
    mc.moe_combine.launches = 0
    mc.moe_combine.passed = 0
    mcount.moe_positions.launches = 0
    mcount.moe_positions.passed = 0


def host_ms(torch, fn, reps=5, device="cuda"):
    """Host time of ``fn`` to the end of its device work, ms a call (on
    ``device="cpu"`` the host's own time)."""
    fn()
    sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(torch, device)
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_call(torch, fn):
    """(kernel launches, device-busy ms, wall ms) of one call of ``fn``
    under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return sum(e.count for e in kernels), busy, wall_ms


def phase_ccc(torch, device="cuda"):
    """Phase 11: the CCC strategy on the card (see the module docstring).
    ``device="cpu"`` rehearses it without a card."""
    from repro_torch.ccc.convex import solve_p21, solve_p21_batched
    from repro_torch.ccc.ddqn import BatchedDDQNAgent, DDQNConfig
    from repro_torch.ccc.env import (BatchedCuttingPointEnv, CuttingPointEnv,
                                     cnn_env_config)
    from repro_torch.ccc.strategy import (random_cut_policy_cost,
                                          run_algorithm1_batched)
    from repro_torch.sysmodel.comm import CommParams, path_loss_gain
    from repro_torch.sysmodel.comp import CompParams
    from repro_torch.sysmodel.privacy import privacy_ok

    reset_all_launch_counts()
    t_phase = time.perf_counter()
    B, N = CCC["n_envs"], CCC["n_clients"]
    comp = CompParams()

    # (a) the batched solve against the numpy solver, two instance sets
    rng = np.random.RandomState(3)
    gains = np.stack([path_loss_gain(rng.uniform(0.05, 0.5, N), rng)
                      for _ in range(B)])
    X = rng.uniform(1e5, 5e7, B)
    gt = torch.tensor(gains, dtype=torch.float32, device=device)
    xt = torch.tensor(X, dtype=torch.float32, device=device)
    for label, comm in (("20 MHz", CommParams()),
                        ("200 kHz", CommParams(total_bandwidth=2e5))):
        res = solve_p21_batched(gt, xt, float(CCC["batch"]), comm, comp)
        refs = [solve_p21(gains[i], X[i], CCC["batch"], comm, comp)
                for i in range(B)]
        feas = res.feasible.cpu().numpy()
        check(feas.tolist() == [r.feasible for r in refs],
              f"ccc: batched P2.1 feasibility differs at {label}")
        ok = feas.astype(bool)
        err = 0.0
        for name in ("chi", "psi"):
            got = getattr(res, name).cpu().numpy()[ok]
            want = np.array([getattr(r, name) for r in refs])[ok]
            rel = np.abs(got - want) / np.abs(want)
            err = max(err, float(rel.max(initial=0.0)))
        check(err <= CCC_SOLVE_RTOL, f"ccc: batched P2.1 chi/psi off the "
              f"numpy solver by {err:.2e} (rtol {CCC_SOLVE_RTOL}) at {label}")
        log(f"[ccc] (a) batched P2.1 at {label}, B {B} x N {N}: "
            f"{int(ok.sum())}/{B} feasible as numpy; chi, psi within "
            f"{err:.2e} of float64 (rtol {CCC_SOLVE_RTOL})")
    solve_ms = host_ms(torch, lambda: solve_p21_batched(
        gt, xt, float(CCC["batch"]), CommParams(), comp))
    t0 = time.perf_counter()
    for i in range(B):
        solve_p21(gains[i], X[i], CCC["batch"], CommParams(), comp)
    np_solve_ms = (time.perf_counter() - t0) * 1e3 / B

    # (b) the batched env against the scalar env, every action
    env_cfg = dict(horizon=CCC["horizon"], batch=CCC["batch"],
                   epsilon=CCC["epsilon"], seed=CCC["seed"])
    for codecs in (("fp32",), ("fp32", "bf16", "int8", "int4")):
        cfg = cnn_env_config(codecs=codecs, **env_cfg)
        scalar = CuttingPointEnv(cfg)
        scalar.reset()
        benv = BatchedCuttingPointEnv(cfg, n_envs=scalar.n_actions,
                                      device=device)
        st, _ = benv.reset()
        st = st._replace(gains=torch.tensor(
            np.broadcast_to(scalar.gains, (benv.n_envs, N)),
            dtype=torch.float32, device=device))
        _, _, r, _, info = benv.step(
            st, torch.arange(benv.n_envs, device=device))
        r, chi, psi = (t.cpu().numpy() for t in (r, info["chi"],
                                                 info["psi"]))
        err = 0.0
        for a in range(scalar.n_actions):
            v, codec = scalar.decode_action(a)
            gamma, c, p, alloc = scalar.cost_terms(v, codec)
            ok = privacy_ok(cfg.phis[v - 1], cfg.total_params,
                            cfg.epsilon) and alloc.feasible
            want = -(cfg.w * gamma + c + p) if ok else -cfg.penalty
            err = max(err, abs(r[a] - want) / abs(want),
                      abs(chi[a] - c) / c, abs(psi[a] - p) / p)
        check(err <= CCC_ENV_RTOL, f"ccc: batched env off the scalar env "
              f"by {err:.2e} (rtol {CCC_ENV_RTOL}), codecs {codecs}")
        log(f"[ccc] (b) batched env step vs scalar cost_terms, "
            f"{scalar.n_actions} actions ({len(codecs)} codecs): within "
            f"{err:.2e} (rtol {CCC_ENV_RTOL})")

    # (c) Algorithm 1 on 32 batched envs
    cfg = cnn_env_config(**env_cfg)
    V = len(cfg.phis) + 1
    benv = BatchedCuttingPointEnv(cfg, n_envs=B, device=device)
    agent = BatchedDDQNAgent(DDQNConfig(state_dim=benv.state_dim,
                                        n_actions=benv.n_actions,
                                        seed=CCC["seed"]), device=device)
    steps = -(-CCC["episodes"] // B) * CCC["horizon"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_algorithm1_batched(benv, episodes=CCC["episodes"], agent=agent)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rewards = np.asarray(res.episode_rewards)
    check(len(rewards) == CCC["episodes"] and np.isfinite(rewards).all(),
          "ccc: non-finite episode rewards")
    check(all(1 <= v <= V - 1 and privacy_ok(cfg.phis[v - 1],
                                             cfg.total_params, cfg.epsilon)
              for v in res.greedy_policy),
          f"ccc: greedy cuts {res.greedy_policy} outside [1, {V - 1}] or "
          "not private")
    env = CuttingPointEnv(cfg)
    s, done, greedy_cost = env.reset(), False, 0.0
    while not done:
        s, r, done, _ = env.step(int(agent.act(s)[0]))
        greedy_cost += -r
    rand = random_cut_policy_cost(CuttingPointEnv(cfg),
                                  rounds=CCC["horizon"], seed=0)["cost"]
    check(greedy_cost <= CCC_GREEDY_SLACK * rand,
          f"ccc: greedy policy cost {greedy_cost:.2f} above "
          f"{CCC_GREEDY_SLACK} x random {rand:.2f}")
    k = max(1, CCC["episodes"] // 10)
    log(f"[ccc] (c) Algorithm 1, {CCC['episodes']} episodes over {B} envs "
        f"({steps} fused steps, {agent.grad_steps} gradient steps) in "
        f"{train_s:.2f} s: mean reward first tenth "
        f"{rewards[:k].mean():.2f}, last tenth {rewards[-k:].mean():.2f}; "
        f"greedy cuts {res.greedy_policy}, cost {greedy_cost:.2f} on the "
        f"scalar env (random cuts {rand:.2f})")

    # per-call costs at B 32, N 10: host clock, then the profiler
    st, ob = benv.reset()
    acts = torch.randint(0, benv.n_actions, (B,), device=device)
    holder = {"st": st, "ob": ob}

    def fused():
        holder["st"], holder["ob"], *_ = agent.fused_step(
            benv, holder["st"], holder["ob"])

    env_ms = host_ms(torch, lambda: benv.step(st, acts))
    fused_ms = host_ms(torch, fused)
    senv = CuttingPointEnv(cfg)
    senv.reset()
    arng = np.random.RandomState(1)
    t0 = time.perf_counter()
    for _ in range(16):
        senv.step(int(arng.randint(senv.n_actions)))
    np_env_ms = (time.perf_counter() - t0) * 1e3 / 16
    log(f"[ccc] B {B}, N {N}: batched solve {solve_ms:.2f} ms (numpy "
        f"{np_solve_ms:.2f} ms a round), env step {env_ms:.2f} ms (numpy "
        f"scalar env step {np_env_ms:.2f} ms: batched "
        f"{np_env_ms * B / env_ms:.1f}x per env-step), fused step "
        f"{fused_ms:.2f} ms; training {1e3 * train_s / steps:.2f} ms a "
        f"fused step [{torch.cuda.get_device_name(0)}]")
    # one call each: the profiler's own cost grows with the ~22,000
    # launches of a call (a fused step holds an env step, which holds a
    # solve; torch_ccc_bench.py profiles the solve alone)
    for name, fn in (("env step", lambda: benv.step(st, acts)),
                     ("fused step", fused)):
        n, busy, wall = profile_call(torch, fn)
        log(f"[ccc] profile {name}: {n:.0f} kernel launches, device busy "
            f"{busy:.3f} of {wall:.2f} ms ({100 * busy / wall:.1f} %)")
    counts = all_launch_counts()
    log(f"[ccc] hand-written kernel launches in the phase: {counts} (the "
        f"CCC path runs none); phase {time.perf_counter() - t_phase:.1f} s")


def bank_sim(spec, params, bank, device, scheme="sfl_ga", sampler="uniform",
             n_clients=None, drift_metric=True):
    """A phase-12 simulator. ``drift_metric=True``: Gamma exact on both
    banks (the host bank copies itself to the card for it), so the rounds'
    metrics compare bit for bit too."""
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig

    cfg = SimConfig(scheme=scheme, cut=spec["cut"],
                    n_clients=n_clients or spec["n_clients"],
                    batch=spec["batch"], lr=spec["lr"],
                    cohort=spec["cohort"], sampler=sampler, cohort_seed=5,
                    bank=bank, drift_metric=drift_metric,
                    uplink_codec="int8", downlink_codec="int8")
    return FedSimulator(CONFIG, cfg, device=device, params=params)


def bank_batches(spec, sampler, train, rounds, seed):
    """Each round's batches for the cohort ``sampler`` draws (pure in t,
    so every run with that schedule trains the same clients on them)."""
    import warnings

    from repro_torch.data import CyclicPartition, round_batches

    parts = CyclicPartition(len(train.x), sampler.n_clients,
                            spec["part_size"])
    rng = np.random.RandomState(seed)
    out = []
    for t in range(rounds):
        idx, _ = sampler.cohort(t)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append(round_batches(train, parts, spec["batch"], 1, rng,
                                     idx=idx))
    return out


def same_state(torch, a, b):
    """Client bank and server of two simulators bit for bit (a host
    bank's leaves are copied to the other's device one at a time, a
    sharded bank's made whole with ``full_tensor()``)."""
    from torch.distributed.tensor import DTensor

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    sa, sb = a.state, b.state
    for side in ("client", "server"):
        for pa, pb in zip(sa[side], sb[side]):
            for k in pa:
                x, y = whole(pa[k]), whole(pb[k])
                if not torch.equal(x, y.to(x.device)):
                    return False
    return True


def lockstep(torch, sims, batches, label, after_round=None):
    """Run the simulators round by round on the same batches; their
    states must agree after every round."""
    losses = []
    for t, (xs, ys) in enumerate(batches):
        outs = [s.run_round(xs, ys) for s in sims]
        check(all(np.isfinite(o["loss"]) and np.isfinite(o["client_drift"])
                  for o in outs),
              f"{label}: non-finite loss in round {t}")
        check(all(o == outs[0] for o in outs),
              f"{label}: round metrics differ in round {t}: {outs}")
        for s in sims[1:]:
            check(same_state(torch, sims[0], s),
                  f"{label}: {sims[0].sim.bank} and {s.sim.bank} banks "
                  f"differ after round {t}")
        losses.append(outs[0]["loss"])
        if after_round is not None:
            after_round(t)
    return losses


def timed_bank_run(torch, spec, params, bank, batches, device):
    """One backend alone, Gamma off (its exact form is an O(N) pass, its
    host default an O(N) float64 pass on the host; neither is the bank's
    residency): (peak device bytes over the run, round times, bank
    stats)."""
    import gc

    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    sim = bank_sim(spec, params, bank, device, drift_metric=False)
    times = []
    for xs, ys in batches:
        t0 = time.perf_counter()
        sim.run_round(xs, ys)  # the loss's float ends in a sync
        times.append(time.perf_counter() - t0)
    sim.close()
    peak = 0
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    return peak, times, sim.bank.stats()


def phase_bank(torch, device="cuda", spec=BANK):
    """Phase 12: cohorts and the client bank (see the module docstring).
    ``device="cpu"`` with a smaller ``spec`` rehearses it without a card
    (no memory figures, no launches)."""
    import shutil
    import tempfile

    from repro_torch import obs
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.core.cohort import make_sampler
    from repro_torch.models import cnn

    t_phase = time.perf_counter()
    train, _, _ = train_data()
    params = cnn.init_cnn(torch.Generator().manual_seed(11), CONFIG)
    reset_launch_counts()
    banks = ("device", "host", "sharded")
    sims = [bank_sim(spec, params, b, device) for b in banks]
    rounds = spec["rounds"]
    batches = bank_batches(spec, sims[0].sampler, train, rounds, seed=2)
    k_slice = spec["cohort"] * sims[1].bank.stats()["bank_bytes"] \
        // spec["n_clients"]
    tmp = ROOT / "build"
    tmp.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase12_", dir=tmp))
    try:
        ckpts = {b: str(tmp / f"{b}.ckpt") for b in banks[1:]}

        def save(t):
            if t + 1 == spec["save_after"]:
                for s in sims[1:]:
                    s.save(ckpts[s.sim.bank])

        losses = lockstep(torch, sims, batches, "sfl_ga", after_round=save)
        resumed = []
        for s in sims[1:]:
            r = bank_sim(spec, params, s.sim.bank, device)
            meta = r.restore(ckpts[s.sim.bank])
            check(meta["t"] == spec["save_after"]
                  and meta["bank_backend"] == s.sim.bank,
                  f"restored t {meta['t']} bank {meta['bank_backend']}")
            for xs, ys in batches[spec["save_after"]:]:
                r.run_round(xs, ys)
            check(same_state(torch, s, r) and same_state(torch, sims[0], r),
                  f"the resumed {s.sim.bank} run differs from the "
                  "uninterrupted runs")
            resumed.append(r)
        ckpt_mb = Path(ckpts["host"]).stat().st_size / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for s in sims + resumed:
        s.close()
    del sims, resumed

    psl = [bank_sim(spec, params, b, device, scheme="psl") for b in banks]
    lockstep(torch, psl, bank_batches(spec, psl[0].sampler, train,
                                      spec["psl_rounds"], seed=3), "psl")
    for s in psl:
        s.close()
    rho = [bank_sim(spec, params, b, device, sampler="rho",
                    n_clients=spec["rho_clients"]) for b in banks]
    dups = [spec["cohort"] - len(set(rho[0].cohort_for_round(t)[0]
                                     .tolist()))
            for t in range(spec["rho_rounds"])]
    check(min(dups) > 0, f"rho sampler drew no duplicates: {dups}")
    lockstep(torch, rho, bank_batches(spec, rho[0].sampler, train,
                                      spec["rho_rounds"], seed=4), "rho")
    for s in rho:
        s.close()
    del psl, rho

    schedule = make_sampler("uniform", spec["n_clients"], spec["cohort"],
                            seed=5)
    timed = bank_batches(spec, schedule, train, spec["timed_rounds"], seed=5)
    runs = {b: timed_bank_run(torch, spec, params, b, timed, device)
            for b in banks}
    bank_bytes = runs["device"][2]["bank_bytes"]
    got = launch_counts()
    nb = len(banks)
    per = {k: predicted_launches("sfl_ga", "int8")[k] * (
        nb * rounds + (nb - 1) * (rounds - spec["save_after"])
        + nb * spec["rho_rounds"] + nb * spec["timed_rounds"])
        + predicted_launches("psl", "int8")[k] * nb * spec["psl_rounds"]
        for k in got}
    want = per if device == "cuda" else {k: 0 for k in got}
    check(got == want, f"bank phase: launches {got}, predicted {want}")
    dpeak, hpeak = runs["device"][0], runs["host"][0]
    hst = runs["host"][2]
    check(hst["device_bytes_peak"] <= 2 * k_slice,
          f"host bank: {hst['device_bytes_peak']} B of client state on the "
          f"device, above two K-slices ({2 * k_slice} B)")
    if device == "cuda":
        check(dpeak - hpeak >= BANK_PEAK_SHARE * bank_bytes,
              f"host run's peak {hpeak} B is not {BANK_PEAK_SHARE} x "
              f"{bank_bytes} B below the device run's {dpeak} B")
    sst = runs["sharded"][2]
    check(sst["backend"] == "sharded"
          and sst["device_bytes_peak"] == bank_bytes,
          f"sharded bank at one rank: device_bytes_peak "
          f"{sst['device_bytes_peak']} B, not the whole bank {bank_bytes} B")
    p50 = {b: obs.percentile(sorted(1e3 * x for x in r[1]), 0.5)
           for b, r in runs.items()}
    log(f"[bank] sfl_ga/int8 paper CNN full width, N {spec['n_clients']} K "
        f"{spec['cohort']} cut {spec['cut']}: bank {bank_bytes / 1e6:.1f} "
        f"MB, K-slice {k_slice / 1e6:.2f} MB; device, host and sharded "
        f"banks bit-identical over {rounds} rounds (losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}), psl over "
        f"{spec['psl_rounds']}, rho at N {spec['rho_clients']} over "
        f"{spec['rho_rounds']} ({dups} duplicate draws); host and sharded "
        f"runs saved after round {spec['save_after']} ({ckpt_mb:.1f} MB "
        f"each) and resumed bit for bit")
    log(f"[bank] {spec['timed_rounds']} rounds alone: device bank peak "
        f"{dpeak / 1e6:.1f} MB, round p50 {p50['device']:.3f} ms; host bank "
        f"peak {hpeak / 1e6:.1f} MB ({(dpeak - hpeak) / 1e6:.1f} MB below), "
        f"round p50 {p50['host']:.3f} ms, device_bytes_peak "
        f"{hst['device_bytes_peak'] / 1e6:.2f} MB (<= 2 K-slices "
        f"{2 * k_slice / 1e6:.2f}), prefetch {hst['prefetch_hits']} hits / "
        f"{hst['prefetch_misses']} misses, gather wait "
        f"{1e3 * hst['gather_wait_s']:.3f} ms in all")
    import torch.distributed as dist

    log(f"[bank] sharded bank ({dist.get_backend()}, "
        f"{dist.get_world_size()} rank), {spec['timed_rounds']} rounds "
        f"alone: peak {runs['sharded'][0] / 1e6:.1f} MB, round p50 "
        f"{p50['sharded']:.3f} ms, device_bytes_peak "
        f"{sst['device_bytes_peak'] / 1e6:.1f} MB (the whole bank at one "
        f"rank)")
    card = nvidia_smi_line() if device == "cuda" else "cpu"
    log(f"[bank] launches B1 {got['grad_agg']} B2 {got['quantize']} B3 "
        f"{got['dequant_agg']} (predicted {want['grad_agg']} / "
        f"{want['quantize']} / {want['dequant_agg']})")
    phase_bank_launcher(torch, device)
    log(f"[bank] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return got


def phase_bank_launcher(torch, device):
    """Phase 12, last part: the CNN launcher on ``--bank sharded``,
    synchronous and async, each read back by the port's report."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.launch import train
    from repro_torch.obs import report

    per = predicted_launches("sfl_ga", "int8")
    tmp = ROOT / "build"
    tmp.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase12_launch_", dir=tmp))
    base = ["--arch", "paper-cnn", "--device", device, "--bank", "sharded",
            "--clients", "64", "--cohort", "8", "--sampler", "uniform",
            "--batch", "8", "--cut", "2", "--rounds", "3", "--quiet",
            "--uplink-codec", "int8", "--downlink-codec", "int8"]
    notes = []
    try:
        for mode, extra in (("sync", []), ("async", ["--async", "--buffer",
                                                     "4"])):
            run = str(tmp / mode)
            reset_launch_counts()
            out = train.main(base + extra + ["--metrics-dir", run])
            got = launch_counts()
            gens = out["async"]["dispatches"] if mode == "async" else 3
            want = {k: gens * v if device == "cuda" else 0
                    for k, v in per.items()}
            check(got == want, f"launcher --bank sharded ({mode}): "
                  f"launches {got}, predicted {want}")
            check(out["bank"]["backend"] == "sharded"
                  and np.isfinite(out["accuracy"]),
                  f"launcher --bank sharded ({mode}): {out}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = report.main([run, "--strict"])
            text = buf.getvalue()
            ok = [ln.strip() for ln in text.splitlines()
                  if "reconcile exactly" in ln]
            check(rc == 0 and ok, f"report on the {mode} run: exit {rc}\n"
                  f"{text[-2000:]}")
            notes.append(f"{mode}: {gens} generations, B1 "
                         f"{got['grad_agg']} B2 {got['quantize']} B3 "
                         f"{got['dequant_agg']}, acc {out['accuracy']:.3f},"
                         f" report exit 0 ({ok[0]})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("[bank] launcher --bank sharded: " + "; ".join(notes))


def async_setup(spec, seed=0):
    """Phase 13's data: the train set over ``spec['n_clients']`` iid
    shares, and a data stream pure in the generation (the launcher's)."""
    import warnings

    from repro_torch.core.protocol import round_seed
    from repro_torch.data import iid_partition, round_batches

    train, test, _ = train_data()
    parts = iid_partition(len(train.x), spec["n_clients"], seed=seed)

    def data_fn(d, idx):
        rng = np.random.RandomState(int(round_seed(seed, d)) % (2**31 - 1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return round_batches(train, parts, spec["batch"], 1, rng,
                                 idx=np.asarray(idx))

    return train, test, parts, data_fn


def async_sim(spec, params, device, bank="device", cut=None):
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig

    cfg = SimConfig(scheme="sfl_ga", cut=cut or spec["cut"],
                    n_clients=spec["n_clients"], batch=spec["batch"],
                    lr=spec["lr"], cohort=spec["cohort"], sampler="uniform",
                    cohort_seed=5, bank=bank, drift_metric=True,
                    uplink_codec="int8", downlink_codec="int8")
    return FedSimulator(CONFIG, cfg, device=device, params=params)


def async_engine(spec, sim, data_fn, **kw):
    from repro_torch.sysmodel.latency import completion_time_fn

    kw.setdefault("completion_fn", completion_time_fn(
        spec["n_clients"], seed=5, straggler_factor=spec["straggler"],
        batch=spec["batch"]))
    return sim.async_engine(data_fn, buffer=kw.pop("buffer", spec["buffer"]),
                            lam=spec["lam"], **kw)


def spy_merges(eng):
    """Record each merge's (client, generation) order."""
    order = []
    apply = eng.executor.apply_merge

    def spy(items, *a):
        order.append([(it["client"], it["gen"]) for it in items])
        return apply(items, *a)

    eng.executor.apply_merge = spy
    return order


def async_run(torch, spec, sim, eng, rec, merges, twins=(), on_merge=None):
    """``merges`` engine steps; each merge's traffic event must reconcile
    and its launches must equal its dispatched generations' prediction.
    Each of ``twins`` (further (sim, engine) pairs) steps in lockstep,
    and its bank and metrics must agree bit for bit with the first's
    after every merge. Returns the step host times (s) and the merge
    events."""
    from repro_torch.obs.ledger import reconcile_events

    per_gen = predicted_launches("sfl_ga", "int8")
    cuda = sim.device.type == "cuda"
    times, events = [], []
    for m in range(merges):
        before = launch_counts()
        n_ev = len(rec.events)
        t0 = time.perf_counter()
        out = eng.step()  # the merge's loss ends in a sync
        times.append(time.perf_counter() - t0)
        got = {k: v - before[k] for k, v in launch_counts().items()}
        new = rec.events[n_ev:]
        merge = [e for e in new if e.get("kind") == "async"]
        check(len(merge) == 1, f"merge {m}: {len(merge)} async events")
        gens = len(merge[0]["dispatched"])
        want = {k: gens * v if cuda else 0 for k, v in per_gen.items()}
        check(got == want, f"merge {m}: launches {got}, predicted {want} "
              f"from {merge[0]['dispatched']} dispatched")
        rows, bad = reconcile_events(e for e in new
                                     if e.get("kind") == "traffic")
        check(len(rows) == 1 and bad == 0,
              f"merge {m}: {bad} of {len(rows)} traffic events do not "
              "reconcile with sysmodel.traffic")
        check(np.isfinite(out["loss"]) and np.isfinite(out["client_drift"]),
              f"merge {m}: non-finite metrics {out}")
        events.append(merge[0])
        for tsim, teng in twins:
            tout = teng.step()
            check(tout == out, f"merge {m}: metrics differ between the "
                  f"{sim.sim.bank} and {tsim.sim.bank} banks: {out} {tout}")
            check(same_state(torch, sim, tsim), f"merge {m}: the "
                  f"{sim.sim.bank} and {tsim.sim.bank} banks differ")
        if on_merge is not None:
            on_merge(m)
    return times, events


def spy_kernels(torch):
    """Wrap B1, B2 and B3 where the protocol calls them
    (``kernels.ops``): the first CUDA call at each distinct input is held
    bit for bit to the plain version on the same inputs (the plain
    versions launch no kernel, so the counts stay the path's). Returns
    the held inputs, keyed by kernel and input (B1's value: its plan),
    and a function that puts the wrappers back."""
    from repro_torch.kernels import grad_agg as ga
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz

    held = {}
    b1, b2, b3 = ops.grad_agg_reduce, ops.quantize_pack, ops.dequant_agg_reduce

    def hold(key, out, ref, value=True):
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        check(all(torch.equal(o, r) for o, r in zip(outs, refs)),
              f"{key[0]} at {key[1:]} is not bit-identical to its plain "
              "version on the main path's inputs")
        held[key] = value

    def grad_agg(g, rho):
        out = b1(g, rho)
        key = ("B1", g.shape[0], g.numel() // g.shape[0])
        if g.is_cuda and key not in held:
            hold(key, out, ga.grad_agg_ref(g, rho), ga.plan_for(g))
        return out

    def quantize(g, *args):
        out = b2(g, *args)
        key = ("B2", tuple(g.shape), *args[1:4], args[5] is None)
        if g.is_cuda and key not in held:
            hold(key, out, qz.quantize_ref(g, *args))
        return out

    def dequant(q, scales, rho, *args):
        out = b3(q, scales, rho, *args)
        key = ("B3", tuple(q.shape), tuple(scales.shape), rho.shape[0],
               *args)
        if q.is_cuda and key not in held:
            hold(key, out, qz.dequant_agg_ref(q, scales, rho, *args))
        return out

    ops.grad_agg_reduce, ops.quantize_pack = grad_agg, quantize
    ops.dequant_agg_reduce = dequant

    def restore():
        ops.grad_agg_reduce, ops.quantize_pack = b1, b2
        ops.dequant_agg_reduce = b3

    return held, restore


def phase_async(torch, device="cuda", spec=ASYNC):
    """Phase 13: the buffered-async engine and the closed loop (see the
    module docstring). ``device="cpu"`` with a smaller ``spec``
    rehearses it without a card (no launches, no card-vs-CPU part)."""
    import shutil
    import tempfile

    from repro_torch import obs
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.models import cnn
    from repro_torch.sysmodel.latency import constant_completion_fn

    t_phase = time.perf_counter()
    train, test, parts, data_fn = async_setup(spec)
    params = cnn.init_cnn(torch.Generator().manual_seed(13), CONFIG)
    reset_launch_counts()
    held, unspy = spy_kernels(torch)
    try:
        # (a) the degenerate schedule is the synchronous loop
        K, steps = spec["cohort"], spec["degenerate_steps"]
        sync, deg = (async_sim(spec, params, device) for _ in range(2))
        eng = async_engine(spec, deg, data_fn, buffer=K,
                           completion_fn=constant_completion_fn(
                               spec["n_clients"], 1.0))
        for t in range(steps):
            a = sync.run_round(*data_fn(t, sync.cohort_for_round(t)[0]))
            b = eng.step()
            check(all(b[k] == v for k, v in a.items()),
                  f"degenerate step {t}: {b} != run_round's {a}")
        check(eng.sync_steps == steps and same_state(torch, sync, deg),
              f"degenerate: {eng.sync_steps} sync steps; params "
              f"{'equal' if same_state(torch, sync, deg) else 'differ'}")
        del sync, deg, eng

        # (b, c) 30 merges on the device and the host banks in lockstep;
        # the host run saved after merge 15 and resumed in a fresh sim
        tmp = ROOT / "build"
        tmp.mkdir(exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="phase13_", dir=tmp))
        ckpt = str(tmp / "async.ckpt")
        rec_d, rec_h, rec_s = obs.Recorder(), obs.Recorder(), obs.Recorder()
        with obs.use_recorder(rec_d):
            dsim = async_sim(spec, params, device)
            deng = async_engine(spec, dsim, data_fn)
        with obs.use_recorder(rec_h):
            hsim = async_sim(spec, params, device, bank="host")
            heng = async_engine(spec, hsim, data_fn)
        with obs.use_recorder(rec_s):
            ssim = async_sim(spec, params, device, bank="sharded")
            seng = async_engine(spec, ssim, data_fn)

        def save(m):
            if m + 1 == spec["save_after"]:
                heng.save(ckpt)

        try:
            times, events = async_run(torch, spec, dsim, deng, rec_d,
                                      spec["merges"],
                                      twins=[(hsim, heng), (ssim, seng)],
                                      on_merge=save)
            hst = hsim.bank.stats()
            rec_r = obs.Recorder()
            with obs.use_recorder(rec_r):
                rsim = async_sim(spec, params, device, bank="host")
                reng = async_engine(spec, rsim, data_fn)
            meta = reng.restore(ckpt)
            check(reng.merge_idx == spec["save_after"]
                  and meta["async_merge_idx"] == spec["save_after"],
                  f"restored at merge {reng.merge_idx}")
            ckpt_mb = Path(ckpt).stat().st_size / 1e6
            async_run(torch, spec, rsim, reng, rec_r,
                      spec["merges"] - spec["save_after"])
            check(same_state(torch, hsim, rsim)
                  and reng.stats() == heng.stats(),
                  "the resumed async run differs from the uninterrupted one")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        st = deng.stats()
        stale = [e["staleness_mean"] for e in events]
        stale_max = max(e["staleness_max"] for e in events)
        gen_sizes = sorted({g for e in events for g in e["dispatched"]})
        for s_ in (dsim, hsim, ssim, rsim):
            s_.close()
        del dsim, hsim, ssim, rsim, deng, heng, seng, reng

        # (d) the card against the CPU
        cpu_note = "card vs CPU not run (CPU rehearsal)"
        if device == "cuda":
            runs = {}
            for dev in ("cuda", "cpu"):
                sim = async_sim(spec, params, dev)
                eng = async_engine(spec, sim, data_fn)
                order = spy_merges(eng)
                losses = [eng.step()["loss"] for _ in range(spec["cpu_merges"])]
                runs[dev] = (sim, order, losses)
            loss_rtol, param_atol = TRAIN_TOL["int8"]
            check(runs["cuda"][1] == runs["cpu"][1],
                  f"merge order differs: card {runs['cuda'][1]}, cpu "
                  f"{runs['cpu'][1]}")
            err = 0.0
            for side in ("client", "server"):
                for gb, cb in zip(runs["cuda"][0].state[side],
                                  runs["cpu"][0].state[side]):
                    for k in gb:
                        err = max(err, float((gb[k].cpu() - cb[k]).abs()
                                             .max()))
            check(err <= param_atol, f"async card vs CPU: params differ by "
                  f"{err} (tolerance {param_atol})")
            for a, b in zip(runs["cuda"][2], runs["cpu"][2]):
                check(abs(a - b) <= loss_rtol * abs(b),
                      f"async card vs CPU: losses {runs['cuda'][2]} / "
                      f"{runs['cpu'][2]}")
            cpu_note = (f"card vs CPU over {spec['cpu_merges']} merges: the "
                        f"same merge order, params max abs diff {err:.3e} "
                        f"(tolerance {param_atol})")
            del runs

        loop_note = phase_async_closed_loop(torch, spec, params, train, test,
                                            parts, data_fn, device)
    finally:
        unspy()
    got = launch_counts()
    ms = sorted(1e3 * t for t in times)
    card = nvidia_smi_line() if device == "cuda" else "cpu"
    log(f"[async] sfl_ga/int8 paper CNN full width, N {spec['n_clients']} K "
        f"{spec['cohort']} B {spec['buffer']} straggler "
        f"{spec['straggler']:g} lam {spec['lam']:g}: degenerate B = K run "
        f"equals {spec['degenerate_steps']} run_round calls bit for bit; "
        f"{spec['merges']} merges, every traffic event reconciles and every "
        f"merge's launches as its dispatches predict")
    log(f"[async] step p50 {obs.percentile(ms, 0.5):.3f} ms p99 "
        f"{obs.percentile(ms, 0.99):.3f} ms (first {times[0] * 1e3:.1f}"
        f" ms); virtual clock {st['clock']:.3f} s over {st['merges']} merges "
        f"({st['dispatches']} dispatches of sizes {gen_sizes}); staleness "
        f"mean {float(np.mean(stale)):.3f} max {stale_max:.0f}; host bank "
        f"prefetch {hst['prefetch_hits']} hits / {hst['prefetch_misses']} "
        f"misses, gather wait {1e3 * hst['gather_wait_s']:.3f} ms [{card}]")
    log(f"[async] device, host and sharded banks bit-identical after every "
        f"merge; "
        f"saved after merge {spec['save_after']} ({ckpt_mb:.1f} MB) and "
        f"resumed to merge {spec['merges']} bit for bit; {cpu_note}")
    log(f"[async] {loop_note}")
    b1_keys = sorted(k for k in held if k[0] == "B1")
    if device == "cuda":
        check({k[0] for k in held} == {"B1", "B2", "B3"},
              f"phase 13 held only {sorted(held)} to the plain versions")
        log("[async] held bit for bit to the plain versions at every "
            "distinct input: B1 " + ", ".join(
                f"({n}, {m}): {held[k].path} ({held[k].grid} blocks)"
                for k in b1_keys for n, m in [k[1:]])
            + "; B2 " + ", ".join(f"{k[1]} int{k[2]}" for k in sorted(held)
                                   if k[0] == "B2")
            + "; B3 " + ", ".join(f"{k[1]} int{k[4]}" for k in sorted(held)
                                   if k[0] == "B3"))
        # B1 at each of the path's (N, M), after the path's count was read
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        gen = torch.Generator(device="cuda").manual_seed(13)
        for _, n, m in b1_keys:
            g = torch.randn((n, m), generator=gen, device="cuda") * 3.0
            rho = torch.rand((n,), generator=gen, device="cuda")
            b1_case(torch, f"async N {n}", g, rho / rho.sum(), flush, sms)
        del flush
    log(f"[async] kernel launches in phase 13: B1 {got['grad_agg']} B2 "
        f"{got['quantize']} B3 {got['dequant_agg']}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return got


def phase_async_closed_loop(torch, spec, params, train, test, parts,
                            data_fn, device):
    """Phase 13 (e): the closed loop in fig. 10's comm-bound env."""
    from repro_torch.ccc.env import CuttingPointEnv, cnn_env_config
    from repro_torch.core.closed_loop import CutSchedule, run_closed_loop
    from repro_torch.data import round_batches
    from repro_torch.models import cnn
    from repro_torch.sysmodel.comm import CommParams
    from repro_torch.sysmodel.comp import CompParams
    from repro_torch.sysmodel.traffic import migration_bits
    from repro_torch.configs.paper_cnn import CONFIG

    rounds, K = spec["loop_rounds"], spec["cohort"]

    def env():
        return CuttingPointEnv(
            cnn_env_config(light=False, n_clients=spec["n_clients"],
                           batch=spec["batch"], seed=0, cohort=K),
            comm=CommParams(total_bandwidth=spec["bandwidth"]),
            comp=CompParams(client_cpu_max=spec["client_cpu"]))

    def loop(schedule, sim, eng=None):
        return run_closed_loop(sim, env(), schedule, train, test, parts,
                               rounds=rounds, eval_every=rounds,
                               batch_seed=3, async_engine=eng)

    fixed = async_sim(spec, params, device)
    rng = np.random.RandomState(3)
    for t in range(rounds):
        idx, _ = fixed.cohort_for_round(t)
        fixed.run_round(*round_batches(train, parts, spec["batch"], 1, rng,
                                       idx=idx))
    const_sim = async_sim(spec, params, device)
    const = loop(CutSchedule.constant(spec["cut"]), const_sim)
    check(const.n_migrations == 0 and same_state(torch, fixed, const_sim),
          "closed loop: the constant schedule differs from the fixed-cut "
          "loop")
    cuts = list(spec["loop_cuts"])
    want_cuts = [cuts[t % len(cuts)] for t in range(rounds)]
    outs = {}
    for mode in ("sync", "async"):
        sim = async_sim(spec, params, device, cut=want_cuts[0])
        eng = async_engine(spec, sim, data_fn) if mode == "async" else None
        drained = []
        if eng is not None:
            set_cut = sim.set_cut

            def spy_set_cut(v, sim=sim, eng=eng, set_cut=set_cut):
                if v != sim.cut:
                    drained.append(eng.queue_depth)
                return set_cut(v)

            sim.set_cut = spy_set_cut
        r = loop(CutSchedule.from_sequence(cuts), sim, eng)
        check(r.cuts == want_cuts, f"closed loop {mode}: cuts {r.cuts}")
        moves = [(a, b) for a, b in zip(want_cuts, want_cuts[1:]) if a != b]
        check(r.n_migrations == len(moves),
              f"closed loop {mode}: {r.n_migrations} migrations for "
              f"{len(moves)} changes of cut")
        wall = 0.0
        for t, rec in enumerate(r.records):
            moved = t > 0 and want_cuts[t] != want_cuts[t - 1]
            want_bits = migration_bits(
                cnn.phi(CONFIG, want_cuts[t - 1] if t else want_cuts[0]),
                cnn.phi(CONFIG, want_cuts[t]), n_clients=K,
                raw_bits_per_elem=32)["total_bits"] if moved else 0
            check(rec["migration_bits"] == want_bits,
                  f"closed loop {mode} round {t}: migration bits "
                  f"{rec['migration_bits']}, traffic.migration_bits "
                  f"{want_bits}")
            check((rec["migration_s"] > 0) == moved,
                  f"closed loop {mode} round {t}: migration latency "
                  f"{rec['migration_s']} (moved: {moved})")
            wall += rec["latency_s"] + rec["migration_s"]
            check(rec["wall_clock_s"] == wall,
                  f"closed loop {mode} round {t}: wall-clock "
                  f"{rec['wall_clock_s']} != {wall}")
        if eng is not None:
            check(len(drained) == len(moves) and not any(drained),
                  f"closed loop async: queue depths {drained} at the "
                  f"{len(moves)} migrations")
        check(np.isfinite(r.final_acc), f"closed loop {mode}: accuracy")
        outs[mode] = r
    s, a = outs["sync"], outs["async"]
    return (f"closed loop, comm-bound env: constant schedule equals the "
            f"fixed-cut loop bit for bit over {rounds} rounds; cycled "
            f"{cuts}: {s.n_migrations} migrations of "
            f"{s.migration_bits_total / 8e6:.3f} MB in all, priced "
            f"{sum(x['migration_s'] for x in s.records):.4f} s of "
            f"{s.total_latency_s:.4f} s wall-clock (sync), async "
            f"{a.total_latency_s:.4f} s with the queue empty at each of its "
            f"{a.n_migrations} migrations")


# ---------------------------------------------------------------------------
# Phase 14: SFL-GA training of the split LM through the launcher
# ---------------------------------------------------------------------------

def lm_argv(p, device, metrics_dir, steps=None, extra=()):
    """The launcher's flags for one part of phase 14."""
    codec = p.get("codec", "fp32")
    argv = ["--arch", p["arch"], "--preset", p["preset"],
            "--scheme", p.get("scheme", "sfl_ga"),
            "--clients", str(p["clients"]), "--batch", str(p["batch"]),
            "--seq", str(p["seq"]), "--steps", str(steps or p["steps"]),
            "--optimizer", p["optimizer"], "--lr", repr(p["lr"]),
            "--tau", str(p.get("tau", 1)), "--uplink-codec", codec,
            "--downlink-codec", codec, "--device", device, "--quiet",
            "--log-every", "1000", "--metrics-dir", str(metrics_dir)]
    for key, flag in (("layers", "--layers"), ("cut", "--cut"),
                      ("cohort", "--cohort"), ("bank", "--bank"),
                      ("dynamic_cut", "--dynamic-cut")):
        if p.get(key) is not None:
            argv += [flag, str(p[key])]
    if p.get("lora"):
        argv += ["--peft", "lora", "--lora-rank", str(p["lora"][0]),
                 "--lora-alpha", str(p["lora"][1])]
    if p.get("lora_targets"):
        argv += ["--lora-targets", p["lora_targets"]]
    return argv + list(extra)


def lm_run(torch, label, p, device, tmp, steps=None, extra=(),
           profile_step=None):
    """One launch of ``repro_torch.launch.train`` in LM mode. Every train
    step is wrapped where the launcher builds it
    (``algorithms.make_train_step``): its B1/B2/B3 launches must equal
    ``predicted_launches`` (none on the CPU), its host time is taken to
    the loss's copy, and step ``profile_step`` runs under
    ``torch.profiler``. Then every step's traffic event and every
    migration event must reconcile exactly. Returns the launcher's
    result, the per-step records and the peak device memory."""
    from repro_torch.core import algorithms as alg
    from repro_torch.launch import train

    cuda = device == "cuda"
    tau = p.get("tau", 1)
    want = predicted_launches(p.get("scheme", "sfl_ga"),
                              p.get("codec", "fp32"), tau) if cuda \
        else {k: 0 for k in launch_counts()}
    records = []
    orig = alg.make_train_step

    def make(*a, **kw):
        step = orig(*a, **kw)

        def timed(params, opt_state, batch):
            before = launch_counts()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            prof = None
            if cuda and len(records) == profile_step:
                box = []
                prof = profile_call(torch, lambda: box.append(
                    step(params, opt_state, batch)))
                out = box[0]
            else:
                out = step(params, opt_state, batch)
            loss = float(out[2]["loss"])
            if cuda:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after = launch_counts()
            got = {k: after[k] - before[k] for k in after}
            check(got == want, f"phase 14 {label} step {len(records)}: "
                  f"launches {got}, predicted {want}")
            records.append(dict(s=secs, loss=loss, prof=prof))
            return out

        return timed

    run_dir = tmp / label
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    alg.make_train_step = make
    try:
        res = train.main(lm_argv(p, device, run_dir, steps, extra))
    finally:
        alg.make_train_step = orig
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    with open(run_dir / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    traffic = [e for e in events if e.get("name") == "step_traffic"]
    migrations = [e for e in events if e.get("kind") == "migration"]
    check(len(traffic) == len(records) == (steps or p["steps"]),
          f"phase 14 {label}: {len(traffic)} traffic events for "
          f"{len(records)} steps")
    check(all(e["measured"] == e["modeled"] for e in traffic),
          f"phase 14 {label}: a step's traffic does not reconcile")
    check(len(migrations) == res["n_migrations"]
          and all(e["measured"] == e["modeled"] for e in migrations),
          f"phase 14 {label}: a migration's bits do not reconcile")
    check(all(np.isfinite(r["loss"]) for r in records),
          f"phase 14 {label}: a loss is not finite")
    res["wall_s"] = time.perf_counter() - t0
    return res, records, peak, migrations


def lm_summary(label, p, res, records, peak, migrations, card):
    """One log line: losses, step times (p50 over the steps after the
    first that ran without the profiler), tokens/s, peak memory and the
    profiled step's device-busy share."""
    from repro_torch import obs

    ms = [1e3 * r["s"] for r in records]
    clean = [t for r, t in zip(records[1:], ms[1:]) if r["prof"] is None]
    p50 = obs.percentile(sorted(clean or ms), 0.5)
    k = p.get("cohort") or p["clients"]
    tokens = k * p["batch"] * p["seq"] * p.get("tau", 1)
    prof = [r["prof"] for r in records if r["prof"] is not None]
    busy = ""
    if prof:
        n_k, busy_ms, wall_ms = prof[0]
        busy = (f"; profiled step: {n_k} kernels, device busy "
                f"{busy_ms:.2f} of {wall_ms:.2f} ms "
                f"({100 * busy_ms / wall_ms:.1f} %)")
    mig = ""
    if migrations:
        bits = ", ".join(str(e["modeled"]["total_bits"]) for e in migrations)
        mig = f"; {len(migrations)} migrations of {bits} bits, as modeled"
    losses = ", ".join(f"{r['loss']:.4f}" for r in records)
    steps = ", ".join(f"{t:.1f}" for t in ms)
    log(f"[lm-train] ({label}) losses {losses}; step ms {steps}: p50 "
        f"{p50:.2f} ms, {tokens / (p50 / 1e3):.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB; traffic exact every step{mig}{busy}; "
        f"the launch {res['wall_s']:.1f} s [{card}]")
    return dict(p50_ms=p50, tokens_per_s=tokens / (p50 / 1e3),
                peak_gib=peak / 2**30,
                busy_share=prof[0][1] / prof[0][2] if prof else None,
                losses=[r["loss"] for r in records])


def hashed_checkpoint(path):
    """A FIFO at the checkpoint writer's temporary path, read and hashed
    by a thread as the writer streams into it: the file's sha256 without
    its bytes on disk. Returns the path for ``--checkpoint`` and a
    function that waits for the digest and the byte count."""
    import hashlib
    import os
    import threading

    fifo = str(path) + ".tmp"
    os.mkfifo(fifo)
    out = {"n": 0}

    def read():
        h = hashlib.sha256()
        with open(fifo, "rb") as f:
            while True:
                buf = f.read(1 << 24)
                if not buf:
                    break
                h.update(buf)
                out["n"] += len(buf)
        out["digest"] = h.hexdigest()

    th = threading.Thread(target=read, daemon=True)
    th.start()

    def result():
        th.join()
        return out["digest"], out["n"]

    return str(path), result


def lm_card_vs_cpu(torch, p, label="phase 14 (d)",
                   codecs=("fp32", "int8")):
    """Phase 14 (d) (and 15 (c)): the same train steps from the same
    params and batches on the card (kernels) and on the CPU (plain
    versions), at sfl_ga fp32 and int8; the int8 case carries the CPU's
    state to the card before each step (C3). Returns a note for the
    log."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import algorithms as alg
    from repro_torch.data import synthetic_token_batches
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves

    cfg = get_config(p["arch"]).with_overrides(num_layers=p["layers"])
    plan = lm.build_plan(cfg, p["cut"])
    n, b, S, lr = p["clients"], p["batch"], p["seq"], p["lr"]
    # drawn on the card (fast at full width) and copied to the CPU
    base = alg.split_lm_params(tree_to(lm.init_lm(14, plan, device="cuda"),
                                       "cpu"), n)
    torch.cuda.empty_cache()
    opt = make_optimizer(p["optimizer"], lr)
    notes = []
    for codec in codecs:
        tcfg = TrainConfig(model=cfg, algo="sfl_ga", cut_layer=p["cut"],
                           compute_dtype="float32", param_dtype="float32",
                           lr=lr, remat=False, uplink_codec=codec,
                           downlink_codec=codec, seed=14)
        steps = {d: alg.make_train_step(plan, tcfg, opt, n)
                 for d in ("cpu", "cuda")}
        state = {"cpu": (base, opt.init(base))}
        state["cuda"] = tree_to(state["cpu"], "cuda")
        it = synthetic_token_batches(cfg.vocab_size, n * b, S, seed=14)
        worst = (0.0, 0.0, 0.0)
        for i in range(p["steps"]):
            toks, labels = next(it)
            if codec != "fp32":  # the CPU's state, carried in (C3)
                state["cuda"] = tree_to(state["cpu"], "cuda")
            loss = {}
            for d in ("cpu", "cuda"):
                batch = {"tokens": torch.from_numpy(
                    toks.reshape(n, b, S)).to(d), "labels": torch.from_numpy(
                    labels.reshape(n, b, S)).to(d), "seed": np.uint32(i)}
                pr, st, m = steps[d](*state[d], batch)
                state[d] = (pr, st)
                loss[d] = float(m["loss"])
            rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
            err = torch.cat([(g.cpu() - c).abs().reshape(-1) for g, c in zip(
                tree_leaves(state["cuda"][0]), tree_leaves(state["cpu"][0]))])
            share = float((err > LM_TRAIN_PARAM_ATOL).float().mean())
            reach = 2 * lr * (1 if codec != "fp32" else i + 1)
            check(rel <= LM_LOSS_RTOL and float(err.max()) <= reach
                  and share <= LM_TRAIN_ADAM_SHARE[codec],
                  f"{label} {codec} step {i}: loss rel {rel:.2e}, "
                  f"params max {float(err.max()):.2e} (reach {reach}), "
                  f"share beyond {LM_TRAIN_PARAM_ATOL}: {share:.2e}")
            worst = tuple(max(a, b) for a, b in zip(
                worst, (rel, float(err.max()), share)))
        notes.append(f"{codec}: loss rel {worst[0]:.2e}, params max "
                     f"{worst[1]:.2e}, share beyond {LM_TRAIN_PARAM_ATOL} "
                     f"{worst[2]:.2e}")
        del state, steps
    return "; ".join(notes)


def phase_lm_train(torch, device="cuda", spec=LM_TRAIN):
    """Phase 14: SFL-GA training of the split LM (see the module
    docstring). ``device="cpu"`` with a smaller ``spec`` rehearses it
    without a card (no launches, no card-against-CPU part, no profile)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    card = nvidia_smi_line() if cuda else "cpu"
    tmp = ROOT / "build"
    tmp.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase14_", dir=tmp))
    reset_launch_counts()
    held, unspy = spy_kernels(torch)
    out = {}
    try:
        for label in ("a", "b", "e"):
            p = spec[label]
            res, recs, peak, migs = lm_run(torch, label, p, device, tmp,
                                           profile_step=p["steps"] - 1)
            check(len(migs) == p.get("migrations", 0),
                  f"phase 14 ({label}): {len(migs)} migrations")
            if label == "a":
                check(recs[-1]["loss"] < recs[0]["loss"],
                      f"phase 14 (a): the loss did not fall: "
                      f"{[r['loss'] for r in recs]}")
            out[label] = lm_summary(label, p, res, recs, peak, migs, card)
            if cuda:
                torch.cuda.empty_cache()
        # (c) LoRA at full depth, with a checkpoint of the 3-step run and a
        # resume of 1 step from the 2-step run's file: the two files'
        # digests must agree
        p = spec["c"]
        c_path, c_done = hashed_checkpoint(tmp / "c.ckpt")
        res, recs, peak, migs = lm_run(
            torch, "c", p, device, tmp, profile_step=p["steps"] - 1,
            extra=["--checkpoint", c_path])
        check(recs[-1]["loss"] < recs[0]["loss"],
              f"phase 14 (c): the loss did not fall: "
              f"{[r['loss'] for r in recs]}")
        check(len(migs) == p["migrations"],
              f"phase 14 (c): {len(migs)} migrations")
        out["c"] = lm_summary("c", p, res, recs, peak, migs, card)
        digest_c, nbytes = c_done()
        a_path = str(tmp / "a.ckpt")
        first = lm_run(torch, "c-first", p, device, tmp,
                       steps=p["resume_after"],
                       extra=["--checkpoint", a_path])[0]
        b_path, b_done = hashed_checkpoint(tmp / "b.ckpt")
        resumed = lm_run(torch, "c-resumed", p, device, tmp,
                         steps=p["steps"] - p["resume_after"],
                         extra=["--resume", a_path, "--checkpoint",
                                b_path])[0]
        digest_b, nbytes_b = b_done()
        check(digest_b == digest_c and nbytes_b == nbytes,
              f"phase 14 (c): the resumed run's checkpoint ({nbytes_b} "
              f"bytes, sha256 {digest_b[:16]}) is not the uninterrupted "
              f"run's ({nbytes} bytes, {digest_c[:16]})")
        log(f"[lm-train] (c) checkpoint of {nbytes / 1e9:.2f} GB (the frozen "
            f"base included, the reference's layout); {p['resume_after']} "
            f"steps + a resume of {p['steps'] - p['resume_after']} write the "
            f"uninterrupted run's file byte for byte (sha256 "
            f"{digest_c[:16]}); the launches {first['wall_s']:.1f} s (save "
            f"to disk) and {resumed['wall_s']:.1f} s (load, save)")
        if cuda:
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            note = lm_card_vs_cpu(torch, spec["d"])
            log(f"[lm-train] (d) card against CPU, {spec['d']['arch']} full "
                f"width, {spec['d']['layers']} layers: {note}; "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        unspy()
        shutil.rmtree(tmp, ignore_errors=True)
    got = launch_counts()
    b1_keys = sorted(k for k in held if k[0] == "B1")
    if cuda:
        check({k[0] for k in held} == {"B1", "B2", "B3"},
              f"phase 14 held only {sorted(held)} to the plain versions")
        log("[lm-train] held bit for bit to the plain versions at every "
            "distinct input: B1 " + ", ".join(
                f"({n}, {m}): {held[k].path} ({held[k].grid} blocks)"
                for k in b1_keys for n, m in [k[1:]])
            + "; B2 " + ", ".join(f"{k[1]} int{k[2]}" for k in sorted(held)
                                   if k[0] == "B2")
            + "; B3 " + ", ".join(f"{k[1]} int{k[4]}" for k in sorted(held)
                                   if k[0] == "B3"))
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        gen = torch.Generator(device="cuda").manual_seed(14)
        for _, n, m in b1_keys:
            g = torch.randn((n, m), generator=gen, device="cuda") * 3.0
            rho = torch.rand((n,), generator=gen, device="cuda")
            b1_case(torch, f"lm-train N {n}", g, rho / rho.sum(), flush, sms)
        del flush
    log(f"[lm-train] kernel launches in phase 14: B1 {got['grad_agg']} B2 "
        f"{got['quantize']} B3 {got['dequant_agg']}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the decoder zoo on the card
# ---------------------------------------------------------------------------

# (a) qwen3-moe-30b-a3b at full width (d 2048, 32/4 heads of 128, 128
# experts top-8 of width 768, vocab 151,936, QK-norm), cut to 24 of its
# 48 layers: 623.1 M parameters a layer, 62.3 GB of f32 weights in all;
# served as phase 4 serves granite-8b (SERVE)
ZOO_MOE_LAYERS = 24
# (b), (e): the split forward's batch; (f) starcoder2-3b's: a sequence
# twice its window of 4,096, and the ring cache's prompt and decode steps
ZOO_FORWARD = (1, 2048)
STARCODER = dict(seq=8192, prompt=4200, gen=16)
# (e) jamba-v0.1-52b at full width, one period of 8 layers (53.1 GB):
# prompt 320 = two chunks of 128 through B5 + a 64-token tail
JAMBA_LAYERS = 8
JAMBA_SERVE = dict(users=8, slots=4, prompt_len=320, gen=16, codec="int8",
                   page=16)
# routing of a MoE layer on one path (or device) against another: an
# expert index may differ only where the other run's probabilities at
# the first position that differs and the next lie within ROUTE_TIE of
# each other (a near-tie that f32 noise may order either way). Router
# logits are sums of d_model products of values of order one; the paths'
# hidden states differ by ~1e-6 relative, so the probabilities (<= 1) by
# less than 1e-5. Where a near-tie flips, the run takes the other run's
# choice, so that the logits check holds the kernels and not the tie.
ROUTE_TIE = 1e-5
# (c) card against CPU at full width, 2 layers; (d) training through the
# launcher: full-parameter sfl_ga int8 with a migrating cut (1, 2, 1: a
# 2.49 GB MoE layer moves each way), then LoRA on attention and the
# router over a 16-layer frozen base (42.4 GB) on the host bank
_QWEN = dict(arch="qwen3-moe-30b-a3b", preset="full", batch=1, seq=256,
             steps=3, codec="int8")
ZOO_TRAIN = {
    "cpu": dict(arch="qwen3-moe-30b-a3b", layers=2, cut=1, clients=2,
                batch=1, seq=32, steps=2, optimizer="sgd", lr=0.05),
    "d-full": dict(_QWEN, layers=3, clients=2, optimizer="sgd", lr=0.01,
                   dynamic_cut="1,2,1", migrations=2),
    "d-lora": dict(_QWEN, layers=16, lora=(8, 16.0),
                   lora_targets="attn,router", optimizer="adamw", lr=1e-3,
                   clients=4, cohort=2, bank="host", dynamic_cut="2,3,2",
                   migrations=2),
}
# B4, B5 and B6 at the zoo's shapes: (name, slots, Hkv, G, D, page,
# lengths, max pages), (label, B, Hq, Hkv, S, D, window) and (label, b, h,
# g, c, Q, P, N)
ZOO_PAGED = [
    ("qwen3-moe serve shapes, G=8", 4, 4, 8, 128, 16, [17, 21, 26, 31], 2),
    ("qwen2-vl group, G=6", 8, 2, 6, 128, 16,
     [0, 1, 16, 17, 40, 100, 127, 64], 9),
    ("jamba serve shapes, G=4", 4, 8, 4, 128, 16, [321, 325, 330, 335], 21),
]
ZOO_FLASH = [("qwen3-moe S=2048", 1, 32, 4, 2048, 128, None),
             ("starcoder2 S=8192 window 4096", 1, 24, 2, 8192, 128, 4096)]
ZOO_SSD = [("jamba forward", 1, 128, 1, 16, 128, 64, 16),
           ("jamba serve prompt head", 1, 128, 1, 2, 128, 64, 16)]


class RoutePin:
    """Wraps ``models.moe.route``. In ``"record"`` mode it keeps each
    call's expert indices and router probabilities; in ``"replay"`` mode
    each call is held to the recorded one under the near-tie rule
    (ROUTE_TIE) and takes the recorded choice where a near-tie flipped.
    ``None`` passes through."""

    def __init__(self, torch):
        self.torch = torch
        self.mode = None
        self.calls, self.i, self.flips, self.worst = [], 0, 0, 0.0

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe.route
        moe.route = self._call
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def _probs(self, p, x2d):
        from repro_torch.models.blocks import linear

        return self.torch.softmax(linear(p["router"], x2d).float(), -1)

    def _call(self, p, m, x2d, *seq):
        torch = self.torch
        idx, gates, aux = self._route(p, m, x2d, *seq)
        if self.mode == "record":
            self.calls.append((idx.cpu(), self._probs(p, x2d).cpu()))
        elif self.mode == "replay":
            check(self.i < len(self.calls), "route pin: more MoE calls "
                  "than recorded")
            ridx, rprobs = self.calls[self.i]
            self.i += 1
            check(ridx.shape == idx.shape, f"route pin: call {self.i} "
                  f"routes {tuple(idx.shape)}, recorded {tuple(ridx.shape)}")
            diff = idx.cpu() != ridx
            rows = diff.any(-1)
            if bool(rows.any()):
                first = diff[rows].float().argmax(-1)
                srt = rprobs[rows].sort(-1, descending=True).values
                gap = (srt.gather(-1, first[:, None])
                       - srt.gather(-1, first[:, None] + 1))[:, 0]
                worst = float(gap.max())
                check(worst <= ROUTE_TIE, f"route pin: call {self.i} picks "
                      f"other experts than recorded where the recorded "
                      f"probabilities differ by {worst:.3e} (near-tie "
                      f"bound {ROUTE_TIE})")
                self.flips += int(rows.sum())
                self.worst = max(self.worst, worst)
                idx = ridx.to(idx.device)
                g = self._probs(p, x2d).gather(-1, idx)
                gates = (g / g.sum(-1, keepdim=True).clamp_min(1e-9)).to(
                    x2d.dtype)
        return idx, gates, aux

    def note(self):
        if not self.calls:
            return "no MoE layer"
        return (f"{len(self.calls)} routing calls, {self.flips} token rows "
                f"flipped at near-ties (largest gap {self.worst:.2e}, bound "
                f"{ROUTE_TIE})")


def pinned_forward(torch, params, plan, toks, labels):
    """The split forward with impl="jnp" (routes recorded), then with
    impl="flash" (routes held to them): both runs' logits and losses,
    the flash run's launches, and the pin's note."""
    from repro_torch.models import lm

    def run(impl):
        with torch.no_grad():
            sm, _ = lm.client_forward(params, plan, toks, impl=impl)
            logits, _ = lm.server_forward(params, plan, sm, impl=impl)
        return logits, float(lm.cross_entropy(logits, labels))

    with RoutePin(torch) as pin:
        pin.mode = "record"
        plain, plain_loss = run("jnp")
        pin.mode = "replay"
        reset_all_launch_counts()
        flash, flash_loss = run("flash")
        torch.cuda.synchronize()
        got = all_launch_counts()
        check(pin.i == len(pin.calls), f"route pin: {pin.i} of "
              f"{len(pin.calls)} recorded calls replayed")
    return plain, plain_loss, flash, flash_loss, got, pin.note()


def zoo_forward(torch, label, params, plan, S, want):
    """Phase 15 (b), (e), (f): the split forward at full width with
    impl="flash" under no_grad, launching ``want`` (B4 and B5 counts),
    held to impl="jnp" on the card; both timed. Returns the times, the
    error and the checked run's launches."""
    B = ZOO_FORWARD[0]
    dev = params["embed"]["table"].device
    gen = torch.Generator(device=dev).manual_seed(15)
    toks = torch.randint(0, plan.cfg.vocab_size, (B, S), generator=gen,
                         device=dev)
    labels = torch.randint(0, plan.cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    plain, plain_loss, flash, flash_loss, got, note = pinned_forward(
        torch, params, plan, toks, labels)
    check({k: got[k] for k in want} == want and not any(
        v for k, v in got.items() if k not in want),
          f"phase 15 {label} forward: launches {got}, expected {want}")
    err = float((flash - plain).abs().max())
    check(torch.allclose(flash, plain, atol=LM_LOGITS_TOL,
                         rtol=LM_LOGITS_TOL),
          f"phase 15 {label} forward: flash and jnp logits differ by {err}")
    check(np.isfinite(flash_loss) and abs(flash_loss - plain_loss)
          <= LM_LOSS_RTOL * abs(plain_loss),
          f"phase 15 {label} forward: flash loss {flash_loss}, jnp "
          f"{plain_loss}")
    del flash, plain
    flash_ms = lm_forward(torch, params, plan, toks, labels, "flash")[2]
    plain_ms = lm_forward(torch, params, plan, toks, labels, "jnp")[2]
    torch.cuda.empty_cache()
    log(f"[zoo] ({label}) split forward B {B} S {S}, impl=flash: launches "
        f"{ {k: got[k] for k in want} }; loss {flash_loss:.6f} (jnp "
        f"{plain_loss:.6f}); logits max abs diff flash vs jnp {err:.3e} "
        f"(tolerance {LM_LOGITS_TOL}); {note}; forward {flash_ms:.1f} ms "
        f"with impl=flash, {plain_ms:.1f} ms with impl=jnp; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{nvidia_smi_line()}]")
    return dict(flash_ms=flash_ms, plain_ms=plain_ms, err=err, launches=got)


def zoo_serve(torch, label, params, plan, spec, want_per_step,
              want_per_prefill=None):
    """Phase 15 (a), (e): the split server on a full-width model. Every
    request completes, B6 launches ``want_per_step["paged"]`` a decode
    step (and B5, where given, its count a prefill), every traffic event
    reconciles, the logits are finite; then a profiled decode step.
    Returns the step p50, the profile and the served run's launches."""
    from repro_torch import obs
    from repro_torch.obs.ledger import reconcile_events

    rec = obs.Recorder()
    reset_all_launch_counts()
    engine, _ = serve(torch, params, plan, "cuda", spec["codec"], rec, spec)
    got = all_launch_counts()
    steps = len(engine.step_latencies_s)
    check(len(engine.completions) == spec["users"] and all(
        c.num_tokens == spec["gen"] for c in engine.completions),
        f"phase 15 {label}: not every request completed")
    want = {"paged": want_per_step * steps}
    if want_per_prefill is not None:
        want["ssd"] = want_per_prefill * spec["users"]
    check(all(got[k] == v for k, v in want.items()) and got["flash"] == 0,
          f"phase 15 {label} serve: launches {got}, expected {want}")
    rows, bad = reconcile_events(rec.events)
    check(rows and bad == 0, f"phase 15 {label}: {bad} of {len(rows)} "
          "traffic events do not reconcile")
    check(bool(torch.isfinite(engine.last_logits).all()),
          f"phase 15 {label}: non-finite logits")
    s = engine.summary()
    ms = sorted(1e3 * t for t in engine.step_latencies_s)
    p50 = obs.percentile(ms, 0.5)
    log(f"[zoo] ({label}) served {s['users']} users, {s['tokens']} tokens, "
        f"{s['steps']} steps ({steps} decode), {s['tok_per_s']:.1f} tok/s; "
        f"decode step p50 {p50:.2f} ms p99 {obs.percentile(ms, 0.99):.2f} "
        f"ms; launches {got}; {len(rows)} traffic events reconcile "
        f"[{nvidia_smi_line()}]")
    prof = profile_steps(torch, engine, prompt_len=spec["prompt_len"])
    del engine
    torch.cuda.empty_cache()
    return dict(p50_ms=p50, launches=got, **prof)


def zoo_card_vs_cpu(torch):
    """Phase 15 (c): qwen3-moe at full width and 2 layers, the serve path
    (prefill and decode, fp32 wire) on the card and on the CPU with the
    CPU's routes pinned under the near-tie rule: identical greedy
    streams, first-step logits within LOGITS_ATOL; then 2 sfl_ga steps
    (fp32) from the same params and batches, held as phase 14 (d) holds
    them (phase 15 (d) holds the int8 boundary bit for bit)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    p = ZOO_TRAIN["cpu"]
    cfg = get_config(p["arch"]).with_overrides(num_layers=p["layers"])
    plan = lm.build_plan(cfg, p["cut"])
    params = lm.init_lm(1, plan, torch.float32, "cuda")
    cpu_params = tree_to(params, "cpu")
    t0 = time.perf_counter()
    with RoutePin(torch) as pin:
        pin.mode = "record"
        cpu, cpu_logits = serve(torch, cpu_params, plan, "cpu", "fp32")
        pin.mode = "replay"
        gpu, gpu_logits = serve(torch, params, plan, "cuda", "fp32")
        check(pin.i == len(pin.calls), "route pin: the card made fewer MoE "
              "calls than the CPU")
    err = float((gpu_logits - cpu_logits).abs().max())
    check(torch.allclose(gpu_logits, cpu_logits, atol=LOGITS_ATOL,
                         rtol=LOGITS_RTOL),
          f"phase 15 (c): first-step logits differ by up to {err}")
    streams = [{c.uid: c.tokens for c in e.completions} for e in (gpu, cpu)]
    check(streams[0] == streams[1], "phase 15 (c): card and CPU greedy "
          "streams differ")
    serve_s = time.perf_counter() - t0
    del params, cpu_params, cpu, gpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    note = lm_card_vs_cpu(torch, p, label="phase 15 (c)", codecs=("fp32",))
    log(f"[zoo] (c) card against CPU, {p['arch']} full width, "
        f"{p['layers']} layers: serve {len(streams[0])} identical greedy "
        f"streams, first-step logits max abs diff {err:.3e} (tolerance "
        f"{LOGITS_ATOL}), {pin.note()}, {serve_s:.1f} s; train "
        f"(sfl_ga, sgd, {p['steps']} steps): {note}; "
        f"{time.perf_counter() - t0:.1f} s")


def zoo_kernels(torch):
    """B4, B5 and B6 at the zoo's shapes, each held to its plain version
    and timed beside it (and SDPA for B4 and B6), with its bound."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(15)
    for name, slots, hkv, g, d, page, lengths, maxp in ZOO_PAGED:
        paged_case(torch, name, slots, hkv, g, d, page, lengths, maxp,
                   flush, sms)
    for case in ZOO_FLASH:
        flash_case(torch, *case, gen, flush)
    for case in ZOO_SSD:
        ssd_case(torch, *case, gen, flush, sms)
    del flush
    torch.cuda.empty_cache()


def ring_decode(torch, params, plan):
    """Phase 15 (f): ``lm.prefill`` of a prompt longer than the window,
    then greedy ``lm.decode_step``s over the ring cache; each step's
    logits held to the windowed full-sequence forward (impl="flash") over
    the prompt and the fed tokens at that position."""
    from repro_torch.models import lm

    P, n = STARCODER["prompt"], STARCODER["gen"]
    window = plan.cfg.sliding_window
    dev = params["embed"]["table"].device
    gen = torch.Generator(device=dev).manual_seed(16)
    prompt = torch.randint(0, plan.cfg.vocab_size, (1, P), generator=gen,
                           device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, caches = lm.prefill(params, plan, prompt, max_len=P + n)
        cap = caches[0][0][0].k.shape[1]
        check(cap == min(P + n, window), f"phase 15 (f): ring of {cap} "
              f"rows for window {window}")
        steps, fed = [logits[:, 0]], []
        for _ in range(n):
            tok = torch.argmax(steps[-1], -1)[:, None]
            fed.append(tok)
            logits, caches = lm.decode_step(params, plan, tok, caches)
            steps.append(logits[:, 0])
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t0
        full_toks = torch.cat([prompt] + fed, 1)
        sm, _ = lm.client_forward(params, plan, full_toks, impl="flash")
        full, _ = lm.server_forward(params, plan, sm, impl="flash")
    # step t's logits are those at position P - 1 + t
    err = max(float((s - full[:, P - 1 + t]).abs().max())
              for t, s in enumerate(steps))
    check(all(torch.allclose(s, full[:, P - 1 + t], atol=LM_LOGITS_TOL,
                             rtol=LM_LOGITS_TOL)
              for t, s in enumerate(steps)),
          f"phase 15 (f): ring-cache decode logits differ from the "
          f"windowed forward by up to {err}")
    return (f"ring cache of {cap} rows: prefill of {P} tokens and {n} "
            f"greedy decode steps in {ring_s:.2f} s, each step's logits "
            f"within {err:.3e} of the windowed forward over prompt + fed "
            f"tokens (tolerance {LM_LOGITS_TOL})")


def phase_zoo(torch):
    """Phase 15: the decoder zoo on the card (see the module
    docstring). Returns the per-part numbers for the log."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    total = {k: 0 for k in all_launch_counts()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    out = {}
    reset_all_launch_counts()
    zoo_kernels(torch)  # its launches hold kernels, not the main path

    # (a) qwen3-moe-30b-a3b at full width, 24 layers, served; (b) its
    # split forward with impl="flash"
    cfg = get_config("qwen3-moe-30b-a3b").with_overrides(
        num_layers=ZOO_MOE_LAYERS)
    plan = lm.build_plan(cfg, 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(0, plan, torch.float32, "cuda")
    torch.cuda.synchronize()
    log(f"[zoo] (a) {cfg.name} full width, {cfg.num_layers} layers: f32 "
        f"weights on the card in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated) [{card}]")
    out["a"] = zoo_serve(torch, "a", params, plan, SERVE, cfg.num_layers)
    add(out["a"]["launches"])
    torch.cuda.reset_peak_memory_stats()
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    out["b"] = zoo_forward(torch, "b", params, plan, ZOO_FORWARD[1],
                           {"flash": cfg.num_layers, "combine": n_moe,
                            "count": n_moe})
    add(out["b"]["launches"])
    del params
    torch.cuda.empty_cache()

    # (c) card against CPU at 2 layers
    reset_all_launch_counts()
    zoo_card_vs_cpu(torch)
    add(all_launch_counts())

    # (d) MoE training through the launcher
    tmp = ROOT / "build"
    tmp.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase15_", dir=tmp))
    held, unspy = spy_kernels(torch)
    try:
        for label in ("d-full", "d-lora"):
            p = ZOO_TRAIN[label]
            reset_all_launch_counts()
            res, recs, peak, migs = lm_run(torch, label, p, "cuda", tmp,
                                           profile_step=p["steps"] - 1)
            add(all_launch_counts())
            check(len(migs) == p["migrations"],
                  f"phase 15 ({label}): {len(migs)} migrations")
            out[label] = lm_summary(label, p, res, recs, peak, migs, card)
            torch.cuda.empty_cache()
    finally:
        unspy()
        shutil.rmtree(tmp, ignore_errors=True)
    check({k[0] for k in held} == {"B1", "B2", "B3"},
          f"phase 15 held only {sorted(held)} to the plain versions")
    log("[zoo] (d) held bit for bit to the plain versions at every "
        "distinct input: B1 " + ", ".join(
            f"({k[1]}, {k[2]}): {held[k].path} ({held[k].grid} blocks)"
            for k in sorted(held) if k[0] == "B1")
        + "; B2 " + ", ".join(f"{k[1]} int{k[2]}" for k in sorted(held)
                               if k[0] == "B2")
        + "; B3 " + ", ".join(f"{k[1]} int{k[4]}" for k in sorted(held)
                               if k[0] == "B3"))

    # (e) jamba-v0.1-52b at full width, one period
    cfg = get_config("jamba-v0.1-52b").with_overrides(num_layers=JAMBA_LAYERS)
    plan = lm.build_plan(cfg, 1)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(3, plan, torch.float32, "cuda")
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    log(f"[zoo] (e) {cfg.name} full width, {cfg.num_layers} layers ({n_attn}"
        f" attention, {cfg.num_layers - n_attn} Mamba-2): "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of f32 weights on the "
        f"card [{card}]")
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    out["e-forward"] = zoo_forward(
        torch, "e", params, plan, ZOO_FORWARD[1],
        {"flash": n_attn, "ssd": cfg.num_layers - n_attn, "combine": n_moe,
         "count": n_moe})
    add(out["e-forward"]["launches"])
    out["e"] = zoo_serve(torch, "e", params, plan, JAMBA_SERVE, n_attn,
                         cfg.num_layers - n_attn)
    add(out["e"]["launches"])
    del params
    torch.cuda.empty_cache()

    # (f) starcoder2-3b at full width and depth: the windowed forward and
    # the ring cache
    cfg = get_config("starcoder2-3b")
    plan = lm.build_plan(cfg, 1)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(4, plan, torch.float32, "cuda")
    out["f"] = zoo_forward(torch, "f", params, plan, STARCODER["seq"],
                           {"flash": cfg.num_layers})
    add(out["f"]["launches"])
    reset_all_launch_counts()
    note = ring_decode(torch, params, plan)
    add(all_launch_counts())
    log(f"[zoo] (f) {cfg.name} full width, {cfg.num_layers} layers, window "
        f"{cfg.sliding_window}: {note}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del params
    torch.cuda.empty_cache()
    # the checked runs' launches: the kernels' comparisons, the timing
    # repeats and the profiled steps are left out
    check(total["combine"] > 0 and total["combine_passed"] == 0,
          f"phase 15: {total['combine']} M1 launches, "
          f"{total['combine_passed']} MoE combines left on the plain "
          f"version on the card")
    check(total["count"] > 0 and total["count_passed"] == 0,
          f"phase 15: {total['count']} M2 launches, "
          f"{total['count_passed']} position counts left on the plain "
          f"version on the card")
    log(f"[zoo] kernel launches in phase 15's paths: B1 {total['grad_agg']} "
        f"B2 {total['quantize']} B3 {total['dequant_agg']} B4 "
        f"{total['flash']} B5 {total['ssd']} B6 {total['paged']} M1 "
        f"{total['combine']} ({total['combine_passed']} combines on the "
        f"plain version) M2 {total['count']} ({total['count_passed']} "
        f"counts on the plain version); phase "
        f"{time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 16: whisper-tiny's encoder-decoder, the LM async loop and the LM
# DDQN schedule on the card
# ---------------------------------------------------------------------------

# (a) whisper-tiny at full width and depth (4 + 4 layers, d 384, 6 heads,
# d_ff 1536, 1,500 frames, vocab 51,865), split at cut 1: N 4 clients of b
# 2 clips and 64 decoder tokens, sfl_ga, sgd; 5 steps at fp32 and then 5
# at int8 both ways.
# The encoder's states cross the wire at b x 1,500 x 384 = 1,152,000 f32 a
# client, the decoder's residual at b x 64 x 384 = 49,152
WHISPER = dict(cut=1, clients=4, batch=2, seq=64, steps=5, lr=0.05)
# (b) 4 prompts of 16 decoder tokens over 1,500 frames, 16 greedy steps
WHISPER_SERVE = dict(prompts=4, prompt_len=16, gen=16)
# (c) card against CPU at full width and reduced depth (1 encoder and 2
# decoder layers, cut 1): N 2, b 1, 32 tokens, 2 sgd steps at fp32 and
# int8 (the CPU's state carried in before each int8 step, C3), then a
# prefill of 8 tokens and 8 greedy steps of the whole model
WHISPER_CHECK = dict(enc_layers=1, layers=2, cut=1, clients=2, batch=1,
                     seq=32, steps=2, lr=0.05, prompt_len=8, gen=8)
# (d) the LM async loop through the launcher: granite-8b at full width and
# 2 layers, sfl_ga int8/int8, sgd, N 8, cohorts of K 4, merges of B 2,
# straggler spread 8, 4 merges and the drain; on the card and then on the
# CPU with the same flags
LM_ASYNC = dict(arch="granite-8b", preset="full", layers=2, cut=1,
                clients=8, cohort=4, batch=1, seq=64, steps=4,
                optimizer="sgd", lr=0.05, codec="int8")
LM_ASYNC_FLAGS = ["--async", "--buffer", "2", "--straggler", "8"]
# (e) --dynamic-cut ddqn:4 on granite-8b at full width and 3 layers, sgd,
# N 2, b 1, 64 tokens, 4 steps, with and without LoRA (r 8, alpha 16), at
# the first seed in LM_DDQN_SEEDS whose frozen rollout moves the cut
# within the run
LM_DDQN = dict(arch="granite-8b", preset="full", layers=3, clients=2,
               batch=1, seq=64, steps=4, optimizer="sgd", lr=0.05,
               episodes=4)
LM_DDQN_SEEDS = range(1, 9)


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def whisper_batches(torch, cfg, spec, steps, seed, device):
    """``steps`` batches of random frame embeddings (the stub frontend's
    input) and decoder tokens and labels, made with numpy from ``seed``."""
    rng = np.random.RandomState(seed)
    n, b, S = spec["clients"], spec["batch"], spec["seq"]
    out = []
    for i in range(steps):
        fe = rng.randn(n, b, cfg.encoder.num_frames,
                       cfg.d_model).astype(np.float32)
        toks = rng.randint(0, cfg.vocab_size, (n, b, S))
        labels = rng.randint(0, cfg.vocab_size, (n, b, S))
        out.append({"frame_embeds": torch.from_numpy(fe).to(device),
                    "tokens": torch.from_numpy(toks).to(device),
                    "labels": torch.from_numpy(labels).to(device),
                    "seed": np.uint32(16 + i)})
    return out


def whisper_step(cfg, spec, codec, engine=None):
    from repro_torch.configs import TrainConfig
    from repro_torch.core import algorithms as alg
    from repro_torch.optim import make_optimizer

    tcfg = TrainConfig(model=cfg, algo="sfl_ga", cut_layer=spec["cut"],
                       compute_dtype="float32", param_dtype="float32",
                       lr=spec["lr"], uplink_codec=codec,
                       downlink_codec=codec, seed=16)
    opt = make_optimizer("sgd", spec["lr"])
    return alg.make_whisper_train_step(cfg, tcfg, opt, spec["clients"],
                                       engine=engine), opt


def whisper_wire_bits(cfg, spec, codec):
    """The ledger's bits of one sfl_ga whisper step: both boundaries'
    uplinks from every client and one broadcast of each downlink; the
    labels once."""
    from repro_torch.obs.ledger import LEDGER_CATEGORIES
    from repro_torch.sysmodel.traffic import wire_bits

    n, b = spec["clients"], spec["batch"]
    sizes = (b * spec["seq"] * cfg.d_model,
             b * cfg.encoder.num_frames * cfg.d_model)
    out = {c: 0 for c in LEDGER_CATEGORIES}
    out["up_smashed"] = n * sum(wire_bits(codec, m, 32.0) for m in sizes)
    out["up_labels"] = n * b * spec["seq"] * 32
    out["down_grad"] = sum(wire_bits(codec, m, 32.0) for m in sizes)
    return out


def whisper_train(torch, card, device, cfg, spec=WHISPER):
    """Phase 16 (a): split whisper training, fp32 then int8. Returns the
    per-codec step p50, peak memory and losses."""
    from repro_torch.core.protocol import ProtocolEngine
    from repro_torch.launch import specs
    from repro_torch.obs import TrafficLedger
    from repro_torch.tree import tree_leaves

    cuda = torch.device(device).type == "cuda"
    n = spec["clients"]
    split = specs._whisper_split_stacked(cfg, spec["cut"], n, seed=16,
                                         device=device)
    per_client = sum(x.numel() for x in tree_leaves(split["client"])) // n
    total = per_client + sum(x.numel() for x in tree_leaves(split["server"]))
    batches = whisper_batches(torch, cfg, spec, spec["steps"], 16, device)
    out = {}
    for codec in ("fp32", "int8"):
        eng = ProtocolEngine("sfl_ga", codec, codec)
        ledger = TrafficLedger()
        eng.attach_ledger(ledger, raw_bits_per_elem=32.0,
                          label_bits_per_epoch=spec["batch"] * spec["seq"]
                          * 32)
        step, opt = whisper_step(cfg, spec, codec, eng)
        params, st = split, opt.init(split)
        # two boundaries a step
        want = {k: 2 * v if cuda else 0 for k, v in
                predicted_launches("sfl_ga", codec).items()}
        bits = whisper_wire_bits(cfg, spec, codec)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        secs, losses = [], []
        for i, batch in enumerate(batches):
            before = launch_counts()
            sync(torch, device)
            t0 = time.perf_counter()
            params, st, m = step(params, st, batch)
            losses.append(float(m["loss"]))
            sync(torch, device)
            secs.append(time.perf_counter() - t0)
            got = {k: v - before[k] for k, v in launch_counts().items()}
            check(got == want, f"phase 16 (a) {codec} step {i}: launches "
                  f"{got}, predicted {want} (two boundaries)")
            snap = ledger.snapshot_and_reset()
            check(snap == bits, f"phase 16 (a) {codec} step {i}: the "
                  f"ledger {snap} is not both boundaries' {bits}")
            check(np.isfinite(losses[-1]),
                  f"phase 16 (a) {codec} step {i}: loss {losses[-1]}")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        # the first two steps warm the caches and cuBLAS's heuristics
        ms = [1e3 * s for s in secs]
        p50 = float(np.median(ms[2:] or ms))
        layers = f"{cfg.encoder.num_layers} + {cfg.num_layers} layers"
        log(f"[whisper] (a) {cfg.name} ({layers}, d {cfg.d_model}, "
            f"{total / 1e6:.1f} M parameters a client's model, "
            f"{per_client / 1e6:.1f} M of them client-side), cut "
            f"{spec['cut']}, N {n}, b {spec['batch']}, "
            f"{cfg.encoder.num_frames} frames, {spec['seq']} tokens, sfl_ga "
            f"{codec}: losses {', '.join(f'{x:.4f}' for x in losses)}; step "
            f"ms {', '.join(f'{x:.1f}' for x in ms)}: p50 {p50:.2f} ms; peak "
            f"{peak / 2**30:.2f} GiB; launches B1/B2/B3 {want['grad_agg']}/"
            f"{want['quantize']}/{want['dequant_agg']} a step (two "
            f"boundaries); ledger exact [{card}]")
        out[codec] = dict(p50_ms=p50, peak_gib=peak / 2**30, losses=losses)
        del params, st
    return out


def whisper_greedy(torch, params, cfg, fe, toks, gen):
    """Prefill and ``gen`` greedy steps without autograd; returns the
    tokens, each step's last-position logits (on the CPU) and the host
    times (s) of the prefill and of each step."""
    from repro_torch import full_f32
    from repro_torch.models import encdec

    with torch.no_grad(), full_f32():
        sync(torch, fe.device)
        t0 = time.perf_counter()
        logits, caches = encdec.whisper_prefill(
            params, cfg, fe, toks, max_len=toks.shape[1] + gen)
        sync(torch, fe.device)
        times = [time.perf_counter() - t0]
        tokens, all_logits = [], [logits[:, -1].float().cpu()]
        for _ in range(gen):
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            tokens.append(tok.cpu())
            t0 = time.perf_counter()
            logits, caches = encdec.whisper_decode_step(params, cfg, tok,
                                                        caches)
            sync(torch, fe.device)
            times.append(time.perf_counter() - t0)
            all_logits.append(logits[:, -1].float().cpu())
    return torch.cat(tokens, dim=1), all_logits, times


def whisper_serve(torch, card, device, cfg, spec=WHISPER_SERVE):
    """Phase 16 (b): whisper served at its config."""
    from repro_torch.models import encdec

    params = encdec.init_whisper(16, cfg, device=device)
    rng = np.random.RandomState(16)
    fe = torch.from_numpy(rng.randn(spec["prompts"], cfg.encoder.num_frames,
                                    cfg.d_model).astype(np.float32))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (
        spec["prompts"], spec["prompt_len"])))
    fe, toks = fe.to(device), toks.to(device)
    whisper_greedy(torch, params, cfg, fe, toks, 2)  # warm-up
    before = all_launch_counts()
    tokens, logits, times = whisper_greedy(torch, params, cfg, fe, toks,
                                           spec["gen"])
    got = {k: v - before[k] for k, v in all_launch_counts().items()}
    check(all(bool(torch.isfinite(x).all()) for x in logits),
          "phase 16 (b): a logit is not finite")
    check(tuple(tokens.shape) == (spec["prompts"], spec["gen"])
          and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size,
          f"phase 16 (b): tokens {tuple(tokens.shape)} out of range")
    check(not any(got.values()), f"phase 16 (b): whisper's serving "
          f"launched {got}; its reference reaches no kernel")
    p50 = float(np.median([1e3 * t for t in times[1:]]))
    log(f"[whisper] (b) {cfg.name} served: {spec['prompts']} prompts of "
        f"{spec['prompt_len']} tokens over {cfg.encoder.num_frames} frames, "
        f"prefill {1e3 * times[0]:.2f} ms (the encoder included), "
        f"{spec['gen']} greedy steps on the dense cache, p50 {p50:.2f} ms "
        f"({spec['prompts'] * 1e3 / p50:.0f} tokens/s); tokens and logits "
        f"finite; first stream {tokens[0, :8].tolist()} [{card}]")
    return dict(prefill_ms=1e3 * times[0], step_p50_ms=p50)


def whisper_card_vs_cpu(torch, card, device, full, spec=WHISPER_CHECK):
    """Phase 16 (c): the train step and the greedy stream at reduced depth
    on ``device`` and on the CPU."""
    from repro_torch.launch import specs
    from repro_torch.models import encdec
    from repro_torch.tree import tree_leaves

    cfg = full.with_overrides(num_layers=spec["layers"], encoder=(
        dataclasses.replace(full.encoder, num_layers=spec["enc_layers"])))
    n, lr = spec["clients"], spec["lr"]
    split = specs._whisper_split_stacked(cfg, spec["cut"], n, seed=17,
                                         device="cpu")
    batches = whisper_batches(torch, cfg, spec, spec["steps"], 17, "cpu")
    notes = []
    for codec in ("fp32", "int8"):
        step, opt = whisper_step(cfg, spec, codec)
        # "dev" runs on ``device``, "cpu" on the CPU
        where = {"cpu": "cpu", "dev": device}
        state = {"cpu": (split, opt.init(split))}
        state["dev"] = tree_to(state["cpu"], device)
        worst = (0.0, 0.0, 0.0)
        for i, batch in enumerate(batches):
            if codec != "fp32":  # the CPU's state, carried in (C3)
                state["dev"] = tree_to(state["cpu"], device)
            loss = {}
            for k, d in where.items():
                b = {n: v if n == "seed" else v.to(d)
                     for n, v in batch.items()}
                pr, st, m = step(*state[k], b)
                state[k] = (pr, st)
                loss[k] = float(m["loss"])
            rel = abs(loss["dev"] - loss["cpu"]) / abs(loss["cpu"])
            err = torch.cat([(g.cpu() - c).abs().reshape(-1) for g, c in zip(
                tree_leaves(state["dev"][0]), tree_leaves(state["cpu"][0]))])
            share = float((err > LM_TRAIN_PARAM_ATOL).float().mean())
            reach = 2 * lr * (1 if codec != "fp32" else i + 1)
            check(rel <= LM_LOSS_RTOL and float(err.max()) <= reach
                  and share <= LM_TRAIN_ADAM_SHARE[codec],
                  f"phase 16 (c) {codec} step {i}: loss rel {rel:.2e}, "
                  f"params max {float(err.max()):.2e} (reach {reach}), "
                  f"share beyond {LM_TRAIN_PARAM_ATOL}: {share:.2e}")
            worst = tuple(max(a, b) for a, b in zip(
                worst, (rel, float(err.max()), share)))
        notes.append(f"{codec} steps: loss rel {worst[0]:.2e}, params max "
                     f"{worst[1]:.2e}, share beyond {LM_TRAIN_PARAM_ATOL} "
                     f"{worst[2]:.2e}")
        del state
    params = encdec.init_whisper(17, cfg, device="cpu")
    rng = np.random.RandomState(17)
    fe = torch.from_numpy(rng.randn(2, cfg.encoder.num_frames,
                                    cfg.d_model).astype(np.float32))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        (2, spec["prompt_len"])))
    t_cpu, l_cpu, _ = whisper_greedy(torch, params, cfg, fe, toks,
                                     spec["gen"])
    t_dev, l_dev, _ = whisper_greedy(torch, tree_to(params, device), cfg,
                                     fe.to(device), toks.to(device),
                                     spec["gen"])
    err = max(float((a - b).abs().max()) for a, b in zip(l_dev, l_cpu))
    check(torch.equal(t_dev, t_cpu), f"phase 16 (c): greedy streams differ "
          f"between the card and the CPU: {t_dev.tolist()} {t_cpu.tolist()}")
    check(err <= LOGITS_ATOL, f"phase 16 (c): logits differ by {err:.3e} "
          f"(tolerance {LOGITS_ATOL})")
    notes.append(f"{t_dev.numel()} greedy tokens identical, logits max abs "
                 f"diff {err:.3e} (tolerance {LOGITS_ATOL})")
    log(f"[whisper] (c) card against CPU, d {cfg.d_model}, "
        f"{cfg.encoder.num_layers} + {cfg.num_layers} layers: "
        + "; ".join(notes) + f" [{card}]")


def lm_async_run(torch, label, p, device, tmp, draw_on=None):
    """One launch of the LM launcher with ``--async``. Every generation's
    B1/B2/B3 launches must equal ``predicted_launches`` (none on the CPU)
    and every merge's ``async_traffic`` event must reconcile. With
    ``draw_on`` the launcher's ``init_lm`` draws there and copies to
    ``device`` (the card's generator and the CPU's draw other bits from
    one seed). Returns the launcher's result, each merge's (client,
    generation) pairs and staleness, the merge events, the generations'
    sizes and the peak device memory."""
    from repro_torch.core import algorithms as alg
    from repro_torch.launch import train
    from repro_torch.models import lm

    cuda = device == "cuda"
    want = predicted_launches("sfl_ga", p["codec"]) if cuda \
        else {k: 0 for k in launch_counts()}
    gens, merges = [], []
    orig_gen = alg.make_gen_step
    orig_merge = train._LMAsyncExecutor.apply_merge

    def make(*a, **kw):
        gen = orig_gen(*a, **kw)

        def counted(params, opt_state, batch):
            before = launch_counts()
            out = gen(params, opt_state, batch)
            got = {k: v - before[k] for k, v in launch_counts().items()}
            check(got == want, f"phase 16 {label} generation {len(gens)}: "
                  f"launches {got}, predicted {want}")
            gens.append(int(batch["tokens"].shape[0]))
            return out

        return counted

    def merge(self, items, taus, lam, merge_idx):
        merges.append(([(it["client"], it["gen"]) for it in items],
                       [float(t) for t in taus]))
        return orig_merge(self, items, taus, lam, merge_idx)

    run_dir = tmp / label
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    orig_init = lm.init_lm
    if draw_on is not None:
        lm.init_lm = lambda seed, plan, dtype, dev: tree_to(
            orig_init(seed, plan, dtype, draw_on), dev)
    alg.make_gen_step, train._LMAsyncExecutor.apply_merge = make, merge
    t0 = time.perf_counter()
    try:
        res = train.main(lm_argv(p, device, run_dir, extra=LM_ASYNC_FLAGS))
    finally:
        alg.make_gen_step, lm.init_lm = orig_gen, orig_init
        train._LMAsyncExecutor.apply_merge = orig_merge
    res["wall_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    with open(run_dir / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    traffic = [e for e in events if e.get("name") == "async_traffic"]
    merge_events = [{k: e[k] for k in ("merge_idx", "clock", "merged",
                                       "dispatched", "queue_depth",
                                       "staleness_mean", "staleness_max")}
                    for e in events if e.get("kind") == "async"]
    check(len(traffic) == len(merge_events) == res["async"]["merges"]
          == len(merges), f"phase 16 {label}: {len(traffic)} traffic events"
          f" for {res['async']['merges']} merges")
    check(all(e["measured"] == e["modeled"] for e in traffic),
          f"phase 16 {label}: a merge's traffic does not reconcile")
    check(len(gens) == res["async"]["dispatches"],
          f"phase 16 {label}: {len(gens)} generations for "
          f"{res['async']['dispatches']} dispatches")
    check(all(np.isfinite(x) for x in res["losses"]),
          f"phase 16 {label}: a loss is not finite")
    return res, merges, merge_events, gens, peak


def lm_async(torch, card, tmp, device, p=LM_ASYNC):
    """Phase 16 (d): the LM async loop on ``device`` and on the CPU."""
    res, merges, events, gens, peak = lm_async_run(torch, "d-card", p,
                                                   device, tmp)
    t0 = time.perf_counter()
    # the CPU launch starts from the card's draw
    cres, cmerges, cevents, cgens, _ = lm_async_run(torch, "d-cpu", p,
                                                    "cpu", tmp,
                                                    draw_on=device)
    cpu_s = time.perf_counter() - t0
    check(res["async"] == cres["async"] and merges == cmerges
          and events == cevents and gens == cgens,
          f"phase 16 (d): the card's schedule {res['async']} {merges} is "
          f"not the CPU's {cres['async']} {cmerges}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                 cres["losses"]))
    check(rel <= LM_LOSS_RTOL, f"phase 16 (d): losses {res['losses']} on "
          f"the card, {cres['losses']} on the CPU (rel {rel:.2e})")
    st = res["async"]
    losses = ", ".join(f"{x:.4f}" for x in res["losses"])
    log(f"[lm-async] (d) {p['arch']} {p['preset']}, {p['layers']} layers, "
        f"sfl_ga {p['codec']}, sgd, N {p['clients']}, K {p['cohort']}, "
        f"{' '.join(LM_ASYNC_FLAGS[1:])}: {st['merges']} merges of "
        f"{st['dispatches']} generations (sizes {gens}), virtual clock "
        f"{st['clock']:.4f} s; the merge order, the staleness, the clock "
        f"and the dispatches equal the CPU launch's exactly; every "
        f"async_traffic event reconciles; losses {losses} (rel to the "
        f"CPU's {rel:.2e}); the launch {res['wall_s']:.1f} s, peak "
        f"{peak / 2**30:.2f} GiB; the CPU launch {cpu_s:.1f} s [{card}]")
    return dict(merges=st["merges"], dispatches=st["dispatches"],
                loss_rel=rel, peak_gib=peak / 2**30, wall_s=res["wall_s"])


def lm_ddqn(torch, card, tmp, device, base=LM_DDQN, seeds=LM_DDQN_SEEDS):
    """Phase 16 (e): the LM DDQN schedule through the launcher, with and
    without LoRA; then ``lm_env_config`` on the full granite-8b."""
    from types import SimpleNamespace

    from repro_torch.ccc.env import lm_env_config
    from repro_torch.configs import PeftSpec, get_config
    from repro_torch.core.split import (client_adapter_numel,
                                        client_param_numel)
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.sysmodel.traffic import (adapter_migration_bits,
                                              migration_bits)

    out = {}
    spec = f"ddqn:{base['episodes']}"
    for label, lora in (("e-full", None), ("e-lora", (8, 16.0))):
        p = dict(base, lora=lora, dynamic_cut=spec)
        cfg = train._lm_config(SimpleNamespace(
            arch=p["arch"], preset=p["preset"], layers=p["layers"]))
        peft = PeftSpec(rank=lora[0], alpha=lora[1]) if lora else None
        t0 = time.perf_counter()
        for seed in seeds:  # the first seed whose rollout moves the cut
            sched = train._lm_ddqn_schedule(
                spec, SimpleNamespace(seed=seed, cohort=None), cfg, peft,
                p["clients"], p["batch"], p["seq"], device)
            if len({sched(i) for i in range(p["steps"])}) > 1:
                break
        search_s = time.perf_counter() - t0
        scheds = []
        orig = train._lm_ddqn_schedule

        def spy(*a):
            scheds.append(orig(*a))
            return scheds[-1]

        train._lm_ddqn_schedule = spy
        try:
            res, recs, peak, migs = lm_run(torch, label, p, device, tmp,
                                           extra=["--seed", str(seed)])
        finally:
            train._lm_ddqn_schedule = orig
        rollout = [scheds[0](i) for i in range(p["steps"])]
        with open(tmp / label / "events.jsonl") as f:
            stepped = [e["cut"] for e in map(json.loads, f)
                       if e.get("name") == "step_traffic"]
        check(stepped == rollout, f"phase 16 ({label}): the run's cuts "
              f"{stepped} are not its frozen rollout's {rollout}")
        check(len(migs) == sum(x != y for x, y in zip(stepped, stepped[1:])),
              f"phase 16 ({label}): {len(migs)} migrations for cuts "
              f"{stepped}")
        for e in migs:
            a = lm.build_plan(cfg, e["cut_from"], peft=peft)
            b = lm.build_plan(cfg, e["cut"], peft=peft)
            mb = (adapter_migration_bits(client_adapter_numel(a),
                                         client_adapter_numel(b),
                                         n_clients=p["clients"],
                                         raw_bits_per_elem=32) if lora else
                  migration_bits(client_param_numel(a),
                                 client_param_numel(b),
                                 n_clients=p["clients"],
                                 raw_bits_per_elem=32))
            check(e["modeled"] == e["measured"] == mb,
                  f"phase 16 ({label}): migration {e['cut_from']} -> "
                  f"{e['cut']}: {e['measured']}, priced {mb}")
        bits = ", ".join(str(e["modeled"]["total_bits"]) for e in migs)
        losses = ", ".join(f"{r['loss']:.4f}" for r in recs)
        log(f"[lm-ddqn] ({label}) {p['arch']} {p['preset']}, {p['layers']} "
            f"layers, {'LoRA r 8, ' if lora else ''}--dynamic-cut {spec} "
            f"--seed {seed} (found in {search_s:.1f} s): the agent on "
            f"{device}, frozen rollout {scheds[0].cuts}; the run's cuts "
            f"{stepped} follow it; {len(migs)} migrations of [{bits}] "
            f"bits, each the priced one; losses {losses}; peak "
            f"{peak / 2**30:.2f} GiB; the launch {res['wall_s']:.1f} s "
            f"[{card}]")
        out[label] = dict(seed=seed, cuts=stepped, migrations=len(migs))
        if device == "cuda":
            torch.cuda.empty_cache()
    full = get_config("granite-8b")
    for lora in (None, PeftSpec()):
        e = lm_env_config(full, seq=base["seq"], peft=lora,
                          n_clients=base["clients"], batch=base["batch"])
        at = (0, 1, len(e.phis) // 2 - 1, len(e.phis) - 1)
        log(f"[lm-ddqn] lm_env_config({full.name}, {full.num_layers} "
            f"layers{', LoRA' if lora else ''}) at v = "
            f"{', '.join(str(v + 1) for v in at)}: phi(v) "
            f"{[e.phis[v] for v in at]}, mig_phis "
            f"{[e.mig_phis[v] for v in at]}, client FLOP fraction "
            f"{[round(e.flop_fracs[v], 6) for v in at]}; q "
            f"{e.total_params}; X(v) {e.smashed_elems[0]} a sample")
    return out


def phase_whisper_lm(torch, device="cuda", whisper_cfg=None, specs=None):
    """Phase 16: whisper-tiny, the LM async loop and the LM DDQN schedule
    (see the module docstring). ``device="cpu"`` with a reduced
    ``whisper_cfg`` and smaller ``specs`` (keys ``WHISPER``,
    ``WHISPER_SERVE``, ``WHISPER_CHECK``, ``LM_ASYNC``, ``LM_DDQN``)
    rehearses it without a card (no launches; (c) and (d) compare the CPU
    with itself)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    card = nvidia_smi_line() if cuda else "cpu"
    cfg = whisper_cfg or get_config("whisper-tiny")
    sp = dict(WHISPER=WHISPER, WHISPER_SERVE=WHISPER_SERVE,
              WHISPER_CHECK=WHISPER_CHECK, LM_ASYNC=LM_ASYNC,
              LM_DDQN=LM_DDQN)
    sp.update(specs or {})
    out = {}
    reset_all_launch_counts()
    tmp = ROOT / "build"
    tmp.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase16_", dir=tmp))
    held, unspy = spy_kernels(torch)
    try:
        t0 = time.perf_counter()
        out["a"] = whisper_train(torch, card, device, cfg, sp["WHISPER"])
        path_a = all_launch_counts()
        t1 = time.perf_counter()
        out["b"] = whisper_serve(torch, card, device, cfg,
                                 sp["WHISPER_SERVE"])
        t2 = time.perf_counter()
        whisper_card_vs_cpu(torch, card, device, cfg, sp["WHISPER_CHECK"])
        t3 = time.perf_counter()
        log(f"[whisper] (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
            f"{t3 - t2:.1f} s")
        reset_launch_counts()
        out["d"] = lm_async(torch, card, tmp, device, sp["LM_ASYNC"])
        path_d = launch_counts()
        t4 = time.perf_counter()
        reset_launch_counts()
        out["e"] = lm_ddqn(torch, card, tmp, device, sp["LM_DDQN"])
        path_e = launch_counts()
        log(f"[lm] (d) {t4 - t3:.1f} s, (e) {time.perf_counter() - t4:.1f} "
            "s")
    finally:
        unspy()
        shutil.rmtree(tmp, ignore_errors=True)
    if cuda:
        check({k[0] for k in held} == {"B1", "B2", "B3"},
              f"phase 16 held only {sorted(held)} to the plain versions")
        log("[whisper/lm] held bit for bit to the plain versions at every "
            "distinct input: B1 " + ", ".join(
                f"({k[1]}, {k[2]}): {held[k].path} ({held[k].grid} blocks)"
                for k in sorted(held) if k[0] == "B1")
            + "; B2 " + ", ".join(f"{k[1]} int{k[2]}" for k in sorted(held)
                                   if k[0] == "B2")
            + "; B3 " + ", ".join(f"{k[1]} int{k[4]}" for k in sorted(held)
                                   if k[0] == "B3"))
    # the checked runs' launches; (c)'s card steps, held to the CPU's, are
    # left out
    log(f"[whisper/lm] kernel launches in phase 16's paths: (a) B1 "
        f"{path_a['grad_agg']} B2 {path_a['quantize']} B3 "
        f"{path_a['dequant_agg']} (B4 {path_a['flash']} B5 {path_a['ssd']} "
        f"B6 {path_a['paged']}); (d) B1 {path_d['grad_agg']} B2 "
        f"{path_d['quantize']} B3 {path_d['dequant_agg']}; (e) B1 "
        f"{path_e['grad_agg']} B2 {path_e['quantize']} B3 "
        f"{path_e['dequant_agg']}; phase {time.perf_counter() - t_phase:.1f}"
        f" s [{card}]")
    out["launches"] = dict(a=path_a, d=path_d, e=path_e)
    return out


# phase 17: the dry run's granite-8b x train_4k x single rows under sfl_ga
# and sfl (a subprocess on the CPU, fake tensors over a fake 256-rank
# group), and a real granite-8b step on the card held to its roofline
# bound: full width, 4 layers, cut 2, sfl_ga fp32 in full f32, N 4, b 1,
# S 1,024 (4,096 tokens a step)
ROOF_DRYRUN = dict(arch="granite-8b", shape="train_4k", mesh="single",
                   layers=None, timeout=600)
ROOF = dict(arch="granite-8b", layers=4, cut=2, clients=4, batch=1,
            seq=1024, steps=5, lr=0.01)
# phase 17 (c): the (b) step at b 2. At b 1 the step's peak is the sgd
# update's (params, gradients, updates and new params: 38,253,150,220 B
# of live storage on fake tensors with remat and without), so remat's
# saving shows only where the layers' activations outgrow it: at b 2,
# 41,891,446,844 B without remat and 38,253,215,756 B with it
ROOF_REMAT = dict(ROOF, batch=2)

# a dry-run subprocess: one scheme's row, and the per-rank shard of each
# client leaf (what sfl's client-model average all-reduces, in f32)
ROOF_DRYRUN_CODE = r"""
import json, math, sys
from repro_torch.launch import dryrun, specs
from repro_torch.launch.shardings import map_with_path
arch, shape, mesh_tag, algo, out_path = sys.argv[1:6]
ov = {"num_layers": int(sys.argv[6])} if len(sys.argv) > 6 else None
try:
    out = {"row": dryrun.run_case(arch, shape, mesh_tag, algo=algo,
                                  extra_overrides=ov, verbose=False)}
    case = specs.build_case(arch, shape, dryrun.production_mesh(mesh_tag),
                            extra_overrides=ov)
    leaves, shds = [], []
    map_with_path(lambda p, x, r: leaves.append(x), case.args[0]["client"])
    map_with_path(lambda p, s, r: shds.append(s),
                  case.in_shardings[0]["client"])
    out["client_local"] = [math.prod(specs._local_shape(x.shape, s)[1:])
                           for x, s in zip(leaves, shds)]
    out["b"] = case.args[2]["tokens"].shape[1]
    out["seq"] = case.args[2]["tokens"].shape[2]
finally:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
json.dump(out, open(out_path, "w"))
"""


def roof_dryrun_start(tmp, spec=ROOF_DRYRUN):
    """Phase 17 (a)'s subprocesses, one a scheme, started: they run on
    the CPU while (b) runs on the card."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH")
                                          else [])))
    runs = {}
    for algo in ("sfl_ga", "sfl"):
        out = tmp / f"dryrun_{algo}.json"
        args = [sys.executable, "-c", ROOF_DRYRUN_CODE, spec["arch"],
                spec["shape"], spec["mesh"], algo, str(out)]
        if spec.get("layers"):
            args.append(str(spec["layers"]))
        runs[algo] = (subprocess.Popen(
            args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), out)
    return runs, time.perf_counter()


def roof_dryrun_stop(runs):
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def roof_dryrun_check(runs, t0, spec=ROOF_DRYRUN):
    """Phase 17 (a): both rows ``ok``; sfl_ga's eq. 5 all-reduce of X(v)
    (b S d f32, one client a rank) and sfl's client-model average (each
    client leaf's rank shard, f32) are the only difference of their
    all-reduce bytes over the client axis ("data")."""
    from repro_torch.configs import get_config

    got = {}
    try:
        for algo, (proc, out) in runs.items():
            _, err = proc.communicate(timeout=spec["timeout"])
            check(proc.returncode == 0, f"phase 17 (a): the {algo} dry run "
                  f"exited {proc.returncode}: {err[-3000:]}")
            got[algo] = json.loads(out.read_text())
    finally:
        roof_dryrun_stop(runs)
    wall = time.perf_counter() - t0
    for algo in ("sfl_ga", "sfl"):
        r = got[algo]["row"]
        check(r["status"] == "ok", f"phase 17 (a): {algo} row {r}")
        log(f"[roofline] (a) dry run {spec['arch']} x {spec['shape']} x "
            f"{spec['mesh']} {algo} (CPU, fake tensors, priced on "
            f"{r['device']}): Tc={r['t_compute_s']:.4f}s "
            f"Tm={r['t_memory_s']:.4f}s Tcoll={r['t_collective_s']:.4f}s "
            f"-> {r['bottleneck']} useful={r['useful_flops_ratio']:.3f} "
            f"mem/rank={r['per_device_mem_bytes']:.4e} B run "
            f"{r['compile_s']:.1f}s coll={json.dumps(r['coll_detail'])}")
    info = got["sfl_ga"]
    d = get_config(spec["arch"]).d_model
    x_v = 4 * info["b"] * info["seq"] * d
    phi = 4 * sum(info["client_local"])
    key = "all-reduce@data"
    ga = got["sfl_ga"]["row"]["coll_detail"]
    sfl = got["sfl"]["row"]["coll_detail"]
    diff = ga.get(key, 0) - sfl.get(key, 0)
    check(diff == x_v - phi and ga.get(key, 0) >= x_v,
          f"phase 17 (a): {key} sfl_ga {ga.get(key)} - sfl {sfl.get(key)}"
          f" = {diff}, predicted X(v) {x_v} - phi(v) {phi} = {x_v - phi}")
    others = (set(ga) | set(sfl)) - {key}
    check(all(ga.get(k) == sfl.get(k) for k in others),
          f"phase 17 (a): other collectives differ: {ga} {sfl}")
    log(f"[roofline] (a) {key}: sfl_ga {ga[key]} B (eq. 5: one X(v) "
        f"all-reduce of {x_v} B) - sfl {sfl[key]} B (client-model "
        f"average: {len(info['client_local'])} all-reduces, {phi} B) = "
        f"{diff} B, as predicted; subprocesses' wall {wall:.1f} s")
    return {algo: got[algo]["row"] for algo in got}


def roof_step(torch, device, spec, fake=False, remat=False):
    """The phase 17 (b) step: (step, params, opt_state, batch); ``remat``
    checkpoints each layer (phase 17 (c))."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import algorithms as alg
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    cfg = get_config(spec["arch"])
    cfg = cfg.with_overrides(num_layers=spec["layers"])
    plan = lm.build_plan(cfg, spec["cut"])
    n, b, S = spec["clients"], spec["batch"], spec["seq"]
    tcfg = TrainConfig(model=cfg, algo="sfl_ga", cut_layer=spec["cut"],
                       compute_dtype="float32", param_dtype="float32",
                       remat=remat)
    opt = make_optimizer("sgd", spec["lr"])
    step = alg.make_train_step(plan, tcfg, opt, n)
    params = alg.split_lm_params(
        lm.init_lm(27, plan, torch.float32, device=device), n)
    gen = None if fake else torch.Generator(device=device).manual_seed(27)
    toks = torch.randint(0, cfg.vocab_size, (2, n, b, S), generator=gen,
                         device=device)
    return step, params, opt.init(params), {"tokens": toks[0],
                                            "labels": toks[1]}


def remat_recompute_flops(torch, spec):
    """What remat recomputes in a phase 17 step, counted on fake tensors:
    the layers' forward over the step's N b S tokens, less each layer's
    MLP down projection (2 T d_ff d), whose output no backward saves, so
    the recompute stops before it (torch's early stop; XLA drops the dead
    op likewise)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.roofline import OpCounter
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf

    cfg = get_config(spec["arch"]).with_overrides(num_layers=spec["layers"])
    plan = lm.build_plan(cfg, spec["cut"])
    T = spec["clients"] * spec["batch"] * spec["seq"]
    with FakeTensorMode():
        params = lm.init_lm(27, plan, torch.float32, device="cpu")
        x = torch.empty(spec["clients"] * spec["batch"], spec["seq"],
                        cfg.d_model)
        counter = OpCounter()
        with counter, torch.no_grad():
            tf.apply_groups_train(
                lm.all_group_params(params), cfg, lm.all_groups(plan), x,
                lm._positions(cfg, x.shape[0], spec["seq"]))
    return counter.stats.flops - spec["layers"] * 2 * T * cfg.d_ff \
        * cfg.d_model


def fake_count(torch, spec, remat):
    """The phase 17 step counted on fake tensors (``OpCounter``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.roofline import OpCounter

    with FakeTensorMode():
        step, params, opt_state, batch = roof_step(torch, "cpu", spec,
                                                   fake=True, remat=remat)
        counter = OpCounter()
        with counter:
            step(params, opt_state, batch)
    return counter.stats


def roof_remat(torch, device, spec=ROOF_REMAT):
    """Phase 17 (c): the (b) step with ``remat=False`` and ``remat=True``
    from the same params (drawn anew from (b)'s seed) and batch, a
    warm-up and 2 timed steps each: the warm-up's B1 launch held bit for
    bit to the plain version, the params bit for bit equal, B1 once a
    timed step in both, the peak memory of each run's timed steps
    (remat's lower on the card), its step p50; then one more remat step counted over the
    card, whose FLOPs equal the fake count, which exceeds the plain
    step's by ``remat_recompute_flops``."""
    from repro_torch.analysis.roofline import OpCounter
    from repro_torch.configs import get_config
    from repro_torch.tree import tree_leaves

    cuda = device == "cuda"
    plain, fake = fake_count(torch, spec, False), fake_count(torch, spec,
                                                             True)
    plain_flops = plain.flops
    recompute = remat_recompute_flops(torch, spec)
    check(fake.flops - plain_flops == recompute,
          f"phase 17 (c): remat adds {fake.flops - plain_flops} "
          f"FLOPs, predicted the recomputed forward's {recompute}")
    key = ("B1", spec["clients"],
           spec["batch"] * spec["seq"] * get_config(spec["arch"]).d_model)
    got = {}
    for remat in (False, True):
        step, params, opt_state, batch = roof_step(torch, device, spec,
                                                   remat=remat)
        # the warm-up, untimed: its B1 launch at (N, b S d), an input no
        # other phase gives B1, is held bit for bit to the plain version
        held, unspy = spy_kernels(torch)
        try:
            params, opt_state, m = step(params, opt_state, batch)
            sync(torch, device)
        finally:
            unspy()
        check(bool(torch.isfinite(m["loss"])), "phase 17 (c): loss")
        if cuda:
            check(set(held) == {key}, f"phase 17 (c) remat={remat} held "
                  f"{sorted(held)} to the plain versions, predicted {key}")
            log(f"[roofline] (c) remat={remat}: B1 held bit for bit to the "
                f"plain version at ({key[1]}, {key[2]}): {held[key].path} "
                f"({held[key].grid} blocks)")
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times = []
        for _ in range(2):
            t = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            sync(torch, device)
            times.append(time.perf_counter() - t)
            check(bool(torch.isfinite(m["loss"])), "phase 17 (c): loss")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        launches = launch_counts()["grad_agg"]
        check(launches == (2 if cuda else 0), f"phase 17 (c) remat={remat}:"
              f" {launches} B1 launches in 2 timed steps, predicted one a "
              "step")
        if not remat:
            want = [x.cpu() for x in tree_leaves(params)]
        else:
            have = tree_leaves(params)
            check(len(have) == len(want) and all(
                torch.equal(a.cpu(), b) for a, b in zip(have, want)),
                "phase 17 (c): the params after 3 steps differ between "
                "remat on and off")
            del want
            real = OpCounter()
            with real:
                params, opt_state, m = step(params, opt_state, batch)
            sync(torch, device)
            check(real.stats.flops == fake.flops,
                  f"phase 17 (c): the card's remat step counts "
                  f"{real.stats.flops} FLOPs, the fake one {fake.flops}")
        got[remat] = dict(p50=float(np.median(times)), peak=peak,
                          times=times)
        del step, params, opt_state, batch, m
        if cuda:
            torch.cuda.empty_cache()
    if cuda:
        check(got[True]["peak"] < got[False]["peak"],
              f"phase 17 (c): remat's peak {got[True]['peak']} B is not "
              f"below the plain step's {got[False]['peak']} B")
    log(f"[roofline] (c) remat on {spec['arch']} x {spec['layers']} layers "
        f"(the (b) step at b {spec['batch']}): params bit for bit after 3 "
        f"steps; fake peak live storage {plain.peak_bytes} B plain, "
        f"{fake.peak_bytes} B remat; plain step p50 "
        f"{1e3 * got[False]['p50']:.2f} ms, peak "
        f"{got[False]['peak'] / 2 ** 30:.2f} GiB; remat step p50 "
        f"{1e3 * got[True]['p50']:.2f} ms, peak "
        f"{got[True]['peak'] / 2 ** 30:.2f} GiB; FLOPs {fake.flops:.6e}"
        f" (fake and card equal) = plain {plain_flops:.6e} + recomputed "
        f"forward {recompute:.6e}; B1 once a step in both")
    return dict(plain=got[False], remat=got[True], flops=fake.flops,
                recompute=recompute)


def phase_roofline(torch, device="cuda", spec=ROOF, dryrun=ROOF_DRYRUN,
                   remat_spec=ROOF_REMAT):
    """Phase 17 (see the module docstring). ``device="cpu"`` with a small
    ``spec`` and ``dryrun`` (``layers`` set) rehearses it without a card:
    (b)'s times are CPU times there and its bound is not checked."""
    import tempfile

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.roofline import OpCounter, device_peaks
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    tmp = ROOT / "build"
    tmp.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase17_", dir=tmp))
    runs, t0 = roof_dryrun_start(tmp, dryrun)
    try:
        # (b) count the step on fake tensors: no storage, the same Python
        with FakeTensorMode():
            step, params, opt_state, batch = roof_step(torch, "cpu", spec,
                                                       fake=True)
            fake = OpCounter()
            with fake:
                step(params, opt_state, batch)
        del step, params, opt_state, batch
        name = torch.cuda.get_device_name(0) if cuda else \
            "NVIDIA H100 80GB HBM3"
        peaks = device_peaks(name)
        # the step's products run on G1's 3xTF32 (three TF32 products a
        # product), the fastest f32-accurate rate the card has
        t_compute = fake.stats.flops / (peaks.flop_per_s("tf32") / 3)
        t_memory = fake.stats.bytes / peaks.hbm_bytes_per_s
        # (b) the real step: one warm-up, whose B1 launch at (N, b S d)
        # is held bit for bit to the plain version on the same inputs
        step, params, opt_state, batch = roof_step(torch, device, spec)
        held, unspy = spy_kernels(torch)
        try:
            params, opt_state, m = step(params, opt_state, batch)
            sync(torch, device)
        finally:
            unspy()
        check(bool(torch.isfinite(m["loss"])), "phase 17 (b): loss")
        key = ("B1", spec["clients"],
               spec["batch"] * spec["seq"] * get_config(spec["arch"]).d_model)
        if cuda:
            check(set(held) == {key}, f"phase 17 (b) held {sorted(held)} "
                  f"to the plain versions, predicted {key}")
            log(f"[roofline] (b) B1 held bit for bit to the plain version "
                f"at ({key[1]}, {key[2]}): {held[key].path} "
                f"({held[key].grid} blocks)")
        # then the timed steps and the counted one, B1's launches counted
        # over them
        reset_launch_counts()
        times = []
        for _ in range(spec["steps"]):
            sync(torch, device)
            t = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            sync(torch, device)
            times.append(time.perf_counter() - t)
            check(bool(torch.isfinite(m["loss"])), "phase 17 (b): loss")
        p50 = float(np.median(times))
        real = OpCounter()
        with real:
            params, opt_state, m = step(params, opt_state, batch)
        sync(torch, device)
        launches = launch_counts()["grad_agg"]
        want = (1 + spec["steps"]) if cuda else 0
        check(launches == want, f"phase 17 (b): {launches} B1 launches, "
              f"predicted {want} (one a step)")
        check(real.stats.flops == fake.stats.flops,
              f"phase 17 (b): the card step counts {real.stats.flops} "
              f"FLOPs, the fake one {fake.stats.flops}")
        if cuda:
            check(p50 >= t_compute, f"phase 17 (b): p50 {p50:.6f} s "
                  f"below the 3xTF32 compute bound {t_compute:.6f} s: a "
                  "counting fault")
        tokens = spec["clients"] * spec["batch"] * spec["seq"]
        log(f"[roofline] (b) {spec['arch']} full width x {spec['layers']} "
            f"layers, cut {spec['cut']}, sfl_ga fp32 full f32, N "
            f"{spec['clients']} b {spec['batch']} S {spec['seq']} "
            f"({tokens} tokens) on {name if cuda else 'the CPU'}"
            f"{' (' + nvidia_smi_line() + ')' if cuda else ''}: step p50 "
            f"{1e3 * p50:.2f} ms of {spec['steps']} "
            f"({', '.join(f'{1e3 * t:.2f}' for t in times)}); FLOPs "
            f"{fake.stats.flops:.6e} (fake and card equal) -> t_compute "
            f"{1e3 * t_compute:.2f} ms at 3xTF32 "
            f"{peaks.tf32_flop_per_s / 3:.3g}/s (f32 SIMT "
            f"{1e3 * fake.stats.flops / peaks.f32_flop_per_s:.2f} ms); "
            f"bytes fake {fake.stats.bytes:.6e} card "
            f"{real.stats.bytes:.6e} (B1's plain loop against its "
            f"ctypes launch) -> t_memory {1e3 * t_memory:.2f} ms at "
            f"{peaks.hbm_bytes_per_s:.3g} B/s; p50/t_compute "
            f"{p50 / t_compute:.3f}, p50/t_memory {p50 / t_memory:.3f}; "
            f"B1 launches {launches}")
        del step, params, opt_state, batch, m
        if cuda:
            torch.cuda.empty_cache()
        remat = roof_remat(torch, device, remat_spec)
        rows = roof_dryrun_check(runs, t0, dryrun)
    finally:
        roof_dryrun_stop(runs)
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[roofline] phase 17 {time.perf_counter() - t_phase:.1f} s")
    return dict(p50=p50, t_compute=t_compute, t_memory=t_memory,
                flops=fake.stats.flops, rows=rows, remat=remat)


# phase 18: the reference's scripts on the card. (a) the serve bench's
# rows (scheduler, users, slots, tokens, decode steps) and traffic events
# are set by integers, so they are the reference's on any device
SERVE_BENCH_ROWS = [("continuous", 4, 4, 56, 47),
                    ("continuous", 8, 4, 112, 48),
                    ("continuous", 16, 4, 224, 57),
                    ("sequential", 16, 4, 224, 188)]
SERVE_BENCH_EVENTS = 342
# (b) the example's requests: 4 users of 12 new tokens on each arch
EXAMPLE_USERS, EXAMPLE_TOKENS = 4, 48
# (d) the driver's entries run in the smoke
DRIVER_ONLY = "kernels_micro,fig8,roofline,fig4"


def phase_serve_bench(torch, params, plan, device="cuda"):
    """Phase 18 (a): ``benchmarks/torch_serve_bench.py`` at full width on
    phase 4's weights (see the module docstring). ``device="cpu"`` with
    a reduced model rehearses it without a card (no launches)."""
    from benchmarks import torch_serve_bench as sb
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import lm

    t0 = time.perf_counter()
    pa.paged_attention_decode.launches = 0
    out = sb.run(device=device, params=params, plan=plan)
    launches = pa.paged_attention_decode.launches
    got = [(r["scheduler"], r["users"], r["slots"], r["tokens"], r["steps"])
           for r in out["rows"]]
    check(got == SERVE_BENCH_ROWS, f"phase 18 (a): serve bench rows {got}, "
          f"the reference's {SERVE_BENCH_ROWS}")
    check(out["traffic_events"] == SERVE_BENCH_EVENTS
          and out["traffic_mismatches"] == 0,
          f"phase 18 (a): {out['traffic_events']} traffic events (the "
          f"reference's {SERVE_BENCH_EVENTS}), {out['traffic_mismatches']} "
          "mismatches")
    check(out["speedup"] >= 2.0, f"phase 18 (a): continuous batching "
          f"speedup {out['speedup']:.3f}x below the 2x gate")
    check(out["finite"], "phase 18 (a): non-finite logits")
    n_attn = sum(g.repeat * len(g.period) for g in lm.all_groups(plan))
    check(launches == n_attn * out["decode_steps"] * (device == "cuda"),
          f"phase 18 (a): paged attention launched {launches} times, "
          f"expected {n_attn} x {out['decode_steps']} decode steps")
    for r in out["rows"]:
        log(f"[serve_bench] {r['scheduler']:<10} users {r['users']:>2} "
            f"slots {r['slots']} tokens {r['tokens']:>3} steps "
            f"{r['steps']:>3} wall {r['wall_s']:.3f} s {r['tok_per_s']:.2f}"
            f" tok/s p50 {1e3 * r['p50_s']:.2f} ms p99 "
            f"{1e3 * r['p99_s']:.2f} ms slo {r['slo_attainment']:.3f}")
    log(f"[serve_bench] {plan.cfg.name} ({n_attn} layers): speedup "
        f"{out['speedup']:.3f}x; {out['traffic_events']} traffic events, 0 "
        f"mismatches; {launches} B6 launches = {n_attn} x "
        f"{out['decode_steps']} decode steps; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_scripts(torch, dryrun_rows, device="cuda"):
    """Phase 18 (b)-(d): the serve example, the kernels bench and the
    figure driver on the card (see the module docstring). The driver's
    roofline table reads ``dryrun_rows``, phase 17 (a)'s rows by scheme.
    ``device="cpu"`` rehearses them without a card (no launches, plain
    rows only)."""
    import contextlib
    import importlib.util
    import io
    import shutil
    import tempfile

    from benchmarks import torch_kernels_bench as kb
    from benchmarks import torch_roofline
    from benchmarks import torch_run
    from repro_torch.models import lm
    from repro_torch.obs import report

    t0 = time.perf_counter()
    cuda = device == "cuda"
    tmp = ROOT / "build"
    tmp.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase18_", dir=tmp))
    try:
        # (b) the example, each arch's metrics read back by the report
        spec = importlib.util.spec_from_file_location(
            "torch_serve_decode", ROOT / "examples" / "torch_serve_decode.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        reset_all_launch_counts()
        engines = example.main(["--metrics-dir", str(tmp / "serve"),
                                "--quiet", "--device", device])
        paged = all_launch_counts()["paged"]
        granite = engines["granite-8b"]
        n_attn = sum(g.repeat * len(g.period)
                     for g in lm.all_groups(granite.plan))
        check(paged == n_attn * len(granite.step_latencies_s) * cuda,
              f"phase 18 (b): {paged} B6 launches, expected {n_attn} x "
              f"{len(granite.step_latencies_s)} granite decode steps")
        notes = []
        for arch, engine in engines.items():
            s = engine.summary()
            check((s["users"], s["tokens"]) == (EXAMPLE_USERS,
                                                EXAMPLE_TOKENS),
                  f"phase 18 (b): {arch} served {s['users']} users, "
                  f"{s['tokens']} tokens")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = report.main([str(tmp / "serve" / arch), "--strict"])
            ok = [ln.strip() for ln in buf.getvalue().splitlines()
                  if "reconcile exactly" in ln]
            check(rc == 0 and ok, f"phase 18 (b): report on {arch}: exit "
                  f"{rc}\n{buf.getvalue()[-2000:]}")
            notes.append(f"{arch} {s['users']} users {s['tokens']} tokens "
                         f"{s['tok_per_s']:.1f} tok/s p50 "
                         f"{1e3 * s['p50_s']:.2f} ms, report exit 0 "
                         f"({ok[0]})")
        log(f"[scripts] (b) examples/torch_serve_decode.py: "
            f"{'; '.join(notes)}; {paged} B6 launches")
        # (c) the kernels bench: each kernel held to its plain version
        before = all_launch_counts()
        rows = kb.run(device)
        after = all_launch_counts()
        want = [f"{stem}_{kind}_{shape}" for stem, shape in kb.ROWS
                for kind in (("kernel", "plain") if cuda else ("plain",))]
        check([n for n, _ in rows] == want,
              f"phase 18 (c): kernels bench rows {[n for n, _ in rows]}")
        check(all(after[k] > before[k] or not cuda for k in
                  ("grad_agg", "quantize", "dequant_agg", "flash", "ssd")),
              f"phase 18 (c): a kernel did not launch: {before} -> {after}")
        log("[scripts] (c) benchmarks/torch_kernels_bench.py, 7 kernels "
            "held to their plain versions: " + " ".join(
                f"{n}={us:.1f}us" for n, us in rows))
        # (d) the driver on a subset of its entries; its roofline table
        # reads phase 17 (a)'s rows, keyed by arch x shape x mesh as the
        # reference's table keys them (so both schemes' rows are one
        # cell, the later one's)
        rows = tmp / "torch_dryrun.jsonl"
        rows.write_text("".join(json.dumps(r) + "\n"
                                for r in dryrun_rows.values()))
        cells = {(r["arch"], r["shape"], r["mesh"]): r
                 for r in dryrun_rows.values()}
        bn = {}
        for r in cells.values():
            bn[r["bottleneck"]] = bn.get(r["bottleneck"], 0) + 1
        table = f"cells ok={len(cells)} skipped=0 err=0 bottlenecks={bn}"
        out = tmp / "BENCH_smoke.json"
        paths = torch_roofline.DEFAULT_PATHS
        torch_roofline.DEFAULT_PATHS = (str(rows),)
        try:
            rc = torch_run.main(["--only", DRIVER_ONLY, "--json", str(out),
                                 "--device", device])
        finally:
            torch_roofline.DEFAULT_PATHS = paths
        got = json.loads(out.read_text())
        res = got["results"]
        check(rc == 0 and len(res) == 4
              and all(r["status"] == "ok" for r in res.values()),
              f"phase 18 (d): driver exit {rc}, entries {res}")
        check(res["roofline_table"]["derived"] == table,
              f"phase 18 (d): roofline table {res['roofline_table']} over "
              f"phase 17 (a)'s rows, predicted {table}")
        smi = got["manifest"].get("nvidia_smi")
        check(smi == (nvidia_smi_line() if cuda else None),
              f"phase 18 (d): manifest {got['manifest']}")
        log("[scripts] (d) benchmarks/torch_run.py --only " + DRIVER_ONLY
            + ": " + "; ".join(f"{k} ok {v['wall_s']:.3f} s"
                               for k, v in res.items())
            + f"; roofline table over phase 17 (a)'s rows: {table}"
            + f"; manifest names {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[scripts] phase 18 (b)-(d) {time.perf_counter() - t0:.1f} s")


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
    for src in secs:  # each kernel's lines are printed by its phase
        report = ptxas_report(_build.build_log(src))
        regs = [r for _, r, _ in report] or [0]
        log(f"[build] {src}: {len(report)} kernel instances, "
            f"{min(regs)}-{max(regs)} registers, "
            f"{sum(sp for _, _, sp in report)} bytes of spills")

    max_err, rec = phase_kernels(torch)
    agg_errs, agg_recs = phase_agg_kernels(torch)
    lm_errs, lm_recs = phase_lm_kernels(torch)
    gemm_rec = phase_gemm(torch)
    combine_rec = phase_moe_combine(torch)
    count_rec = phase_moe_count(torch)
    launches, granite_params, granite_plan = phase_serve(torch)
    phase_card_vs_cpu(torch)
    train_launches = phase_train(torch)
    phase_train_card_vs_cpu(torch)
    ssd_launches = phase_ssm_serve(torch)
    phase_ssm_card_vs_cpu(torch)
    fwd_launches = phase_lm_forward(torch, granite_params, granite_plan)
    phase_serve_bench(torch, granite_params, granite_plan)
    del granite_params
    torch.cuda.empty_cache()
    phase_ccc(torch)
    phase_bank(torch)
    phase_async(torch)
    if torch.distributed.is_initialized():  # the sharded bank's group
        torch.distributed.destroy_process_group()
    phase_lm_train(torch)
    phase_zoo(torch)
    phase_whisper_lm(torch)
    roof = phase_roofline(torch)
    phase_scripts(torch, roof["rows"])
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    src = "src/repro_torch/kernels/csrc/"
    kernels = [dict(
        name="paged_attention_decode", route="cuda",
        source=src + "paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:85",
        launches=launches, max_abs_err=max_err, **rec)]
    for key, fn, cu, replaces in (
            ("grad_agg", "grad_agg_reduce", "grad_agg.cu",
             "src/repro/kernels/grad_agg.py:35"),
            ("quantize", "quantize_pack", "quantize.cu",
             "src/repro/kernels/quantize.py:98"),
            ("dequant_agg", "dequant_agg_reduce", "quantize.cu",
             "src/repro/kernels/quantize.py:157")):
        kernels.append(dict(name=fn, route="cuda", source=src + cu,
                            replaces=replaces,
                            launches=train_launches[key],
                            max_abs_err=agg_errs[key], **agg_recs[key]))
    # B4's launches are the granite-8b forward's (its only path); B5's are
    # the SSM serve run's (its LM-forward launches are checked in phase 10)
    kernels.append(dict(
        name="flash_attention_bhsd", route="cuda",
        source=src + "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:89",
        launches=fwd_launches["granite-8b"], max_abs_err=lm_errs["flash"],
        **lm_recs["flash"]))
    kernels.append(dict(
        name="ssd_intra_chunk", route="cuda", source=src + "ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:62", launches=ssd_launches,
        max_abs_err=lm_errs["ssd"], **lm_recs["ssd"]))
    err = gemm_rec.pop("max_err")
    kernels.append(dict(
        name="gemm", route="cuda", source=src + "gemm.cu",
        replaces="none (XLA's dot on the TPU)", max_abs_err=err, **gemm_rec))
    err = combine_rec.pop("max_err")
    kernels.append(dict(
        name="moe_combine", route="cuda", source=src + "moe_combine.cu",
        replaces="none (XLA's gather and einsum on the TPU)",
        max_rel_err=err, **combine_rec))
    kernels.append(dict(
        name="moe_count", route="cuda", source=src + "moe_count.cu",
        replaces="none (XLA's cumsum on the TPU)", max_abs_err=0,
        **count_rec))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
