"""Continuous-batching split decode server (DESIGN.md §18).

Port of ``repro.core.serve_engine``. Many concurrent users share one
fixed-slot decode batch over the split boundary. A request queue admits
users into free slots (**prefill-on-admit**: the prompt runs an
exact-length prefill; its K/V rows are scattered into the slot's pages,
and an SSM layer's conv inputs and recurrent state into the slot's row),
every decode step advances ALL live slots at their own positions
(the paged cache's per-slot ``lengths``), finished requests retire their
slot per step (EOS or length budget) and the freed slot is **backfilled**
from the queue on the next step.

Split structure: the client runs ``embed + layers[:cut]`` and uplinks ONE
boundary activation per token through the transport codec
(``repro_torch.compress``); the server runs the rest, samples the next
token on the device, and unicasts the token id back. Both legs are added
to the obs traffic ledger by the host code that ran them (the host knows
the live-slot count) and reconciled exactly against
``sysmodel.traffic.decode_step_traffic`` / ``prefill_traffic``.

Per-token SLO: each user holds a block-fading channel drawn at admission;
a token's latency is the measured step wall-clock plus its modeled comm
latency (``sysmodel.latency.token_comm_latency``).

Device rule: the engine runs on ``device`` (default ``"cuda"``) and
raises without a card unless the caller passes ``device="cpu"``. On the
card every attention layer's decode runs the hand-written paged-decode
kernel (B6), every SSM layer's prefill the SSD intra-chunk kernel (B5)
on the prompt's chunk-aligned head, and the int codecs kernels B2/B3; on
the CPU, their plain versions. ``backfill=False`` is the fixed-batch
sequential baseline.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import full_f32, obs, require_device
from repro_torch.compress.codecs import get_codec
from repro_torch.models import lm
from repro_torch.models import paging
from repro_torch.models import transformer as tf
from repro_torch.models.blocks import embed
from repro_torch.sysmodel import traffic
from repro_torch.sysmodel.comm import CommParams, path_loss_gain
from repro_torch.sysmodel.latency import token_comm_latency


@dataclass
class Request:
    """One user's generation request."""
    uid: int
    prompt: np.ndarray            # (S,) int32 token ids
    max_new_tokens: int = 32


@dataclass
class Completion:
    """A finished (or still-running) request's server-side record."""
    uid: int
    prompt_len: int
    tokens: List[int] = field(default_factory=list)
    admitted_step: int = -1
    finished_step: int = -1
    token_latencies_s: List[float] = field(default_factory=list)
    slo_hits: int = 0             # tokens meeting the per-token SLO

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)


@dataclass
class _Slot:
    completion: Completion
    max_new_tokens: int
    pages: List[int]              # physical page ids owned by this slot
    gain: float                   # block-fading channel gain (admission draw)


class ServeEngine:
    """Continuous-batching split decode over a paged KV cache.

    ``params``/``plan`` are the ``init_lm``/``build_plan`` pair with
    ``plan.cut >= 1``, with params already on ``device``. ``slots`` is
    the decode batch width; ``num_pages`` bounds physical cache memory
    (defaults to full occupancy). ``last_logits`` holds the last decode
    step's ``(slots, vocab)`` logits on the device.
    """

    def __init__(self, params, plan: lm.ModelPlan, *, slots: int,
                 max_len: int, page_size: int = 16,
                 num_pages: Optional[int] = None, codec: str = "fp32",
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 backfill: bool = True, slo_ms: Optional[float] = None,
                 seed: int = 0, comm: Optional[CommParams] = None,
                 dtype=torch.float32, device="cuda"):
        self.device = require_device(device)
        cfg = plan.cfg
        if plan.cut < 1:
            raise ValueError("ServeEngine needs a split plan (cut >= 1): "
                             "the codec boundary and traffic legs price the "
                             "client→server activation wire")
        if cfg.sliding_window is not None:
            raise ValueError("paged serving is full-causal only "
                             f"({cfg.name} has a sliding window)")
        if cfg.port_fields_set():
            raise ValueError(f"the serve engine does not serve {cfg.name}: "
                             f"it sets {cfg.port_fields_set()}")
        where = params["embed"]["table"].device
        if where.type != self.device.type:
            raise ValueError(f"params are on {where}, the engine runs on "
                             f"{self.device}: build them there "
                             "(init_lm(..., device=...))")
        self.params = params
        self.plan = plan
        self.cfg = cfg
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.codec_name = codec
        self.codec = get_codec(codec)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.backfill = bool(backfill)
        self.slo_ms = slo_ms
        self.seed = int(seed)
        self.comm = comm or CommParams()
        self.dtype = dtype
        self._raw_bits = float(torch.finfo(dtype).bits)
        self._per_token_up_bits = traffic.wire_bits(
            codec, cfg.d_model, self._raw_bits)

        self.groups = lm.all_groups(plan)
        self.caches = paging.init_paged_group_caches(
            cfg, self.groups, self.slots, self.max_len, self.page_size,
            num_pages, dtype, self.device)
        self.max_pages = paging.pages_for(self.max_len, self.page_size)
        pool = num_pages if num_pages is not None \
            else self.slots * self.max_pages
        self.allocator = paging.PageAllocator(pool)

        # host-owned admission state (pushed to the device by replace_tables)
        self._table = np.zeros((self.slots, self.max_pages), np.int32)
        self._lengths = np.zeros((self.slots,), np.int32)
        self._live = np.zeros((self.slots,), bool)
        self._cur_tok = np.zeros((self.slots,), np.int32)
        self._slot_meta: List[Optional[_Slot]] = [None] * self.slots
        self._dirty = True  # push state before the first step

        self.queue: deque = deque()
        self.completions: List[Completion] = []
        self._pending_prefill_lens: List[int] = []  # admitted since last step
        self.step_count = 0
        self.step_latencies_s: List[float] = []
        self.last_logits: Optional[torch.Tensor] = None
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._gain_rng = np.random.RandomState(self.seed ^ 0x5EED5EED)
        self._rec = obs.get_recorder()

    # -- device work -----------------------------------------------------

    def _sample(self, logits):
        """Greedy argmax (the parity mode) or temperature sampling from
        the engine's seeded device generator -- deterministic per seed,
        but not jax's draws."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def _decode(self, tokens, n_live: int, codec_seed: int):
        plan, cfg, params = self.plan, self.cfg, self.params
        ncg = len(plan.client_groups)
        # client half: embed + layers[:cut]
        x = embed(params["embed"], tokens[:, None], self.dtype)
        x, cc = tf.apply_groups_decode(params["client"], cfg,
                                       plan.client_groups, x,
                                       self.caches[:ncg])
        # the split boundary: one activation per slot through the codec
        x = self.codec.roundtrip(x, codec_seed)
        self._rec.tap_bits("up_activation", n_live * self._per_token_up_bits)
        self._rec.tap_bits("down_token", n_live * traffic.TOKEN_ID_BITS)
        # server half: layers[cut:] + head, sampling on the device
        x, cs = tf.apply_groups_decode(params["server"], cfg,
                                       plan.server_groups, x,
                                       self.caches[ncg:])
        logits = lm.logits_from_hidden(params, cfg, x)[:, 0]
        return self._sample(logits), list(cc) + list(cs), logits

    @full_f32()
    def _prefill(self, tokens, codec_seed: int):
        # tokens (1, S) -- exact length, no padding
        plan, cfg, params = self.plan, self.cfg, self.params
        S = tokens.shape[1]
        x = embed(params["embed"], tokens, self.dtype)
        positions = lm._positions(cfg, 1, S, device=self.device)
        x, cc = tf.apply_groups_prefill(params["client"], cfg,
                                        plan.client_groups, x, positions, S)
        x = self.codec.roundtrip(x, codec_seed)
        self._rec.tap_bits("up_activation", traffic.wire_bits(
            self.codec_name, S * cfg.d_model, self._raw_bits))
        self._rec.tap_bits("down_token", traffic.TOKEN_ID_BITS)
        x, cs = tf.apply_groups_prefill(params["server"], cfg,
                                        plan.server_groups, x, positions, S)
        logits = lm.logits_from_hidden(params, cfg, x[:, -1:, :])[:, 0]
        return self._sample(logits)[0], list(cc) + list(cs)

    def _adopt(self, pcaches, slot: int, page_ids) -> None:
        """Scatter a B=1 prefill's caches into the engine's slot, in place:
        attention K/V rows into the slot's pages of every layer's pool, an
        SSM layer's conv inputs and state into row ``slot``."""
        for ec, pc in zip(self.caches, pcaches):
            for e_layer, p_layer in zip(ec, pc):
                for e, p in zip(e_layer, p_layer):
                    if isinstance(e, paging.PagedKVCache):
                        paging.write_prompt(e, page_ids, p.k, p.v)
                    else:
                        e.conv[slot] = p.conv[0]
                        e.state[slot] = p.state[0]

    # -- host-side admission / retirement --------------------------------

    def submit(self, req: Request) -> None:
        S = len(req.prompt)
        if S < 1:
            raise ValueError("empty prompt")
        if S + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {S} + gen {req.max_new_tokens} "
                f"exceeds max_len {self.max_len}")
        self.queue.append(req)

    def _draw_gain(self) -> float:
        d_km = self._gain_rng.uniform(0.05, 0.5)
        return float(path_loss_gain(np.asarray(d_km), self._gain_rng))

    def _admit(self, slot: int, req: Request) -> None:
        S = len(req.prompt)
        need = paging.pages_for(S, self.page_size)
        pages = self.allocator.alloc(need)  # raises when pool is dry
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                               device=self.device)
        seed = (self.seed + 0x9E37 * (self.step_count + 1)) & 0x7FFFFFFF
        first, pcaches = self._prefill(toks, seed)
        ids = np.zeros((self.max_pages,), np.int32)
        ids[:need] = pages
        self._adopt(pcaches, slot, torch.as_tensor(ids, device=self.device))
        first = int(first)
        self._pending_prefill_lens.append(S)
        comp = Completion(uid=req.uid, prompt_len=S,
                          admitted_step=self.step_count)
        comp.tokens.append(first)
        self._slot_meta[slot] = _Slot(completion=comp,
                                      max_new_tokens=req.max_new_tokens,
                                      pages=list(pages),
                                      gain=self._draw_gain())
        self._table[slot] = ids
        self._lengths[slot] = S
        self._live[slot] = True
        self._cur_tok[slot] = first
        self._dirty = True
        self._maybe_finish(slot, first)

    def _maybe_finish(self, slot: int, token: int) -> bool:
        meta = self._slot_meta[slot]
        done = (self.eos_id is not None and token == self.eos_id) or \
            meta.completion.num_tokens >= meta.max_new_tokens
        if done:
            self._retire(slot)
        return done

    def _retire(self, slot: int) -> None:
        meta = self._slot_meta[slot]
        meta.completion.finished_step = self.step_count
        self.completions.append(meta.completion)
        self.allocator.free(meta.pages)
        self._slot_meta[slot] = None
        self._table[slot] = 0
        self._lengths[slot] = 0
        self._live[slot] = False
        self._cur_tok[slot] = 0
        self._dirty = True

    def _admit_from_queue(self) -> int:
        """Fill free slots from the queue. With ``backfill=False`` the
        engine only re-admits once EVERY slot has drained (the fixed-
        batch sequential baseline)."""
        if not self.queue:
            return 0
        if not self.backfill and self._live.any():
            return 0
        admitted = 0
        for slot in range(self.slots):
            if not self.queue:
                break
            if self._live[slot]:
                continue
            self._admit(slot, self.queue.popleft())
            admitted += 1
        return admitted

    def _ensure_capacity(self) -> None:
        """Allocate the next page for any live slot whose upcoming write
        (position ``lengths[b]``) would cross its allocated frontier."""
        for slot in range(self.slots):
            if not self._live[slot]:
                continue
            meta = self._slot_meta[slot]
            if int(self._lengths[slot]) + 1 > len(meta.pages) * self.page_size:
                (pid,) = self.allocator.alloc(1)
                self._table[slot, len(meta.pages)] = pid
                meta.pages.append(pid)
                self._dirty = True

    # -- the step loop ----------------------------------------------------

    @full_f32()
    def step(self) -> Dict[str, float]:
        """Admit → decode one token for every live slot → retire.

        Returns per-step stats (also emitted as a ``serve_token`` event).
        """
        rec = self._rec
        admitted = self._admit_from_queue()
        prefill_lens = self._pending_prefill_lens
        self._pending_prefill_lens = []
        self._ensure_capacity()
        if not self._live.any():
            self._flush_traffic(0, prefill_lens)
            return {"n_live": 0, "admitted": admitted, "retired": 0,
                    "latency_s": 0.0}
        if self._dirty:
            self.caches = paging.replace_tables(
                self.caches, self._table, self._lengths, self._live)
            self._dirty = False

        live_before = self._live.copy()
        n_live = int(live_before.sum())
        seed = (self.seed ^ 0x51E9 * (self.step_count + 1)) & 0x7FFFFFFF
        t0 = time.perf_counter()
        tokens = torch.as_tensor(self._cur_tok.astype(np.int64),
                                 device=self.device)
        nxt, self.caches, self.last_logits = self._decode(tokens, n_live,
                                                          seed)
        # the copy to the host waits for the step's device work to finish,
        # so the timed window covers it (per-token latency needs the sync)
        nxt = nxt.cpu().numpy()
        step_s = time.perf_counter() - t0
        self.step_latencies_s.append(step_s)

        # modeled vs measured decode+prefill traffic, reconciled exactly
        self._flush_traffic(n_live, prefill_lens)

        # per-user comm latency on this step's live channels
        gains = np.asarray([self._slot_meta[s].gain
                            for s in range(self.slots) if live_before[s]])
        comm_s = token_comm_latency(self._per_token_up_bits,
                                    traffic.TOKEN_ID_BITS, gains, self.comm)
        slo_s = None if self.slo_ms is None else self.slo_ms / 1e3

        retired = 0
        ci = 0
        for slot in range(self.slots):
            if not live_before[slot]:
                continue
            tok = int(nxt[slot])
            meta = self._slot_meta[slot]
            meta.completion.tokens.append(tok)
            tok_s = step_s + float(comm_s[ci])
            meta.completion.token_latencies_s.append(tok_s)
            if slo_s is None or tok_s <= slo_s:
                meta.completion.slo_hits += 1
            ci += 1
            self._lengths[slot] += 1
            self._cur_tok[slot] = tok
            if self._maybe_finish(slot, tok):
                retired += 1
        self.step_count += 1

        rec.event("serve_token", name="decode", model=self.cfg.name,
                  step=self.step_count - 1, batch=n_live, latency_s=step_s,
                  admitted=admitted, retired=retired,
                  **paging.paged_cache_stats(self.caches))
        return {"n_live": n_live, "admitted": admitted, "retired": retired,
                "latency_s": step_s}

    def _flush_traffic(self, n_live: int, prefill_lens: List[int]) -> None:
        """One ``traffic`` event per step: ledger snapshot vs the modeled
        decode leg (n_live users) plus any prefill legs admitted since
        the last step -- the report CLI's exit-1 reconciliation gate."""
        rec = self._rec
        if not (rec.enabled and rec.ledger is not None):
            return
        if n_live == 0 and not prefill_lens:
            return
        modeled = traffic.decode_step_traffic(
            n_live=n_live, d_model=self.cfg.d_model,
            codec=self.codec_name, raw_bits_per_elem=self._raw_bits)
        for S in prefill_lens:
            pf = traffic.prefill_traffic(
                prompt_len=S, d_model=self.cfg.d_model,
                codec=self.codec_name, raw_bits_per_elem=self._raw_bits)
            for k, v in pf.items():
                modeled[k] += v
        measured = rec.ledger.snapshot_and_reset()
        rec.event("traffic", name="serve_step", round=self.step_count,
                  scheme="serve", cut=self.plan.cut,
                  measured=measured, modeled=modeled)

    def run(self, max_steps: Optional[int] = None) -> List[Completion]:
        """Drain the queue: step until every request completed."""
        steps = 0
        while self.queue or self._live.any():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.completions

    # -- summary -----------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        """Aggregate serving stats (the ``serve_summary`` event payload)."""
        lat = [t for c in self.completions for t in c.token_latencies_s]
        toks = sum(c.num_tokens for c in self.completions)
        wall = sum(self.step_latencies_s)
        slo_tokens = sum(len(c.token_latencies_s) for c in self.completions)
        hits = sum(c.slo_hits for c in self.completions)
        return {
            "users": len(self.completions),
            "tokens": toks,
            "steps": self.step_count,
            "wall_s": wall,
            "tok_per_s": toks / max(wall, 1e-9),
            "p50_s": obs.percentile(lat, 0.50),
            "p99_s": obs.percentile(lat, 0.99),
            "mean_s": float(np.mean(lat)) if lat else float("nan"),
            "slo_attainment": hits / max(slo_tokens, 1),
        }

    def emit_summary(self) -> Dict[str, float]:
        s = self.summary()
        self._rec.event("serve_summary", name="decode", model=self.cfg.name,
                        batch=self.slots, **s)
        return s


def make_requests(n_users: int, prompt_len: int, gen_tokens, *,
                  vocab_size: int, seed: int = 0) -> List[Request]:
    """Deterministic request set shared by the launcher / smoke / tests
    (the reference's draws: the same seed gives the same requests).

    ``gen_tokens`` is an int (uniform lengths) or a sequence cycled over
    the users.
    """
    rng = np.random.RandomState(seed)
    if isinstance(gen_tokens, int):
        gen_tokens = [gen_tokens]
    return [
        Request(uid=i,
                prompt=rng.randint(0, vocab_size, prompt_len).astype(np.int32),
                max_new_tokens=int(gen_tokens[i % len(gen_tokens)]))
        for i in range(n_users)
    ]
