"""The paper's CNN-scale federated simulator (port of
``repro.core.simulator``).

Runs the literal SFL-GA protocol of §II-A/B and the three baselines of
§V (traditional SFL, PSL, FL) on the paper CNN, K participants at once.
Per-round batches have shape (K, tau, B, H, W, C).

State. The server keeps ONE aggregated model between rounds (eq. 7
rho-averages the per-client server replicas every round). Client models
live in a ``core.bank.ClientBank``: per-client stacks with a leading
(N,) axis for sfl_ga and psl, whose client models drift (the drift is
the paper's Gamma), and ONE copy for sfl and fl, whose client
aggregation makes every entry equal. The bank lives on the device
(``bank="device"``), in host memory with only the round's K-slice on
the device (``bank="host"``, double-buffered prefetch), or split over
the ranks of a ``launch.mesh.make_bank_mesh`` mesh (``bank="sharded"``:
every rank runs this simulator with the same seeds and data, SPMD, and
holds N / ranks client rows; a round's K-slice is gathered onto every
rank and each rank scatters back the rows it owns).

Each round a ``core.cohort.CohortSampler`` picks K <= N participants
(``full``: everyone, weights rho; ``uniform``, ``rho``, ``latency``);
their client stacks are gathered, trained, aggregated with the
cohort's weights (the anchored-delta form when the weights need not sum
to 1) and scattered back. With the identity cohort every gather and
scatter is the whole bank. ``save``/``restore`` checkpoint the state,
the round counter and the cut in the reference's file format.
``async_engine`` builds the buffered-async engine over the simulator
(``core.async_engine``, executor ``_SimAsyncExecutor``): generations
dispatched against the current model, merged B at a time with a
staleness discount.

A local epoch, for the split schemes:

1. the clients' forward, ``torch.func.vmap`` over the stacked client
   params, under ``torch.func.vjp`` so its backward waits for step 4;
2. the uplink channel on the stacked (K, B, ...) smashed data -- outside
   every functorch transform, so an int codec runs kernels B2/B3 once for
   all K clients;
3. the server replicas' loss and gradients (vmap under vjp);
4. the scheme's downlink on the (K, ...) cotangents, again outside the
   transforms: the eq. 5 aggregate (kernel B1) and one broadcast for
   sfl_ga, a per-client unicast for sfl/psl; then the clients' backward
   and the SGD step.

Scheme semantics, codecs, seeds and the ledger taps come from
``core.protocol.ProtocolEngine``; per-round traffic from
``sysmodel.traffic``. The simulator runs on the card unless the caller
passes ``device="cpu"`` (then every kernel is its plain version).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vjp, vmap

from repro_torch import full_f32, obs, require_device
from repro_torch.checkpoint import (load_checkpoint, load_checkpoint_meta,
                                    save_checkpoint)
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.async_engine import AsyncRoundEngine
from repro_torch.core.bank import ClientBank
from repro_torch.core.cohort import (AdmissionSampler, cohort_stats,
                                     make_sampler)
from repro_torch.core.protocol import SCHEMES, ProtocolEngine, merge_async
from repro_torch.models import cnn
from repro_torch.obs.ledger import LEDGER_CATEGORIES, totals
from repro_torch.sysmodel.latency import completion_time_fn
from repro_torch.sysmodel.traffic import (migration_bits, round_traffic_bits,
                                          round_traffic_breakdown)


@dataclass(frozen=True)
class SimConfig:
    """The reference's ``SimConfig``."""
    scheme: str = "sfl_ga"
    cut: int = 1  # v
    n_clients: int = 10
    batch: int = 32
    tau: int = 1
    lr: float = 0.05
    bytes_per_elem: int = 4
    # cut-layer transport codecs: 'fp32' is a strict no-op. Codecs apply
    # to the smashed-data / gradient payloads of the split schemes;
    # model-sync payloads stay fp32 in both math and accounting.
    uplink_codec: str = "fp32"
    downlink_codec: str = "fp32"
    codec_seed: int = 0
    # partial participation (core.cohort): K participants per round out
    # of the N-client bank; None = everyone (the identity cohort)
    cohort: Optional[int] = None
    sampler: str = "full"  # full | uniform | rho | latency
    cohort_seed: int = 0
    # client-bank residency (core.bank): 'device' -- the stacked bank on
    # the device; 'host' -- in host memory, O(K) device bytes,
    # double-buffered prefetch; 'sharded' -- DTensors over
    # launch.mesh.make_bank_mesh(device), O(N / ranks) device bytes a
    # rank. Collapsed banks (sfl/fl) are O(1) and stay on the device
    # whatever is asked.
    bank: str = "device"
    bank_prefetch: bool = True
    # Gamma drift metric: True -- exact over the whole bank (an O(N)
    # device copy for 'host', the form the parity tests pin); False --
    # off (rounds report NaN); None -- exact on 'device', chunk-streamed
    # on the host for 'host' (same metric, last ulps apart); exact for
    # 'sharded' (the bank gathered in order onto every rank).
    drift_metric: Optional[bool] = None


Blocks = List[Dict[str, torch.Tensor]]


def _map(fn, *trees) -> Blocks:
    return [{k: fn(*(t[i][k] for t in trees)) for k in trees[0][i]}
            for i in range(len(trees[0]))]


def _stack(tree: Blocks, n: int) -> Blocks:
    """Broadcast a single copy to a (n, ...) stack (a view, not a copy)."""
    return _map(lambda p: p.unsqueeze(0).expand((n,) + p.shape), tree)


def _numel(blocks: Blocks) -> int:
    return sum(int(p.numel()) for blk in blocks for p in blk.values())


class FedSimulator:
    def __init__(self, cnn_cfg: CNNConfig, sim: SimConfig,
                 rho: Optional[np.ndarray] = None, seed: int = 0, *,
                 device="cuda", params: Optional[Blocks] = None):
        if sim.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {sim.scheme!r}; known: "
                             f"{SCHEMES}")
        if not (1 <= sim.cut < cnn_cfg.num_layers or sim.scheme == "fl"):
            raise ValueError(f"cut {sim.cut} outside [1, "
                             f"{cnn_cfg.num_layers - 1}]")
        self.device = require_device(device)
        self.cfg = cnn_cfg
        self.sim = sim
        self.proto = ProtocolEngine(sim.scheme, sim.uplink_codec,
                                    sim.downlink_codec,
                                    base_seed=sim.codec_seed)
        self.up_codec = self.proto.uplink
        self.down_codec = self.proto.downlink
        # the recorder active at construction is the simulator's for life
        self._rec = obs.get_recorder()
        if self._rec.enabled:
            self.proto.attach_ledger(
                self._rec.ledger,
                raw_bits_per_elem=sim.bytes_per_elem * 8,
                label_bits_per_epoch=sim.batch * 32)
        self._t = 0  # round counter (drives codec + cohort seed schedules)
        self.rho_np = np.asarray(
            rho if rho is not None
            else np.full(sim.n_clients, 1.0 / sim.n_clients), np.float32)
        if self.rho_np.shape != (sim.n_clients,):
            raise ValueError(f"rho {self.rho_np.shape} for {sim.n_clients} "
                             "clients")
        self.rho = torch.from_numpy(self.rho_np).to(self.device)
        self.n_participants = sim.cohort or sim.n_clients
        self.sampler = make_sampler(sim.sampler, sim.n_clients,
                                    self.n_participants, rho=self.rho_np,
                                    seed=sim.cohort_seed)
        spec = self.proto.spec
        self._bank_stacked = spec.split and not spec.client_aggregate
        if sim.drift_metric is None:
            self._drift_mode = "stream" if sim.bank == "host" else "exact"
        else:
            self._drift_mode = "exact" if sim.drift_metric else "off"
        if params is None:
            params = cnn.init_cnn(torch.Generator().manual_seed(seed),
                                  cnn_cfg)
        params = [{k: v.to(self.device, torch.float32) for k, v in b.items()}
                  for b in params]
        self.cut = sim.cut  # current cut; SimConfig.cut stays the initial one
        if sim.scheme == "fl":
            client0, self.server = list(params), []
        else:
            client0, self.server = params[:sim.cut], params[sim.cut:]
        # built empty so the initial broadcast lands directly in the
        # backend's storage
        self.bank = ClientBank([], n_clients=sim.n_clients,
                               stacked=self._bank_stacked, backend=sim.bank,
                               device=self.device,
                               prefetch=sim.bank_prefetch)
        if sim.bank == "host" and self._bank_stacked and self.sampler.identity:
            obs.log(
                f"bank[host]: identity cohort (sampler={sim.sampler!r}, "
                f"cohort=None) degrades every round to a full O(N) "
                f"host<->device round-trip; set SimConfig.cohort < "
                f"n_clients={sim.n_clients} to get the O(K) residency")
        if self._bank_stacked:
            self.bank.replace([self.bank.broadcast_single(b)
                               for b in client0])
        else:  # single client copy (sfl collapse / fl full model)
            self.bank.replace(client0)

    # ------------------------------------------------------------------
    @property
    def state(self) -> Dict:
        """``{"client": bank (list of blocks), "server": list of blocks}``.
        Drains the bank's pipeline first, so it reflects every completed
        round. Client leaves are in the bank's storage: device tensors
        for ``device``, host tensors for ``host``, DTensors for
        ``sharded`` (``full_tensor()`` reads one whole; ``save`` does)."""
        self.bank.flush()
        return {"client": self.bank.tree, "server": self.server}

    def close(self) -> None:
        """Release the bank's worker thread (host backend). The simulator
        stays usable; sweeps that build many simulators close each one."""
        self.bank.close()

    def __enter__(self) -> "FedSimulator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def cohort_for_round(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """The round-``t`` cohort ``(idx, weights)``, pure in ``t``."""
        return self.sampler.cohort(t)

    # ------------------------------------------------------------------
    @full_f32(deterministic=True)
    def set_cut(self, v: int) -> Dict[str, int]:
        """Move the cut boundary to ``v`` between rounds.

        Blocks crossing server -> client are broadcast into the bank;
        blocks crossing client -> server from a drifting bank rho-merge
        into the single server copy by the anchored-delta mean (exact
        when the bank entries agree); a single-copy bank is re-partitioned.
        Returns the migration traffic (``sysmodel.traffic.migration_bits``)
        for the round's participants; zero when v is unchanged."""
        if not self.proto.spec.split:
            raise ValueError("set_cut: scheme 'fl' has no cut boundary")
        if not 1 <= v < self.cfg.num_layers:
            raise ValueError(f"cut {v} outside [1, {self.cfg.num_layers - 1}]")
        old = self.cut
        bits = migration_bits(
            cnn.phi(self.cfg, old), cnn.phi(self.cfg, v),
            n_clients=self.n_participants,
            raw_bits_per_elem=self.sim.bytes_per_elem * 8)
        if v == old:
            return bits
        self.bank.flush()  # a migration must see every pending scatter
        client, server = list(self.bank.tree), list(self.server)
        if self._bank_stacked:
            if v > old:  # boundary layers move client-ward: broadcast
                moved = _numel(server[:v - old])
                client = client + [self.bank.broadcast_single(b)
                                   for b in server[:v - old]]
                server = server[v - old:]
            else:        # client-ward layers merge into the server copy
                moved = _numel(client[v:]) // self.sim.n_clients
                server = [self.bank.merge_anchored(b, self.rho)
                          for b in client[v:]] + server
                client = client[:v]
        elif v > old:
            moved = _numel(server[:v - old])
            client, server = client + server[:v - old], server[v - old:]
        else:
            moved = _numel(client[v:])
            client, server = client[:v], client[v:] + server
        self.server, self.cut = server, v
        self.bank.replace(client)
        if self._rec.enabled:
            payload = int(math.ceil(moved * self.sim.bytes_per_elem * 8)) \
                * self.n_participants
            self._rec.event(
                "migration", name="set_cut", scheme=self.sim.scheme,
                cut=v, cut_from=old, participants=self.n_participants,
                measured={"up_bits": payload if v < old else 0,
                          "down_bits": payload if v > old else 0,
                          "total_bits": payload},
                modeled=bits)
        return bits

    # ------------------------------------------------------------------
    def _epoch_split(self, v, w, cp, sp, x, y, seed):
        """One local epoch of split training (sfl_ga / sfl / psl) on the
        stacked (K, ...) params; returns the new params and the
        w-weighted loss."""
        cfg = self.cfg

        def clients(c):
            return vmap(lambda ci, xi: cnn.client_forward(ci, xi, cfg, v))(
                c, x)

        def servers(s, sm):
            return vmap(lambda si, smi, yi: cnn.server_loss(si, smi, yi, cfg,
                                                            v))(s, sm, y)

        smashed, client_vjp = vjp(clients, cp)
        # uplink: each participant ships an encoded X(v); the server
        # trains against the reconstruction
        smashed = self.proto.encode_uplink(smashed, seed)
        loss_n, server_vjp = vjp(servers, sp, smashed)
        gs_n, s_n = server_vjp(torch.ones_like(loss_n))
        # eq. 5 for sfl_ga (ONE broadcast payload); per-client unicast
        # cotangents for sfl / psl
        (gc_n,) = client_vjp(self.proto.downlink_cotangent(s_n, w, seed))
        lr = self.sim.lr
        cp = _map(lambda p, g: p - lr * g, cp, gc_n)
        sp = _map(lambda p, g: p - lr * g, sp, gs_n)
        return cp, sp, torch.sum(loss_n * w)

    def _epoch_fl(self, w, cp, x, y):
        cfg = self.cfg

        def losses(c):
            return vmap(lambda ci, xi, yi: cnn.server_loss(ci, xi, yi, cfg,
                                                           0))(c, x, y)

        loss_n, fl_vjp = vjp(losses, cp)
        (g_n,) = fl_vjp(torch.ones_like(loss_n))
        cp = _map(lambda p, g: p - self.sim.lr * g, cp, g_n)
        return cp, torch.sum(loss_n * w)

    def _epochs(self, v, client, server, x, y, seed, w):
        """The tau local epochs of a round or an async generation from
        the given models: client, the cohort's stacks (K, ...) for
        drifting schemes or the single copy; server, the single copy; x:
        (K, tau, B, H, W, C); y: (K, tau, B) int64; seed: uint32; w: (K,)
        cohort weights. Returns the per-participant (K, ...) client and
        server params and the (tau,) epoch losses."""
        spec = self.proto.spec
        K = x.shape[0]
        if not spec.split:
            cp, sp = _stack(client, K), []
        else:
            sp = _stack(server, K)  # the eq. 6 replicas live in the round
            cp = _stack(client, K) if spec.client_aggregate else client
        losses = []
        for e, s in enumerate(self.proto.epoch_seeds(seed, x.shape[1])):
            if spec.split:
                cp, sp, loss = self._epoch_split(v, w, cp, sp, x[:, e],
                                                 y[:, e], int(s))
            else:
                cp, loss = self._epoch_fl(w, cp, x[:, e], y[:, e])
            losses.append(loss)
        return cp, sp, torch.stack(losses)

    def _round(self, v, client, server, x, y, seed, w):
        """One synchronous round (``_epochs``, then the scheme's cohort
        aggregation). Returns the new client and server state and the
        (tau,) epoch losses."""
        spec = self.proto.spec
        anchored = self.sampler.anchored
        cp, sp, losses = self._epochs(v, client, server, x, y, seed, w)
        cp, sp = self.proto.finalize_cohort(
            cp, sp, w,
            client_anchor=client if (anchored and spec.client_aggregate)
            else None,
            server_anchor=server if (anchored and spec.server_aggregate)
            else None)
        return cp, sp, losses

    def _gen(self, v, client, server, x, y, seed, w) -> Dict:
        """Dispatch-time compute of one async generation: ``_epochs``
        against the dispatch-time models with no aggregation. Returns the
        mean loss, each participant's server delta against the dispatch
        anchor (``protocol.merge_async`` staleness-weights them at merge
        time) and ``client_out``: deltas for client-aggregating schemes,
        the absolute updated rows otherwise (personalized models scatter
        back into the bank as they are)."""
        spec = self.proto.spec
        cp, sp, losses = self._epochs(v, client, server, x, y, seed, w)

        def delta(p, a):
            return p.float() - a.float().unsqueeze(0)

        out = {"loss": losses.mean()}
        if spec.split:
            out["server_delta"] = _map(delta, sp, server)
        out["client_out"] = _map(delta, cp, client) \
            if spec.client_aggregate else cp
        self._emit_epoch_loss(losses)
        return out

    def _emit_epoch_loss(self, losses: torch.Tensor) -> None:
        """The (tau,) epoch losses as the ``epoch_loss`` gauge."""
        if not self._rec.enabled:
            return
        v = losses.detach().cpu().numpy()
        summary = {"mean": float(v.mean()), "min": float(v.min()),
                   "max": float(v.max()), "n": int(v.size)}
        if v.size <= 16:
            summary["values"] = [float(a) for a in v]
        self._rec.gauge("epoch_loss", summary)

    def _drift_value(self) -> float:
        """Gamma under the configured mode: exact over the whole bank,
        chunk-streamed on the host, or off (NaN)."""
        if self._drift_mode == "off":
            return float("nan")
        if self._drift_mode == "stream":
            return self.bank.drift_streamed()
        return self.bank.drift(ProtocolEngine.client_drift)

    def async_engine(self, data_fn, *, buffer: Optional[int] = None,
                     lam: float = 0.5, completion_fn=None,
                     straggler_factor: float = 4.0,
                     refill: Optional[int] = None) -> AsyncRoundEngine:
        """The event-driven buffered-async round engine over this
        simulator (``core.async_engine``).

        ``data_fn(d, idx) -> (x, y)`` supplies the admitted generation's
        batches, shape ``(len(idx), tau, B, ...)`` in ``idx`` order, pure
        in ``d`` so a resume replays the stream. ``buffer`` is the merge
        size B <= K (default K: with a zero-spread ``completion_fn`` the
        engine is the synchronous loop, bit for bit); ``completion_fn``
        defaults to the heterogeneous ``sysmodel.latency.
        completion_time_fn`` draw at ``straggler_factor``. The engine's
        ``step()`` replaces ``run_round``; call ``drain()`` before
        ``set_cut`` or reading the final state."""
        buffer = self.n_participants if buffer is None else int(buffer)
        admission = AdmissionSampler(
            self.sampler, buffer if refill is None else int(refill))
        if completion_fn is None:
            completion_fn = completion_time_fn(
                self.sim.n_clients, seed=self.sim.cohort_seed,
                straggler_factor=straggler_factor, batch=self.sim.batch)
        ex = _SimAsyncExecutor(self, data_fn, admission)
        return AsyncRoundEngine(ex, admission, completion_fn,
                                buffer=buffer, lam=lam)

    # ------------------------------------------------------------------
    @full_f32(deterministic=True)
    def run_round(self, x, y) -> Dict[str, float]:
        """One federated round over the round-``t`` cohort. ``x``: (K,
        tau, B, H, W, C) float images, ``y``: (K, tau, B) labels, as
        numpy arrays or tensors, for the K participants in
        ``cohort_for_round(t)`` order (not the whole bank).

        With metrics enabled the round runs inside ``span("round")`` and
        emits ``traffic`` (the ledger reconciled against
        ``round_traffic_breakdown``), ``cohort`` and ``round`` events."""
        rec = self._rec
        if not rec.enabled:
            return self._run_round_impl(x, y)
        t = self._t
        rec.set_round(t)
        idx, w = self.cohort_for_round(t)
        with rec.span("round", cut=self.cut, scheme=self.sim.scheme):
            out = self._run_round_impl(x, y)
        measured = rec.ledger.snapshot_and_reset()
        rec.event(
            "traffic", name="round_traffic", scheme=self.sim.scheme,
            cut=self.cut, tau=self.sim.tau, participants=self.n_participants,
            uplink_codec=self.up_codec.name,
            downlink_codec=self.down_codec.name,
            measured=measured, modeled=self.comm_breakdown_per_round())
        rec.event("cohort", name="cohort",
                  **cohort_stats(idx, w, self.sim.n_clients))
        rec.event("round", name="round", loss=out["loss"],
                  client_drift=out["client_drift"], cut=self.cut,
                  participants=self.n_participants, bank=self.bank.stats())
        return out

    def _run_round_impl(self, x, y) -> Dict[str, float]:
        t = self._t
        idx, w = self.cohort_for_round(t)
        K = self.n_participants
        if x.shape[0] != K:
            raise ValueError(
                f"run_round: got data for {x.shape[0]} clients, round "
                f"cohort has {K} participants (see cohort_for_round)")
        x = torch.as_tensor(x).to(self.device, torch.float32)
        y = torch.as_tensor(y).to(self.device, torch.int64)
        seed = self.proto.round_seed(t)
        self._t += 1
        identity = self.sampler.identity
        stacked = self._bank_stacked
        gidx = None if (identity or not stacked) else idx
        client_in = self.bank.gather(gidx, t=t) if stacked \
            else self.bank.tree
        # double buffer: when round t+1's cohort is disjoint from this
        # one, its slice stages host->device WHILE this round trains (the
        # bank's worker already orders it after round t-1's scatter);
        # overlapping cohorts wait until this round's scatter is enqueued,
        # or the prefetch would read stale rows
        pre_idx = None
        if stacked and not identity and self.bank.prefetch_enabled:
            pre_idx, _ = self.sampler.peek(t + 1)
            if np.intersect1d(idx, pre_idx).size == 0:
                self.bank.prefetch(t + 1, pre_idx)
                pre_idx = None
        w_t = self.rho if identity else torch.from_numpy(
            np.asarray(w, np.float32)).to(self.device)
        client, self.server, losses = self._round(
            self.cut, client_in, self.server, x, y, seed, w_t)
        if stacked:
            # duplicate indices (rho sampler) resolve to the LAST
            # occurrence on every backend
            self.bank.scatter(gidx, client)
            if pre_idx is not None:
                self.bank.prefetch(t + 1, pre_idx)
            drift = self._drift_value()
        else:
            self.bank.replace(client)  # one copy: zero drift
            drift = 0.0
        self._emit_epoch_loss(losses)
        bits = self.comm_bits_per_round()
        return {"loss": float(losses.mean()), "client_drift": drift,
                "bits_up": bits["up_bits"], "bits_down": bits["down_bits"]}

    def global_params(self) -> Blocks:
        """Global evaluation model: rho-weighted mean over the client bank
        (``ClientBank.rho_mean``: on the device bank, and on the host
        bank up to its chunk size, the one-chunk device expression) and
        the single aggregated server copy."""
        return list(self.bank.rho_mean(self.rho)) + list(self.server)

    @full_f32(deterministic=True)
    @torch.no_grad()
    def evaluate(self, x, y, batch: int = 512) -> float:
        """Accuracy of the global model on (x, y)."""
        cfg = self.cfg
        params = self.global_params()
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(0, len(x), batch):
            xb = torch.as_tensor(x[i:i + batch]).to(self.device,
                                                    torch.float32)
            yb = torch.as_tensor(y[i:i + batch]).to(self.device, torch.int64)
            logits = cnn.forward_blocks(params, xb, cfg, 0, cfg.num_layers)
            correct += (logits.argmax(-1) == yb).sum()
        return int(correct) / len(x)

    # ------------------------------------------------------------------
    def comm_bits_per_round(self) -> Dict[str, int]:
        """Per-round traffic of this configuration (``sysmodel.traffic``),
        priced for the round's participants."""
        return round_traffic_bits(self.sim.scheme, **self._traffic_kwargs())

    def comm_breakdown_per_round(self) -> Dict[str, int]:
        """Per-category view of ``comm_bits_per_round`` (the ledger's
        reconciliation target)."""
        return round_traffic_breakdown(self.sim.scheme,
                                       **self._traffic_kwargs())

    def _traffic_kwargs(self) -> Dict:
        cfg, sim = self.cfg, self.sim
        be8 = sim.bytes_per_elem * 8
        split = self.proto.spec.split
        return dict(
            n_clients=self.n_participants, tau=sim.tau,
            smashed_elems=cnn.smashed_numel(cfg, self.cut) * sim.batch
            if split else 0,
            label_bits=sim.batch * 32,
            client_model_bits=cnn.phi(cfg, self.cut) * be8 if split else 0,
            full_model_bits=cnn.total_params(cfg) * be8,
            uplink_codec=self.up_codec.name,
            downlink_codec=self.down_codec.name,
            raw_bits_per_elem=be8)

    def comm_bytes_per_round(self) -> Dict[str, int]:
        """Byte view of ``comm_bits_per_round``."""
        bits = self.comm_bits_per_round()
        return {"up_bytes": bits["up_bits"] // 8,
                "down_bytes": bits["down_bits"] // 8,
                "total_bytes": bits["total_bits"] // 8}

    def save(self, path: str, extra_meta: Optional[Dict] = None) -> None:
        """Checkpoint the state, the round counter ``_t`` and the cut, in
        the reference's file format and with its meta keys.

        ``_t`` drives the codec seeds and the cohort schedule (both pure
        in ``(seed, t)``); the cut lets ``restore`` re-partition before
        loading; the cohort fields guard against resuming under another
        sampling schedule."""
        meta = self._checkpoint_meta()
        if extra_meta:
            meta.update(extra_meta)
        # ``state`` flushes the bank; the writer streams the leaves chunk
        # by chunk, so a host bank saves with no device traffic
        save_checkpoint(path, self.state, meta)

    def _checkpoint_meta(self) -> Dict:
        return {"t": self._t, "cut": self.cut, "scheme": self.sim.scheme,
                "n_clients": self.sim.n_clients,
                "cohort": self.n_participants,
                "sampler": self.sim.sampler,
                "cohort_seed": self.sim.cohort_seed,
                "bank_backend": self.sim.bank}

    def restore(self, path: str) -> Dict:
        """Resume from ``save``: re-partition to the saved cut, load the
        state and the round counter (codec seeds and cohort schedule
        continue where the run stopped)."""
        meta = load_checkpoint_meta(path)
        self._check_restore(meta)
        state, meta = load_checkpoint(path, self.state)
        self._load_state(state, meta)
        return meta

    def _check_restore(self, meta: Dict) -> None:
        """Refuse a checkpoint of another scheme, bank backend or cohort
        schedule, then re-partition to its cut."""
        if meta.get("scheme") != self.sim.scheme:
            raise ValueError(f"checkpoint scheme {meta.get('scheme')!r} != "
                             f"simulator scheme {self.sim.scheme!r}")
        # checkpoints without the field were device-resident; restoring
        # across backends would silently move the O(N) bank
        saved_bank = meta.get("bank_backend", "device")
        if saved_bank != self.sim.bank:
            raise ValueError(
                f"checkpoint bank backend {saved_bank!r} != simulator "
                f"{self.sim.bank!r}: restoring would silently move the "
                f"client bank; rebuild with SimConfig(bank={saved_bank!r}) "
                f"or re-save from a matching run")
        for key, got in (("cohort", self.n_participants),
                         ("sampler", self.sim.sampler),
                         ("cohort_seed", self.sim.cohort_seed)):
            if key in meta and meta[key] != got:
                raise ValueError(
                    f"checkpoint {key} {meta[key]!r} != simulator {got!r}: "
                    f"resuming would replay a different cohort schedule")
        if self.proto.spec.split and meta.get("cut") != self.cut:
            self.set_cut(int(meta["cut"]))

    def _load_state(self, state: Dict, meta: Dict) -> None:
        # host copies: the bank re-ingests them into its own storage, the
        # server goes back on the device
        self.bank.replace(state["client"])
        self.server = [{k: v.to(self.device) for k, v in blk.items()}
                       for blk in state["server"]]
        self._t = int(meta["t"])


def _stack_rows(pairs, device) -> Blocks:
    """Stack per-entry payload rows ``[(blocks, pos), ...]`` into blocks
    with a leading (B,) buffer axis (the merge batch), on ``device``
    (rows of a restored generation come back from the checkpoint on the
    host)."""
    rows = [_map(lambda p, i=pos: p[i].to(device), tree)
            for tree, pos in pairs]
    return _map(lambda *r: torch.stack(r), *rows)


class _SimAsyncExecutor:
    """``FedSimulator`` face of ``core.async_engine.AsyncRoundEngine``.

    Dispatch (``run_generation``) gathers the admitted clients' bank
    rows, runs ``_gen`` against the current server model and returns
    per-participant deltas (server side, and the collapsed client copy
    for aggregating schemes) or the personalized rows (non-aggregating
    schemes). Merge (``apply_merge``) folds the B completed entries'
    deltas into the live model with ``protocol.merge_async`` and
    scatters personalized rows back. The degenerate path (``run_sync``)
    is ``FedSimulator.run_round``, unchanged, so B = K zero-spread
    schedules stay bit-identical to the barrier loop. Both dispatch and
    merge compute inside ``full_f32(deterministic=True)``, as
    ``run_round`` does: cuDNN's default backward flips last bits that
    the int codecs amplify, and resume and repeat runs must agree bit
    for bit.

    Traffic: the dispatch compute taps the ledger as a sync round does
    (smashed data, labels and gradients over tau epochs, at the
    generation's size); aggregating schemes also meter the model-sync
    downlink at dispatch and the uplink at merge. Per merge, the ledger
    snapshot reconciles against ``round_traffic_breakdown`` at the step's
    dispatch and merge sizes, exactly.

    The host bank's prefetch stages the predicted next admission (pure
    in ``d``): as soon as its rows are disjoint from every in-flight
    client (only merges of in-flight clients write the bank before that
    gather), or else after a later merge's scatter, whose enqueued copy
    the bank's worker then orders before it."""

    def __init__(self, sim: FedSimulator, data_fn, admission):
        self.sim = sim
        self.data_fn = data_fn
        self.admission = admission
        self._step_dispatch: List[int] = []  # generation sizes since merge
        self._inflight: Dict[int, int] = {}  # client -> in-flight count
        self._pre: Optional[Tuple[int, np.ndarray]] = None

    # -- engine contract -------------------------------------------------
    def run_sync(self, d: int, idx, w):
        sim = self.sim
        if sim._t != d:
            raise RuntimeError(
                f"degenerate sync path needs lockstep counters "
                f"(sim._t={sim._t}, generation d={d})")
        x, y = self.data_fn(d, idx)
        return sim.run_round(x, y)

    @full_f32(deterministic=True)
    def run_generation(self, d: int, idx, w):
        sim = self.sim
        idx = np.asarray(idx, np.int64)
        x, y = self.data_fn(d, idx)
        if x.shape[0] != idx.size:
            raise ValueError(
                f"data_fn returned {x.shape[0]} clients for a "
                f"generation of {idx.size}")
        x = torch.as_tensor(x).to(sim.device, torch.float32)
        y = torch.as_tensor(y).to(sim.device, torch.int64)
        seed = sim.proto.round_seed(d)
        stacked = sim._bank_stacked
        if self._pre is not None and self._pre[0] == d:
            self._pre = None  # this gather settles it (hit or miss)
        client_in = sim.bank.gather(idx, t=d) if stacked else sim.bank.tree
        w_t = torch.from_numpy(np.asarray(w, np.float32)).to(sim.device)
        out = sim._gen(sim.cut, client_in, sim.server, x, y, seed, w_t)
        for n in idx.tolist():
            self._inflight[n] = self._inflight.get(n, 0) + 1
        if stacked and sim.bank.prefetch_enabled:
            # the next gather from the bank is the d+1 admission's slice
            nxt, _ = self.admission.admit(d + 1)
            self._pre = (d + 1, np.asarray(nxt, np.int64))
            self._try_prefetch()
        if sim._rec.enabled and sim.proto.spec.client_aggregate:
            # aggregating schemes ship the current aggregate client-ward
            # at dispatch; the uplink leg is metered at merge
            sim.proto.tap_model_sync(out["client_out"],
                                     directions=("down_model",))
        self._step_dispatch.append(int(idx.size))
        return {"idx": idx, "w": np.asarray(w, np.float32),
                "loss": out["loss"],
                "server_delta": out.get("server_delta", []),
                "client_out": out["client_out"]}

    @full_f32(deterministic=True)
    def apply_merge(self, items, taus, lam, merge_idx):
        sim = self.sim
        spec = sim.proto.spec
        dev = sim.device
        idx = np.asarray([it["client"] for it in items], np.int64)
        w = torch.from_numpy(
            np.asarray([it["w"] for it in items], np.float32)).to(dev)
        tau = torch.from_numpy(np.asarray(taus, np.float32)).to(dev)

        def rows(key):
            return _stack_rows([(it["payload"][key], it["pos"])
                                for it in items], dev)

        if spec.split:
            sim.server = merge_async(sim.server, rows("server_delta"), w,
                                     tau, lam)
        for it in items:
            n = it["client"]
            c = self._inflight.get(n, 0) - 1
            if c <= 0:
                self._inflight.pop(n, None)
            else:
                self._inflight[n] = c
        if spec.client_aggregate:
            cd = rows("client_out")
            if sim._rec.enabled:
                sim.proto.tap_model_sync(cd, directions=("up_model",))
            sim.bank.replace(merge_async(list(sim.bank.tree), cd, w, tau,
                                         lam))
            drift = 0.0
        else:
            # personalized rows scatter back absolute (each row is that
            # client's own model; duplicates resolve in merge order)
            sim.bank.scatter(idx, rows("client_out"))
            self._try_prefetch()
            drift = sim._drift_value()
        loss = float(np.mean([float(it["payload"]["loss"])
                              for it in items]))
        modeled = self._modeled_breakdown(self._step_dispatch, len(items))
        tot = totals(modeled)
        out = {"loss": loss, "client_drift": drift,
               "bits_up": tot["up_bits"], "bits_down": tot["down_bits"]}
        rec = sim._rec
        if rec.enabled:
            measured = rec.ledger.snapshot_and_reset()
            rec.event(
                "traffic", name="async_traffic", scheme=sim.sim.scheme,
                cut=sim.cut, tau=sim.sim.tau, participants=len(items),
                dispatched=list(self._step_dispatch),
                uplink_codec=sim.up_codec.name,
                downlink_codec=sim.down_codec.name,
                measured=measured, modeled=modeled)
            rec.event("round", name="async_merge", loss=loss,
                      client_drift=drift, cut=sim.cut,
                      participants=len(items), bank=sim.bank.stats())
        self._step_dispatch = []
        return out

    def _try_prefetch(self) -> None:
        if self._pre is None:
            return
        t, idx = self._pre
        busy = np.asarray(sorted(self._inflight), np.int64)
        if np.intersect1d(idx, busy).size == 0:
            self.sim.bank.prefetch(t, idx)
            self._pre = None

    def _modeled_breakdown(self, dispatch_sizes, merge_size) -> Dict[str, int]:
        """Per-category traffic model of one engine step: the compute
        legs (smashed data, labels and gradients over tau epochs, and the
        model-sync downlink) at each dispatched generation's size, the
        model-sync uplink at the merge size."""
        sim = self.sim
        kw = sim._traffic_kwargs()
        acc = {c: 0 for c in LEDGER_CATEGORIES}
        for g in dispatch_sizes:
            bd = round_traffic_breakdown(sim.sim.scheme,
                                         **{**kw, "n_clients": int(g)})
            for c in ("up_smashed", "up_labels", "down_grad", "down_model"):
                acc[c] += bd[c]
        bd = round_traffic_breakdown(sim.sim.scheme,
                                     **{**kw, "n_clients": int(merge_size)})
        acc["up_model"] += bd["up_model"]
        return acc

    # -- checkpoint surface ----------------------------------------------
    def checkpoint_state(self):
        return self.sim.state, self.sim._checkpoint_meta()

    def checkpoint_template(self):
        return self.sim.state

    def prepare_restore(self, meta) -> None:
        self.sim._check_restore(meta)

    def restore_state(self, tree, meta) -> None:
        self.sim._load_state(tree, meta)

    def sync_inflight(self, clients) -> None:
        """Rebuild the in-flight refcounts from the engine's restored
        pending queue (called by ``AsyncRoundEngine.restore``)."""
        self._inflight = {}
        for n in clients:
            n = int(n)
            self._inflight[n] = self._inflight.get(n, 0) + 1
        self._pre = None
        self._step_dispatch = []

    def gen_template(self, size: int):
        """Zero payload with ``run_generation``'s tree and shapes for a
        generation of ``size``: the checkpoint's load template."""
        sim = self.sim
        spec = sim.proto.spec
        state = sim.state

        def zrows(tree, lead):
            return [{k: np.zeros((size,) + tuple(p.shape)[lead:], np.float32)
                     for k, p in blk.items()} for blk in tree]

        t = {"idx": np.zeros((size,), np.int64),
             "w": np.zeros((size,), np.float32),
             "loss": np.zeros((), np.float32),
             "server_delta": zrows(state["server"], 0) if spec.split else []}
        t["client_out"] = zrows(state["client"],
                                0 if spec.client_aggregate else 1)
        return t
