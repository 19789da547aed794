"""The paper's CNN-scale federated simulator (port of
``repro.core.simulator``).

Runs the literal SFL-GA protocol of §II-A/B and the three baselines of
§V (traditional SFL, PSL, FL) on the paper CNN, K participants at once.
Per-round batches have shape (K, tau, B, H, W, C).

State. The server keeps ONE aggregated model between rounds (eq. 7
rho-averages the per-client server replicas every round). Client models
live in a bank: per-client stacks with a leading (N,) axis for sfl_ga
and psl, whose client models drift (the drift is the paper's Gamma), and
ONE copy for sfl and fl, whose client aggregation makes every entry
equal. This slice has the ``device`` bank and the identity cohort (every
client takes part every round, weights rho); partial cohorts, the host
and sharded banks, the async engine and checkpoints come with slice 4.

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
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.cohort import cohort_stats
from repro_torch.core.protocol import (SCHEMES, ProtocolEngine,
                                       aggregate_cohort)
from repro_torch.models import cnn
from repro_torch.sysmodel.traffic import (migration_bits, round_traffic_bits,
                                          round_traffic_breakdown)

_LATER = ("is not ported yet: it comes with slice 4 of the port (the "
          "client bank, cohort samplers, async engine and checkpoints)")


@dataclass(frozen=True)
class SimConfig:
    """The reference's ``SimConfig`` without the fields of the engines
    that slice 4 ports. This slice runs ``bank="device"``,
    ``sampler="full"`` and ``cohort=None`` (or ``n_clients``) only; other
    values raise ``NotImplementedError``. The Gamma drift metric is the
    exact one over the whole bank."""
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
    cohort: Optional[int] = None
    sampler: str = "full"
    bank: str = "device"


Blocks = List[Dict[str, torch.Tensor]]


def _map(fn, *trees) -> Blocks:
    return [{k: fn(*(t[i][k] for t in trees)) for k in trees[0][i]}
            for i in range(len(trees[0]))]


def _stack(tree: Blocks, n: int) -> Blocks:
    """Broadcast a single copy to a (n, ...) stack (a view, not a copy)."""
    return _map(lambda p: p.unsqueeze(0).expand((n,) + p.shape), tree)


def _numel(blocks: Blocks) -> int:
    return sum(int(p.numel()) for blk in blocks for p in blk.values())


def _nbytes(blocks: Blocks) -> int:
    return sum(p.numel() * p.element_size() for blk in blocks
               for p in blk.values())


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
        if sim.bank != "device":
            raise NotImplementedError(f"bank {sim.bank!r} {_LATER}")
        if sim.sampler != "full" or sim.cohort not in (None, sim.n_clients):
            raise NotImplementedError(
                f"sampler {sim.sampler!r} with cohort {sim.cohort} {_LATER}")
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
        self._t = 0  # round counter (drives the codec seed schedule)
        self.rho_np = np.asarray(
            rho if rho is not None
            else np.full(sim.n_clients, 1.0 / sim.n_clients), np.float32)
        if self.rho_np.shape != (sim.n_clients,):
            raise ValueError(f"rho {self.rho_np.shape} for {sim.n_clients} "
                             "clients")
        self.rho = torch.from_numpy(self.rho_np).to(self.device)
        self.n_participants = sim.n_clients
        spec = self.proto.spec
        self._bank_stacked = spec.split and not spec.client_aggregate
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
        self.client = self._broadcast(client0) if self._bank_stacked \
            else client0
        self._peak_bank_bytes = _nbytes(self.client)

    # ------------------------------------------------------------------
    @property
    def state(self) -> Dict:
        """``{"client": bank (list of blocks), "server": list of blocks}``."""
        return {"client": self.client, "server": self.server}

    def _broadcast(self, blocks: Blocks) -> Blocks:
        """A single copy stacked to (N, ...), one copy per client."""
        return _map(lambda p: p.unsqueeze(0).expand(
            (self.sim.n_clients,) + p.shape).clone(), blocks)

    def bank_stats(self) -> Dict:
        """The reference bank's ``stats()`` for its ``device`` backend."""
        nbytes = _nbytes(self.client)
        self._peak_bank_bytes = max(self._peak_bank_bytes, nbytes)
        return {"backend": "device", "bank_bytes": nbytes, "slice_bytes": 0,
                "device_bytes": nbytes,
                "device_bytes_peak": self._peak_bank_bytes,
                "prefetch_hits": 0, "prefetch_misses": 0,
                "gather_wait_s": 0.0}

    def cohort_for_round(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """The identity cohort: every client, weights rho."""
        return np.arange(self.sim.n_clients, dtype=np.int64), self.rho_np

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
        client, server = list(self.client), list(self.server)
        if self._bank_stacked:
            if v > old:  # boundary layers move client-ward: broadcast
                moved = _numel(server[:v - old])
                client = client + self._broadcast(server[:v - old])
                server = server[v - old:]
            else:        # client-ward layers merge into the server copy
                moved = _numel(client[v:]) // self.sim.n_clients
                blk = client[v:]
                anchor = _map(lambda p: p[0], blk)
                server = aggregate_cohort(blk, self.rho, anchor) + server
                client = client[:v]
        elif v > old:
            moved = _numel(server[:v - old])
            client, server = client + server[:v - old], server[v - old:]
        else:
            moved = _numel(client[v:])
            client, server = client[:v], client[v:] + server
        self.client, self.server, self.cut = client, server, v
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

    def _round(self, v, client, server, x, y, seed, w):
        """client: the bank (K, ...) for drifting schemes or the single
        copy; server: single copy; x: (K, tau, B, H, W, C); y: (K, tau,
        B) int64; seed: uint32; w: (K,) weights. Returns the new client
        and server state and the (tau,) epoch losses."""
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
        cp, sp = self.proto.finalize_cohort(cp, sp, w)
        return cp, sp, torch.stack(losses)

    def _drift_value(self) -> float:
        if not self._bank_stacked:
            return 0.0  # one copy: zero drift by construction
        return float(ProtocolEngine.client_drift(self.client))

    def async_engine(self, *args, **kwargs):
        raise NotImplementedError(f"the buffered-async engine {_LATER}")

    # ------------------------------------------------------------------
    @full_f32(deterministic=True)
    def run_round(self, x, y) -> Dict[str, float]:
        """One federated round over every client. ``x``: (K, tau, B, H, W,
        C) float images, ``y``: (K, tau, B) labels, as numpy arrays or
        tensors.

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
                  participants=self.n_participants, bank=self.bank_stats())
        return out

    def _run_round_impl(self, x, y) -> Dict[str, float]:
        K = self.n_participants
        if x.shape[0] != K:
            raise ValueError(
                f"run_round: got data for {x.shape[0]} clients, round "
                f"cohort has {K} participants")
        x = torch.as_tensor(x).to(self.device, torch.float32)
        y = torch.as_tensor(y).to(self.device, torch.int64)
        seed = self.proto.round_seed(self._t)
        self._t += 1
        self.client, self.server, losses = self._round(
            self.cut, self.client, self.server, x, y, seed, self.rho)
        if self._rec.enabled:
            v = losses.detach().cpu().numpy()
            summary = {"mean": float(v.mean()), "min": float(v.min()),
                       "max": float(v.max()), "n": int(v.size)}
            if v.size <= 16:
                summary["values"] = [float(a) for a in v]
            self._rec.gauge("epoch_loss", summary)
        bits = self.comm_bits_per_round()
        return {"loss": float(losses.mean()),
                "client_drift": self._drift_value(),
                "bits_up": bits["up_bits"], "bits_down": bits["down_bits"]}

    def global_params(self) -> Blocks:
        """Global evaluation model: rho-weighted mean over the client bank
        and the single aggregated server copy."""
        client = self.client
        if self._bank_stacked:
            client = _map(lambda p: torch.sum(
                p * self.rho.reshape((-1,) + (1,) * (p.ndim - 1)), dim=0),
                client)
        return list(client) + list(self.server)

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
        raise NotImplementedError(f"save (the checkpoint module) {_LATER}")

    def restore(self, path: str) -> Dict:
        raise NotImplementedError(f"restore (the checkpoint module) {_LATER}")
