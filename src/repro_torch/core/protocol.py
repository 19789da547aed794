"""The scheme engine: SFL protocol semantics defined once.

Port of ``repro.core.protocol``. One ``SchemeSpec`` per scheme says who
aggregates what each round (eqs. 5, 7); one ``ProtocolEngine`` per run
owns the transport codecs, the per-round / per-local-epoch seed
schedule, the traffic-ledger taps and the client-drift metric. The
simulator calls its transport methods on the stacked (K, ...) tensors of
a round, and the LM train steps (``core.algorithms``) call ``boundary``,
the same semantics as one autograd op; both run outside any functorch
transform, so the codec and eq. 5 run as the port's kernels (B1 for the
aggregate, B2/B3 for int codecs). Aggregations and the drift metric map
over any tree of tensors (``repro_torch.tree``): the CNN's blocks, the
LM's split sides and LoRA adapter trees alike; with ``adapter_sync``
the model-sync taps meter adapters (``up_adapter``/``down_adapter``).

Ledger taps are host calls into the attached ``obs`` ledger, made once
per execution of the transport op, with the bit counts of the
reference's ``_tap``. With fp32 codecs every transport method is a no-op
or plain f32 arithmetic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.compress import (broadcast_channel, get_codec,
                                  unicast_channel, uplink_channel)
from repro_torch.core.gradagg import (client_param_average,
                                      make_gradagg_compressed)
from repro_torch.kernels import ops
from repro_torch.sysmodel.traffic import wire_bits
from repro_torch.tree import tree_leaves, tree_map

# Seed strides: one uint32 seed per round (drives codec stochastic
# rounding), decorrelated across rounds and local epochs by odd strides.
ROUND_SEED_STRIDE = 1000003
EPOCH_SEED_STRIDE = 65537
_U32 = 0xFFFFFFFF


def round_seed(base_seed: int, t: int) -> np.uint32:
    """uint32 codec seed for round ``t``."""
    return np.uint32((int(base_seed) + int(t) * ROUND_SEED_STRIDE) & _U32)


def rho_cohort(rho, idx, inclusion_prob):
    """Horvitz-Thompson cohort weights w_n = rho_n / pi_n for the
    participants ``idx`` (pi = 1 for the identity cohort: rho itself)."""
    rho = np.asarray(rho)
    return (rho[np.asarray(idx)] / inclusion_prob).astype(np.float32)


def _weights(w, p):
    w = torch.as_tensor(w, dtype=torch.float32, device=p.device)
    return w.reshape((-1,) + (1,) * (p.ndim - 1))


def aggregate_cohort(tree, w, anchor=None):
    """rho-weighted reduction over the leading cohort axis to ONE copy
    (eq. 7). ``tree`` is any tree of tensors with a leading (K,) axis
    (the CNN's blocks, the LM's split sides, adapter trees); leaves lose
    it.

    Without ``anchor``: sum_k w_k x_k. With ``anchor`` (the model every
    participant started from): anchor + sum_k w_k (x_k - anchor), the
    unbiased partial-participation form."""
    def plain(p):
        return torch.sum(p.float() * _weights(w, p), dim=0).to(p.dtype)

    def delta(p, a):
        a32 = a.float()
        upd = torch.sum((p.float() - a32[None]) * _weights(w, p), dim=0)
        return (a32 + upd).to(p.dtype)

    if anchor is None:
        return tree_map(plain, tree)
    return tree_map(delta, tree, anchor)


def staleness_discount(tau, lam: float = 0.5):
    """lambda(tau) = (1 + tau)^(-lam), the polynomial staleness discount of
    buffered-async FL; lambda(0) = 1."""
    tau = torch.as_tensor(tau, dtype=torch.float32)
    return (1.0 + tau) ** torch.tensor(-float(lam), dtype=torch.float32)


def merge_async(current, deltas, w, tau, lam: float = 0.5):
    """current + sum_i lambda(tau_i) * w_i * delta_i over the leading buffer
    axis of ``deltas`` (any tree shaped like ``current``)."""
    ww = staleness_discount(tau, lam) * torch.as_tensor(w, dtype=torch.float32)

    def f(c, d):
        upd = torch.sum(d.float() * _weights(ww, d), dim=0)
        return (c.float() + upd).to(c.dtype)

    return tree_map(f, current, deltas)


@dataclass(frozen=True)
class SchemeSpec:
    """Who aggregates what, per round (the paper's §II and §V baselines)."""
    name: str
    split: bool               # has a cut boundary (False = plain FL)
    gradient_broadcast: bool  # eq. 5: aggregate cotangents, ONE broadcast
    server_aggregate: bool    # eq. 7: rho-average server-side replicas
    client_aggregate: bool    # rho-average client-side models (sfl / fl)


SCHEME_SPECS = {
    "sfl_ga": SchemeSpec("sfl_ga", True, True, True, False),
    "sfl": SchemeSpec("sfl", True, False, True, True),
    "psl": SchemeSpec("psl", True, False, True, False),
    "fl": SchemeSpec("fl", False, False, False, True),
}

SCHEMES = tuple(SCHEME_SPECS)


def scheme_spec(name: str) -> SchemeSpec:
    try:
        return SCHEME_SPECS[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; known: {SCHEMES}") from None


class _UnicastBoundary(torch.autograd.Function):
    """sfl/psl boundary: lossy uplink on the smashed data, per-client lossy
    unicast on the cotangents (no aggregation)."""

    @staticmethod
    def forward(ctx, x, rho, up, down, seed):
        ctx.down, ctx.seed = down, seed
        ctx.rho_shape = rho.shape
        y = uplink_channel(up, x, seed)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        with obs.span("downlink"):
            gq = unicast_channel(ctx.down, g, ctx.seed)
        return gq, g.new_zeros(ctx.rho_shape), None, None, None


def _make_unicast_boundary(up, down):
    def chan(x, rho, seed=0):
        return _UnicastBoundary.apply(x, rho, up, down, int(seed))

    return chan


class ProtocolEngine:
    """Scheme semantics + codec transport + seed schedule for one run."""

    def __init__(self, scheme: str, uplink_codec="fp32",
                 downlink_codec="fp32", base_seed: int = 0,
                 adapter_sync: bool = False):
        self.spec = scheme_spec(scheme)
        self.uplink = get_codec(uplink_codec)
        self.downlink = get_codec(downlink_codec)
        self.base_seed = int(base_seed)
        # PEFT: the trees this engine syncs are LoRA adapters, metered
        # under the up_adapter/down_adapter ledger categories
        self.adapter_sync = bool(adapter_sync)
        self._ledger = None
        self._raw_bits = 32.0
        self._label_bits = 0
        if not self.spec.split:
            self._boundary_op = None
        elif self.spec.gradient_broadcast:
            self._boundary_op = make_gradagg_compressed(self.uplink,
                                                        self.downlink)
        elif self.uplink.is_identity and self.downlink.is_identity:
            self._boundary_op = None  # fp32 sfl/psl: boundary is a no-op
        else:
            self._boundary_op = _make_unicast_boundary(self.uplink,
                                                       self.downlink)

    # -- traffic ledger (repro_torch.obs) --------------------------------
    def attach_ledger(self, ledger, *, raw_bits_per_elem: float = 32.0,
                      label_bits_per_epoch: int = 0) -> None:
        """Meter this engine's transport: every method below credits the
        ledger with the wire bits of the payloads it actually sent."""
        self._ledger = ledger
        self._raw_bits = float(raw_bits_per_elem)
        self._label_bits = int(label_bits_per_epoch)

    def _tap(self, category: str, bits: int) -> None:
        bits = int(bits)
        if self._ledger is not None and bits > 0:
            self._ledger.add(category, bits)

    def _wire(self, codec, numel: int) -> int:
        return wire_bits(codec.name, int(numel), self._raw_bits)

    def _sync_categories(self):
        return (("up_adapter", "down_adapter") if self.adapter_sync
                else ("up_model", "down_model"))

    def _tap_model_sync(self, tree, directions=None):
        """Client-model sync: the tree's leading axis is the cohort, priced
        raw per participant (model payloads are never codec-compressed).
        ``directions`` restricts the tap to one leg (the async engine's
        dispatch and merge); None taps the round trip."""
        leaves = tree_leaves(tree)
        if not leaves:
            return
        k = int(leaves[0].shape[0])
        per = sum(int(p.numel()) for p in leaves) // k
        bits = k * int(math.ceil(per * self._raw_bits))
        for cat in (directions or self._sync_categories()):
            self._tap(cat, bits)

    # -- seed schedule --------------------------------------------------
    def round_seed(self, t: int) -> np.uint32:
        return round_seed(self.base_seed, t)

    @staticmethod
    def epoch_seeds(seed, tau: int) -> np.ndarray:
        """(tau,) uint32 per-local-epoch seeds from one round seed."""
        k = np.arange(tau, dtype=np.uint64)
        return ((int(seed) + k * EPOCH_SEED_STRIDE) & _U32).astype(np.uint32)

    # -- explicit transport (simulator epoch bodies) ---------------------
    def encode_uplink(self, smashed: torch.Tensor, seed) -> torch.Tensor:
        """Per-client lossy uplink of the smashed data X(v); (N, ...)."""
        if self._ledger is not None:
            k = int(smashed.shape[0])
            elems = math.prod(smashed.shape[1:])
            self._tap("up_smashed", k * self._wire(self.uplink, elems))
            self._tap("up_labels", k * self._label_bits)
        return uplink_channel(self.uplink, smashed, seed)

    def downlink_cotangent(self, s_n: torch.Tensor, rho: torch.Tensor,
                           seed) -> torch.Tensor:
        """Scheme-dependent downlink of the smashed-data gradients s^n:
        SFL-GA rho-aggregates them (eq. 5, ``ops.grad_agg``) and
        broadcasts ONE payload; sfl/psl unicast each client its own."""
        if self._ledger is not None:
            k = int(s_n.shape[0])
            elems = math.prod(s_n.shape[1:])
            payloads = 1 if self.spec.gradient_broadcast else k
            self._tap("down_grad", payloads * self._wire(self.downlink, elems))
        if self.spec.gradient_broadcast:
            agg = ops.grad_agg(s_n, rho)
            agg = broadcast_channel(self.downlink, agg, seed)
            return agg.unsqueeze(0).expand(s_n.shape)
        return unicast_channel(self.downlink, s_n, seed)

    # -- autodiff boundary -----------------------------------------------
    def boundary(self, x: torch.Tensor, rho: torch.Tensor, seed=0,
                 tap_labels: bool = True) -> torch.Tensor:
        """The scheme's cut-layer transport as one differentiable op:
        forward = lossy uplink, backward = the scheme's downlink (eq. 5
        aggregate-broadcast for SFL-GA, per-client unicast otherwise).
        Taps both directions here, once per forward (one backward per
        forward)."""
        if self._ledger is not None and self.spec.split:
            k = int(x.shape[0])
            elems = math.prod(x.shape[1:])
            self._tap("up_smashed", k * self._wire(self.uplink, elems))
            if tap_labels:
                self._tap("up_labels", k * self._label_bits)
            payloads = 1 if self.spec.gradient_broadcast else k
            self._tap("down_grad", payloads * self._wire(self.downlink, elems))
        if self._boundary_op is None:
            return x
        return self._boundary_op(x, rho, seed)

    def tap_model_sync(self, tree, directions=None) -> None:
        """Meter the client-model sync round-trip for aggregations done
        outside ``finalize_cohort``; no-op without a ledger or for schemes
        that do not sync client models."""
        if self._ledger is not None and self.spec.client_aggregate:
            self._tap_model_sync(tree, directions)

    # -- per-round model aggregation (eq. 7 + baselines) -----------------
    @staticmethod
    def aggregate(tree, rho: Optional[torch.Tensor] = None):
        """rho-weighted mean over the leading client axis, broadcast back."""
        return client_param_average(tree, rho)

    def finalize_cohort(self, client, server, w, client_anchor=None,
                        server_anchor=None):
        """Aggregating sides come back as ONE copy (no leading axis);
        non-aggregating sides pass through with their per-participant
        axis."""
        if self.spec.server_aggregate:
            server = aggregate_cohort(server, w, server_anchor)
        if self.spec.client_aggregate:
            if self._ledger is not None:
                self._tap_model_sync(client)
            client = aggregate_cohort(client, w, client_anchor)
        return client, server

    # -- metrics ---------------------------------------------------------
    @staticmethod
    def client_drift(client_tree) -> torch.Tensor:
        """sum ||w_c^n - mean||^2 over clients and leaves: the Gamma(phi(v))
        proxy of Assumption 4."""
        # leaves in the reference's order (jax sorts dict keys), summed
        # left to right on the device
        return sum(torch.sum(torch.square(p - p.mean(dim=0, keepdim=True)))
                   for p in tree_leaves(client_tree))
