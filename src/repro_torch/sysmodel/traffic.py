"""Per-round and per-step traffic: a copy of the parts of
``repro.sysmodel.traffic`` that the port's slices price.

* Training (the paper's protocol): ``round_traffic_breakdown`` prices one
  round of each scheme per ledger category -- smashed data and labels up
  per client per local epoch, the eq. 5 gradient down once (sfl_ga) or
  per client (sfl/psl), client-model sync (sfl) or full-model exchange
  (fl) at raw precision; ``migration_bits`` prices a cut move and
  ``adapter_migration_bits`` a cut move under PEFT (only the adapters
  move); ``scheme_traffic_table`` prices every scheme at once.
* Serving: during decode each LIVE user uplinks one boundary activation
  per token and receives one sampled token id back; prefill-on-admit
  ships the whole prompt's activations once.

The simulator's and the serve engine's measured ledgers are reconciled
against these formulas exactly. Pure stdlib.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

from repro_torch.sysmodel.payload import spec_for

SCHEMES: Tuple[str, ...] = ("sfl_ga", "sfl", "psl", "fl")

# bits of one sampled token id on the serving downlink (int32 on the wire)
TOKEN_ID_BITS = 32


def _empty_breakdown() -> Dict[str, int]:
    """All ledger categories, zeroed -- kept in lockstep with
    ``repro_torch.obs.ledger.LEDGER_CATEGORIES``."""
    return {"up_smashed": 0, "up_labels": 0, "up_model": 0, "up_adapter": 0,
            "up_activation": 0, "down_grad": 0, "down_model": 0,
            "down_adapter": 0, "down_token": 0}


def wire_bits(codec: str, numel: int, raw_bits_per_elem: float = 32.0) -> int:
    """Bits on the wire for a ``numel``-element cut-layer payload.

    The ``fp32`` passthrough prices at ``raw_bits_per_elem`` (the caller's
    uncompressed wire precision); real codecs define their own absolute
    wire format via ``PayloadSpec``.
    """
    if numel <= 0:
        return 0
    if codec is None or codec == "fp32":
        return int(math.ceil(numel * raw_bits_per_elem))
    return spec_for(codec).payload_bits(numel)


def round_traffic_breakdown(scheme: str, *, n_clients: int, tau: int = 1,
                            smashed_elems: int = 0, label_bits: int = 0,
                            client_model_bits: int = 0,
                            full_model_bits: int = 0,
                            adapter_model_bits: int = 0,
                            uplink_codec: str = "fp32",
                            downlink_codec: str = "fp32",
                            raw_bits_per_elem: float = 32.0
                            ) -> Dict[str, int]:
    """Per-round traffic split into the obs ledger's categories.

    Same inputs as ``round_traffic_bits``; the result maps each of
    ``repro.obs.ledger.LEDGER_CATEGORIES`` to its modeled bits, so the
    traffic ledger's measured counts can be reconciled flow by flow
    (not just as up/down totals). The ``fl`` full-model exchange lands
    in the model-sync rows (``up_model``/``down_model``): it IS model
    sync, with q in place of φ.

    PEFT (DESIGN.md §17): with ``adapter_model_bits`` set, the federated
    unit is the adapter sliver φ̂, not φ/q — model-sync legs move to the
    ``up_adapter``/``down_adapter`` categories (the smashed-data boundary
    is unchanged; only the parameter legs shrink). Mutually exclusive
    with ``client_model_bits``/``full_model_bits``.
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; known: {SCHEMES}")
    if adapter_model_bits and (client_model_bits or full_model_bits):
        raise ValueError("adapter_model_bits replaces client/full model "
                         "bits — pass one or the other, not both")
    N = n_clients
    bd = _empty_breakdown()
    up_sync, down_sync = ("up_adapter", "down_adapter") \
        if adapter_model_bits else ("up_model", "down_model")
    if scheme == "fl":
        q = adapter_model_bits or full_model_bits
        bd[up_sync] = N * q
        bd[down_sync] = N * q
    else:
        X_up = wire_bits(uplink_codec, smashed_elems, raw_bits_per_elem)
        X_dn = wire_bits(downlink_codec, smashed_elems, raw_bits_per_elem)
        bd["up_smashed"] = N * tau * X_up
        bd["up_labels"] = N * tau * label_bits
        if scheme == "sfl_ga":
            bd["down_grad"] = tau * X_dn  # aggregated gradient, ONE broadcast
        elif scheme == "psl":
            bd["down_grad"] = N * tau * X_dn
        else:  # sfl: per-client unicast + client-model sync round-trip
            phi = adapter_model_bits or client_model_bits
            bd[up_sync] = N * phi
            bd["down_grad"] = N * tau * X_dn
            bd[down_sync] = N * phi
    return {k: int(v) for k, v in bd.items()}


def round_traffic_bits(scheme: str, **kw) -> Dict[str, int]:
    """Per-round traffic of one scheme, in bits.

    * ``smashed_elems`` — elements in ONE cut-layer payload (per client,
      per local epoch): batch × smashed-activation size.
    * ``label_bits`` — label bits per client per local epoch (uplink).
    * ``client_model_bits`` — φ(v) on the wire (``sfl`` model sync).
    * ``full_model_bits`` — q on the wire (``fl`` full-model exchange).

    Sums ``round_traffic_breakdown`` — totals and the per-category view
    cannot drift apart.
    """
    bd = round_traffic_breakdown(scheme, **kw)
    up = sum(v for k, v in bd.items() if k.startswith("up_"))
    down = sum(v for k, v in bd.items() if k.startswith("down_"))
    return {"up_bits": int(up), "down_bits": int(down),
            "total_bits": int(up + down)}


def round_traffic_bytes(scheme: str, **kw) -> Dict[str, int]:
    """Byte view of ``round_traffic_bits`` (ceil per direction; exact for
    whole-byte wire formats, which every shipped codec has)."""
    bits = round_traffic_bits(scheme, **kw)
    return {"up_bytes": -(-bits["up_bits"] // 8),
            "down_bytes": -(-bits["down_bits"] // 8),
            "total_bytes": -(-bits["up_bits"] // 8)
            + (-(-bits["down_bits"] // 8))}


def migration_bits(phi_old: int, phi_new: int, *, n_clients: int,
                   raw_bits_per_elem: float = 32.0) -> Dict[str, int]:
    """Wire cost of moving the cut from φ(v_old) to φ(v_new) parameters.

    Dynamic splitting (Algorithm 1 executed against live training) is not
    free: when the cut moves client-ward (φ grows) the server ships the
    boundary layers' parameters DOWN to every client (each client needs
    its own copy — per-client replicas are identical after an eq.-7
    aggregation round, but the unicast still happens N times); when the
    cut moves server-ward (φ shrinks) every client UPLOADS its own —
    possibly drifted — copy of the departing layers. Under partial
    participation pass the COHORT size: only the K participants of the
    migrating round move layers over the wire; idle bank entries sync
    lazily when next sampled (DESIGN.md §13). φ values are
    parameter counts (``models.cnn.phi`` / ``core.split.client_param_numel``);
    parameters ride the wire at ``raw_bits_per_elem`` (model payloads are
    never codec-compressed, matching the model-sync rows above).
    """
    delta = int(phi_new) - int(phi_old)
    if delta == 0:
        return {"up_bits": 0, "down_bits": 0, "total_bits": 0}
    payload = int(math.ceil(abs(delta) * raw_bits_per_elem)) * n_clients
    up, down = (payload, 0) if delta < 0 else (0, payload)
    return {"up_bits": up, "down_bits": down, "total_bits": up + down}


def adapter_migration_bits(adapter_phi_old: int, adapter_phi_new: int, *,
                           n_clients: int,
                           raw_bits_per_elem: float = 32.0) -> Dict[str, int]:
    """PEFT cut migration (DESIGN.md §17): the frozen base is replicated on
    both sides of every cut, so a cut move ships ONLY the adapter sliver
    φ̂(v) — same direction/unicast structure as :func:`migration_bits`,
    with adapter counts from ``core.split.client_adapter_numel`` in place
    of φ. This is what makes dynamic cuts nearly free under LoRA."""
    return migration_bits(adapter_phi_old, adapter_phi_new,
                          n_clients=n_clients,
                          raw_bits_per_elem=raw_bits_per_elem)


def scheme_traffic_table(schemes: Iterable[str] = SCHEMES,
                         **kw) -> Dict[str, Dict[str, int]]:
    """Convenience for benchmarks/examples: one accounting call per scheme
    over a shared workload description."""
    return {s: round_traffic_bits(s, **kw) for s in schemes}


def decode_step_traffic(*, n_live: int, d_model: int, codec: str = "fp32",
                        raw_bits_per_elem: float = 32.0,
                        token_bits: int = TOKEN_ID_BITS) -> Dict[str, int]:
    """Modeled per-decode-step serving traffic, in ledger categories.

    ``n_live`` is the number of OCCUPIED decode slots this step (retired
    slots transmit nothing). Uplink: one ``d_model``-element activation
    per live user through ``codec``; downlink: one token id.
    """
    bd = _empty_breakdown()
    n = max(0, int(n_live))
    bd["up_activation"] = n * wire_bits(codec, d_model, raw_bits_per_elem)
    bd["down_token"] = n * int(token_bits)
    return bd


def prefill_traffic(*, prompt_len: int, d_model: int, codec: str = "fp32",
                    raw_bits_per_elem: float = 32.0,
                    token_bits: int = TOKEN_ID_BITS) -> Dict[str, int]:
    """Modeled admission traffic for ONE user: the prompt's
    ``prompt_len × d_model`` boundary activation payload up, the first
    sampled token id down."""
    bd = _empty_breakdown()
    bd["up_activation"] = wire_bits(codec, int(prompt_len) * int(d_model),
                                    raw_bits_per_elem)
    bd["down_token"] = int(token_bits)
    return bd
