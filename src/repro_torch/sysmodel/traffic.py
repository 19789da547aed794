"""Serving traffic of the split decode server: a copy of the serving
legs of ``repro.sysmodel.traffic``.

During decode each LIVE user uplinks one boundary activation per token
(the cut-layer hidden state, priced under the transport codec) and
receives one sampled token id back; prefill-on-admit ships the whole
prompt's activations once. The engine's measured ledger is reconciled
against these formulas exactly, step by step. Pure stdlib.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.sysmodel.payload import spec_for

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
