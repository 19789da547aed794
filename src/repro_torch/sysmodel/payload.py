"""Codec-aware payload accounting: a copy of ``repro.sysmodel.payload``.

One ``PayloadSpec`` per codec name: bits per element plus side-channel
overhead (scale words, top-k indices). ``compress.codecs`` implements the
formats and ``traffic`` prices payloads with them. Pure stdlib; the
values are the reference's, so both packages price a payload alike.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class PayloadSpec:
    """Wire format of one codec: bits per element + side-channel overhead."""
    name: str
    data_bits: float          # payload bits per *kept* element
    scale_bits: int = 0       # bits per scale word (0 = no scales)
    tile: int = 0             # elements covered by one scale word
    density: float = 1.0      # fraction of elements kept (top-k sparsif.)
    index_bits: int = 0       # bits per kept element for indices (top-k)
    distortion: float = 0.0   # relative quantization-noise proxy

    def kept(self, numel: int) -> int:
        return max(1, math.ceil(numel * self.density)) if numel else 0

    def payload_bits(self, numel: int) -> int:
        """Total bits on the wire for a ``numel``-element tensor."""
        if numel <= 0:
            return 0
        bits = self.kept(numel) * (self.data_bits + self.index_bits)
        if self.tile:
            bits += math.ceil(numel / self.tile) * self.scale_bits
        return int(math.ceil(bits))


_SPECS: Dict[str, PayloadSpec] = {
    "fp32": PayloadSpec("fp32", data_bits=32.0),
    "bf16": PayloadSpec("bf16", data_bits=16.0, distortion=2.0 ** -16 / 3),
    "fp8": PayloadSpec("fp8", data_bits=8.0, distortion=2.0 ** -8 / 3),
    "int8": PayloadSpec("int8", data_bits=8.0, scale_bits=32, tile=256,
                        distortion=(1.0 / 127) ** 2 / 3),
    "int4": PayloadSpec("int4", data_bits=4.0, scale_bits=32, tile=256,
                        distortion=(1.0 / 7) ** 2 / 3),
}

_TOPK_RE = re.compile(r"^topk(\d{1,2})$")


def spec_for(name: str) -> PayloadSpec:
    """Spec by codec name. ``topkP`` keeps P% of elements (fp32 values +
    int32 indices), e.g. ``topk10``; distortion ~ the dropped mass."""
    if name in _SPECS:
        return _SPECS[name]
    m = _TOPK_RE.match(name)
    if m:
        pct = int(m.group(1))
        if not 1 <= pct <= 99:
            raise ValueError(f"topk percentage out of range: {name}")
        return PayloadSpec(name, data_bits=32.0, index_bits=32,
                           density=pct / 100.0, distortion=1.0 - pct / 100.0)
    raise KeyError(f"unknown codec {name!r}; known: {sorted(_SPECS)} "
                   "or topkP (P in 1..99)")


# ---------------------------------------------------------------------------
# Payload KINDS — what a priced flow carries, orthogonal to how it is coded.
# Keyed by the obs-ledger category so reconciliation reports (obs/report.py)
# can name the adapter flows instead of lumping them into model-sync bytes.
# ---------------------------------------------------------------------------

PAYLOAD_KINDS: Dict[str, str] = {
    "up_smashed": "cut-layer activations X(v), transport codec",
    "up_labels": "labels riding the uplink, raw",
    "up_model": "full client-model sync up (sfl φ / fl q), raw",
    "up_adapter": "LoRA adapter sync up (peft φ̂: A/B factors + scales), raw",
    "down_grad": "cut-layer gradients, transport codec",
    "down_model": "full client-model sync down (sfl φ / fl q), raw",
    "down_adapter": "LoRA adapter sync down (peft φ̂), raw",
}


def kind_for_category(category: str) -> str:
    """Human description of a ledger category's payload kind."""
    return PAYLOAD_KINDS.get(category, category)


def lora_adapter_numel(d_in: int, d_out: int, rank: int) -> int:
    """Elements of ONE adapter on the wire: A (d_in×r) + B (r×d_out) + the
    scalar scale — matches ``models.blocks.init_lora`` leaf for leaf."""
    return rank * (d_in + d_out) + 1
