"""Cut-layer transport codecs: the lossy wire format of split learning.

Port of ``repro.compress.codecs``. Every tensor crossing the client/server
boundary goes through a ``Codec``: ``encode`` produces a ``Payload``
(quantized values + side-channel scales/indices), ``decode`` rebuilds the
tensor. Bit accounting lives in ``repro_torch.sysmodel.payload``. The
wire formats are the reference's bit for bit:

* ``PassthroughCodec`` -- fp32 identity; ``roundtrip`` returns its input.
* ``CastCodec`` -- bf16 / fp8 (e4m3fn) element casts with the
  reference's bits: its fp8 cast turns |x| > 464 (and +-inf) into a NaN
  of x's sign where torch saturates to +-448, and its bf16 NaN keeps the
  sign where torch writes 0xFFFF.
* ``IntQuantCodec`` -- int8/int4 symmetric absmax quantization over flat
  256-element tiles with one fp32 scale each and counter-hash stochastic
  rounding (:func:`hash_uniform`); int4 packs value pairs into one byte,
  the even index in the low nibble. Encode and decode run through
  ``kernels.ops.quantize`` / ``dequant_agg``: the Hopper kernels on the
  card, their plain versions on the CPU.
* ``TopKCodec`` -- magnitude top-k (fp32 values + int32 indices) with
  optional error feedback. ``torch.topk`` and ``jax.lax.top_k`` are not
  known to break ties alike.

Stochastic rounding derives from an explicit integer ``seed``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.quantize import hash_uniform  # noqa: F401 (API)
from repro_torch.sysmodel.payload import PayloadSpec, spec_for

FP8_NAN_ABOVE = 464.0  # the reference's e4m3fn cast rounds above this to NaN


class Payload:
    """Encoded tensor: data (+ scales or indices) and the original shape
    and dtype."""

    def __init__(self, data, scale=None, meta=None, *, shape, dtype, codec):
        self.data = data
        self.scale = scale
        self.meta = meta
        self.shape = tuple(shape)
        self.dtype = dtype
        self.codec = codec

    def __repr__(self):
        return (f"Payload(codec={self.codec!r}, shape={self.shape}, "
                f"data={tuple(getattr(self.data, 'shape', ()))})")


class Codec:
    """Base codec. Stateless by default; stateful codecs (error feedback)
    override ``init_state``/``encode_ef``."""

    name: str = "base"
    is_identity: bool = False

    @property
    def spec(self) -> PayloadSpec:
        return spec_for(self.name)

    def encode(self, x: torch.Tensor, seed=0) -> Payload:
        raise NotImplementedError

    def decode(self, p: Payload) -> torch.Tensor:
        raise NotImplementedError

    def payload_bits(self, shape: Tuple[int, ...]) -> int:
        return self.spec.payload_bits(int(math.prod(shape)))

    def roundtrip(self, x: torch.Tensor, seed=0) -> torch.Tensor:
        """decode(encode(x)): the lossy channel as one op."""
        return self.decode(self.encode(x, seed))

    def init_state(self, shape: Tuple[int, ...], device="cpu"):
        return None

    def encode_ef(self, x: torch.Tensor, state, seed=0):
        """Encode with error feedback: returns (payload, new_state)."""
        return self.encode(x, seed), state


class PassthroughCodec(Codec):
    name = "fp32"
    is_identity = True

    def encode(self, x, seed=0):
        return Payload(x, shape=x.shape, dtype=x.dtype, codec=self.name)

    def decode(self, p):
        return p.data

    def roundtrip(self, x, seed=0):
        return x


class CastCodec(Codec):
    def __init__(self, name: str, wire_dtype):
        self.name = name
        self.wire_dtype = wire_dtype

    def encode(self, x, seed=0):
        if self.wire_dtype == torch.float8_e4m3fn:
            nan = torch.copysign(torch.full_like(x, float("nan")), x)
            data = torch.where(x.abs() > FP8_NAN_ABOVE, nan, x).to(
                self.wire_dtype)
        elif self.wire_dtype == torch.bfloat16:
            # torch writes every NaN as 0xFFFF; the reference keeps the
            # sign with the quiet NaN 0x7FC0 / 0xFFC0
            nan_bits = torch.where(torch.signbit(x), -64, 0x7FC0).to(
                torch.int16)
            data = torch.where(torch.isnan(x), nan_bits,
                               x.to(torch.bfloat16).view(torch.int16)
                               ).view(torch.bfloat16)
        else:
            data = x.to(self.wire_dtype)
        return Payload(data, shape=x.shape, dtype=x.dtype, codec=self.name)

    def decode(self, p):
        return p.data.to(p.dtype)


class IntQuantCodec(Codec):
    """Symmetric absmax quantization over flat tiles of ``tile`` elements,
    one fp32 scale each; int4 packs value pairs into int8 words.

    The flat, zero-padded tensor is the kernels' (N, T, D) = (1, 1,
    numel_pad) view in (1, tile) tiles: ``kernels.quantize`` hashes the
    global (0, 0, flat index), which is the reference codec's stochastic
    rounding bit for bit (a (1, numel_pad / tile, tile) view has the same
    tiles but hashes (0, row, col), other bits). ``encode_clients`` /
    ``decode_clients`` run K clients' payloads, each with its own seed,
    in one kernel launch each."""

    def __init__(self, bits: int, tile: int = 256, stochastic: bool = True):
        if bits not in (4, 8):
            raise ValueError(f"IntQuantCodec bits must be 4 or 8, got {bits}")
        self.name = f"int{bits}"
        self.bits = bits
        self.tile = tile
        self.stochastic = stochastic
        if tile != spec_for(self.name).tile:
            raise ValueError("tile must match the PayloadSpec wire format")

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    def _rows(self, x, k: int):
        """x as k zero-padded f32 rows of whole tiles: (k, numel_pad)."""
        numel = int(math.prod(x.shape)) // k
        pad = (-numel) % self.tile
        rows = x.reshape(k, numel).to(torch.float32)
        return torch.nn.functional.pad(rows, (0, pad)) if pad else rows

    def _encode_rows(self, rows, seed, client_seeds=None):
        k, n = rows.shape
        q, scale = ops.quantize(rows.reshape(k, 1, n).contiguous(), seed,
                                self.bits, 1, self.tile, self.stochastic,
                                client_seeds)
        return q.reshape(k, n // self.tile, -1), scale.reshape(k, -1)

    def _decode_rows(self, data, scale):
        k, tiles = scale.shape
        one = torch.ones(1, dtype=torch.float32, device=data.device)
        return ops.dequant_agg(data.reshape(1, k, -1), scale.reshape(1, k,
                               tiles), one, self.bits, 1, self.tile)

    def encode(self, x, seed=0):
        q, scale = self._encode_rows(self._rows(x, 1), seed)
        return Payload(q[0], scale[0], shape=x.shape, dtype=x.dtype,
                       codec=self.name)

    def decode(self, p):
        x = self._decode_rows(p.data[None], p.scale[None])[0]
        numel = int(math.prod(p.shape))
        return x[:numel].reshape(p.shape).to(p.dtype)

    def encode_clients(self, x, client_seeds):
        """Encode x[k] with seed client_seeds[k] for each of x's K leading
        rows, as K ``encode`` calls would, in one launch. client_seeds:
        (K,) int64 tensor of uint32 seeds on x's device. The payload keeps
        the leading K axis: data (K, tiles, tile*bits/8), scale (K,
        tiles)."""
        k = x.shape[0]
        q, scale = self._encode_rows(self._rows(x, k), 0, client_seeds)
        return Payload(q, scale, shape=x.shape, dtype=x.dtype,
                       codec=self.name)

    def decode_clients(self, p):
        """Decode an ``encode_clients`` payload in one launch."""
        k = p.shape[0]
        x = self._decode_rows(p.data, p.scale)
        numel = int(math.prod(p.shape)) // k
        return x[:, :numel].reshape(p.shape).to(p.dtype)


class TopKCodec(Codec):
    """Magnitude top-k over the flattened tensor; ``density`` is the kept
    fraction. ``encode_ef`` implements error feedback: the residual
    accumulates client-side and is re-offered next round."""

    def __init__(self, density: float):
        pct = round(density * 100)
        if not (1 <= pct <= 99 and abs(density * 100 - pct) < 1e-9):
            raise ValueError(
                f"TopKCodec density must be a whole percent in "
                f"[0.01, 0.99], got {density}")
        self.name = f"topk{pct}"
        self.density = pct / 100.0

    def _k(self, numel: int) -> int:
        return max(1, math.ceil(numel * self.density))

    def encode(self, x, seed=0):
        flat = x.reshape(-1).to(torch.float32)
        _, idx = torch.topk(flat.abs(), self._k(flat.shape[0]))
        return Payload(flat[idx], meta=idx.to(torch.int32), shape=x.shape,
                       dtype=x.dtype, codec=self.name)

    def decode(self, p):
        numel = int(math.prod(p.shape))
        flat = torch.zeros((numel,), dtype=torch.float32,
                           device=p.data.device)
        flat[p.meta.long()] = p.data
        return flat.reshape(p.shape).to(p.dtype)

    def init_state(self, shape, device="cpu"):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def encode_ef(self, x, state, seed=0):
        offered = x.to(torch.float32) + state
        payload = self.encode(offered, seed)
        new_state = offered - self.decode(payload).to(torch.float32)
        return payload, new_state


def get_codec(codec) -> Codec:
    """Codec by name ('fp32', 'bf16', 'fp8', 'int8', 'int4', 'topkP') or
    pass an existing Codec through unchanged."""
    if isinstance(codec, Codec):
        return codec
    if codec is None or codec == "fp32":
        return PassthroughCodec()
    if codec == "bf16":
        return CastCodec("bf16", torch.bfloat16)
    if codec == "fp8":
        return CastCodec("fp8", torch.float8_e4m3fn)
    if codec == "int8":
        return IntQuantCodec(8)
    if codec == "int4":
        return IntQuantCodec(4)
    spec = spec_for(codec)  # raises KeyError with the known-name list
    return TopKCodec(spec.density)


def codec_names() -> Tuple[str, ...]:
    return ("fp32", "bf16", "fp8", "int8", "int4")
