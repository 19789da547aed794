"""Config registry: ``get_config("<arch-id>")`` and reduced smoke variants.

A copy of ``repro.configs`` holding every architecture of the
reference's zoo: dense GQA (granite-8b, granite-20b, command-r-35b with
its parallel block, starcoder2-3b with its sliding window), the M-RoPE
VLM backbone qwen2-vl-2b, the MoE models qwen3-moe-30b-a3b and
kimi-k2-1t-a32b, Mamba-2 mamba2-130m and the Jamba hybrid
jamba-v0.1-52b, and the encoder-decoder whisper-tiny (``models.encdec``).
``reduced_config`` is the reference's rule, unchanged, so the port's
smoke preset is the reference's.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    INPUT_SHAPES,
    EncoderConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    PeftSpec,
    SSMConfig,
    TrainConfig,
)

_ARCH_MODULES = {
    "command-r-35b": "command_r_35b",
    "mamba2-130m": "mamba2_130m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-tiny": "whisper_tiny",
    "starcoder2-3b": "starcoder2_3b",
    "granite-8b": "granite_8b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "granite-20b": "granite_20b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port has: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests.

    Per the assignment: <=2 layers, d_model<=512, <=4 experts.
    """
    d_model = min(cfg.d_model, 256)
    num_heads = max(1, min(cfg.num_heads, 4))
    num_kv = max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads else 0
    if cfg.arch_type == "ssm":
        num_heads = num_kv = 0
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=64 if cfg.num_heads else None,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 256),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=min(cfg.ssm.state_dim, 32), chunk_size=32
        )
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, num_layers=2, num_frames=32)
    if cfg.hybrid_period:
        # keep the hybrid flavour in 2 layers: one mamba, one attention
        kw["hybrid_period"] = 2
        kw["hybrid_attn_offsets"] = (1,)
    if cfg.mrope_sections:
        # sections must sum to head_dim/2 = 32
        kw["mrope_sections"] = (8, 12, 12)
    return dataclasses.replace(cfg, **kw)


__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "EncoderConfig",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "PeftSpec",
    "SSMConfig",
    "TrainConfig",
    "get_config",
    "reduced_config",
]
