"""Decoder stack: layer plans, prefill and decode over layer groups.

Port of ``repro.models.transformer`` for the serve slice. Layers are
grouped into runs with identical structure ("specs") exactly as in the
reference, so a group here is the group there; where the reference
stacks a group's parameters and runs ``lax.scan``, the port keeps one
parameter dict per layer and loops in Python:

    params_list[group][layer][sublayer]   (sublayer = index in the period)

A "spec" is (mixer, ffn). This slice runs the dense llama-style spec
``("attn", "dense")``; SSM mixers and MoE FFNs raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import paging as paging_mod
from repro_torch.models.blocks import init_mlp, init_rmsnorm, mlp, rmsnorm

Spec = Tuple[str, str]  # (mixer, ffn)


def layer_specs(cfg: ModelConfig) -> List[Spec]:
    out = []
    for i in range(cfg.num_layers):
        mixer = "attn" if cfg.is_attn_layer(i) else "ssm"
        if cfg.arch_type == "ssm":
            ffn = "none"
        else:
            ffn = "moe" if cfg.is_moe_layer(i) else "dense"
        out.append((mixer, ffn))
    return out


@dataclass(frozen=True)
class LayerGroup:
    repeat: int  # layers in the group
    period: Tuple[Spec, ...]  # sublayer specs within one layer


def group_specs(specs: Sequence[Spec], max_period: int = 8) -> List[LayerGroup]:
    """Greedy: peel non-periodic prefix layers, then one periodic group."""
    n = len(specs)
    for prefix in range(0, min(3, n)):
        rest = specs[prefix:]
        for p in range(1, max_period + 1):
            if len(rest) % p:
                continue
            if all(rest[i] == rest[i % p] for i in range(len(rest))):
                groups = [LayerGroup(1, (s,)) for s in specs[:prefix]]
                groups.append(LayerGroup(len(rest) // p, tuple(rest[:p])))
                return groups
    return [LayerGroup(1, (s,)) for s in specs]  # fallback: no grouping


def _require_dense(spec: Spec) -> None:
    mixer, ffn = spec
    if mixer != "attn":
        raise NotImplementedError(
            f"{mixer!r} mixer layers (Mamba-2 SSD, TPU kernel B5) come with "
            "the port's SSM/hybrid slice; the serve slice runs dense "
            "attention layers only")
    if ffn != "dense":
        raise NotImplementedError(
            f"{ffn!r} FFN layers come with the port's LM-stack slice; the "
            "serve slice runs dense SwiGLU/GELU FFNs only")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _init_sublayer(gen, cfg: ModelConfig, spec: Spec, dtype, device):
    _require_dense(spec)
    p = {"norm1": init_rmsnorm(cfg.d_model, dtype, device),
         "attn": attn_mod.init_attention(gen, cfg, dtype, device)}
    if not cfg.parallel_block:
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, device)
    p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                        cfg.mlp_bias, dtype, device)
    return p


def init_groups(gen, cfg: ModelConfig, groups: Sequence[LayerGroup], dtype,
                device):
    """Per-layer param trees: ``[group][layer][sublayer]`` dicts."""
    return [[tuple(_init_sublayer(gen, cfg, s, dtype, device)
                   for s in g.period) for _ in range(g.repeat)]
            for g in groups]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _ffn(cfg, p, x):
    return mlp(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps), cfg.mlp_act)


def _sublayer_prefill(cfg, spec, p, x, positions, max_len):
    _require_dense(spec)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    a, cache = attn_mod.attend_prefill(p["attn"], cfg, h, positions, max_len)
    if cfg.parallel_block:
        return x + a + mlp(p["mlp"], h, cfg.mlp_act), cache
    x = x + a
    return x + _ffn(cfg, p, x), cache


def apply_groups_prefill(params_list, cfg, groups, x, positions, max_len):
    """Returns (x, caches) -- caches[group][layer][sublayer] KVCaches."""
    caches = []
    for g, gp in zip(groups, params_list):
        gc = []
        for layer_p in gp:
            lc = []
            for i, s in enumerate(g.period):
                x, c = _sublayer_prefill(cfg, s, layer_p[i], x, positions,
                                         max_len)
                lc.append(c)
            gc.append(tuple(lc))
        caches.append(gc)
    return x, caches


def _sublayer_decode(cfg, spec, p, x, cache):
    _require_dense(spec)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    a, cache = paging_mod.attend_decode_paged(p["attn"], cfg, h, cache)
    if cfg.parallel_block:
        return x + a + mlp(p["mlp"], h, cfg.mlp_act), cache
    x = x + a
    return x + _ffn(cfg, p, x), cache


def apply_groups_decode(params_list, cfg, groups, x, caches):
    """One-token decode over paged caches. Returns (x, new_caches)."""
    new_caches = []
    for g, gp, gc in zip(groups, params_list, caches):
        ngc = []
        for layer_p, layer_c in zip(gp, gc):
            lc = []
            for i, s in enumerate(g.period):
                x, c = _sublayer_decode(cfg, s, layer_p[i], x, layer_c[i])
                lc.append(c)
            ngc.append(tuple(lc))
        new_caches.append(ngc)
    return x, new_caches
