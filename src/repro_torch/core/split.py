"""Split-model bookkeeping: phi(v), X(v), FLOP partitions per cut
(port of ``repro.core.split``).

These feed the paper's system models: phi(v) -> the privacy constraint
(eq. 17) and SFL client-model traffic; X(v) -> the up/downlink payloads
(eqs. 12-13); the client/server FLOPs -> computation latency (eqs.
14-16). Under PEFT the counts are the adapters' (phi-hat). Every count
comes from the config's shapes and allocates nothing.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as lm_mod
from repro_torch.models.attention import (attn_flops_per_token,
                                          mla_param_numel)
from repro_torch.models.blocks import mlp_flops_per_token
from repro_torch.models.moe import moe_flops_per_token
from repro_torch.models.ssm import ssm_flops_per_token
from repro_torch.models.transformer import layer_specs, lora_numel
from repro_torch.tree import tree_leaves


def _group_numel(groups_params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(groups_params))


def client_param_numel(plan: lm_mod.ModelPlan) -> int:
    """φ(v) in parameters, from layer shapes (no allocation)."""
    counts = _layer_param_counts(plan.cfg)
    emb = plan.cfg.vocab_size * plan.cfg.d_model
    return emb + sum(counts[:plan.cut])


def total_param_numel(plan: lm_mod.ModelPlan) -> int:
    counts = _layer_param_counts(plan.cfg)
    cfg = plan.cfg
    emb = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings and plan.cut == 0 else cfg.vocab_size * cfg.d_model
    return emb + head + sum(counts)


def _layer_param_counts(cfg: ModelConfig):
    """Per-layer parameter counts, by spec: every leaf of the layer's
    tree, so φ(v), the model-sync traffic and a migration's bits are
    those of the tensors that move. The reference counts two norms and
    the attention or SSM projections and FFN weights only: it leaves out
    the QK-norm scales, the attention and MLP biases, a Mamba-2 layer's
    conv bias, ``A_log``, ``D`` and ``dt_bias``, and counts a second norm
    that a parallel block (and an FFN-free SSM layer) does not have; on
    an attention-free config it reads a head_dim of zero and raises."""
    d = cfg.d_model
    counts = []
    for mixer, ffn in layer_specs(cfg):
        parallel = cfg.parallel_block and mixer == "attn"
        # norm1 before a mixer, norm2 before an FFN (none in a parallel
        # block)
        c = d * ((mixer != "none") + (ffn != "none" and not parallel))
        if mixer == "none":
            pass
        elif mixer == "attn" and cfg.is_mla:
            c += mla_param_numel(cfg)
        elif mixer == "attn":
            hd = cfg.resolved_head_dim
            c += d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
            if cfg.attn_bias:  # wq, wk, wv (wo has none)
                c += hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
            if cfg.qk_norm:
                c += 2 * hd
        else:
            s = cfg.ssm
            d_inner, H = s.inner(d)
            gn = s.n_groups * s.state_dim
            c += d * (2 * d_inner + 2 * gn + H)  # in_proj
            c += (s.conv_dim + 1) * (d_inner + 2 * gn)  # conv weight, bias
            c += 3 * H  # A_log, D, dt_bias
            c += d_inner * d + d_inner  # out_proj + norm
        if ffn == "dense":
            nm = 3 if cfg.mlp_act == "swiglu" else 2
            c += nm * d * cfg.d_ff
            if cfg.mlp_bias:
                c += (nm - 1) * cfg.d_ff + d
        elif ffn == "moe":
            m = cfg.moe
            nm = 3 if cfg.mlp_act == "swiglu" else 2
            c += m.held * nm * d * m.d_ff_expert
            c += d * m.num_experts  # router
            if m.router == "sigmoid":  # correction_bias
                c += m.num_experts
            if m.num_shared_experts:
                c += nm * d * m.shared_width
        counts.append(c)
    return counts


def layer_adapter_counts(cfg: ModelConfig, peft):
    """Per-layer TRAINABLE adapter counts under a PeftSpec (incl. the scalar
    scale leaf per target) — the PEFT analogue of ``_layer_param_counts``.
    Must match ``init_group_loras`` leaf for leaf: the obs-ledger measures
    real trees, so any drift here fails reconciliation."""
    return [lora_numel(cfg, spec, peft) for spec in layer_specs(cfg)]


def client_adapter_numel(plan: lm_mod.ModelPlan) -> int:
    """φ̂(v): per-client TRAINABLE parameters under PEFT — adapters of
    layers[:cut] only (embedding is frozen base and never crosses the
    wire). This is what model-sync and cut-migration legs price."""
    assert plan.peft is not None, "client_adapter_numel needs a PEFT plan"
    counts = layer_adapter_counts(plan.cfg, plan.peft)
    return sum(counts[:plan.cut])


def server_adapter_numel(plan: lm_mod.ModelPlan) -> int:
    assert plan.peft is not None, "server_adapter_numel needs a PEFT plan"
    counts = layer_adapter_counts(plan.cfg, plan.peft)
    return sum(counts[plan.cut:])


def flops_per_token_per_layer(cfg: ModelConfig, context: int):
    """Forward FLOPs/token per layer (backward ≈ 2x)."""
    out = []
    for mixer, ffn in layer_specs(cfg):
        f = 0
        if mixer == "attn":
            f += attn_flops_per_token(cfg, context)
        elif mixer == "ssm":
            f += ssm_flops_per_token(cfg)
        if ffn == "dense":
            f += mlp_flops_per_token(cfg.d_model, cfg.d_ff, cfg.mlp_act)
        elif ffn == "moe":
            f += moe_flops_per_token(cfg)
        out.append(f)
    return out


def split_flops(cfg: ModelConfig, cut: int, context: int) -> Dict[str, float]:
    """γ_F^c, γ_B^c, γ_F^s, γ_B^s per token (eqs. 14-16 analogues)."""
    per_layer = flops_per_token_per_layer(cfg, context)
    head = 2 * cfg.d_model * cfg.vocab_size
    cf = sum(per_layer[:cut])
    sf = sum(per_layer[cut:]) + head
    return {"client_fwd": cf, "client_bwd": 2 * cf,
            "server_fwd": sf, "server_bwd": 2 * sf}


def model_flops_train_step(cfg: ModelConfig, tokens: int, context: int) -> float:
    """MODEL_FLOPS = 6·N_active·D-style estimate for the roofline table."""
    per_layer = flops_per_token_per_layer(cfg, context)
    head = 2 * cfg.d_model * cfg.vocab_size
    fwd = (sum(per_layer) + head) * tokens
    return 3.0 * fwd  # fwd + 2x bwd


def model_flops_serve(cfg: ModelConfig, tokens: int, context: int) -> float:
    per_layer = flops_per_token_per_layer(cfg, context)
    head = 2 * cfg.d_model * cfg.vocab_size
    return float((sum(per_layer) + head) * tokens)
