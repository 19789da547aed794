"""Decoder stack: layer plans, full-sequence forward, prefill and decode
over layer groups.

Port of ``repro.models.transformer``. Layers are grouped into runs with
identical structure ("specs") exactly as in the reference, so a group
here is the group there; where the reference stacks a group's parameters
and runs ``lax.scan`` (with remat in training), the port keeps one
parameter dict per layer and loops in Python, checkpointing each layer
in training where the reference checkpoints its scan body:

    params_list[group][layer][sublayer]   (sublayer = index in the period)

A "spec" is (mixer, ffn) with mixer in {attn, ssm, none} and ffn in
{dense, moe, none}: dense llama-style layers, MoE layers
(``models.moe``), Mamba-2 layers, and hybrids such as Jamba's period of
eight (one attention and seven Mamba-2 mixers, MoE and dense FFNs
alternating), whose group holds sublayers of different specs side by
side. A config's ``layer_pattern`` (the port's own; Nemotron-H's) makes
every layer one sublayer: a mixer alone (``("ssm", "none")``,
``("attn", "none")``) or an FFN alone (``("none", "moe")``, ``("none",
"dense")``, one norm, ``norm2``, before it); its groups are peeled as any
other's, falling back to a group a layer. The flash forward (B4, B5),
prefill, decode and LoRA refuse such a config. Each
residual branch is scaled by ``cfg.residual_multiplier`` where it is not
1 (granite-4.0-h's 0.22; a MoE FFN's branch holds its shared expert).
The full-sequence forward returns the sum of the MoE layers' balance losses
beside the activations; prefill and decode drop it, as the reference's
do.

LoRA adapter trees mirror the layer lists (``[group][layer][sublayer]``,
nested dicts), with each targeted linear's dict replaced by its
``{"a", "b", "s"}`` factors and everything untargeted absent, so the
bank, cohort and cut-migration functions move adapters as they move
layers. ``attach_group_loras`` hangs them on the base linears (the
factored forward), ``merge_group_loras`` folds them in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from repro_torch import placed_like
from repro_torch.configs.base import LAYER_KINDS, ModelConfig, PeftSpec
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import paging as paging_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import (init_lora, init_mlp, init_rmsnorm,
                                       merge_lora, mlp, rmsnorm)

Spec = Tuple[str, str]  # (mixer, ffn)


def layer_specs(cfg: ModelConfig) -> List[Spec]:
    if cfg.layer_pattern:
        return [LAYER_KINDS[c] for c in cfg.layer_pattern]
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


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _init_sublayer(gen, cfg: ModelConfig, spec: Spec, dtype, device):
    mixer, ffn = spec
    p = {}
    if mixer != "none":
        p["norm1"] = init_rmsnorm(cfg.d_model, dtype, device)
    if mixer == "attn":
        p["attn"] = attn_mod.init_attention(gen, cfg, dtype, device)
    elif mixer == "ssm":
        p["ssm"] = ssm_mod.init_mamba2(gen, cfg, dtype, device)
    if ffn != "none" and not (cfg.parallel_block and mixer == "attn"):
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, device)
    if ffn == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                            cfg.mlp_bias, dtype, device)
    elif ffn == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
    return p


def init_groups(gen, cfg: ModelConfig, groups: Sequence[LayerGroup], dtype,
                device):
    """Per-layer param trees: ``[group][layer][sublayer]`` dicts."""
    return [[tuple(_init_sublayer(gen, cfg, s, dtype, device)
                   for s in g.period) for _ in range(g.repeat)]
            for g in groups]


# ---------------------------------------------------------------------------
# LoRA adapters
# ---------------------------------------------------------------------------

def lora_target_dims(cfg: ModelConfig, spec: Spec, peft: PeftSpec) -> dict:
    """(d_in, d_out) per targeted projection of one sublayer, keyed like
    the param tree (``{"attn": {"wq": ...}}``): the one source of the
    adapters' init and of their analytic counts. The head_dim is read for
    attention sublayers only (the reference reads it for every sublayer
    and so refuses LoRA on an attention-free config)."""
    refuse_layer_pattern(cfg, "LoRA")
    mixer, ffn = spec
    d = cfg.d_model
    out: dict = {}
    if mixer == "attn" and "attn" in peft.targets:
        if cfg.is_mla:
            raise ValueError(f"{cfg.name}: LoRA targets wq/wk/wv/wo; "
                             f"multi-head latent attention has none of "
                             f"them but wo")
        hd = cfg.resolved_head_dim
        out["attn"] = {
            "wq": (d, cfg.num_heads * hd),
            "wk": (d, cfg.num_kv_heads * hd),
            "wv": (d, cfg.num_kv_heads * hd),
            "wo": (cfg.num_heads * hd, d),
        }
    if mixer == "ssm" and "ssm" in peft.targets:
        s = cfg.ssm
        d_inner, heads = s.inner(d)
        d_in_proj = 2 * d_inner + 2 * s.n_groups * s.state_dim + heads
        out["ssm"] = {"in_proj": (d, d_in_proj), "out_proj": (d_inner, d)}
    if ffn == "dense" and "mlp" in peft.targets:
        mats = {"up": (d, cfg.d_ff), "down": (cfg.d_ff, d)}
        if cfg.mlp_act == "swiglu":
            mats["gate"] = (d, cfg.d_ff)
        out["mlp"] = mats
    if ffn == "moe" and "router" in peft.targets:
        out["moe"] = {"router": (d, cfg.moe.num_experts)}
    return out


def lora_numel(cfg: ModelConfig, spec: Spec, peft: PeftSpec) -> int:
    """Trainable elements of one sublayer's adapters, the scalar scale
    leaf included: ``init_sublayer_lora``'s leaves, element for element."""
    n = 0
    for mats in lora_target_dims(cfg, spec, peft).values():
        for d_in, d_out in mats.values():
            n += peft.rank * (d_in + d_out) + 1  # A + B + s
    return n


def init_sublayer_lora(gen, cfg: ModelConfig, spec: Spec, peft: PeftSpec,
                       dtype=torch.float32, device="cpu"):
    p: dict = {}
    for name, mats in sorted(lora_target_dims(cfg, spec, peft).items()):
        p[name] = {m: init_lora(gen, dims[0], dims[1], peft.rank,
                                peft.alpha, dtype, device)
                   for m, dims in sorted(mats.items())}
    return p


def init_group_loras(gen, cfg: ModelConfig, groups: Sequence[LayerGroup],
                     peft: PeftSpec, dtype=torch.float32, device="cpu"):
    """Adapter trees in the layer lists' layout: ``[group][layer]
    [sublayer]``."""
    return [[tuple(init_sublayer_lora(gen, cfg, s, peft, dtype, device)
                   for s in g.period) for _ in range(g.repeat)]
            for g in groups]


def _is_adapter(node) -> bool:
    return isinstance(node, dict) and set(node) == {"a", "b", "s"}


def _walk(base, ad, leaf_fn):
    if _is_adapter(ad):
        return leaf_fn(base, ad)
    if isinstance(ad, dict):
        return {k: _walk(base[k], ad[k], leaf_fn) if k in ad else base[k]
                for k in base}
    if isinstance(ad, (tuple, list)):
        return type(ad)(_walk(b, a, leaf_fn) for b, a in zip(base, ad))
    return base


def attach_group_loras(params_list, lora_list):
    """The base layer lists with every targeted linear's dict given a
    ``"lora"`` entry, which ``blocks.linear`` applies on the factored
    path. Dict surgery only: no tensor is copied."""
    return [_walk(gp, la, lambda b, a: dict(b, lora=a))
            for gp, la in zip(params_list, lora_list)]


def merge_group_loras(params_list, lora_list):
    """Fold adapters into the base weights (w' = w + s AB): base-shaped
    layer lists, for serving, evaluation or parity with the
    full-parameter path."""
    return [_walk(gp, la, merge_lora)
            for gp, la in zip(params_list, lora_list)]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def refuse_layer_pattern(cfg: ModelConfig, path: str):
    """Raise where ``path`` runs only (mixer, ffn) layers and ``cfg`` sets
    a ``layer_pattern``."""
    if cfg.layer_pattern:
        raise ValueError(f"{cfg.name}: {path} runs (mixer, ffn) layers; "
                         f"this model sets layer_pattern "
                         f"{cfg.layer_pattern!r}")


def _residual(cfg, x, y):
    """x + y on the residual stream; a branch is scaled by
    ``cfg.residual_multiplier`` where it is not 1."""
    m = cfg.residual_multiplier
    return x + y if m == 1.0 else x + m * y


def _ffn(cfg, spec, p, x):
    """The sublayer's FFN on the residual stream. Returns (x, aux): the
    MoE balance loss, or None for a dense or absent FFN."""
    if spec[1] == "dense":
        x = _residual(cfg, x, mlp(p["mlp"], rmsnorm(p["norm2"], x,
                                                    cfg.norm_eps),
                                  cfg.mlp_act))
    elif spec[1] == "moe":
        y, aux = moe_mod.moe_apply(p["moe"], cfg,
                                   rmsnorm(p["norm2"], x, cfg.norm_eps))
        return _residual(cfg, x, y), aux
    return x, None


def _parallel(cfg, spec) -> bool:
    return cfg.parallel_block and spec == ("attn", "dense")


def _parallel_out(cfg, p, x, a, h):
    return _residual(cfg, _residual(cfg, x, a),
                     mlp(p["mlp"], h, cfg.mlp_act))


def _sublayer_train(cfg, spec, p, x, positions, impl):
    """Returns (x, aux); aux is None without a MoE FFN."""
    if spec[0] == "none":
        return _ffn(cfg, spec, p, x)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec[0] == "attn":
        a = attn_mod.attend_train(p["attn"], cfg, h, positions, impl)
    else:
        a = ssm_mod.mamba2_train(p["ssm"], cfg, h,
                                 use_kernel=(impl == "flash"))
    if _parallel(cfg, spec):
        return _parallel_out(cfg, p, x, a, h), None
    return _ffn(cfg, spec, p, _residual(cfg, x, a))


def layer_train(cfg, period, layer_p, x, x0, aux_total, positions, impl):
    """One layer of a group (one period: the reference's scan body).
    Returns (x, aux_total) with the layer's MoE balance losses added in
    sublayer order; every sublayer's output takes ``x0``'s layout."""
    for i, s in enumerate(period):
        x, aux = _sublayer_train(cfg, s, layer_p[i], x, positions, impl)
        x = placed_like(x, x0)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def remat_layer(fn, *args):
    """``fn(*args)`` with its activations rematerialized: only the inputs
    are kept, and the backward runs ``fn`` again to rebuild what it
    needs. The train forward draws no random numbers (the codec's
    rounding hash sits at the boundary, outside the layers), so the
    recompute needs no saved RNG state. The graph the backward walks is
    the forward's own, so values and gradients are those of ``fn``
    unwrapped, bit for bit."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def apply_groups_train(params_list, cfg: ModelConfig, groups, x, positions,
                       impl: str = "jnp", remat: bool = True):
    """Full-sequence forward through all groups. Returns (x, aux_sum),
    aux the sum of the MoE layers' balance losses (zero without MoE
    layers), added in layer order as the reference's scan adds it.
    ``impl="flash"`` runs attention through kernel B4 and the SSD
    through kernel B5 (their plain versions on the CPU); ``"jnp"`` is the
    model's own masked-softmax attention and ``ssd_chunked``. ``remat``
    checkpoints each layer, as the reference's ``jax.checkpoint`` of its
    scan body does; it applies only where autograd records (a no-grad
    forward runs as it would without it). A checkpoint cannot sit inside
    ``torch.func.vmap``: a vmapped caller passes ``remat=False``."""
    if impl == "flash":
        refuse_layer_pattern(cfg, "the flash forward (B4, B5)")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    x0 = x
    remat = remat and torch.is_grad_enabled()
    for g, gp in zip(groups, params_list):
        for layer_p in gp:
            args = (cfg, g.period, layer_p, x, x0, aux_total, positions,
                    impl)
            x, aux_total = (remat_layer(layer_train, *args) if remat
                            else layer_train(*args))
    return x, aux_total


def _sublayer_prefill(cfg, spec, p, x, positions, max_len):
    """The serve path's prefill: an SSM layer runs its chunk-aligned head
    through ``kernels.ops.ssd`` (kernel B5 on the card)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec[0] == "attn":
        a, cache = attn_mod.attend_prefill(p["attn"], cfg, h, positions,
                                           max_len)
    else:
        a, cache = ssm_mod.mamba2_prefill(p["ssm"], cfg, h)
    if _parallel(cfg, spec):
        return _parallel_out(cfg, p, x, a, h), cache
    return _ffn(cfg, spec, p, _residual(cfg, x, a))[0], cache


def apply_groups_prefill(params_list, cfg, groups, x, positions, max_len):
    """Returns (x, caches) -- caches[group][layer][sublayer]: a KVCache
    per attention layer, an SSMCache per SSM layer."""
    refuse_layer_pattern(cfg, "prefill")
    caches = []
    x0 = x
    for g, gp in zip(groups, params_list):
        gc = []
        for layer_p in gp:
            lc = []
            for i, s in enumerate(g.period):
                x, c = _sublayer_prefill(cfg, s, layer_p[i], x, positions,
                                         max_len)
                x = placed_like(x, x0)
                lc.append(c)
            gc.append(tuple(lc))
        caches.append(gc)
    return x, caches


def _sublayer_decode(cfg, spec, p, x, cache):
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec[0] == "attn" and isinstance(cache, attn_mod.KVCache):
        a, cache = attn_mod.attend_decode(p["attn"], cfg, h, cache)
    elif spec[0] == "attn":
        a, cache = paging_mod.attend_decode_paged(p["attn"], cfg, h, cache)
    else:
        a, cache = ssm_mod.mamba2_decode(p["ssm"], cfg, h, cache)
    if _parallel(cfg, spec):
        return _parallel_out(cfg, p, x, a, h), cache
    return _ffn(cfg, spec, p, _residual(cfg, x, a))[0], cache


def apply_groups_decode(params_list, cfg, groups, x, caches):
    """One-token decode over paged or dense caches (attention) and
    recurrent states (SSM). Returns (x, new_caches)."""
    refuse_layer_pattern(cfg, "decode")
    new_caches = []
    x0 = x
    for g, gp, gc in zip(groups, params_list, caches):
        ngc = []
        for layer_p, layer_c in zip(gp, gc):
            lc = []
            for i, s in enumerate(g.period):
                x, c = _sublayer_decode(cfg, s, layer_p[i], x, layer_c[i])
                x = placed_like(x, x0)
                lc.append(c)
            ngc.append(tuple(lc))
        new_caches.append(ngc)
    return x, new_caches


def init_group_caches(cfg: ModelConfig, groups, batch: int, max_len: int,
                      dtype=torch.float32, device="cpu"):
    """Empty dense caches in ``apply_groups_decode``'s layout."""
    refuse_layer_pattern(cfg, "decode")

    def one(spec):
        if spec[0] == "attn":
            return attn_mod.init_cache(cfg, batch, max_len, dtype, device)
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)

    return [[tuple(one(s) for s in g.period) for _ in range(g.repeat)]
            for g in groups]
