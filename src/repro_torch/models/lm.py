"""Top-level language model: embeddings -> layer groups -> norm -> logits.

Port of ``repro.models.lm``. ``ModelPlan`` freezes everything static
(config, cut point, layer grouping, and the LoRA spec when the run
trains adapters) so one plan drives init, the full-sequence forward,
prefill and decode, and the SFL split (client side = embed +
layers[:cut], server side = rest + head) is structural. The parameter
tree has the reference's keys (``embed``, ``client``, ``server``,
``final_norm``, ``head``), with per-layer lists where the reference
stacks a group (``models.transformer``); adapter trees
(``init_lm_loras``) have its ``client``/``server`` layout.

The forward (``client_forward``, ``server_forward``, ``lm_loss``) trains
under autograd with ``impl="jnp"`` (the model's own attention and
``ssd_chunked``), which is what the reference's train step pins
(``core.algorithms``). With ``impl="flash"`` it runs kernels B4 and B5,
which have no backward: that path is forward only on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import is_dtensor, reduce_partial, require_device
from repro_torch.configs.base import ModelConfig, PeftSpec
from repro_torch.models import transformer as tf
from repro_torch.models.blocks import (embed, init_embedding, init_linear,
                                       init_rmsnorm, linear, rmsnorm, unembed)


@dataclass(frozen=True)
class ModelPlan:
    cfg: ModelConfig
    cut: int  # 0 = no split (everything server-side); v in [1, L-1] for SFL
    client_groups: Tuple[tf.LayerGroup, ...]
    server_groups: Tuple[tf.LayerGroup, ...]
    # PEFT: when set, the trained and federated unit is the adapter tree
    # and the init_lm tree is a frozen base
    peft: Optional[PeftSpec] = None

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers


def build_plan(cfg: ModelConfig, cut: int = 0,
               peft: Optional[PeftSpec] = None) -> ModelPlan:
    if not 0 <= cut < cfg.num_layers:
        raise ValueError(f"cut {cut} outside [0, {cfg.num_layers})")
    specs = tf.layer_specs(cfg)
    cg = tuple(tf.group_specs(specs[:cut])) if cut else ()
    sg = tuple(tf.group_specs(specs[cut:]))
    return ModelPlan(cfg=cfg, cut=cut, client_groups=cg, server_groups=sg,
                     peft=peft)


def init_lm(seed: int, plan: ModelPlan, dtype=torch.float32,
            device="cuda"):
    """Random parameters drawn directly on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: the reference's
    distributions, not jax's bits (use ``convert.params_from_jax`` to
    carry the reference's own weights over)."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    cfg = plan.cfg
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
        "client": tf.init_groups(gen, cfg, plan.client_groups, dtype, dev),
        "server": tf.init_groups(gen, cfg, plan.server_groups, dtype, dev),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, dev),
    }
    # Tied embeddings are untied when the model is split: the embedding
    # lives client-side, the head server-side (they can no longer share).
    if not cfg.tie_embeddings or plan.cut >= 1:
        params["head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, False,
                                     dtype, dev)
    return params


def init_lm_loras(seed: int, plan: ModelPlan, dtype=torch.float32,
                  device="cuda"):
    """Adapter trees for a PEFT plan, ``{"client": [...], "server":
    [...]}`` in the layer lists' layout, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (use
    ``convert.loras_from_jax`` to carry the reference's draw over).
    Embedding, norms and head carry no adapters: they stay frozen with
    the base."""
    if plan.peft is None:
        raise ValueError("init_lm_loras needs a plan with peft set")
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return {
        "client": tf.init_group_loras(gen, plan.cfg, plan.client_groups,
                                      plan.peft, dtype, dev),
        "server": tf.init_group_loras(gen, plan.cfg, plan.server_groups,
                                      plan.peft, dtype, dev),
    }


def attach_lm_loras(base, loras):
    """The init_lm-shaped tree with adapters attached on both halves: the
    forward-ready view of (frozen base, trainable adapters)."""
    return dict(base,
                client=tf.attach_group_loras(base["client"], loras["client"]),
                server=tf.attach_group_loras(base["server"], loras["server"]))


def merge_lm_loras(base, loras):
    """Fold adapters into the frozen base: a plain full-parameter tree
    (w' = w + s AB) for every path that knows no adapters."""
    return dict(base,
                client=tf.merge_group_loras(base["client"], loras["client"]),
                server=tf.merge_group_loras(base["server"], loras["server"]))


def all_groups(plan: ModelPlan):
    return tuple(plan.client_groups) + tuple(plan.server_groups)


def all_group_params(params):
    return list(params["client"]) + list(params["server"])


def _positions(cfg: ModelConfig, B: int, S: int, device="cpu"):
    """(B, S) text positions 0..S-1; under M-RoPE the three planes all
    take them, (3, B, S), the reference's text-only default."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(B, S)
    if cfg.mrope_sections:
        pos = pos[None].expand(3, B, S)
    return pos


def logits_from_hidden(params, cfg: ModelConfig, x):
    """Final norm and head (or the tied table); divided by
    ``cfg.logits_scaling`` where it is not 1."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if "head" in params:
        out = linear(params["head"], x)
    else:
        out = unembed(params["embed"], x)
    return out if cfg.logits_scaling == 1.0 else out / cfg.logits_scaling


def scale_embedding(cfg: ModelConfig, x):
    """The input embeddings times ``cfg.embedding_multiplier`` where it is
    not 1 (precomputed ones too, as the table's rows)."""
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def _inputs(params, cfg: ModelConfig, tokens=None, inputs_embeds=None,
            dtype=torch.float32):
    x = inputs_embeds if inputs_embeds is not None \
        else embed(params["embed"], tokens, dtype)
    return scale_embedding(cfg, x)


# ---------------------------------------------------------------------------
# Full-sequence forward, split into client/server halves (the SFL boundary)
#
# ``impl`` selects the model path as in the reference: "flash" runs the
# attention layers through kernel B4 and the SSM layers through kernel B5
# (their plain versions on the CPU), "jnp" the model's own masked-softmax
# attention and ``ssd_chunked``. ``remat`` checkpoints each layer where
# autograd records, as the reference's does (``transformer.
# apply_groups_train``). ``dtype`` defaults to float32, the kernels' type,
# where the reference defaults to bf16.
# ---------------------------------------------------------------------------

def client_forward(params, plan: ModelPlan, tokens=None, inputs_embeds=None,
                   positions=None, impl="jnp", remat=True,
                   dtype=torch.float32):
    """Client-side model: embed + layers[:cut]. Output = smashed data
    (eq. 1) and the aux loss (zero without MoE)."""
    cfg = plan.cfg
    x = _inputs(params, cfg, tokens, inputs_embeds, dtype)
    B, S = x.shape[:2]
    if positions is None:
        positions = _positions(cfg, B, S, x.device)
    return tf.apply_groups_train(params["client"], cfg, plan.client_groups,
                                 x, positions, impl, remat)


def server_forward(params, plan: ModelPlan, smashed, positions=None,
                   impl="jnp", remat=True):
    """Server-side model: layers[cut:] + norm + head. Returns (logits,
    aux)."""
    cfg = plan.cfg
    B, S = smashed.shape[:2]
    if positions is None:
        positions = _positions(cfg, B, S, smashed.device)
    x, aux = tf.apply_groups_train(params["server"], cfg, plan.server_groups,
                                   smashed, positions, impl, remat)
    return logits_from_hidden(params, cfg, x), aux


def lm_loss(params, plan: ModelPlan, tokens=None, labels=None,
            inputs_embeds=None, impl="jnp", remat=True, boundary_fn=None,
            dtype=torch.float32, aux_weight: float = 0.01):
    """Full train loss: (loss + aux_weight * aux, (loss, aux)).
    ``boundary_fn`` is applied to the smashed data -- where the SFL-GA
    gradient-aggregation op plugs in."""
    smashed, aux_c = client_forward(params, plan, tokens, inputs_embeds,
                                    impl=impl, remat=remat, dtype=dtype)
    if boundary_fn is not None:
        smashed = boundary_fn(smashed)
    logits, aux_s = server_forward(params, plan, smashed, impl=impl,
                                   remat=remat)
    loss = cross_entropy(logits, labels)
    return loss + aux_weight * (aux_c + aux_s), (loss, aux_c + aux_s)


def cross_entropy(logits, labels, ignore_id: int = -1):
    """Mean token CE in fp32. labels: (B, S) int, ignore_id masked out."""
    lf = logits.float()
    if is_dtensor(lf):
        # vocab-parallel: the max and the sum of exps reduce over the
        # vocab shards as (B, S) values, not as gathered logits
        m = reduce_partial(torch.amax(lf.detach(), dim=-1, keepdim=True))
        lse = (m + torch.log(reduce_partial(
            torch.sum(torch.exp(lf - m), dim=-1, keepdim=True))))[..., 0]
    else:
        lse = torch.logsumexp(lf, dim=-1)
    ll = reduce_partial(
        torch.gather(lf, -1, labels.clamp_min(0).long()[..., None]))[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((lse - ll) * mask) / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# Serving on the composed model: prefill and dense one-token decode (the
# serve engine pages its caches instead, ``core.serve_engine``)
# ---------------------------------------------------------------------------

def prefill(params, plan: ModelPlan, tokens=None, inputs_embeds=None,
            max_len=None, dtype=torch.float32):
    """Returns (last-position logits (B, 1, V), caches[group][layer]
    [sublayer]) with dense caches of capacity ``max_len``."""
    cfg = plan.cfg
    x = _inputs(params, cfg, tokens, inputs_embeds, dtype)
    B, S = x.shape[:2]
    x, caches = tf.apply_groups_prefill(all_group_params(params), cfg,
                                        all_groups(plan), x,
                                        _positions(cfg, B, S, x.device),
                                        max_len or S)
    return logits_from_hidden(params, cfg, x[:, -1:, :]), caches


def decode_step(params, plan: ModelPlan, token, caches, dtype=torch.float32):
    """token: (B, 1) ids (or (B, 1, d) embeddings). One step over dense
    caches; returns (logits, caches)."""
    x = scale_embedding(plan.cfg, embed(params["embed"], token, dtype)
                        if token.dim() == 2 else token)
    x, caches = tf.apply_groups_decode(all_group_params(params), plan.cfg,
                                       all_groups(plan), x, caches)
    return logits_from_hidden(params, plan.cfg, x), caches


def init_caches(plan: ModelPlan, batch: int, max_len: int,
                dtype=torch.float32, device="cpu"):
    return tf.init_group_caches(plan.cfg, all_groups(plan), batch, max_len,
                                dtype, device)
