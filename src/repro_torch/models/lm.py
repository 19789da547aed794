"""Top-level language model: embeddings -> layer groups -> norm -> logits.

Port of the serve-slice parts of ``repro.models.lm``. ``ModelPlan``
freezes everything static (config, cut point, layer grouping) so one
plan drives init, prefill and decode, and the SFL split (client side =
embed + layers[:cut], server side = rest + head) is structural. The
parameter tree has the reference's keys (``embed``, ``client``,
``server``, ``final_norm``, ``head``), with per-layer lists where the
reference stacks a group (``models.transformer``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch import require_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.blocks import (init_embedding, init_linear,
                                       init_rmsnorm, linear, rmsnorm, unembed)


@dataclass(frozen=True)
class ModelPlan:
    cfg: ModelConfig
    cut: int  # 0 = no split (everything server-side); v in [1, L-1] for SFL
    client_groups: Tuple[tf.LayerGroup, ...]
    server_groups: Tuple[tf.LayerGroup, ...]


def build_plan(cfg: ModelConfig, cut: int = 0) -> ModelPlan:
    if not 0 <= cut < cfg.num_layers:
        raise ValueError(f"cut {cut} outside [0, {cfg.num_layers})")
    specs = tf.layer_specs(cfg)
    cg = tuple(tf.group_specs(specs[:cut])) if cut else ()
    sg = tuple(tf.group_specs(specs[cut:]))
    return ModelPlan(cfg=cfg, cut=cut, client_groups=cg, server_groups=sg)


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


def all_groups(plan: ModelPlan):
    return tuple(plan.client_groups) + tuple(plan.server_groups)


def all_group_params(params):
    return list(params["client"]) + list(params["server"])


def _positions(cfg: ModelConfig, B: int, S: int, device="cpu"):
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE positions are not in the serve "
                                  "slice of the port")
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    return pos.expand(B, S)


def logits_from_hidden(params, cfg: ModelConfig, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if "head" in params:
        return linear(params["head"], x)
    return unembed(params["embed"], x)
