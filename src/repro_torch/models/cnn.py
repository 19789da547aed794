"""The paper's CNN (§V-A, McMahan-style) as a V=5-block split model.

Port of ``repro.models.cnn``. Blocks: conv32 -> conv64 -> fc512 ->
fc128 -> fc_out. Cutting point v in {1..4} puts blocks[:v] on the client
(client-side model w^c, size phi(v)) and blocks[v:] on the server.

Parameters are plain lists of ``{"w", "b"}`` tensors in the reference's
layouts, so its weights carry over unchanged (``convert``): conv weights
HWIO, fc weights ``(d_in, d_out)`` applied as ``x @ w``. Activations are
NHWC at the public functions. ``torch.nn.functional.conv2d`` wants NCHW
and OIHW, so each conv block permutes in and back out; block 1 flattens
the NHWC map, as the reference does, so fc1's rows line up with its
params. SAME 5x5 convolution is padding 2; max-pool is 2x2 VALID.
Every function here is pure in its arguments and works under
``torch.func.vmap`` over a leading client axis of the params.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig


def _conv_pool(params, x):
    """relu(conv SAME) -> 2x2 max-pool, NHWC in and out."""
    w = params["w"].permute(3, 2, 0, 1)              # HWIO -> OIHW
    k = w.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2)
    y = y + params["b"][:, None, None]
    y = F.max_pool2d(torch.relu(y), 2, 2)
    return y.permute(0, 2, 3, 1)                     # NCHW -> NHWC


def block_shapes(cfg: CNNConfig) -> List[Tuple[int, ...]]:
    """Activation shape (per sample) after each block."""
    s = cfg.image_size
    return [(s // 2, s // 2, cfg.conv_channels[0]),
            (s // 4, s // 4, cfg.conv_channels[1]),
            (cfg.fc_dim,), (cfg.fc_dim // 4,), (cfg.num_classes,)]


def param_shapes(cfg: CNNConfig) -> List[dict]:
    """``{"w": shape, "b": shape}`` of each block, as ``init_cnn`` makes
    them (counts parameters without drawing any)."""
    s, k = cfg.image_size, cfg.kernel_size
    c1, c2 = cfg.conv_channels
    flat = c2 * (s // 4) * (s // 4)
    dims = [(cfg.channels, c1), (c1, c2), (flat, cfg.fc_dim),
            (cfg.fc_dim, cfg.fc_dim // 4), (cfg.fc_dim // 4, cfg.num_classes)]
    return [{"w": (k, k, din, dout) if i < 2 else (din, dout), "b": (dout,)}
            for i, (din, dout) in enumerate(dims)]


def init_cnn(generator: torch.Generator, cfg: CNNConfig,
             device="cpu") -> List[dict]:
    """He-normal weights and zero biases, drawn from ``generator`` on its
    own device and placed on ``device`` (a CPU generator gives the same
    params on the card and on the CPU). The numbers differ from the
    reference's ``jax.random`` draw; to start from the reference's
    params, convert them (``convert.cnn_params_from_jax``)."""
    out = []
    for shp in param_shapes(cfg):
        fan_in = math.prod(shp["w"][:-1])
        w = torch.randn(shp["w"], generator=generator,
                        device=generator.device) * math.sqrt(2.0 / fan_in)
        out.append({"w": w.to(device),
                    "b": torch.zeros(shp["b"], device=device)})
    return out


def apply_block(i: int, params, x, cfg: CNNConfig):
    if i == 0 or i == 1:
        x = _conv_pool(params, x)
        if i == 1:
            x = x.reshape(x.shape[0], -1)
        return x
    x = x @ params["w"] + params["b"]
    if i < 4:
        x = torch.relu(x)
    return x


def forward_blocks(params_list, x, cfg: CNNConfig, start: int, stop: int):
    for i in range(start, stop):
        x = apply_block(i, params_list[i - start], x, cfg)
    return x


def client_forward(client_params, x, cfg: CNNConfig, v: int):
    """Smashed data S = l(w^c; xi) (eq. 1)."""
    return forward_blocks(client_params, x, cfg, 0, v)


def server_logits(server_params, smashed, cfg: CNNConfig, v: int):
    return forward_blocks(server_params, smashed, cfg, v, cfg.num_layers)


def server_loss(server_params, smashed, y, cfg: CNNConfig, v: int):
    """Mean cross-entropy; ``y`` holds int64 class ids."""
    logits = server_logits(server_params, smashed, cfg, v)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def phi(cfg: CNNConfig, v: int, params=None) -> int:
    """Client-side model size phi(v) in parameter count (eq. 17)."""
    if params is None:
        return sum(math.prod(s) for b in param_shapes(cfg)[:v]
                   for s in b.values())
    return sum(int(t.numel()) for b in params[:v] for t in b.values())


def total_params(cfg: CNNConfig, params=None) -> int:
    return phi(cfg, cfg.num_layers, params)


def smashed_numel(cfg: CNNConfig, v: int) -> int:
    """Per-sample element count of the smashed data at cut v -> X_t(v)."""
    return int(math.prod(block_shapes(cfg)[v - 1]))


def block_flops(cfg: CNNConfig) -> List[int]:
    """Per-sample forward FLOPs per block (convs dominate, unlike params)."""
    s, k = cfg.image_size, cfg.kernel_size
    c1, c2 = cfg.conv_channels
    flat = c2 * (s // 4) * (s // 4)
    return [
        2 * s * s * k * k * cfg.channels * c1,
        2 * (s // 2) * (s // 2) * k * k * c1 * c2,
        2 * flat * cfg.fc_dim,
        2 * cfg.fc_dim * (cfg.fc_dim // 4),
        2 * (cfg.fc_dim // 4) * cfg.num_classes,
    ]


def client_flop_fraction(cfg: CNNConfig, v: int) -> float:
    """Fraction of per-sample FLOPs below the cut."""
    f = block_flops(cfg)
    return float(sum(f[:v]) / sum(f))
