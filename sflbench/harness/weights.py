"""Seeded initial weights, made on the device by the benchmark.

Both sides of the output check start from these: the program gets them
in its own layout (``harness.program``), and the reference makes them
again from the same seed after the window. Leaf names are the key paths
of the model's parameter tree (``layer3.attn.wq.w``, ``head.w``), one
unstacked copy of each: the split's client copies are the program's to
make.

The distributions are the usual ones for these families: linear weights
normal with std 1 / sqrt(d_in), the embedding normal with std 0.02, norm
scales 1; for a Mamba-2 mixer the depthwise conv normal / sqrt(k), A_log
= log(1..H), D = 1, and dt_bias the inverse softplus of a dt drawn
log-uniformly in [dt_min, dt_max]. All normal leaves come from one
``normal_`` call over one flat buffer and all uniform ones from one
``uniform_`` call, on a ``torch.Generator`` of the device seeded with
``--seed``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, tuple, str, float]  # name, shape, kind, std


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["num_heads"]


def ssm_dims(model: dict) -> dict:
    s = model["ssm"]
    d_inner = s["expand"] * model["d_model"]
    heads = d_inner // s["head_dim"]
    gn = s["n_groups"] * s["state_dim"]
    return {"d_inner": d_inner, "heads": heads, "gn": gn,
            "conv_ch": d_inner + 2 * gn,
            "in_proj": 2 * d_inner + 2 * gn + heads}


def _normal(name, d_in, d_out) -> Leaf:
    return (name, (d_in, d_out), "normal", 1.0 / math.sqrt(d_in))


def layer_leaves(model: dict, i: int) -> List[Leaf]:
    d = model["d_model"]
    p = f"layer{i}."
    out: List[Leaf] = [(p + "norm1.scale", (d,), "ones", 0.0)]
    if model["arch_type"] == "dense":
        hd = head_dim(model)
        hq, hkv = model["num_heads"] * hd, model["num_kv_heads"] * hd
        ff = model["d_ff"]
        out += [_normal(p + "attn.wq.w", d, hq),
                _normal(p + "attn.wk.w", d, hkv),
                _normal(p + "attn.wv.w", d, hkv),
                _normal(p + "attn.wo.w", hq, d),
                (p + "norm2.scale", (d,), "ones", 0.0),
                _normal(p + "mlp.gate.w", d, ff),
                _normal(p + "mlp.up.w", d, ff),
                _normal(p + "mlp.down.w", ff, d)]
    elif model["arch_type"] == "ssm":
        s, sd = model["ssm"], ssm_dims(model)
        out += [_normal(p + "ssm.in_proj.w", d, sd["in_proj"]),
                (p + "ssm.conv_w", (s["conv_dim"], sd["conv_ch"]), "normal",
                 1.0 / math.sqrt(s["conv_dim"])),
                (p + "ssm.conv_b", (sd["conv_ch"],), "zeros", 0.0),
                (p + "ssm.A_log", (sd["heads"],), "a_log", 0.0),
                (p + "ssm.D", (sd["heads"],), "ones", 0.0),
                (p + "ssm.dt_bias", (sd["heads"],), "dt_bias", 0.0),
                (p + "ssm.norm.scale", (sd["d_inner"],), "ones", 0.0),
                _normal(p + "ssm.out_proj.w", sd["d_inner"], d)]
    else:
        raise ValueError(f"arch_type {model['arch_type']!r} has no weights "
                         f"here (dense and ssm only)")
    return out


def leaves(model: dict) -> List[Leaf]:
    """Every leaf in a fixed order: the embedding, the layers, the final
    norm and the head (untied: the split keeps the embedding with the
    clients and the head with the server)."""
    d, v = model["d_model"], model["vocab_size"]
    out: List[Leaf] = [("embed.table", (v, d), "normal", 0.02)]
    for i in range(model["num_layers"]):
        out += layer_leaves(model, i)
    out += [("final_norm.scale", (d,), "ones", 0.0), _normal("head.w", d, v)]
    return out


def make(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from ``seed``."""
    specs = leaves(model)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    n_norm = sum(math.prod(s) for _, s, k, _ in specs if k == "normal")
    n_unif = sum(math.prod(s) for _, s, k, _ in specs if k == "dt_bias")
    normal = torch.empty(n_norm, dtype=torch.float32, device=device)
    normal.normal_(0.0, 1.0, generator=gen)
    unif = torch.empty(n_unif, dtype=torch.float32, device=device)
    if n_unif:
        unif.uniform_(generator=gen)
    out: Dict[str, torch.Tensor] = {}
    on = ou = 0
    for name, shape, kind, std in specs:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = normal[on:on + n].view(shape).mul_(std)
            on += n
        elif kind == "ones":
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif kind == "a_log":
            out[name] = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                               device=device))
        elif kind == "dt_bias":
            s = model["ssm"]
            u = unif[ou:ou + n]
            ou += n
            dt = torch.exp(u * (math.log(s["dt_max"]) - math.log(s["dt_min"]))
                           + math.log(s["dt_min"]))
            out[name] = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(f"unknown init kind {kind!r}")
    return out


def layer_of(name: str) -> int:
    """The layer index of a ``layer<i>.`` leaf, or -1."""
    if not name.startswith("layer"):
        return -1
    return int(name[5:name.index(".")])


def side_of(name: str, cut: int) -> str:
    """``client`` (the embedding and layers below the cut) or ``server``."""
    i = layer_of(name)
    if name.startswith("embed.") or 0 <= i < cut:
        return "client"
    return "server"
