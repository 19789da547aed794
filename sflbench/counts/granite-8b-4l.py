"""Model FLOPs of a training step of granite-8b-4l (frozen).

Forward FLOPs a token: 2 x the weights of every matrix product (q, k, v,
o, gate, up, down in each layer, and the head), plus attention's scores
and values, 2 x 2 x S x H x D a layer over the full S x S score matrix
that the step computes (the PaLM convention for model FLOPs). A training
step is 3 x the forward (forward, and a backward of twice its work), with
nothing recomputed; the embedding lookup, norms, softmax and the update
are not counted.
"""


def forward_flops_per_token(model: dict, seq: int) -> float:
    d, L = model["d_model"], model["num_layers"]
    H, Hkv = model["num_heads"], model["num_kv_heads"]
    D = model.get("head_dim") or d // H
    ff, V = model["d_ff"], model["vocab_size"]
    weights = L * (d * H * D + 2 * d * Hkv * D + H * D * d + 3 * d * ff) \
        + d * V
    attn = L * 2 * 2 * seq * H * D
    return 2.0 * weights + attn


def step_flops(model: dict, traffic: dict) -> float:
    tokens = traffic["cohort"] * traffic["batch"] * traffic["seq"]
    return 3.0 * tokens * forward_flops_per_token(model, traffic["seq"])
