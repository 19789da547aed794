"""Model FLOPs of a training step of granite-4.0-h-small (frozen).

Forward FLOPs a token, layer by layer:
* a Mamba-2 mixer as in ``mamba2-130m.py``: 2 x the input and output
  projections' weights, the depthwise convolution (2 k a channel), and
  the SSD in its chunked form at chunk Q (full Q x Q blocks);
* an attention mixer as in ``granite-8b-4l.py``: 2 x the q, k, v, o
  weights, and the scores and values over the full S x S matrix;
* every layer's MoE: the router (2 d E), the shared expert (2 x 3 d
  d_ff_shared), and the held experts at the pairs they expect, top_k x
  held / E a token, with no padding (2 x 3 d d_ff_expert each);
* the (sliced) head, 2 d V.
A training step is 3 x the forward, with nothing recomputed (remat's
second forward is not counted); the embedding lookup, norms, gates,
the dispatch and the update are not counted.
"""


def forward_flops_per_token(model: dict, seq: int) -> float:
    d, L, V = model["d_model"], model["num_layers"], model["vocab_size"]
    H, Hkv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    s, m = model["ssm"], model["moe"]
    d_inner = s["expand"] * d
    Hs, P, N = d_inner // s["head_dim"], s["head_dim"], s["state_dim"]
    G, Q = s["n_groups"], s["chunk_size"]
    mamba = 2.0 * (d * (2 * d_inner + 2 * G * N + Hs) + d_inner * d) \
        + 2 * s["conv_dim"] * (d_inner + 2 * G * N) \
        + 2 * Q * N * G + Hs * (2 * Q * P + 4 * N * P)
    attn = 2.0 * (2 * d * H * D + 2 * d * Hkv * D) + 2 * 2 * seq * H * D
    E = m["num_experts"]
    held = m.get("experts_held") or E
    moe = 2.0 * d * E + 2 * 3 * d * m["d_ff_shared"] \
        + 2 * 3 * d * m["d_ff_expert"] * m["top_k"] * held / E
    n_attn = sum(1 for i in range(L)
                 if i % model["hybrid_period"] in model["hybrid_attn_offsets"])
    return n_attn * attn + (L - n_attn) * mamba + L * moe + 2.0 * d * V


def step_flops(model: dict, traffic: dict) -> float:
    tokens = traffic["cohort"] * traffic["batch"] * traffic["seq"]
    return 3.0 * tokens * forward_flops_per_token(model, traffic["seq"])
