"""Model FLOPs of a training step of nemotron-3-nano-13l (frozen).

Forward FLOPs a token, layer by layer of ``layer_pattern``:
* a Mamba-2 mixer (M) as in ``granite-4.0-h-small.py``, at the inner
  width of its ``ssm.num_heads`` heads: 2 x the input and output
  projections' weights, the depthwise convolution (2 k a channel), and
  the SSD in its chunked form at chunk Q (full Q x Q blocks);
* an attention mixer (*) as in ``granite-8b-4l.py``: 2 x the q, k, v, o
  weights, and the scores and values over the full S x S matrix;
* a MoE (E): the router (2 d E), the relu^2 shared expert (2 x 2 d
  d_ff_shared), and the held relu^2 experts at the pairs they expect,
  top_k x held / E a token, with no padding (2 x 2 d d_ff_expert each);
* the (sliced) head, 2 d V.
A training step is 3 x the forward, with nothing recomputed (remat's
second forward is not counted); the embedding lookup, norms, gates, the
router's choice, the dispatch and the update are not counted.
"""


def forward_flops_per_token(model: dict, seq: int) -> float:
    d, V, pattern = model["d_model"], model["vocab_size"], \
        model["layer_pattern"]
    H, Hkv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    s, m = model["ssm"], model["moe"]
    Hs, P, N = s["num_heads"], s["head_dim"], s["state_dim"]
    G, Q = s["n_groups"], s["chunk_size"]
    d_inner = Hs * P
    mamba = 2.0 * (d * (2 * d_inner + 2 * G * N + Hs) + d_inner * d) \
        + 2 * s["conv_dim"] * (d_inner + 2 * G * N) \
        + 2 * Q * N * G + Hs * (2 * Q * P + 4 * N * P)
    attn = 2.0 * (2 * d * H * D + 2 * d * Hkv * D) + 2 * 2 * seq * H * D
    E = m["num_experts"]
    held = m.get("experts_held") or E
    moe = 2.0 * d * E + 2 * 2 * d * m["d_ff_shared"] \
        + 2 * 2 * d * m["d_ff_expert"] * m["top_k"] * held / E
    dense = 2.0 * 2 * d * model["d_ff"]
    per = {"M": mamba, "*": attn, "E": moe, "-": dense}
    return sum(per[c] for c in pattern) + 2.0 * d * V


def step_flops(model: dict, traffic: dict) -> float:
    tokens = traffic["cohort"] * traffic["batch"] * traffic["seq"]
    return 3.0 * tokens * forward_flops_per_token(model, traffic["seq"])
