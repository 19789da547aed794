"""Model FLOPs of a training step of tiny-hybrid-moe (a test's counts).

Forward FLOPs a token: 2 x the weights each token multiplies: the
attention projections, the Mamba-2 projections, the SwiGLU MLPs, the
router, top_k routed experts and the shared one, and the head. A step
is 3 x the forward.
"""


def step_flops(model: dict, traffic: dict) -> float:
    d, L, V = model["d_model"], model["num_layers"], model["vocab_size"]
    H, Hkv = model["num_heads"], model["num_kv_heads"]
    D = model["head_dim"]
    m, s = model["moe"], model["ssm"]
    di = s["expand"] * d
    heads = di // s["head_dim"]
    gn = s["n_groups"] * s["state_dim"]
    attn = 2 * d * H * D + 2 * d * Hkv * D
    ssm = d * (2 * di + 2 * gn + heads) + di * d
    moe = d * m["num_experts"] + 3 * d * m["d_ff_expert"] * (
        m["top_k"] + m["num_shared_experts"])
    w = 0
    for i in range(L):
        w += attn if i % model["hybrid_period"] in \
            model["hybrid_attn_offsets"] else ssm
        w += moe if i >= m["first_k_dense"] and \
            (i - m["first_k_dense"]) % m["every"] == 0 \
            else 3 * d * model["d_ff"]
    tokens = traffic["cohort"] * traffic["batch"] * traffic["seq"]
    return 3.0 * tokens * 2.0 * (w + d * V)
