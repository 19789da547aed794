"""Model FLOPs of a training step of kimi-k2-instruct-5l (frozen).

Forward FLOPs a token, layer by layer:
* every layer's multi-head latent attention: 2 x the weights of q_a,
  q_b, kv_a, kv_b and o_proj, the scores over the full S x S matrix at
  the q.k width (nope + rope) and the values at v's width, 2 x S x H x
  (qk + v);
* the dense first layers' SwiGLU, 2 x 3 d d_ff;
* every later layer's MoE as in ``granite-4.0-h-small.py``: the router
  (2 d E), the shared expert (2 x 3 d shared width), and the held
  experts at the pairs they expect, top_k x held / E a token, with no
  padding (2 x 3 d d_ff_expert each);
* the (sliced) head, 2 d V.
A training step is 3 x the forward, with nothing recomputed (remat's
second forward is not counted); the embedding lookup, norms, RoPE, the
router's choice, the dispatch and the update are not counted.
"""


def forward_flops_per_token(model: dict, seq: int) -> float:
    d, L, V, H = (model["d_model"], model["num_layers"], model["vocab_size"],
                  model["num_heads"])
    nope, rope, dv = (model["qk_nope_head_dim"], model["qk_rope_head_dim"],
                      model["v_head_dim"])
    qr, kvr, m = model["q_lora_rank"], model["kv_lora_rank"], model["moe"]
    mla = 2.0 * (d * qr + qr * H * (nope + rope) + d * (kvr + rope)
                 + kvr * H * (nope + dv) + H * dv * d) \
        + 2.0 * seq * H * (nope + rope + dv)
    dense = 2.0 * 3 * d * model["d_ff"]
    E = m["num_experts"]
    held = m.get("experts_held") or E
    shared = m.get("d_ff_shared") or m["d_ff_expert"] * m["num_shared_experts"]
    moe = 2.0 * d * E + 2 * 3 * d * shared \
        + 2 * 3 * d * m["d_ff_expert"] * m["top_k"] * held / E
    n_dense = m["first_k_dense"]
    return L * mla + n_dense * dense + (L - n_dense) * moe + 2.0 * d * V


def step_flops(model: dict, traffic: dict) -> float:
    tokens = traffic["cohort"] * traffic["batch"] * traffic["seq"]
    return 3.0 * tokens * forward_flops_per_token(model, traffic["seq"])
