"""Model FLOPs of a training step of mamba2-130m (frozen).

Forward FLOPs a token: 2 x the weights of the input and output
projections of every layer and of the (untied) head, the depthwise
convolution (2 k FLOPs a channel), and the SSD in its chunked form at
chunk Q: the scores C B^T once a group (2 Q N), their product with the
inputs (2 Q P a head), and the chunk states written and read (2 N P each,
a head). Full Q x Q blocks are counted, as the step computes them. A
training step is 3 x the forward, nothing recomputed; norms, gates and
the update are not counted.
"""


def forward_flops_per_token(model: dict, seq: int) -> float:
    d, L, V = model["d_model"], model["num_layers"], model["vocab_size"]
    s = model["ssm"]
    d_inner = s["expand"] * d
    H, P, N = d_inner // s["head_dim"], s["head_dim"], s["state_dim"]
    G, Q = s["n_groups"], s["chunk_size"]
    in_proj = d * (2 * d_inner + 2 * G * N + H)
    out_proj = d_inner * d
    conv = 2 * s["conv_dim"] * (d_inner + 2 * G * N)
    ssd = 2 * Q * N * G + H * (2 * Q * P + 4 * N * P)
    return L * (2.0 * (in_proj + out_proj) + conv + ssd) + 2.0 * d * V


def step_flops(model: dict, traffic: dict) -> float:
    tokens = traffic["cohort"] * traffic["batch"] * traffic["seq"]
    return 3.0 * tokens * forward_flops_per_token(model, traffic["seq"])
