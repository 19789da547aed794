"""Kimi-K2-Instruct on the port, held against the plain PyTorch
reference of its family (``sflbench/reference/kimi_k2.py``, which
imports nothing of the program) at CPU size: the configuration's model
cut to d 32, 4 heads, q rank 24, kv rank 16, q.k heads of 8 + 8 and v
heads of 12, a dense first layer of 64, 16 experts of 16 (top 4, 4 held)
beside a shared expert of 16, vocab 128, with MLA, YaRN, the sigmoid
router, its correction bias, routed scaling and sequence-wise balance
loss as published.

* the unsplit loss and every leaf's gradient, and one SFL-GA step's
  readings at cut 1 (the benchmark's checked steps);
* MLA alone, with q.k 16 != v 12, and YaRN at the published numbers;
* the router: the choice on s + b with gates from s, x 2.827, ties to
  the lower expert; the sequence-wise loss against a hand count;
* the correction bias takes no gradient and does not move;
* the expert share: the shares' outputs, the shared expert counted
  once, add up to the uncut reference layer;
* the ``mla`` and ``mla_scores`` spans, the parameter count, and the
  reference's imports;
* on the card (``cuda``), a step against the CPU.

Both sides compute in float32 and sum in different orders (the
reference splits the scores into their nope and rope parts and keeps
the rope pairs interleaved): values of order one agree to a few 1e-7, so
2e-5 holds with margin and catches any wrong term.
"""
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "sflbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import reference  # noqa: E402
from harness import check, session, spec, weights  # noqa: E402
from reference import kimi_k2 as ref_mod  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import (ModelConfig, MoEConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

TOL = 2e-5
CELL = "kimik2-5l.sflga-fp32-cut1-s1024-remat"
CONFIG = json.loads((BENCH / "configs" / "kimi-k2-instruct-5l.json")
                    .read_text())
FAM = reference.Family(ref_mod)
SEED = 2 ** 31 + 38


def _update(tree: dict, keys: dict) -> dict:
    for k, v in keys.items():
        if isinstance(v, dict):
            _update(tree[k], v)
        else:
            tree[k] = v
    return tree


def tiny(**over) -> dict:
    """The configuration's model at CPU size, with ``over`` applied."""
    m = json.loads(json.dumps(CONFIG["model"]))
    _update(m, FAM.tiny["moe"])
    return _update(m, json.loads(json.dumps(over)))


def port_config(m: dict) -> ModelConfig:
    return ModelConfig(name=CONFIG["name"], **dict(m, moe=MoEConfig(
        **m["moe"])))


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def port_params(flat: dict, plan) -> dict:
    """``init_lm``'s tree for ``plan`` from the reference's named leaves
    (the same tensors)."""
    tree = _nest(flat)
    layers = iter([tree.pop(f"layer{i}")
                   for i in range(plan.cfg.num_layers)])
    for side, groups in (("client", plan.client_groups),
                         ("server", plan.server_groups)):
        tree[side] = [[tuple(next(layers) for _ in g.period)
                       for _ in range(g.repeat)] for g in groups]
    return tree


def _tokens(m, shape=(2, 32), seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, m["vocab_size"], shape, generator=g)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def _losses(flat, toks, m):
    """(the port's CE + 0.01 aux, the reference's), unsplit, on the same
    leaves."""
    x, aux = FAM.embed(flat, toks, m), 0.0
    for i in range(m["num_layers"]):
        x, a = FAM.layer(flat, i, x, m)
        aux = aux if a is None else aux + a
    want = lm.cross_entropy(FAM.logits(flat, x, m), toks) \
        + FAM.aux_weight * aux
    cfg = port_config(m)
    plan = lm.build_plan(cfg, 0)
    params = port_params(flat, plan)
    logits, got_aux = lm.server_forward(params, plan,
                                        lm._inputs(params, cfg, toks),
                                        remat=False)
    got = lm.cross_entropy(logits, toks) + 0.01 * got_aux
    return got, want


def test_loss_and_every_gradient_match_the_reference():
    m = tiny()
    flat = {k: v.requires_grad_(True)
            for k, v in weights.make(m, SEED, "cpu", FAM).items()}
    got, want = _losses(flat, _tokens(m), m)
    _close(got, want)
    names = list(flat)
    g_got = torch.autograd.grad(got, [flat[k] for k in names],
                                allow_unused=True)
    g_want = torch.autograd.grad(want, [flat[k] for k in names])
    for k, a, b in zip(names, g_got, g_want):
        if k.endswith("correction_bias"):
            assert a is None and not b.any(), k  # no gradient on either side
            continue
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, msg=k)
    cfg = port_config(m)
    assert cfg.is_mla and not cfg.attention_is_reference
    assert set(cfg.port_fields_set()) == {
        "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
        "qk_rope_head_dim", "v_head_dim", "yarn_factor",
        "yarn_original_max_position", "yarn_beta_fast", "yarn_beta_slow",
        "yarn_mscale_all_dim", "moe.experts_held", "moe.router",
        "moe.routed_scaling"}


def test_split_step_matches_the_reference():
    """The benchmark's checked steps at CPU size: three SFL-GA steps of 4
    clients at cut 1 with remat, losses, first gradients and changes
    against the reference's."""
    c = spec.cell(CELL)
    cfg = json.loads(json.dumps(c.config))
    cfg["model"] = tiny()
    c = dataclasses.replace(c, config=cfg, traffic=dict(c.traffic, seq=32))
    su = session.setup(c, SEED, "cpu")
    ref = session.reference_readings(c, SEED, "cpu")
    nums = check.numbers(su.checked, ref)
    assert nums["loss_gap"] < 1e-6, nums
    assert nums["grad_gap"] < 1e-4, nums
    assert nums["change_gap"] < 1e-4, nums
    assert set(su.checked["grad"]) == set(ref["grad"])


def test_mla_alone_matches_the_reference():
    """q.k 16 (8 nope + 8 rope) against v 12, 4 heads, YaRN on (at rope
    width 8 its ramp runs from frequency 2 to 3, so both sides of it are
    taken)."""
    m = tiny()
    assert m["qk_nope_head_dim"] + m["qk_rope_head_dim"] != m["v_head_dim"]
    cfg = port_config(m)
    gen = torch.Generator().manual_seed(3)
    p = attn_mod.init_mla(gen, cfg)
    for k in ("q_a_norm", "kv_a_norm"):  # scales other than 1
        p[k]["scale"] = 1 + 0.1 * torch.randn(p[k]["scale"].shape,
                                              generator=gen)
    x = torch.randn(2, 32, m["d_model"], generator=gen)
    pos = lm._positions(cfg, 2, 32)
    flat = {f"a.{k}.{leaf}": v for k, d in p.items() for leaf, v in d.items()}
    assert ref_mod.yarn_correction_range(m) == (2, 3)
    with torch.no_grad():
        got = attn_mod.attend_train(p, cfg, x, pos)
        want = ref_mod.mla(flat, "a.", x, m)
        _close(got, want)
        # without YaRN: plain RoPE frequencies at 1/sqrt(16)
        m1 = dict(m, yarn_factor=1.0)
        _close(attn_mod.attend_train(p, port_config(m1), x, pos),
               ref_mod.mla(flat, "a.", x, m1))
    assert got.shape == (2, 32, m["d_model"])


def test_yarn_at_the_published_numbers():
    """At rope width 64, theta 50,000, original 4,096 and beta 1 and 1
    the correction range is frequencies 19 to 20: 0-19 keep
    theta^(-2i/64), 20-31 are divided by 32; the softmax scale is
    192^-1/2 x (0.1 ln 32 + 1)^2."""
    m = CONFIG["model"]
    cfg = port_config(m)
    assert blocks.yarn_range(64, 50000.0, 4096, 1.0, 1.0) == (19, 20)
    assert ref_mod.yarn_correction_range(m) == (19, 20)
    base = blocks.rope_freqs(64, 50000.0)
    got = blocks.yarn_freqs(64, 50000.0, cfg.yarn)
    assert torch.equal(got[:20], base[:20])
    _close(got[20:], base[20:] / 32)
    _close(got, ref_mod.inv_freq(m, "cpu"))
    mscale = 0.1 * math.log(32) + 1
    assert abs(mscale - 1.346574) < 1e-6
    assert abs(attn_mod.softmax_scale(cfg) - 0.130861) < 1e-6
    assert abs(ref_mod.softmax_scale(m) - 0.130861) < 1e-6
    assert attn_mod.softmax_scale(dataclasses.replace(cfg,
                                                      yarn_factor=1.0)) == 0.0


def _router(E=8, k=3, **kw):
    m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=4, router="sigmoid",
                  routed_scaling=2.827, **kw)
    return m, {"router": {"w": torch.eye(E)}}


def test_router_chooses_on_the_biased_scores_and_gates_with_the_plain():
    """One row of logits (the router the identity): the top 3 of s + b
    are experts 4, then 1 and 2 tied (to the lower first), where s alone
    would choose 0, 6 and 7; the gates are s of 4, 1, 2 over their sum,
    times 2.827. A tie between the scores alone also goes to the lower
    expert."""
    m, p = _router()
    logits = torch.tensor([[2.0, 0.0, 0.0, -1.0, 0.5, -2.0, 1.5, 1.0]])
    s = torch.sigmoid(logits)[0]
    top = s.max()
    b = top + 0.5 - s  # every expert's s + b at top + 0.5 ...
    b[[1, 2]] += 0.25  # ... but 1 and 2, tied above them ...
    b[4] += 0.5        # ... and 4 above those
    p["correction_bias"] = b
    idx, gates, _ = moe_mod.route(p, m, logits, seq=1)
    assert idx.tolist() == [[4, 1, 2]]
    want = s[[4, 1, 2]] / s[[4, 1, 2]].sum() * 2.827
    _close(gates[0], want)
    p["correction_bias"] = torch.zeros(8)
    ties = torch.tensor([[0.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0]])
    assert moe_mod.route(p, m, ties, seq=1)[0].tolist() == [[1, 2, 3]]


def test_sequence_loss_against_a_hand_count():
    """Two sequences of 3 tokens, 4 experts, top 2, no bias: f_i = E / (k
    S) x the sequence's choices of i, P_i the sequence's mean of s_i /
    sum_j s_j; the loss sum_i f_i P_i, averaged over the two."""
    m, p = _router(E=4, k=2)
    p["correction_bias"] = torch.zeros(4)
    logits = torch.tensor([[3.0, 2.0, 0.0, -1.0],
                           [2.5, -1.0, 1.0, 0.0],
                           [0.0, 1.0, 2.0, -2.0],
                           [-1.0, 0.0, 1.0, 2.0],
                           [0.0, -2.0, 1.5, 1.0],
                           [1.0, 2.0, 0.0, 3.0]])
    idx, _, aux = moe_mod.route(p, m, logits, seq=3)
    assert idx.tolist() == [[0, 1], [0, 2], [2, 1], [3, 2], [2, 3], [3, 1]]
    # choices per expert: sequence 1 (0: 2, 1: 2, 2: 2, 3: 0), sequence 2
    # (0: 0, 1: 1, 2: 2, 3: 3)
    counts = torch.tensor([[2.0, 2, 2, 0], [0.0, 1, 2, 3]])
    s = torch.sigmoid(logits)
    share = (s / s.sum(1, keepdim=True)).reshape(2, 3, 4).mean(1)
    hand = float(((counts * 4 / (2 * 3)) * share).sum(1).mean())
    assert abs(float(aux) - hand) < 1e-6
    assert abs(float(ref_mod.sequence_balance_loss(s, idx, 2, 3, 4, 2))
               - hand) < 1e-6
    with pytest.raises(ValueError, match="whole sequences"):
        moe_mod.route(p, m, logits, seq=4)


def test_the_bias_std_is_the_score_gap_at_the_kth_place():
    """The correction bias's std is the expected gap between the 8th and
    9th largest of 384 sigmoid scores at the seeded start, whose logits
    are N(0, 1): drawn, the mean gap is within 3 % of it."""
    m = CONFIG["model"]["moe"]
    g = torch.Generator().manual_seed(0)
    s = torch.sigmoid(torch.randn(8192, m["num_experts"], generator=g))
    top = s.topk(m["top_k"] + 1, dim=-1)[0]
    gap = float((top[:, -2] - top[:, -1]).mean())
    want = ref_mod.bias_std(m)
    assert abs(want - 0.0053) < 1e-4
    assert abs(gap - want) < 0.03 * want, (gap, want)


def _step(m, cut=1, n=2, remat=True):
    cfg = port_config(m)
    plan = lm.build_plan(cfg, cut)
    tcfg = TrainConfig(model=cfg, cut_layer=cut, compute_dtype="float32",
                       param_dtype="float32", lr=0.01, remat=remat)
    opt = make_optimizer("sgd", 0.01)
    step = alg.make_train_step(plan, tcfg, opt, n)
    flat = weights.make(m, SEED, "cpu", FAM)
    params = alg.split_lm_params(port_params(flat, plan), n)
    toks = _tokens(m, (n, 1, 32), seed=1)
    batch = {"tokens": toks, "labels": toks, "seed": 7}
    return step, params, opt.init(alg.trainable_params(params)), batch


@pytest.mark.parametrize("cut", [1, 2], ids=["server", "client_too"])
def test_the_correction_bias_does_not_move(cut):
    """A step at cut 1 (every MoE layer the server's) and at cut 2 (layer
    1's under the clients' vmap): every bias leaf comes back bit for bit,
    every other leaf moves."""
    step, params, state, batch = _step(tiny(), cut)
    new, _, _ = step(params, state, batch)
    flat = {}
    for side in ("client", "server"):
        for gi, g in enumerate(params[side]["groups"]):
            for li, lp in enumerate(g):
                for si, sub in enumerate(lp):
                    flat[(side, gi, li, si)] = (
                        sub, new[side]["groups"][gi][li][si])
    biases = 0
    for old, upd in flat.values():
        if "moe" in old:
            assert torch.equal(upd["moe"]["correction_bias"],
                               old["moe"]["correction_bias"])
            assert not torch.equal(upd["moe"]["router"]["w"],
                                   old["moe"]["router"]["w"])
            biases += 1
    assert biases == 4


def test_expert_shares_add_up_to_the_uncut_layer():
    """Experts 0-15 held by four shares of 4 (offsets 0, 4, 8, 12): with
    capacity 1.0 some pairs are dropped; each share routes over all 16
    with the whole count's capacity, so the shares' outputs, less the
    shared expert each adds, sum to the uncut reference layer's output,
    and every share's balance loss is the uncut layer's."""
    m = tiny(moe=dict(experts_held=0, capacity_factor=1.0))
    flat = weights.make(dict(m, num_layers=2), SEED, "cpu", FAM)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 32, m["d_model"], generator=gen)
    with torch.no_grad():
        want, want_aux = ref_mod.moe(flat, "layer1.moe.", x, m)
        p = _nest(flat)["layer1"]["moe"]
        cfg = port_config(m)
        C = moe_mod._capacity(cfg.moe, 64)
        keep = moe_mod._dispatch(p, cfg.moe, x.reshape(64, -1), C, 32)[3]
        assert 0 < int(keep.sum()) < keep.numel()  # drops
        total = -3 * moe_mod.mlp(p["shared"], x, "swiglu")
        for off in (0, 4, 8, 12):
            share = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, experts_held=4, expert_offset=off))
            ps = dict(p, **{k: p[k][off:off + 4]
                            for k in ("w_gate", "w_up", "w_down")})
            y, aux = moe_mod.moe_apply(ps, share, x)
            _close(aux, want_aux)
            total = total + y
    _close(total, want)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_step_opens_the_mla_spans(remat):
    """A step at cut 1 opens ``mla`` and, inside it, ``mla_scores`` once a
    layer a forward (the client's layer under vmap too), again in remat's
    recompute; the server's 4 MoE forwards count their rows."""
    m = tiny()
    step, params, state, batch = _step(m, remat=remat)
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        step(params, state, batch)
    rec.close()
    spans = [e["name"] for e in rec.events if e["kind"] == "span"]
    forwards = m["num_layers"] * (2 if remat else 1)
    assert spans.count("mla") == forwards
    assert spans.count("mla_scores") == forwards
    counts = [e for e in rec.events if e["kind"] == "summary"][0]["counters"]
    C = math.ceil(4 * 64 * 1.25 / 16)
    assert counts["moe_expert_rows"] == 4 * C * 4 * (2 if remat else 1)


def test_split_counts_match_the_tree_and_the_benchmark():
    """``core.split``'s counts (phi(v), the model-sync and migration
    bits) are the elements of ``init_lm``'s tree, MLA's leaves and the
    bias included (the final norm aside); at the published widths the
    MLA layer is 101.1 M, and its FLOPs are the benchmark's count."""
    cfg = port_config(tiny())
    plan = lm.build_plan(cfg, 1)
    params = lm.init_lm(0, plan, device="cpu")
    # less the final norm, which the counts leave out for every model
    assert split.total_param_numel(plan) == sum(
        int(t.numel()) for t in tree_leaves(params)) - cfg.d_model
    full = port_config(CONFIG["model"])
    assert round(attn_mod.mla_param_numel(full) / 1e5) == 1011
    # the split's FLOPs a token, the head's added, are the benchmark's
    # frozen count at the cell's sequence
    m = CONFIG["model"]
    want = spec.counts(CONFIG["name"]).forward_flops_per_token(m, 1024)
    got = sum(split.flops_per_token_per_layer(full, 1024)) \
        + 2 * m["d_model"] * m["vocab_size"]
    assert got == want


def test_reference_imports_no_jax_and_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import reference.kimi_k2; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}); "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_on_the_card_as_on_the_cpu(cuda):
    """A tiny configuration's SFL-GA step (4 clients, cut 1, remat) on
    the card against the CPU."""
    step, params, state, batch = _step(tiny(), n=4)
    p_cpu, _, m_cpu = step(params, state, batch)
    move = lambda t: t.to(cuda)  # noqa: E731
    p_dev, _, m_dev = step(tree_map(move, params), tree_map(move, state),
                           dict(batch, tokens=batch["tokens"].to(cuda),
                                labels=batch["labels"].to(cuda)))
    torch.testing.assert_close(m_dev["loss"].cpu(), m_cpu["loss"],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(p_dev), tree_leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
