"""NVIDIA Nemotron 3 Nano on the port, held against the plain PyTorch
reference of its family (``sflbench/reference/nemotron_h.py``, which
imports nothing of the program) at CPU size: the configuration's model
cut to d 32, 4 Mamba-2 heads of 8 in 2 groups of state 16, 4/2
attention heads of 8, 8 experts of 16 (top 2, 4 held) beside a shared
expert of 32, vocab 128, and the pattern ``MEM*E``, with one-sublayer
layers, the per-group gated norm, NoPE attention, relu^2 experts and
the sigmoid router as published.

* the unsplit loss and every leaf's gradient, a dense ``-`` layer too,
  and one SFL-GA step's readings at cut 1 and at cut 2 (the benchmark's
  checked steps);
* the per-group gated norm against a hand computation, the groups of B
  and C shared by consecutive heads, relu^2 against its formula;
* the expert share: the shares' outputs, the shared expert counted
  once, add up to the uncut reference layer;
* the layer pattern's specs and groups, the parameter and FLOP counts,
  the ``mamba``/``ssd`` spans, and the reference's imports;
* on the card (``cuda``), a step against the CPU.

Both sides compute in float32 and sum in different orders (the
reference walks the SSD chunk by chunk, the experts one at a time and
attention one sequence at a time): values of order one agree to a few
1e-7, so 2e-5 holds with margin and catches any wrong term.
"""
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

BENCH = Path(__file__).resolve().parents[1] / "sflbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import reference  # noqa: E402
from harness import check, session, spec, weights  # noqa: E402
from reference import nemotron_h as ref_mod  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import (ModelConfig, MoEConfig,  # noqa: E402
                                      SSMConfig, TrainConfig)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

TOL = 2e-5
CELL = "nemotron3nano-13l.sflga-fp32-s4096-remat"
CONFIG = json.loads((BENCH / "configs" / "nemotron-3-nano-13l.json")
                    .read_text())
FAM = reference.Family(ref_mod)
SEED = 2 ** 31 + 41


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
    _update(m, FAM.tiny["hybrid"])
    return _update(m, json.loads(json.dumps(over)))


def port_config(m: dict) -> ModelConfig:
    return ModelConfig(name=CONFIG["name"], **dict(
        m, moe=MoEConfig(**m["moe"]), ssm=SSMConfig(**m["ssm"])))


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


@pytest.mark.parametrize("pattern", ["MEM*E", "M-E*M"])
def test_loss_and_every_gradient_match_the_reference(pattern):
    """The tiny pattern, and one with a dense relu^2 ``-`` layer."""
    m = tiny(layer_pattern=pattern)
    flat = {k: v.requires_grad_(True)
            for k, v in weights.make(m, SEED, "cpu", FAM).items()}
    # norm scales other than 1, so that a scale in the wrong place shows
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for k, v in flat.items():
            if k.endswith("norm.scale"):
                v.add_(0.2 * torch.randn(v.shape, generator=gen))
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
    assert set(cfg.port_fields_set()) == {
        "position_embedding", "layer_pattern", "moe.experts_held",
        "moe.router", "moe.routed_scaling", "moe.d_ff_shared",
        "ssm.num_heads", "ssm.norm_per_group"}


@pytest.mark.parametrize("cut", [1, 2], ids=["cut1", "cut2"])
def test_split_step_matches_the_reference(cut):
    """The benchmark's checked steps at CPU size: three SFL-GA steps of 4
    clients with remat, at cut 1 (the Mamba-2 layer on the clients) and
    at the cell's cut 2 (a MoE layer under the clients' vmap too),
    losses, first gradients and changes against the reference's."""
    c = spec.cell(CELL)
    cfg = json.loads(json.dumps(c.config))
    cfg["model"] = tiny()
    c = dataclasses.replace(c, config=cfg, traffic=dict(
        c.traffic, seq=32, setup_cuts=[cut] * 3, cut_cycle=[cut]))
    su = session.setup(c, SEED, "cpu")
    ref = session.reference_readings(c, SEED, "cpu")
    nums = check.numbers(su.checked, ref)
    assert nums["loss_gap"] < 1e-6, nums
    assert nums["grad_gap"] < 1e-4, nums
    assert nums["change_gap"] < 1e-4, nums
    assert set(su.checked["grad"]) == set(ref["grad"])
    on_client = {k.split(".")[1] for k in ref["grad"]
                 if k.startswith("client.layer")}
    assert on_client == {f"layer{i}" for i in range(cut)}


def test_gated_norm_per_group_by_hand():
    """Over 2 groups of 16 of a 32-wide inner width: each group's RMS
    over its own 16 channels, times the scale; the whole width's norm
    where ``norm_per_group`` is off."""
    m = tiny()
    cfg = port_config(m)
    gen = torch.Generator().manual_seed(6)
    y, z = (torch.randn(2, 5, 32, generator=gen) for _ in range(2))
    scale = 1 + 0.3 * torch.randn(32, generator=gen)
    h = y * F.silu(z)
    eps = m["norm_eps"]
    hand = torch.cat([g * torch.rsqrt(g.square().mean(-1, keepdim=True)
                                      + eps) for g in h.split(16, -1)], -1)
    got = ssm_mod._gated_norm({"norm": {"scale": scale}}, cfg, y, z)
    _close(got, hand * scale)
    _close(ref_mod.gated_group_norm(y, z, scale, 2, eps), hand * scale)
    whole = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, norm_per_group=False))
    got = ssm_mod._gated_norm({"norm": {"scale": scale}}, whole, y, z)
    _close(got, h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps)
           * scale)
    assert ssm_mod._dims(cfg) == (32, 4, 32 + 2 * 2 * 16)
    with pytest.raises(ValueError, match="per group"):
        dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                         n_groups=3))


def test_groups_of_b_and_c_are_shared_by_consecutive_heads():
    """With 2 groups over 4 heads, heads 0-1 read group 0's B and C and
    heads 2-3 group 1's: the SSD of all 4 heads is the SSD of each half
    on its own group."""
    gen = torch.Generator().manual_seed(7)
    b, S, H, P, G, N = 2, 32, 4, 8, 2, 16
    x = torch.randn(b, S, H, P, generator=gen)
    dt = F.softplus(torch.randn(b, S, H, generator=gen))
    A = -torch.rand(H, generator=gen)
    Bm, Cm = (torch.randn(b, S, G, N, generator=gen) for _ in range(2))
    y, state = ssm_mod.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    for g in range(G):
        h = slice(2 * g, 2 * g + 2)
        yg, sg = ssm_mod.ssd_chunked(x[:, :, h], dt[:, :, h], A[h],
                                     Bm[:, :, g:g + 1], Cm[:, :, g:g + 1],
                                     chunk=16)
        _close(y[:, :, h], yg)
        _close(state[:, h], sg)


def test_relu2_against_the_formula():
    """relu(x up)^2 down, ungated, for the dense MLP, the shared expert
    and the held experts (two products each, no ``w_gate``); the FLOP
    counts take two matrices."""
    m = tiny()
    cfg = port_config(m)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(3, 32, generator=gen)
    p = blocks.init_mlp(gen, 32, 48, "relu2")
    assert set(p) == {"up", "down"}
    want = torch.clamp(x @ p["up"]["w"], min=0) ** 2 @ p["down"]["w"]
    _close(blocks.mlp(p, x, "relu2"), want)
    assert blocks.mlp_flops_per_token(32, 48, "relu2") == 2 * 2 * 32 * 48
    pm = moe_mod.init_moe(gen, cfg)
    assert set(pm) == {"router", "w_up", "w_down", "shared",
                       "correction_bias"}
    assert set(pm["shared"]) == {"up", "down"}
    mo = cfg.moe
    assert moe_mod.moe_flops_per_token(cfg) == \
        2 * 2 * 32 * 16 * 2 * 4 // 8 + 2 * 32 * 8 + 2 * 2 * 32 * 32
    # every token to expert 0 of the held 4, C large enough to keep all
    one = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, top_k=1, capacity_factor=8.0, num_shared_experts=0))
    pm["router"]["w"] = torch.zeros(32, 8)
    pm["correction_bias"] = torch.tensor([1.0] + [0.0] * 7)
    with torch.no_grad():
        y, _ = moe_mod.moe_apply(pm, one, x[None])
    want = torch.relu(x @ pm["w_up"][0]).square() @ pm["w_down"][0]
    _close(y[0], want * mo.routed_scaling)


def test_expert_shares_add_up_to_the_uncut_layer():
    """Experts 0-7 held by two shares of 4 (offsets 0 and 4): with
    capacity 1.0 some pairs are dropped; each share routes over all 8
    with the whole count's capacity, so the shares' outputs, less the
    shared expert each adds, sum to the uncut reference layer's output,
    and every share's balance loss is the uncut layer's."""
    m = tiny(moe=dict(experts_held=0, capacity_factor=1.0))
    flat = weights.make(m, SEED, "cpu", FAM)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 32, m["d_model"], generator=gen)
    with torch.no_grad():
        want, want_aux = ref_mod.moe(flat, "layer1.moe.", x, m)
        p = _nest(flat)["layer1"]["moe"]
        cfg = port_config(m)
        C = moe_mod._capacity(cfg.moe, 64)
        keep = moe_mod._dispatch(p, cfg.moe, x.reshape(64, -1), C, 32)[3]
        assert 0 < int(keep.sum()) < keep.numel()  # drops
        total = -moe_mod.mlp(p["shared"], x, "relu2")
        for off in (0, 4):
            share = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, experts_held=4, expert_offset=off))
            ps = dict(p, **{k: p[k][off:off + 4] for k in ("w_up", "w_down")})
            y, aux = moe_mod.moe_apply(ps, share, x)
            _close(aux, want_aux)
            total = total + y
    _close(total, want)


def test_layer_pattern_makes_one_sublayer_layers():
    """Each character one (mixer, ffn); a mixer-less layer has one norm,
    ``norm2``; the cell's cut 2 gives the clients one group of the pair
    (M, E) and the server a group a layer; the published 52-layer
    pattern runs through ``group_specs``' fallback."""
    cfg = port_config(CONFIG["model"])
    specs = tf.layer_specs(cfg)
    assert specs[:6] == [("ssm", "none"), ("none", "moe"), ("ssm", "none"),
                         ("none", "moe"), ("ssm", "none"), ("attn", "none")]
    assert [cfg.is_attn_layer(i) for i in range(13)] == \
        [c == "*" for c in "MEMEM*EMEMEM*"]
    assert [cfg.is_moe_layer(i) for i in range(13)] == \
        [c == "E" for c in "MEMEM*EMEMEM*"]
    plan = lm.build_plan(cfg, 2)
    assert plan.client_groups == (tf.LayerGroup(1, (specs[0], specs[1])),)
    assert sum(g.repeat * len(g.period) for g in plan.server_groups) == 11
    full = dataclasses.replace(cfg, num_layers=52,
                               layer_pattern=CONFIG["hybrid_override_pattern"])
    fs = tf.layer_specs(full)
    assert tf.group_specs(fs) == [tf.LayerGroup(1, (s,)) for s in fs]
    small = port_config(tiny(layer_pattern="M-E*M"))
    p = tf.init_groups(torch.Generator().manual_seed(0), small,
                       [tf.LayerGroup(1, (s,)) for s in
                        tf.layer_specs(small)], torch.float32, "cpu")
    assert [sorted(g[0][0]) for g in p] == [
        ["norm1", "ssm"], ["mlp", "norm2"], ["moe", "norm2"],
        ["attn", "norm1"], ["norm1", "ssm"]]
    with pytest.raises(ValueError, match="layer_pattern"):
        dataclasses.replace(cfg, layer_pattern="MEMX")
    with pytest.raises(ValueError, match="layer_pattern"):
        dataclasses.replace(cfg, layer_pattern="MEM")
    with pytest.raises(ValueError, match="mlp_act"):
        dataclasses.replace(cfg, mlp_act="gelu")


def _step(m, cut=2, n=2, remat=True):
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


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_step_opens_the_mamba_and_ssd_spans(remat):
    """A step at cut 2 opens ``mamba`` and, inside it, ``ssd`` once a
    Mamba-2 layer a forward (the client's under vmap too), again in
    remat's recompute; the server's 2 MoE forwards count their rows."""
    m = tiny()
    step, params, state, batch = _step(m, remat=remat)
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        step(params, state, batch)
    rec.close()
    spans = [e["name"] for e in rec.events if e["kind"] == "span"]
    forwards = m["layer_pattern"].count("M") * (2 if remat else 1)
    assert spans.count("mamba") == forwards
    assert spans.count("ssd") == forwards
    counts = [e for e in rec.events if e["kind"] == "summary"][0]["counters"]
    C = math.ceil(2 * 64 * 1.25 / 8)
    assert counts["moe_expert_rows"] == 4 * C * (2 if remat else 1)


def test_split_counts_match_the_tree_and_the_benchmark():
    """``core.split``'s counts are the elements of ``init_lm``'s tree,
    the one-norm layers, the per-head widths and the two-matrix experts
    included (the final norm aside); at the published widths the 13
    layers, the embedding and the head are ~1.27 B parameters, and the
    FLOPs a token are the benchmark's count but for the SSD's chunked
    term, which the port's split model prices at 4 d_inner (Q + N) a
    token and the benchmark as its products, C B^T once a group (2 Q N
    G), the scores' values (2 Q d_inner) and the states (4 N d_inner)."""
    cfg = port_config(tiny())
    plan = lm.build_plan(cfg, 2)
    params = lm.init_lm(0, plan, device="cpu")
    assert split.total_param_numel(plan) == sum(
        int(t.numel()) for t in tree_leaves(params)) - cfg.d_model
    full = port_config(CONFIG["model"])
    assert round(split.total_param_numel(lm.build_plan(full, 2)) / 1e7) \
        == 127
    m = CONFIG["model"]
    want = spec.counts(CONFIG["name"]).forward_flops_per_token(m, 4096)
    got = sum(split.flops_per_token_per_layer(full, 4096)) \
        + 2 * m["d_model"] * m["vocab_size"]
    s = m["ssm"]
    Q, N, G = s["chunk_size"], s["state_dim"], s["n_groups"]
    d_inner = s["num_heads"] * s["head_dim"]
    ssd_gap = 4 * d_inner * (Q + N) - (2 * Q * N * G + 2 * Q * d_inner
                                       + 4 * N * d_inner)
    assert got - want == m["layer_pattern"].count("M") * ssd_gap


def test_reference_imports_no_jax_and_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import reference.nemotron_h; "
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
    """A tiny configuration's SFL-GA step (4 clients, cut 2, remat) on
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
