"""granite-4.0-h-small on the port, held against the plain PyTorch
reference of its family (``sflbench/reference/granite_hybrid.py``, which
imports nothing of the program) at CPU size: the configuration's model
cut to d 32, 4/2 heads of 8, 8 experts of 16 (top 3, 2 held) beside a
shared expert of 32, Mamba-2 heads of 16 and chunk 16, vocab 128, with
every multiplier, the NoPE attention and the period of 10 (attention at
5) as published.

* the unsplit forward's logits and balance loss, and one SFL-GA step's
  loss, gradients and change at cut 2 (the benchmark's checked steps);
* each of the port's new fields alone against the reference;
* the expert share: the shares' outputs, the shared expert counted
  once, add up to the whole layer's, drops included;
* the whole 40-layer pattern through ``group_specs``' fallback;
* the ``moe``/``moe_experts`` spans and the two counters of a step;
* the default configurations' forwards and steps dispatch exactly the
  operations they did before these fields existed (pinned digests of
  the aten op sequence), so their numbers are those of that code bit for
  bit;
* on the card (``cuda``), the sliced layer and a step against the CPU,
  and M1 (the combine's kernel, ``kernels/moe_combine.py``) against its
  plain version at the cell's widths, on the server's tokens and under
  ``vmap`` over the 4 clients, with its counters; M2 (the position
  count's kernel, ``kernels/moe_count.py``) likewise, bit for bit, also
  with every pair to one expert and at E 128 and 256, and its launches
  in a step.

Both sides compute in float32 and sum in different orders (the port's
combine sums a token's k choices at once, the reference expert by
expert): values of order one agree to a few 1e-7, so 2e-5 holds with
margin and catches any wrong term.
"""
import dataclasses
import hashlib
import json
import math
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "sflbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import reference  # noqa: E402
from harness import check, session, spec, weights  # noqa: E402
from reference import granite_hybrid as ref_fam_module  # noqa: E402
from repro_torch import full_f32, obs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import (ModelConfig, MoEConfig,  # noqa: E402
                                      PeftSpec, SSMConfig, TrainConfig)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.blocks import mlp  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

TOL = 2e-5
CELL = "granite4h-small-10l.sflga-fp32-s1024-remat"
CONFIG = json.loads((BENCH / "configs" / "granite-4.0-h-small.json")
                    .read_text())
FAM = reference.Family(ref_fam_module)
SEED = 2 ** 31 + 17
DEFAULTS = dict(position_embedding="rope", attention_multiplier=0.0,
                embedding_multiplier=1.0, residual_multiplier=1.0,
                logits_scaling=1.0,
                moe=dict(d_ff_shared=0, experts_held=0, expert_offset=0))


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
    kw = dict(m, moe=MoEConfig(**m["moe"]), ssm=SSMConfig(**m["ssm"]),
              hybrid_attn_offsets=tuple(m["hybrid_attn_offsets"]))
    return ModelConfig(name=CONFIG["name"], **kw)


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
    """``init_lm``'s tree for ``plan`` from the reference's named leaves."""
    tree = _nest(flat)
    layers = iter([tree.pop(f"layer{i}")
                   for i in range(plan.cfg.num_layers)])
    for side, groups in (("client", plan.client_groups),
                         ("server", plan.server_groups)):
        tree[side] = [[tuple(next(layers) for _ in g.period)
                       for _ in range(g.repeat)] for g in groups]
    return tree


def ref_forward(flat, tokens, m):
    x, aux = FAM.embed(flat, tokens, m), 0.0
    for i in range(m["num_layers"]):
        x, a = FAM.layer(flat, i, x, m)
        aux = aux + a
    return FAM.logits(flat, x, m), aux


def port_forward(flat, tokens, m):
    cfg = port_config(m)
    plan = lm.build_plan(cfg, 0)
    params = port_params(flat, plan)
    x = lm._inputs(params, cfg, tokens)
    return lm.server_forward(params, plan, x, remat=False)


def _tokens(m, shape=(2, 32), seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, m["vocab_size"], shape, generator=g)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def _against_reference(m):
    flat = weights.make(m, SEED, "cpu", FAM)
    toks = _tokens(m)
    with torch.no_grad():
        want, want_aux = ref_forward(flat, toks, m)
        got, got_aux = port_forward(flat, toks, m)
    _close(got, want)
    _close(got_aux, want_aux)
    ce = lm.cross_entropy(got, toks)
    _close(ce, lm.cross_entropy(want, toks))
    return got


def test_logits_and_balance_loss_match_the_reference():
    m = tiny()
    got = _against_reference(m)
    assert got.shape == (2, 32, m["vocab_size"])
    cfg = port_config(m)
    assert cfg.attention_multiplier == 1 / 128 and cfg.moe.held == 2
    assert cfg.moe.shared_width == 32
    assert set(cfg.port_fields_set()) == {
        "position_embedding", "attention_multiplier",
        "embedding_multiplier", "residual_multiplier", "logits_scaling",
        "moe.d_ff_shared", "moe.experts_held"}


def test_split_step_matches_the_reference():
    """The benchmark's checked steps at CPU size: three SFL-GA steps of 4
    clients at cut 2 with remat, losses, first gradients and changes
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
    assert len(su.checked["losses"]) == session.CHECKED


FIELDS = {
    "defaults": {},
    "nope_and_scale": dict(position_embedding="nope",
                           attention_multiplier=0.0078125),
    "residual": dict(residual_multiplier=0.22),
    "embedding_and_logits": dict(embedding_multiplier=12.0,
                                 logits_scaling=16.0),
    "shared_width": dict(moe=dict(d_ff_shared=32)),
    "expert_share": dict(moe=dict(experts_held=2, expert_offset=4)),
}


@pytest.mark.parametrize("case", sorted(FIELDS))
def test_each_field_alone(case):
    """From every new field at its default (RoPE at 1/sqrt(8), no
    multiplier, the shared expert 16 wide, all 8 experts), one field or
    pair set: the port and the reference agree."""
    m = tiny(**DEFAULTS)
    _update(m, json.loads(json.dumps(FIELDS[case])))
    cfg = port_config(m)
    want = set()
    for k, v in FIELDS[case].items():
        want |= {f"moe.{f}" for f in v} if k == "moe" else {k}
    assert set(cfg.port_fields_set()) == want
    _against_reference(m)


def test_expert_shares_add_up_to_the_whole_layer():
    """Experts 0-7 held by four shares of 2 (offsets 0, 2, 4, 6): with
    capacity 1.0 some pairs are dropped; each share routes over all 8
    with the whole count's capacity, so the shares' outputs, less the
    shared expert each adds, sum to the unsliced layer's output, and
    every share's balance loss is the whole layer's."""
    m = tiny(moe=dict(experts_held=0, capacity_factor=1.0))
    cfg = port_config(m)
    gen = torch.Generator().manual_seed(5)
    p = moe_mod.init_moe(gen, cfg)
    x = torch.randn(2, 32, m["d_model"], generator=gen)
    with torch.no_grad():
        whole, aux = moe_mod.moe_apply(p, cfg, x)
        C = moe_mod._capacity(cfg.moe, 64)
        keep = moe_mod._dispatch(p, cfg.moe, x.reshape(64, -1), C)[3]
        assert 0 < int(keep.sum()) < keep.numel()  # drops
        shared = mlp(p["shared"], x, "swiglu")
        total = -3 * shared
        for off in (0, 2, 4, 6):
            share = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, experts_held=2, expert_offset=off))
            ps = dict(p, **{k: p[k][off:off + 2]
                            for k in ("w_gate", "w_up", "w_down")})
            y, a = moe_mod.moe_apply(ps, share, x)
            assert torch.equal(a, aux)
            total = total + y
            # the reference's share, from the same weights
            mr = dict(m, moe=dict(m["moe"], experts_held=2,
                                  expert_offset=off))
            flat = {"l.router.w": p["router"]["w"], "l.w_gate": ps["w_gate"],
                    "l.w_up": ps["w_up"], "l.w_down": ps["w_down"],
                    **{f"l.shared.{k}.w": p["shared"][k]["w"]
                       for k in ("gate", "up", "down")}}
            yr, ar = ref_fam_module.moe(flat, "l.", x, mr)
            _close(y, yr)
            _close(a, ar)
    _close(total, whole)


def test_whole_pattern_runs_through_the_fallback():
    """All 40 layers (attention at 5, 15, 25, 35) group one a layer
    (no period of at most 8 repeats), and run against the reference; at
    the cell's 10 layers and cut 2 the server's 8 form one period."""
    m = tiny(num_layers=40)
    cfg = port_config(m)
    specs = tf.layer_specs(cfg)
    assert [i for i, s in enumerate(specs) if s[0] == "attn"] == \
        [5, 15, 25, 35]
    assert {s[1] for s in specs} == {"moe"}
    assert tf.group_specs(specs) == [tf.LayerGroup(1, (s,)) for s in specs]
    plan = lm.build_plan(cfg, 2)
    assert plan.client_groups == (tf.LayerGroup(2, (("ssm", "moe"),)),)
    assert len(plan.server_groups) == 38
    ten = lm.build_plan(port_config(tiny()), 2)
    assert ten.server_groups == (tf.LayerGroup(1, tuple(specs[2:10])),)
    _against_reference(m)


def _step(m, remat, n=2):
    cfg = port_config(m)
    plan = lm.build_plan(cfg, 2)
    tcfg = TrainConfig(model=cfg, cut_layer=2, compute_dtype="float32",
                       param_dtype="float32", lr=0.01, remat=remat)
    opt = make_optimizer("sgd", 0.01)
    step = alg.make_train_step(plan, tcfg, opt, n)
    flat = weights.make(m, SEED, "cpu", FAM)
    params = alg.split_lm_params(port_params(flat, plan), n)
    toks = _tokens(m, (n, 1, 32), seed=1)
    batch = {"tokens": toks, "labels": toks, "seed": 7}
    return step, params, opt.init(alg.trainable_params(params)), batch


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_step_counts_expert_rows_and_opens_its_spans(remat):
    """Under a recorder that keeps counters, a step opens ``moe`` and
    ``moe_experts`` and counts the server's 8 MoE forwards (twice under
    remat: the backward's recompute): held x C rows each, C over all 8
    experts at the server's 64 tokens, and at most that many kept pairs.
    The Null recorder takes no counter, so the layer makes none."""
    m = tiny()
    step, params, state, batch = _step(m, remat)
    assert not obs.takes_counters()
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        assert obs.takes_counters()
        step(params, state, batch)
    rec.close()
    spans = [e["name"] for e in rec.events if e["kind"] == "span"]
    forwards = 8 * (2 if remat else 1)
    # the clients' layers open the spans under vmap too, and count nothing
    assert spans.count("moe") == forwards + 2 * (2 if remat else 1)
    assert spans.count("moe_experts") == spans.count("moe")
    counts = [e for e in rec.events if e["kind"] == "summary"][0]["counters"]
    mo = m["moe"]
    C = math.ceil(mo["top_k"] * 64 * mo["capacity_factor"]
                  / mo["num_experts"])
    assert counts["moe_expert_rows"] == mo["experts_held"] * C * forwards
    assert 0 < counts["moe_pairs_kept"] <= counts["moe_expert_rows"]


# sha256 of each default configuration's aten op sequence (op, argument
# dtypes and shapes, scalar arguments), recorded before the port had the
# new fields: an equal sequence on equal inputs gives equal bits
OP_DIGESTS = {
    "granite-8b": (792, "d380b6a348aa2f902711d21f516a1b087ecb75990caf"
                        "4245c8508e4974f06cc6"),
    # the SSMs since ``ssd_chunked`` contracts per group (C B^T once a
    # group, B and C never repeated to the heads)
    "mamba2-130m": (834, "ce6e062fa049e0f3e381741d5ac5ebd4512e656319b8"
                         "329c492be8923e60214f"),
    "jamba-v0.1-52b": (1075, "9affbfa81baa73cb9f34d4d6f1eb0af32d1549a420"
                             "b4ebd881cc263121ce7ace"),
    "qwen3-moe-30b-a3b": (1280, "5eced1579b4cca4c6023c87c249243bb99148f"
                                "23fccac8659cf71c386c826ff6"),
    "granite-8b step": (1193, "c59d095aee1648bd0c23f41a00cba7fcb2df71e0"
                              "9ec97d37589764463642b7b1"),
    "jamba-v0.1-52b step": (1787, "4ad696c331cc99528e51aba3705bf6b6af592c"
                                  "f550b8a78cc4de8860d823a165"),
    # the masked softmax alone with v as wide as q.k (GQA, 4/2 heads of
    # 8), recorded before it took v's own width
    "sdpa": (81, "666f7d2076448969a90248e2a4be8e41da48625ddb47bae4263a1230"
                 "cb4475ca"),
}


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat, _ = torch.utils._pytree.tree_flatten((args, kwargs or {}))
        self.log.append(str(func) + repr([
            (str(a.dtype), tuple(a.shape)) if isinstance(a, torch.Tensor)
            else repr(a) for a in flat]))
        return func(*args, **(kwargs or {}))

    def digest(self):
        return (len(self.log),
                hashlib.sha256("\n".join(self.log).encode()).hexdigest())


def _forward_ops(arch):
    cfg = reduced_config(get_config(arch))
    plan = lm.build_plan(cfg, 1)
    params = lm.init_lm(0, plan, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), _Ops() as ops:
        lm.lm_loss(params, plan, toks, toks, remat=False)
        _, caches = lm.prefill(params, plan, toks, max_len=72)
        lm.decode_step(params, plan, toks[:, :1], caches)
    return ops.digest()


def _step_ops(arch):
    cfg = reduced_config(get_config(arch))
    plan = lm.build_plan(cfg, 1)
    tcfg = TrainConfig(model=cfg, cut_layer=1, compute_dtype="float32",
                       param_dtype="float32", lr=0.01, remat=True)
    opt = make_optimizer("sgd", 0.01)
    step = alg.make_train_step(plan, tcfg, opt, 2)
    params = alg.split_lm_params(lm.init_lm(0, plan, device="cpu"), 2)
    state = opt.init(alg.trainable_params(params))
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 64),
                         generator=torch.Generator().manual_seed(0))
    with _Ops() as ops:
        step(params, state, {"tokens": toks, "labels": toks, "seed": 3})
    return ops.digest()


def _sdpa_ops():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 8, generator=gen)
    k = torch.randn(2, 16, 2, 8, generator=gen)
    v = torch.randn(2, 16, 2, 8, generator=gen)
    with torch.no_grad(), _Ops() as ops:
        attn_mod._maybe_chunked_causal(q, k, v, None, 0.0, 0.0)
        attn_mod._sdpa(q, k, v, None, 0.0, 0.25)
    return ops.digest()


@pytest.mark.parametrize("case", sorted(OP_DIGESTS))
def test_defaults_dispatch_the_earlier_operations(case):
    """The default configurations (granite-8b, mamba2-130m and two MoE
    families, reduced) keep their forward (loss, prefill, a decode step)
    and their SFL-GA step op for op: every new field's default adds no
    operation and changes no argument. The masked softmax, where v is as
    wide as q.k, dispatches what it did before it took v's own width."""
    if case == "sdpa":
        assert _sdpa_ops() == OP_DIGESTS[case]
        return
    arch, _, what = case.partition(" ")
    got = _step_ops(arch) if what else _forward_ops(arch)
    assert got == OP_DIGESTS[case]


def test_paths_that_cannot_honour_the_fields_refuse_them():
    m = tiny()
    cfg = port_config(m)
    plan = lm.build_plan(cfg, 2)
    params = port_params(weights.make(m, SEED, "cpu", FAM), plan)
    x = torch.zeros(1, 16, m["d_model"])
    attn = params["server"][0][0][3]["attn"]  # layer 5
    with pytest.raises(ValueError, match="B4"):
        attn_mod.attend_train(attn, cfg, x, None, impl="flash")
    from repro_torch.core.serve_engine import ServeEngine
    with pytest.raises(ValueError, match="does not serve"):
        ServeEngine(params, plan, slots=1, max_len=32, device="cpu")
    from repro_torch.models import paging
    with pytest.raises(ValueError, match="B6"):
        paging.attend_decode_paged(attn, cfg, x[:, :1], None)
    with pytest.raises(ValueError, match="outside"):
        MoEConfig(num_experts=8, top_k=2, d_ff_expert=16, experts_held=4,
                  expert_offset=6)
    with pytest.raises(ValueError, match="position_embedding"):
        dataclasses.replace(cfg, position_embedding="alibi")
    # multi-head latent attention (Kimi K2's): B4, B6, the dense caches,
    # the serve engine and LoRA's wq/wk/wv targets refuse it
    mla = dataclasses.replace(
        get_config("granite-8b"), num_layers=3, d_model=32, num_heads=4,
        num_kv_heads=4, d_ff=64, vocab_size=128, q_lora_rank=16,
        kv_lora_rank=8, qk_nope_head_dim=8, qk_rope_head_dim=4,
        v_head_dim=6)
    assert not mla.attention_is_reference
    plan = lm.build_plan(mla, 1)
    params = lm.init_lm(0, plan, device="cpu")
    attn = params["server"][0][0][0]["attn"]
    assert "q_a" in attn and "wq" not in attn
    x = torch.zeros(1, 16, 32)
    with pytest.raises(ValueError, match="B4"):
        attn_mod.attend_train(attn, mla, x, None, impl="flash")
    with pytest.raises(ValueError, match="does not serve"):
        ServeEngine(params, plan, slots=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="B6"):
        paging.attend_decode_paged(attn, mla, x[:, :1], None)
    with pytest.raises(ValueError, match="latent"):
        lm.prefill(params, plan, torch.zeros(1, 8, dtype=torch.long))
    with pytest.raises(ValueError, match="latent"):
        tf.lora_target_dims(mla, ("attn", "dense"),
                            dataclasses.replace(PeftSpec(), targets=("attn",)))
    with pytest.raises(ValueError, match="MLA"):
        dataclasses.replace(mla, qk_rope_head_dim=3)
    with pytest.raises(ValueError, match="causal self-attention"):
        attn_mod.attend_train(attn, mla, x, None, causal=False)
    with pytest.raises(ValueError, match="attention_multiplier"):
        dataclasses.replace(mla, attention_multiplier=0.125)
    with pytest.raises(ValueError, match="YaRN"):
        dataclasses.replace(get_config("granite-8b"), yarn_factor=4.0)
    with pytest.raises(ValueError, match="beta_fast"):
        dataclasses.replace(mla, yarn_factor=4.0,
                            yarn_original_max_position=4096)
    with pytest.raises(ValueError, match="router"):
        MoEConfig(num_experts=8, top_k=2, d_ff_expert=16, router="relu")
    # one-sublayer layers (Nemotron-H's layer_pattern): the flash forward
    # (B4, B5), prefill, decode, the serve engine and LoRA refuse them,
    # here on RoPE attention that B4 would otherwise take
    pat = dataclasses.replace(
        get_config("granite-8b"), num_layers=3, d_model=32, num_heads=4,
        num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
        layer_pattern="*-*")
    assert pat.attention_is_reference
    assert pat.port_fields_set() == ("layer_pattern",)
    plan = lm.build_plan(pat, 1)
    params = lm.init_lm(0, plan, device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="flash forward"):
        lm.lm_loss(params, plan, toks, toks, impl="flash", remat=False)
    with pytest.raises(ValueError, match="prefill"):
        lm.prefill(params, plan, toks)
    with pytest.raises(ValueError, match="decode"):
        lm.init_caches(plan, 1, 8)
    with pytest.raises(ValueError, match="decode"):
        lm.decode_step(params, plan, toks[:, :1], [])
    with pytest.raises(ValueError, match="does not serve"):
        ServeEngine(params, plan, slots=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="LoRA"):
        tf.lora_target_dims(pat, ("attn", "none"), PeftSpec())
    with pytest.raises(ValueError, match="layer_pattern"):
        dataclasses.replace(pat, layer_pattern="*-")
    # the port's SSM fields: each alone is off its default
    ssm = dataclasses.replace(get_config("mamba2-130m"), ssm=SSMConfig(
        num_heads=8, n_groups=2, norm_per_group=True))
    assert ssm.port_fields_set() == ("ssm.num_heads", "ssm.norm_per_group")
    # a MoE's experts follow mlp_act, which they take as swiglu or relu2
    with pytest.raises(ValueError, match="mlp_act"):
        dataclasses.replace(get_config("qwen3-moe-30b-a3b"), mlp_act="gelu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_on_the_card_as_on_the_cpu(cuda):
    """The sliced layer at the cell's widths (d 4,096, 72 experts of 768,
    top 10, 9 held, shared 1,536) on 1,024 tokens, and a tiny
    configuration's SFL-GA step, on the card against the CPU."""
    m = dict(CONFIG["model"])
    cfg = port_config(m)
    gen = torch.Generator().manual_seed(3)
    p = moe_mod.init_moe(gen, cfg)
    x = torch.randn(1, 1024, m["d_model"], generator=gen)
    move = lambda t: t.to(cuda)  # noqa: E731
    with torch.no_grad(), full_f32():
        y, aux = moe_mod.moe_apply(p, cfg, x)
        on = moe_mod.moe_apply(tree_map(move, p), cfg, x.to(cuda))
    # a near-tie may route one token elsewhere on the card; all but a few
    # rows agree
    rows = (on[0].cpu() - y).abs().amax(-1)[0] <= 1e-4
    assert rows.float().mean() > 0.99
    torch.testing.assert_close(on[1].cpu(), aux, rtol=1e-5, atol=1e-6)

    small = tiny()
    step, params, state, batch = _step(small, remat=True)
    p_cpu, _, m_cpu = step(params, state, batch)
    p_dev, _, m_dev = step(tree_map(move, params), tree_map(move, state),
                           dict(batch, tokens=batch["tokens"].to(cuda),
                                labels=batch["labels"].to(cuda)))
    torch.testing.assert_close(m_dev["loss"].cpu(), m_cpu["loss"],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(p_dev), tree_leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


# M1 at the cell's widths. Tolerances, from f32 rounding (u = 2^-24):
# - y: the kernel adds a token's <= 10 kept rows with fmaf, <= 10
#   roundings of partial sums no larger than S = sum_j |g_j ye_j|, so it
#   lies within 10 u S < 1e-6 S of the float64 sum;
# - dgates: <dy, ye> over 4,096 products is summed along at most 29
#   roundings (16 fmaf in a thread, 5 shuffles, 8 warps), so it lies
#   within 29 u P < 2e-6 P of the float64 dot, P = sum |dy ye|;
# - dye is one product an element, as the plain version's: bit for bit.
COMBINE_Y_TOL, COMBINE_DGATES_TOL = 1e-6, 2e-6


def _cell_routing(cuda, T, seed):
    """The cell's router and dispatch on T tokens on the card: (rows (R,
    d) of a random expert output, slot, gates, keep)."""
    cfg = port_config(dict(CONFIG["model"]))
    m, d = cfg.moe, cfg.d_model
    gen = torch.Generator().manual_seed(seed)
    router = moe_mod.init_linear(gen, d, m.num_experts, False)
    x = torch.randn(T, d, generator=gen).to(cuda)
    Cg = moe_mod._capacity(m, T)
    with torch.no_grad(), full_f32():
        _, slot, gates, keep, _ = moe_mod._dispatch(
            {"router": tree_map(lambda t: t.to(cuda), router)}, m, x, Cg)
    g = torch.Generator(device=cuda).manual_seed(seed)
    rows = torch.randn(m.held * Cg, d, generator=g, device=cuda)
    return rows, slot, gates, keep


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_combine_close(y, rows, slot, gates):
    from repro_torch.kernels import moe_combine as mc

    want = mc.moe_combine_ref(rows.double(), slot, gates.double())
    scale = mc.moe_combine_ref(rows.double().abs(), slot,
                               gates.double().abs())
    assert bool(((y.double() - want).abs()
                 <= COMBINE_Y_TOL * scale + 1e-30).all())


def _assert_grads(dye, dgates, dy, rows, slot, gates):
    from repro_torch.kernels import moe_combine as mc

    ref_dye, _ = mc.moe_combine_grad_ref(dy, rows, slot, gates)
    assert torch.equal(dye, ref_dye)
    R = rows.shape[0]
    kept = slot < R
    t = kept.nonzero()[:, 0]
    own = torch.zeros_like(dye)
    own[slot[kept]] = gates[kept][:, None] * dy[t]
    assert torch.equal(_bits(dye), _bits(own))  # zeros where no pair owns
    pairs = rows[slot.clamp(max=R - 1)].double() * dy[:, None].double()
    want = pairs.sum(-1) * kept
    bound = COMBINE_DGATES_TOL * pairs.abs().sum(-1)
    assert bool(((dgates.double() - want).abs() <= bound).all())
    assert bool((dgates[~kept] == 0).all())


@pytest.mark.cuda
def test_combine_kernel_at_the_cells_widths(cuda):
    """M1 on the server's 4,096 tokens (k 10 of 72 experts, 9 held, C
    712, d 4,096) against its plain version and float64; two launches
    give the same bits."""
    from repro_torch.kernels import moe_combine as mc

    rows, slot, gates, keep = _cell_routing(cuda, 4096, 5)
    assert rows.shape == (9 * 712, CONFIG["model"]["d_model"])
    assert 0 < int(keep.sum()) < keep.numel()
    launches = mc.moe_combine.launches
    y = mc.moe_combine(rows, slot, gates)
    _assert_combine_close(y, rows, slot, gates)
    dy = torch.randn(y.shape, generator=torch.Generator(
        device=cuda).manual_seed(6), device=cuda)
    dye, dgates = mc.moe_combine_grad(dy, rows, slot, gates)
    _assert_grads(dye, dgates, dy, rows, slot, gates)
    again = (mc.moe_combine(rows, slot, gates),
             *mc.moe_combine_grad(dy, rows, slot, gates))
    for a, b in zip((y, dye, dgates), again):
        assert torch.equal(_bits(a), _bits(b))
    assert mc.moe_combine.launches == launches + 6


@pytest.mark.cuda
def test_combine_kernel_under_vmap_over_four_clients(cuda):
    """The clients' layer: 4 clients of 1,024 tokens (C 178) each routed
    on its own, through the op's ``vmap`` rule (one launch a direction
    over the 4 clients' rows) against each client's plain version."""
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import ops

    per = [_cell_routing(cuda, 1024, 10 + b) for b in range(4)]
    n, d = CONFIG["model"]["moe"]["experts_held"], per[0][0].shape[1]
    ye = torch.stack([p[0] for p in per]).reshape(4, n, -1, d)
    slot, gates, keep = (torch.stack([p[i] for p in per]) for i in (1, 2, 3))
    ye.requires_grad_(True)
    gates.requires_grad_(True)
    launches, passed = mc.moe_combine.launches, mc.moe_combine.passed
    y = torch.func.vmap(ops.moe_combine)(ye, [slot], [gates], [keep])
    assert mc.moe_combine.launches == launches + 1
    dy = torch.randn(y.shape, generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda)
    dye, dgates = torch.autograd.grad(y, (ye, gates), dy)
    assert mc.moe_combine.launches == launches + 3
    assert mc.moe_combine.passed == passed
    for b, (rows, s, g, _) in enumerate(per):
        _assert_combine_close(y[b].detach(), rows, s, g)
        _assert_grads(dye[b].reshape(-1, d), dgates[b], dy[b], rows, s, g)


@pytest.mark.cuda
def test_combine_launches_on_the_cells_layer(cuda):
    """The cell's MoE layer at full width: a server forward (4 x 1,024
    tokens) and the clients' forward under ``vmap`` each launch M1 once;
    neither leaves a combine on the plain version."""
    from repro_torch.kernels import moe_combine as mc

    cfg = port_config(dict(CONFIG["model"]))
    gen = torch.Generator().manual_seed(8)
    p = tree_map(lambda t: t.to(cuda), moe_mod.init_moe(gen, cfg))
    x = torch.randn(4, 1024, cfg.d_model, generator=gen).to(cuda)
    launches, passed = mc.moe_combine.launches, mc.moe_combine.passed
    with torch.no_grad(), full_f32():
        moe_mod.moe_apply(p, cfg, x)
        torch.func.vmap(lambda xc: moe_mod.moe_apply(p, cfg, xc)[0])(
            x[:, None])
    assert mc.moe_combine.launches == launches + 2
    assert mc.moe_combine.passed == passed


@pytest.mark.cuda
def test_expert_products_on_g1_at_the_cells_layer(cuda, monkeypatch):
    """The cell's MoE layer at full width: the server's 9 held experts (C
    712, 4 x 1,024 tokens) and the 4 clients' under ``vmap`` with a
    weight each (C 178) take their three products on G1, 3 launches
    forward and 6 backward each (the clients x experts on the kernel's
    batch axis, one launch a product), none left on ``torch.bmm``; the
    layer's output and gradients are ``torch.bmm``'s to f32 rounding."""
    from repro_torch.kernels import gemm as gm
    from repro_torch.kernels import ops

    cfg = port_config(dict(CONFIG["model"]))
    gen = torch.Generator().manual_seed(9)
    p = tree_map(lambda t: t.to(cuda), moe_mod.init_moe(gen, cfg))
    pc = tree_map(lambda t: torch.stack([t] * 4), p)  # a copy a client
    x = torch.randn(4, 1024, cfg.d_model, generator=gen).to(cuda)
    dy = torch.randn(x.shape, generator=torch.Generator(
        device=cuda).manual_seed(10), device=cuda)
    names = ("w_gate", "w_up", "w_down")

    def fresh(tree):  # the experts' weights as leaves
        tree = tree_map(torch.Tensor.detach, tree)
        for k in names:
            tree[k].requires_grad_(True)
        return tree

    def run():
        server, clients = fresh(p), fresh(pc)
        xs, xc = (x.detach().requires_grad_(True) for _ in range(2))
        with full_f32():
            ys = moe_mod.moe_apply(server, cfg, xs)[0]
            yc = torch.func.vmap(
                lambda q, t: moe_mod.moe_apply(q, cfg, t)[0])(
                    clients, xc[:, None])[:, 0]
        leaves = (xs, xc, *(server[k] for k in names),
                  *(clients[k] for k in names))
        return (ys, yc) + torch.autograd.grad((ys, yc), leaves, (dy, dy))

    calls = []
    gemm = ops.gemm

    def spy(a, b, form="y"):
        if a.dim() == 3:
            calls.append((form, a.shape[0]))
        return gemm(a, b, form)

    monkeypatch.setattr(ops, "gemm", spy)
    passed = gm.gemm.passed
    got = run()
    torch.cuda.synchronize()
    assert gm.gemm.passed == passed
    held = cfg.moe.held
    for batch in (held, 4 * held):
        assert sorted(f for f, b in calls if b == batch) == \
            ["dw"] * 3 + ["dx"] * 3 + ["y"] * 3
    rule = ops.takes_kernel
    monkeypatch.setattr(ops, "gemm", gemm)
    monkeypatch.setattr(ops, "takes_kernel",
                        lambda a, w: w.dim() == 2 and rule(a, w))
    want = run()
    assert gm.gemm.passed == passed + 2 * 3
    for g, e in zip(got, want):
        g, e = g.detach().double(), e.detach().double()
        assert float((g - e).norm() / e.norm()) < 1e-5


# M2 at the cell's shapes: integers, so the kernel's positions are the
# plain version's bit for bit, and two launches give the same bits.

def _count_equal(ids, E):
    from repro_torch.kernels import moe_count as mcount

    launches = mcount.moe_positions.launches
    got = mcount.moe_positions(ids, E)
    again = mcount.moe_positions(ids, E)
    assert mcount.moe_positions.launches == launches + 2
    want = mcount.moe_positions_ref(ids, E)
    assert got.dtype == torch.int32 and got.shape == ids.shape
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.cuda
def test_count_kernel_at_the_cells_shapes(cuda):
    """M2 on the server's routes (T 4,096, k 10 of 72 experts, the
    cell's router), every pair to one expert, E 128 and 256 (one block
    of counters each) and a qwen3-moe chunk's 524,288 pairs (a block per
    SM, many rounds a warp), each against its plain version bit for
    bit; it raises on ids it does not take (the router's strided view
    among them: the op flattens it first)."""
    from repro_torch.kernels import moe_count as mcount

    cfg = port_config(dict(CONFIG["model"]))
    m, d = cfg.moe, cfg.d_model
    gen = torch.Generator().manual_seed(21)
    router = moe_mod.init_linear(gen, d, m.num_experts, False)
    x = torch.randn(4096, d, generator=gen).to(cuda)
    with torch.no_grad(), full_f32():
        idx, _, _ = moe_mod.route(
            {"router": tree_map(lambda t: t.to(cuda), router)}, m, x)
    assert idx.shape == (4096, 10)
    _count_equal(idx.reshape(-1), m.num_experts)
    one = torch.full((40960,), 7, dtype=torch.int64, device=cuda)
    _count_equal(one, m.num_experts)
    assert torch.equal(mcount.moe_positions(one, m.num_experts),
                       torch.arange(40960, dtype=torch.int32, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(22)
    for E, shape in ((128, (4096, 8)), (256, (4096, 8)), (72, (1001, 3)),
                     (128, (65536, 8))):
        _count_equal(torch.randint(0, E, shape, generator=g, device=cuda), E)
    with pytest.raises(ValueError, match="int64"):
        mcount.moe_positions(idx.to(torch.int32), m.num_experts)
    with pytest.raises(ValueError, match="contiguous"):
        mcount.moe_positions(idx, m.num_experts)  # the sort's column view
    with pytest.raises(ValueError, match="experts"):
        mcount.moe_positions(idx.reshape(-1), mcount.MAX_E + 1)


@pytest.mark.cuda
def test_count_kernel_under_vmap_over_four_clients(cuda):
    """The clients' layer: 4 clients of 1,024 tokens, each routed on its
    own, through the op's ``vmap`` rule: one launch over 4 x 72 experts,
    each client's positions its plain version's bit for bit."""
    from repro_torch.kernels import moe_count as mcount
    from repro_torch.kernels import ops

    cfg = port_config(dict(CONFIG["model"]))
    m, d = cfg.moe, cfg.d_model
    gen = torch.Generator().manual_seed(23)
    router = {"router": tree_map(lambda t: t.to(cuda), moe_mod.init_linear(
        gen, d, m.num_experts, False))}
    x = torch.randn(4, 1024, d, generator=gen).to(cuda)
    with torch.no_grad(), full_f32():
        idx = torch.stack([moe_mod.route(router, m, x[b])[0]
                           for b in range(4)])
    launches, passed = (mcount.moe_positions.launches,
                        mcount.moe_positions.passed)
    got = torch.func.vmap(ops.moe_positions, in_dims=(0, None))(
        idx, m.num_experts)
    assert mcount.moe_positions.launches == launches + 1
    assert mcount.moe_positions.passed == passed
    for b in range(4):
        assert torch.equal(got[b],
                           mcount.moe_positions_ref(idx[b], m.num_experts))


@pytest.mark.cuda
def test_count_launches_on_a_step(cuda):
    """A granite-4.0-h step with remat at CPU size (the cell's 10 layers,
    cut 2) on the card: M2 launches 20 times, 8 server MoE forwards and 2
    client ones (both clients in one launch) each twice, and leaves no
    count on the plain version; M1 launches 40 times, as before."""
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import moe_count as mcount

    step, params, state, batch = _step(tiny(), remat=True)
    move = lambda t: t.to(cuda)  # noqa: E731
    params, state = tree_map(move, params), tree_map(move, state)
    batch = dict(batch, tokens=batch["tokens"].to(cuda),
                 labels=batch["labels"].to(cuda))
    step(params, state, batch)  # warm-up: builds the kernels
    counts = (mcount.moe_positions.launches, mcount.moe_positions.passed,
              mc.moe_combine.launches, mc.moe_combine.passed)
    step(params, state, batch)
    torch.cuda.synchronize()
    now = (mcount.moe_positions.launches, mcount.moe_positions.passed,
           mc.moe_combine.launches, mc.moe_combine.passed)
    assert [b - a for a, b in zip(counts, now)] == [20, 0, 40, 0]
