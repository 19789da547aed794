"""LoRA and the analytic counts of the split LM: the port against the
reference on the CPU.

* LoRA primitives: a zero-initialised adapter is an exact forward no-op
  (``torch.equal``); ``merge_lora`` on the reference's numpy factors is
  within 1 ulp of the reference's merge; the merged forward equals the
  factored one within 1e-5; the detached scale takes no gradient.
* ``core.split``: phi(v), the adapter counts and the FLOP partitions
  equal the reference's exactly (integer arithmetic) at full and reduced
  widths, and match the real trees leaf for leaf; on mamba2 (no
  attention heads) the reference's parameter and adapter counts raise
  and the port's count the real trees.
* ``synthetic_token_batches`` is the reference's stream bit for bit;
  the traffic and payload copies price exactly as the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.configs.base import PeftSpec as JPeftSpec  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.data.synthetic import \
    synthetic_token_batches as jtokens  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sysmodel import payload as jpayload  # noqa: E402
from repro.sysmodel import traffic as jtraffic  # noqa: E402
from repro_torch.configs import PeftSpec, get_config, reduced_config  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.core.protocol import ProtocolEngine  # noqa: E402
from repro_torch.data import synthetic_token_batches  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.obs import TrafficLedger  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.sysmodel import payload, traffic  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

PEFT = PeftSpec(kind="lora", rank=4, alpha=8.0)
JPEFT = JPeftSpec(kind="lora", rank=4, alpha=8.0)


def _cfgs(arch, preset):
    j, p = jget_config(arch), get_config(arch)
    if preset == "smoke":
        j, p = jreduced(j), reduced_config(p)
    return j, p


def _granite(layers=3):
    return reduced_config(get_config("granite-8b")).with_overrides(
        num_layers=layers, d_model=64, d_ff=128, vocab_size=128)


def _nonzero_b(loras, seed=5):
    rng = np.random.RandomState(seed)
    return tree_map(lambda x: torch.from_numpy(
        (rng.randn(*x.shape) * 0.05).astype(np.float32))
        if x.ndim == 2 and x.shape[0] == PEFT.rank else x, loras)


def _forward(params, plan, toks):
    sm, _ = lm.client_forward(params, plan, toks)
    return lm.server_forward(params, plan, sm)[0]


def test_zero_init_adapter_is_an_exact_noop():
    plan = lm.build_plan(_granite(), 1, peft=PEFT)
    base = lm.init_lm(0, plan, device="cpu")
    loras = lm.init_lm_loras(1, plan, device="cpu")
    assert all(not torch.any(l) for l in tree_leaves(loras)
               if l.ndim == 2 and l.shape[0] == PEFT.rank)
    toks = torch.randint(0, 128, (2, 12), generator=torch.Generator()
                         .manual_seed(0))
    assert torch.equal(_forward(lm.attach_lm_loras(base, loras), plan, toks),
                       _forward(base, plan, toks))


def test_merge_lora_within_one_ulp_of_reference():
    rng = np.random.RandomState(0)
    w = rng.randn(2, 48, 40).astype(np.float32)  # leading layer axis
    a = (rng.randn(2, 48, 8) / 7).astype(np.float32)
    b = (rng.randn(2, 8, 40) * 0.1).astype(np.float32)
    s = np.full((2,), 2.0, np.float32)
    ref = jblocks.merge_lora({"w": jnp.asarray(w)},
                             {"a": jnp.asarray(a), "b": jnp.asarray(b),
                              "s": jnp.asarray(s)})["w"]
    got = blocks.merge_lora({"w": torch.from_numpy(w)},
                            {"a": torch.from_numpy(a),
                             "b": torch.from_numpy(b),
                             "s": torch.from_numpy(s)})["w"]
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(ref), maxulp=1)


def test_merged_forward_matches_factored():
    plan = lm.build_plan(_granite(), 2, peft=PEFT)
    base = lm.init_lm(0, plan, device="cpu")
    loras = _nonzero_b(lm.init_lm_loras(1, plan, device="cpu"))
    toks = torch.randint(0, 128, (2, 12), generator=torch.Generator()
                         .manual_seed(1))
    factored = _forward(lm.attach_lm_loras(base, loras), plan, toks)
    merged = _forward(lm.merge_lm_loras(base, loras), plan, toks)
    assert not torch.equal(factored, _forward(base, plan, toks))
    torch.testing.assert_close(merged, factored, rtol=1e-5, atol=1e-5)


def test_lora_scale_takes_no_gradient():
    x = torch.randn(3, 6)
    lo = blocks.init_lora(torch.Generator().manual_seed(0), 6, 5, 2, 4.0)
    lo = {k: v.clone().requires_grad_(True) for k, v in lo.items()}
    y = blocks.linear({"w": torch.randn(6, 5), "lora": lo}, x)
    ga, gs = torch.autograd.grad(y.sum(), [lo["b"], lo["s"]],
                                 allow_unused=True)
    assert gs is None and ga is not None
    assert float(lo["s"].detach()) == 2.0 and lo["s"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-130m"])
@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_split_counts_match_reference(arch, preset):
    """Per-layer FLOPs and the client/server FLOP split at every cut: the
    reference's integers exactly. phi(v) and the total: granite's equal
    the reference's; on mamba2 the reference raises (it reads the
    attention head_dim of a config with no heads) and the port's phi(v)
    counts the real client tree (a difference kept on purpose)."""
    jcfg, cfg = _cfgs(arch, preset)
    for v in range(1, cfg.num_layers):
        jp, p = jlm.build_plan(jcfg, v), lm.build_plan(cfg, v)
        assert split.split_flops(cfg, v, 256) == jsplit.split_flops(
            jcfg, v, 256)
        if arch == "granite-8b":
            assert split.client_param_numel(p) == \
                jsplit.client_param_numel(jp)
            assert split.total_param_numel(p) == \
                jsplit.total_param_numel(jp)
    if arch == "mamba2-130m":
        with pytest.raises(ZeroDivisionError):
            jsplit.client_param_numel(jlm.build_plan(jcfg, 1))
    if preset == "smoke":
        p = lm.build_plan(cfg, 1)
        params = lm.init_lm(0, p, device="cpu")
        assert sum(l.numel() for l in tree_leaves(
            [params["embed"], params["client"]])) == \
            split.client_param_numel(p)
    assert split.flops_per_token_per_layer(cfg, 512) == \
        jsplit.flops_per_token_per_layer(jcfg, 512)
    assert split.model_flops_train_step(cfg, 1024, 256) == \
        jsplit.model_flops_train_step(jcfg, 1024, 256)
    assert split.model_flops_serve(cfg, 64, 256) == \
        jsplit.model_flops_serve(jcfg, 64, 256)


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-130m"])
@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_adapter_counts_match_reference_and_trees(arch, preset):
    """phi-hat(v) (client adapters) and the server's adapters equal the
    reference's on granite; at the smoke width they count the real
    adapter trees, scale leaves included. On mamba2 the reference refuses
    LoRA (the same head_dim read) and the port counts the in/out
    projections' adapters of its real trees."""
    jcfg, cfg = _cfgs(arch, preset)
    for v in (1, cfg.num_layers - 1):
        jp = jlm.build_plan(jcfg, v, peft=JPEFT)
        p = lm.build_plan(cfg, v, peft=PEFT)
        if arch == "granite-8b":
            assert split.client_adapter_numel(p) == \
                jsplit.client_adapter_numel(jp)
            assert split.server_adapter_numel(p) == \
                jsplit.server_adapter_numel(jp)
        else:
            with pytest.raises(ZeroDivisionError):
                jsplit.client_adapter_numel(jp)
        if preset == "smoke":
            loras = lm.init_lm_loras(0, p, device="cpu")
            assert sum(l.numel() for l in tree_leaves(loras["client"])) == \
                split.client_adapter_numel(p)
            assert sum(l.numel() for l in tree_leaves(loras["server"])) == \
                split.server_adapter_numel(p)


def test_synthetic_token_batches_bit_for_bit():
    ji, pi = jtokens(300, 6, 17, seed=3), synthetic_token_batches(
        300, 6, 17, seed=3)
    for _ in range(3):
        (jt, jl), (pt, pl) = next(ji), next(pi)
        assert pt.dtype == jt.dtype == np.int32
        np.testing.assert_array_equal(pt, jt)
        np.testing.assert_array_equal(pl, jl)


def test_traffic_and_payload_copies_match_reference():
    for old, new, k in ((1000, 250, 4), (250, 1000, 3), (7, 7, 2)):
        assert traffic.adapter_migration_bits(old, new, n_clients=k) == \
            jtraffic.adapter_migration_bits(old, new, n_clients=k)
    kw = dict(n_clients=3, tau=2, smashed_elems=4096, label_bits=512,
              adapter_model_bits=9000, uplink_codec="int8",
              downlink_codec="int4", raw_bits_per_elem=32)
    assert traffic.scheme_traffic_table(("sfl_ga", "sfl", "psl"), **kw) == \
        jtraffic.scheme_traffic_table(("sfl_ga", "sfl", "psl"), **kw)
    assert payload.PAYLOAD_KINDS == jpayload.PAYLOAD_KINDS
    for cat in list(payload.PAYLOAD_KINDS) + ["down_token"]:
        assert payload.kind_for_category(cat) == \
            jpayload.kind_for_category(cat)
    assert payload.lora_adapter_numel(4096, 1024, 8) == \
        jpayload.lora_adapter_numel(4096, 1024, 8) == 8 * 5120 + 1


@pytest.mark.parametrize("adapter_sync", [False, True])
def test_engine_meters_adapter_sync_under_its_own_categories(adapter_sync):
    eng = ProtocolEngine("sfl", adapter_sync=adapter_sync)
    ledger = TrafficLedger()
    eng.attach_ledger(ledger, raw_bits_per_elem=32.0)
    tree = {"groups": [[({"a": torch.zeros(3, 5, 2), "s": torch.zeros(3)},)]]}
    eng.tap_model_sync(tree)
    snap = ledger.snapshot_and_reset()
    up, down = (("up_adapter", "down_adapter") if adapter_sync
                else ("up_model", "down_model"))
    assert snap[up] == snap[down] == 3 * 11 * 32
    assert sum(snap.values()) == 2 * 3 * 11 * 32


def test_trainable_partition_holds_no_base_moments():
    plan = lm.build_plan(_granite(), 1, peft=PEFT)
    split_p = alg.split_lm_lora_params(lm.init_lm(0, plan, device="cpu"),
                                       lm.init_lm_loras(1, plan,
                                                        device="cpu"), 3)
    tr = alg.trainable_params(split_p)
    assert set(tr) == {"client", "server"} and "base" in split_p
    st = make_optimizer("adamw", 1e-3).init(tr)
    assert sum(l.numel() for l in tree_leaves(st["m"])) == \
        sum(l.numel() for l in tree_leaves(tr))
    assert sum(l.numel() for l in tree_leaves(tr["client"])) == \
        3 * split.client_adapter_numel(plan)
    full = alg.split_lm_params(lm.init_lm(0, lm.build_plan(_granite(), 1),
                                          device="cpu"), 3)
    assert alg.trainable_params(full).keys() == full.keys()
