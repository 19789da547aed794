"""M1, the MoE layer's combine (``kernels/moe_combine.py``), and its op
(``kernels/ops.py`` ``moe_combine``) on the CPU.

* The op's plain path is the layer's earlier combine (a zero row
  appended, ``flat[slot]``, the ``einsum`` over the gates times the kept
  mask, group by group) bit for bit: forward, d``ye`` and d``gates``,
  with drops, a held share (held < experts) and two routing groups.
* The autograd op (``ops._Combine``) on the plain path, the rule patched
  to take CPU tensors: one call over every group, with the slots moved
  to the expert-major rows, gives the earlier combine's outputs and
  gradients bit for bit, and so does its ``vmap`` rule over 3 clients.
* The plain versions of the kernel's forward and backward, against the
  definition in float64: each kept row's d``ye`` is the gate times dy
  exactly, every other row exact zeros, a skipped pair's d``gates`` 0.
* The rule (``ops.combine_takes_kernel``) sends CPU tensors, other
  dtypes, rows that are not whole 16-byte words, strided rows, more
  than ``MAX_K`` choices, DTensors (also through ``vmap``) and calls
  under a dispatch mode to the plain path. A CPU tensor that reports
  itself on the card stands in for one (the rule reads no more).
* A train step through the op (the rule patched) gives the earlier
  step's params, optimizer state and metrics bit for bit, with and
  without remat, and calls the kernel's wrapper once a MoE forward (the
  clients' under ``vmap`` and remat's recomputes too); the earlier path
  calls it never.

The kernel itself runs only on the card
(``tests/test_torch_granite_hybrid.py``, ``cuda``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import vmap  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import (MoEConfig, TrainConfig,  # noqa: E402
                                 get_config, reduced_config)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.kernels import moe_combine as M  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _torch_dist import _no_process_group_left  # noqa: E402,F401
from _torch_threads import _one_torch_thread  # noqa: E402,F401


def _randn(*shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


class _Mode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _earlier(ye, slots, gates, keeps):
    """The layer's combine as it was written before M1."""
    n, GC, d = ye.shape
    G = len(slots)
    Cg = GC // G
    ye_g = ye.reshape(n, G, Cg, d)
    zero = torch.zeros((1, d), dtype=ye.dtype, device=ye.device)
    ys = []
    for gi, (slot, gate, keep) in enumerate(zip(slots, gates, keeps)):
        Tg, k = slot.shape
        flat = torch.cat([ye_g[:, gi].reshape(n * Cg, d), zero], 0)
        yk = flat[slot.reshape(-1)].reshape(Tg, k, d)
        w = gate.to(ye.dtype) * keep.to(ye.dtype)
        ys.append(torch.einsum("tkd,tk->td", yk, w))
    return torch.cat(ys, 0)


# (id, experts, top_k, held, offset, groups, tokens, d, capacity factor)
CASES = [
    ("whole-drops", 8, 2, 8, 0, 1, 32, 16, 0.5),
    ("whole", 4, 2, 4, 0, 1, 24, 8, 1.25),
    ("held-share", 8, 3, 3, 2, 1, 40, 12, 1.25),
    ("groups-2", 8, 2, 8, 0, 2, 48, 8, 1.0),
    ("held-share-groups-2", 6, 3, 2, 4, 2, 36, 20, 0.75),
]
IDS = [c[0] for c in CASES]


def _routed(E, k, n, off, G, T, d, cf, seed=0):
    """ye (held, G Cg, d) and each group's (slot, gates, keep) from the
    layer's own router and dispatch."""
    m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=8, capacity_factor=cf,
                  experts_held=n if n < E else 0, expert_offset=off)
    cfg = get_config("qwen3-moe-30b-a3b").with_overrides(
        moe=m, d_model=d, routing_groups=G)
    params = moe.init_moe(torch.Generator().manual_seed(seed), cfg)
    x = _randn(T, d, seed=seed + 1)
    Cg = moe._capacity(m, T // G)
    groups = [moe._dispatch(params, m, xg, Cg)
              for xg in x.reshape(G, T // G, d).unbind(0)]
    ye = _randn(n, G * Cg, d, seed=seed + 2)
    return (ye, [g[1] for g in groups], [g[2] for g in groups],
            [g[3] for g in groups])


def _grads(fn, ye, slots, gates, keeps):
    """fn's output and its gradients in ye and in each group's gates."""
    ye = ye.detach().requires_grad_(True)
    gates = [g.detach().requires_grad_(True) for g in gates]
    out = fn(ye, slots, gates, keeps)
    cot = _randn(*out.shape, seed=9)
    return (out,) + torch.autograd.grad(out, [ye, *gates], cot)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def _spy(monkeypatch, calls):
    """Count the kernel wrapper's forward calls in ``calls``."""
    rows = ops.combine_rows

    def spy(ye, slot, gates):
        calls.append((tuple(ye.shape), tuple(slot.shape)))
        return rows(ye, slot, gates)

    monkeypatch.setattr(ops, "combine_rows", spy)


def _take_cpu(monkeypatch, calls=None):
    """Route CPU float32 combines through the autograd op; count the
    kernel wrapper's forward calls in ``calls``."""
    monkeypatch.setattr(ops, "combine_takes_kernel", lambda ye, gates: (
        ye.dtype == torch.float32))
    if calls is not None:
        _spy(monkeypatch, calls)


# ---------------------------------------------------------------------------
# the op's plain path and the autograd op on the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_path_is_the_earlier_combine(case):
    inputs = _routed(*case[1:])
    launches, passed = M.moe_combine.launches, M.moe_combine.passed
    _equal(_grads(ops.moe_combine, *inputs), _grads(_earlier, *inputs))
    assert (M.moe_combine.launches, M.moe_combine.passed) == (launches,
                                                              passed)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_op_is_the_earlier_combine(monkeypatch, case):
    inputs = _routed(*case[1:])
    calls = []
    _take_cpu(monkeypatch, calls)
    _equal(_grads(ops.moe_combine, *inputs), _grads(_earlier, *inputs))
    # one call over every group, on ye's rows with no copy
    n, GC, d = inputs[0].shape
    T = sum(s.shape[0] for s in inputs[1])
    assert calls == [((n * GC, d), (T, case[2]))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_vmap_rule_over_three_clients(monkeypatch, case):
    """Per-client routings stacked on a client axis, as the train step's
    client forward sees them: the op's ``vmap`` rule (clients folded
    into rows, slots moved by b R) gives the earlier combine's outputs
    and gradients under ``vmap`` bit for bit."""
    per = [_routed(*case[1:], seed=10 * b) for b in range(3)]
    stacked = [torch.stack([p[0] for p in per])] + [
        [torch.stack([p[i][g] for p in per]) for g in range(case[5])]
        for i in (1, 2, 3)]
    want = _grads(vmap(_earlier), *stacked)
    calls = []
    _take_cpu(monkeypatch, calls)
    got = _grads(vmap(ops.moe_combine), *stacked)
    _equal(got, want)
    n, GC, d = per[0][0].shape
    T = sum(s.shape[0] for s in per[0][1])
    assert calls == [((3 * n * GC, d), (3 * T, case[2]))]


# ---------------------------------------------------------------------------
# the kernel's plain versions against the definition
# ---------------------------------------------------------------------------

ONE_GROUP = [c for c in CASES if c[5] == 1]
TWO_GROUPS = [c for c in CASES if c[5] == 2]


@pytest.mark.parametrize("case", ONE_GROUP, ids=[c[0] for c in ONE_GROUP])
def test_plain_versions_keep_the_definition(case):
    ye, (slot,), (gate,), _ = _routed(*case[1:])
    R, d = ye.shape[0] * ye.shape[1], ye.shape[2]
    rows = ye.reshape(R, d)
    dy = _randn(slot.shape[0], d, seed=5)
    y = M.moe_combine(rows, slot, gate)
    dye, dgates = M.moe_combine_grad(dy, rows, slot, gate)
    kept = slot < R
    want = torch.zeros(slot.shape[0], d, dtype=torch.float64)
    for t, j in kept.nonzero().tolist():
        want[t] += gate[t, j].double() * rows[slot[t, j]].double()
    # k products of order one summed in f32
    torch.testing.assert_close(y.double(), want, rtol=0, atol=1e-6)
    owned = torch.zeros(R, dtype=torch.bool)
    for t, j in kept.nonzero().tolist():
        r = slot[t, j]
        owned[r] = True
        assert torch.equal(dye[r], gate[t, j] * dy[t])
        dot = float(dy[t].double() @ rows[r].double())
        assert abs(float(dgates[t, j]) - dot) <= 1e-6 * (1 + abs(dot))
    assert torch.equal(dye[~owned], torch.zeros_like(dye[~owned]))
    assert torch.equal(dgates[~kept], torch.zeros_like(dgates[~kept]))


@pytest.mark.parametrize("case", TWO_GROUPS, ids=[c[0] for c in TWO_GROUPS])
def test_group_rows_hold_each_kept_pair_once(case):
    """Two groups: the rows the op hands the kernel name each kept
    pair's own row of ye, each row at most once, and the slack R for
    every other pair."""
    ye, slots, _, keeps = _routed(*case[1:])
    n, GC, d = ye.shape
    R, Cg = n * GC, GC // len(slots)
    seen = []
    for g, (s, keep) in enumerate(zip(slots, keeps)):
        rows = torch.where(keep, s // Cg * GC + g * Cg + s % Cg, R)
        assert bool((rows[keep] < R).all()) and bool((rows[~keep] == R).all())
        e, p = s[keep] // Cg, s[keep] % Cg
        assert torch.equal(ye.reshape(R, d)[rows[keep]], ye[e, g * Cg + p])
        seen.append(rows[keep])
    seen = torch.cat(seen)
    assert seen.unique().numel() == seen.numel()


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

def _rule_case(n=2, rows=8, d=16, T=6, k=3, dtype=torch.float32,
               gates_dtype=None, strided=False):
    ye = torch.zeros(n, rows, d, dtype=dtype)
    if strided:
        ye = torch.zeros(n, d, rows, dtype=dtype).transpose(-1, -2)
    return ye, torch.zeros(T, k, dtype=gates_dtype or dtype)


RULE = [  # (id, case kwargs, on the card, takes the kernel)
    ("f32", {}, True, True),
    ("f32-granite-server", dict(n=9, rows=712, d=4096, T=4096, k=10), True,
     True),
    ("f32-k-32", dict(k=32), True, True),
    ("bf16", dict(dtype=torch.bfloat16), True, False),
    ("f16", dict(dtype=torch.float16), True, False),
    ("f64", dict(dtype=torch.float64), True, False),
    ("gates-f64", dict(gates_dtype=torch.float64), True, False),
    ("d-not-16-bytes", dict(d=6), True, False),
    ("ye-strided", dict(strided=True), True, False),
    ("k-above-32", dict(k=33), True, False),
    ("cpu", {}, False, False),
]


@pytest.mark.parametrize("kw,card,want", [r[1:] for r in RULE],
                         ids=[r[0] for r in RULE])
def test_rule(kw, card, want):
    ye, gates = _rule_case(**kw)
    if card:
        ye, gates = _card(ye), _card(gates)
    assert ops.combine_takes_kernel(ye, gates) is want


def test_rule_refuses_under_a_dispatch_mode():
    ye, gates = (_card(t) for t in _rule_case())
    assert ops.combine_takes_kernel(ye, gates)
    with _Mode():
        assert not ops.combine_takes_kernel(ye, gates)


def test_rule_refuses_dtensors(monkeypatch, _no_process_group_left):
    """A DTensor on the card (the dry run's layers), directly and as a
    batched view of one under ``vmap``, stays on the plain path."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = DeviceMesh("cpu", [0])
    monkeypatch.setattr(DTensor, "is_cuda", property(lambda self: True),
                        raising=False)
    ye, gates = _rule_case()
    dye = DTensor.from_local(ye, mesh, [Replicate()])
    dgates = DTensor.from_local(gates, mesh, [Replicate()])
    assert dye.is_cuda and not ops.combine_takes_kernel(dye, _card(gates))
    assert not ops.combine_takes_kernel(_card(ye), dgates)
    seen = []

    def rule(t):
        seen.append(ops.combine_takes_kernel(t, _card(gates)))
        return t

    vmap(rule)(DTensor.from_local(ye[None].expand(3, *ye.shape).clone(),
                                  mesh, [Replicate()]))
    assert seen == [False]


# ---------------------------------------------------------------------------
# a train step through the op, and its calls of the kernel's wrapper
# ---------------------------------------------------------------------------

# (id, experts, top_k, held (0: all), groups)
STEP = [("whole", 8, 2, 0, 1), ("held-share", 8, 3, 3, 1),
        ("groups-2", 8, 2, 0, 2)]


def _train(monkeypatch, E, k, held, G, remat, through_op):
    m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=32,
                  capacity_factor=1.0, experts_held=held, expert_offset=1
                  if held else 0)
    cfg = reduced_config(get_config("qwen3-moe-30b-a3b")).with_overrides(
        num_layers=3, d_model=32, vocab_size=128, moe=m, routing_groups=G)
    plan = lm.build_plan(cfg, 1)
    tcfg = TrainConfig(model=cfg, algo="sfl_ga", cut_layer=1,
                       compute_dtype="float32", param_dtype="float32",
                       lr=0.05, remat=remat)
    opt = make_optimizer("sgd", 0.05)
    N = 2
    step = alg.make_train_step(plan, tcfg, opt, N)
    params = alg.split_lm_params(lm.init_lm(0, plan, device="cpu"), N)
    state = opt.init(alg.trainable_params(params))
    rng = np.random.RandomState(0)
    calls = []
    with monkeypatch.context() as mp:
        if through_op:
            _take_cpu(mp, calls)
        else:
            _spy(mp, calls)
        rec = obs.Recorder()
        with obs.use_recorder(rec):
            metrics = []
            for i in range(2):
                toks = torch.from_numpy(rng.randint(0, 128, (N, 1, 32)))
                params, state, out = step(params, state, {
                    "tokens": toks, "labels": toks,
                    "seed": np.uint32(5 + 1000003 * i)})
                metrics.append({key: float(v) for key, v in out.items()})
        rec.close()
    counts = [e for e in rec.events if e["kind"] == "summary"][0]["counters"]
    return params, state, metrics, counts, len(calls)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("E,k,held,G", [s[1:] for s in STEP],
                         ids=[s[0] for s in STEP])
def test_train_step_through_the_op_bit_for_bit(monkeypatch, E, k, held, G,
                                               remat):
    today = _train(monkeypatch, E, k, held, G, remat, False)
    routed = _train(monkeypatch, E, k, held, G, remat, True)
    for a, b in zip(tree_leaves(today[:2]), tree_leaves(routed[:2])):
        assert torch.equal(a, b)
    assert today[2] == routed[2]
    # 2 steps x (1 client MoE layer, its 2 clients folded into one call
    # under vmap, + 2 server MoE layers), each forward again in remat's
    # recompute
    forwards = 2 * (1 + 2) * (2 if remat else 1)
    assert today[4] == 0
    assert routed[4] == forwards
    assert routed[3]["moe_expert_rows"] == today[3]["moe_expert_rows"]
