"""G1 (``kernels/gemm.py``) and the model's product op
(``kernels/ops.py`` ``matmul``) on the CPU.

* ``ops.matmul`` on a CPU tensor is ``x @ w`` bit for bit, under
  ``vmap`` too, and counts nothing; with a batch of weights (the MoE
  layer's experts) it is ``torch.bmm`` op for op.
* The routing rule (``ops.takes_kernel``), pinned by dtype, rows,
  widths, layout, device and dispatch modes. A CPU tensor that reports
  itself on the card stands in for one (the rule reads no more).
* The kernel's plain version and layout check (``gemm_ref``,
  ``kernel_ready``).
* The autograd op (``ops._Matmul``) on the plain path: its forward,
  backward and ``vmap`` rule give ``x @ w``'s outputs and gradients bit
  for bit, with per-client (batched) and shared weights, and
  ``torch.bmm``'s with per-client batches of weights; and a train step
  routed through it (the rule patched to take CPU tensors) gives
  today's params, optimizer state and metrics bit for bit, with and
  without remat, with per-client weights, with LoRA on a shared base,
  and with an MoE layer's experts on the kernel's batched forms.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import vmap  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import (PeftSpec, TrainConfig, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.kernels import gemm as G  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
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


# ---------------------------------------------------------------------------
# ops.matmul on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xs,ws", [((5, 3, 8), (8, 12)), ((300, 64), (64, 36)),
                                   ((2, 130, 16), (16, 20)),
                                   ((7, 6), (6, 10))])
def test_matmul_on_cpu_is_x_at_w_bit_for_bit(xs, ws):
    x, w = _randn(*xs, seed=1), _randn(*ws, seed=2)
    launches, passed = G.gemm.launches, G.gemm.passed
    assert torch.equal(ops.matmul(x, w), x @ w)
    xb, wb = _randn(3, *xs, seed=3), _randn(3, *ws, seed=4)
    assert torch.equal(vmap(ops.matmul)(xb, wb),
                       vmap(lambda a, b: a @ b)(xb, wb))
    assert torch.equal(vmap(ops.matmul, in_dims=(0, None))(xb, w),
                       vmap(lambda a, b: a @ b, in_dims=(0, None))(xb, w))
    assert (G.gemm.launches, G.gemm.passed) == (launches, passed)


class _Log(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_matmul_with_a_batch_of_weights_on_cpu_is_bmm_op_for_op():
    """The experts' products on the CPU: ``torch.bmm`` bit for bit and
    op for op, under ``vmap`` with weights per client or shared too, and
    nothing counted."""
    x, w = _randn(4, 130, 8, seed=1), _randn(4, 8, 12, seed=2)
    launches, passed = G.gemm.launches, G.gemm.passed
    with _Log() as got:
        y = ops.matmul(x, w)
    with _Log() as want:
        ref = torch.bmm(x, w)
    assert torch.equal(y, ref) and got.ops == want.ops
    xb, wb = _randn(3, 4, 130, 8, seed=3), _randn(3, 4, 8, 12, seed=4)
    for in_dims, wt in (((0, 0), wb), ((0, None), w)):
        assert torch.equal(vmap(ops.matmul, in_dims=in_dims)(xb, wt),
                           vmap(torch.bmm, in_dims=in_dims)(xb, wt))
    assert (G.gemm.launches, G.gemm.passed) == (launches, passed)


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------

def _rule_case(rows=128, K=64, N=32, dtype=torch.float32, lead=(),
               x_t=False, w_t=False, w_lead=()):
    x = torch.zeros(*lead, rows, K, dtype=dtype)
    if x_t:
        x = torch.zeros(*lead, K, rows, dtype=dtype).transpose(-1, -2)
    w = torch.zeros(*w_lead, N, K, dtype=dtype).transpose(-1, -2) if w_t \
        else torch.zeros(*w_lead, K, N, dtype=dtype)
    return x, w


RULE = [  # (id, case kwargs, on the card, takes the kernel)
    ("f32-one-tile", {}, True, True),
    ("f32-rows-folded", dict(rows=64, lead=(2,)), True, True),
    ("f32-large", dict(rows=4096, K=768, N=3352), True, True),
    ("decode-rows", dict(rows=127), True, False),
    ("decode-rows-folded", dict(rows=40, lead=(3,)), True, False),
    ("bf16", dict(dtype=torch.bfloat16), True, False),
    ("f16", dict(dtype=torch.float16), True, False),
    ("f64", dict(dtype=torch.float64), True, False),
    ("K-not-16-bytes", dict(K=66), True, False),
    ("N-not-16-bytes", dict(N=30), True, False),
    ("x-transposed", dict(x_t=True), True, False),
    ("w-transposed", dict(w_t=True), True, False),
    ("cpu", {}, False, False),
    # a batch of weights (B, K, N) over x (B, M, K): the MoE experts
    ("batched-one-tile-each", dict(lead=(2,), w_lead=(2,)), True, True),
    ("batched-rows-127-each", dict(rows=127, lead=(2,), w_lead=(2,)), True,
     False),
    ("batched-batch-mismatch", dict(lead=(2,), w_lead=(3,)), True, False),
    ("batched-w-transposed", dict(lead=(2,), w_lead=(2,), w_t=True), True,
     False),
    ("batched-cpu", dict(lead=(2,), w_lead=(2,)), False, False),
]


@pytest.mark.parametrize("kw,card,want", [r[1:] for r in RULE],
                         ids=[r[0] for r in RULE])
def test_routing_rule(kw, card, want):
    x, w = _rule_case(**kw)
    if card:
        x, w = _card(x), _card(w)
    assert ops.takes_kernel(x, w) is want


def test_routing_rule_refuses_under_a_dispatch_mode():
    x, w = _rule_case()
    x, w = _card(x), _card(w)
    assert ops.takes_kernel(x, w)
    with _Mode():
        assert not ops.takes_kernel(x, w)


def test_routing_rule_refuses_mismatched_and_batched_weights():
    x, w = _rule_case()
    x, w = _card(x), _card(w)
    assert not ops.takes_kernel(x, _card(torch.zeros(68, 32)))
    assert not ops.takes_kernel(x, _card(torch.zeros(2, 64, 32)))
    assert not ops.takes_kernel(_card(torch.zeros(2, 128, 64)),
                                _card(torch.zeros(2, 68, 32)))


# ---------------------------------------------------------------------------
# the kernel's plain version and layout check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_gemm_plain_forms(batched):
    lead = (2,) if batched else ()
    x, w = _randn(*lead, 9, 8, seed=5), _randn(*lead, 8, 12, seed=6)
    dy = _randn(*lead, 9, 12, seed=7)
    xd, wd, dyd = x.double(), w.double(), dy.double()
    cases = ((G.gemm(x, w, "y"), xd @ wd),
             (G.gemm(dy, w, "dx"), dyd @ wd.transpose(-1, -2)),
             (G.gemm(x, dy, "dw"), xd.transpose(-1, -2) @ dyd))
    for got, want in cases:
        assert got.dtype == torch.float32
        assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(G.gemm(x, w), x @ w)
    with pytest.raises(ValueError):
        G.gemm(x, w, "yt")


def test_kernel_ready_layouts():
    t = torch.zeros(16, 8)
    assert G.kernel_ready(t) and G.kernel_ready(torch.zeros(2, 16, 8))
    assert not G.kernel_ready(t.double())
    assert not G.kernel_ready(t.t())                       # last axis strided
    assert not G.kernel_ready(torch.zeros(16, 6))          # rows of 24 bytes
    assert not G.kernel_ready(torch.zeros(17 * 8).view(-1)[1:129]
                              .view(16, 8))                # base off 16 bytes
    assert not G.kernel_ready(torch.zeros(1, 8).expand(16, 8))  # stride 0
    assert not G.kernel_ready(torch.zeros(8))              # 1-d


# ---------------------------------------------------------------------------
# the autograd op on the plain path
# ---------------------------------------------------------------------------

def _grads(fn, *args):
    leaves = [a.detach().requires_grad_(True) for a in args]
    out = fn(*leaves)
    cot = _randn(*out.shape, seed=9)
    return (out,) + torch.autograd.grad(out, leaves, cot)


@pytest.mark.parametrize("xs,ws", [((3, 5, 8), (8, 12)), ((4, 6, 8),
                                                         (4, 8, 12)),
                                   ((130, 16), (16, 20))])
def test_function_is_x_at_w_bit_for_bit(xs, ws):
    x, w = _randn(*xs, seed=10), _randn(*ws, seed=11)
    got = _grads(ops._Matmul.apply, x, w)
    want = _grads(lambda a, b: a @ b, x, w)
    for g, e in zip(got, want):
        assert torch.equal(g, e)


@pytest.mark.parametrize("in_dims,exact,batch", [
    ((0, 0), True, False), ((0, None), True, False), ((None, 0), False, False),
    ((1, 0), False, False), ((0, 0), True, True), ((0, None), False, True)],
    ids=["per-client", "shared-w", "shared-x", "x-batched-on-axis-1",
         "per-client-batch-of-weights", "shared-batch-of-weights"])
def test_function_vmap_rule(in_dims, exact, batch):
    """The model's layouts (clients on axis 0 of x, weights per client
    or shared) are ``x @ w`` bit for bit, and per-client batches of
    weights (the clients' MoE experts, clients x experts on the kernel's
    batch axis) ``torch.bmm`` bit for bit. Off the model's path, a
    shared x and clients on another axis of x take their gradients in
    another order or layout than autograd's broadcast, and a batch of
    weights shared by the clients takes ``torch.matmul``'s broadcast;
    they agree to f32 rounding."""
    xs = {0: (3, 2, 5, 8), None: (2, 5, 8), 1: (2, 3, 5, 8)}[in_dims[0]]
    ws = (2, 8, 12) if batch else (8, 12)
    if in_dims[1] == 0:
        ws = (3, *ws)
    x, w = _randn(*xs, seed=12), _randn(*ws, seed=13)
    got = _grads(vmap(ops._Matmul.apply, in_dims=in_dims), x, w)
    want = _grads(vmap(torch.bmm if batch else lambda a, b: a @ b,
                       in_dims=in_dims), x, w)
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:], want[1:]):
        assert torch.equal(g, e) if exact else \
            torch.allclose(g, e, rtol=1e-6, atol=1e-5)


N, B, S = 3, 2, 16
SMALL = dict(num_layers=4, d_model=64, d_ff=128, vocab_size=256)


def _train(arch, peft, remat):
    over = SMALL if arch == "granite-8b" else dict(num_layers=3, d_model=64,
                                                    vocab_size=256)
    cfg = reduced_config(get_config(arch)).with_overrides(**over)
    plan = lm.build_plan(cfg, 2, peft=PeftSpec(rank=4, alpha=8.0)
                         if peft else None)
    base = lm.init_lm(0, plan, device="cpu")
    split = (alg.split_lm_lora_params(
        base, lm.init_lm_loras(1, plan, device="cpu"), N) if peft
        else alg.split_lm_params(base, N))
    tcfg = TrainConfig(model=cfg, algo="sfl_ga", cut_layer=2,
                       compute_dtype="float32", param_dtype="float32",
                       lr=0.05, remat=remat, peft="lora" if peft else "none",
                       lora_rank=4, lora_alpha=8.0)
    opt = make_optimizer("sgd", 0.05)
    step = alg.make_train_step(plan, tcfg, opt, N)
    state = opt.init(alg.trainable_params(split))
    rng = np.random.RandomState(0)
    metrics = []
    for i in range(2):
        batch = {"tokens": torch.from_numpy(rng.randint(0, 256, (N, B, S))),
                 "labels": torch.from_numpy(rng.randint(0, 256, (N, B, S))),
                 "seed": np.uint32(11 + 1000003 * i)}
        split, state, m = step(split, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return split, state, metrics


@pytest.mark.parametrize("arch,peft,remat", [
    ("granite-8b", False, False), ("granite-8b", False, True),
    ("granite-8b", True, False), ("granite-8b", True, True),
    ("mamba2-130m", False, False), ("qwen3-moe-30b-a3b", False, False),
    ("qwen3-moe-30b-a3b", False, True)],
    ids=["granite-per-client", "granite-per-client-remat",
         "granite-lora-shared-base", "granite-lora-shared-base-remat",
         "mamba2-per-client", "qwen3-moe-per-client",
         "qwen3-moe-per-client-remat"])
def test_train_step_through_the_op_bit_for_bit(monkeypatch, arch, peft,
                                               remat):
    today = _train(arch, peft, remat)
    calls = []
    gemm = ops.gemm

    def spy(a, b, form="y"):
        calls.append((form, a.dim(), a.shape[0]))
        return gemm(a, b, form)

    monkeypatch.setattr(ops, "takes_kernel", lambda x, w: (
        x.dtype == torch.float32 and (w.dim() == 2 or x.dim() == 3)))
    monkeypatch.setattr(ops, "gemm", spy)
    routed = _train(arch, peft, remat)
    for a, b in zip(tree_leaves(today[:2]), tree_leaves(routed[:2])):
        assert torch.equal(a, b)
    assert today[2] == routed[2]
    # a frozen base takes no dW
    forms = {f for f, _, _ in calls}
    assert forms == ({"y", "dx"} if peft else {"y", "dx", "dw"})
    # per-client weights reach the kernel's batch axis; a shared base
    # folds the clients into M
    assert any(d == 3 for _, d, _ in calls) is not peft
    if arch == "qwen3-moe-30b-a3b":
        # the experts' products in every form: the server's E experts on
        # the batch axis, and the clients' N x E under vmap
        E = reduced_config(get_config(arch)).moe.num_experts
        for batch in (E, N * E):
            assert {f for f, d, b in calls if d == 3 and b == batch} == \
                {"y", "dx", "dw"}
