"""M2, the MoE layer's position-in-expert count (``kernels/moe_count.py``),
and its op (``kernels/ops.py`` ``moe_positions``) on the CPU.

* The plain version is the layer's earlier expression (the (T k, E) int32
  one-hot, ``cumsum`` over dim 0, minus 1, each pair's own column
  gathered) bit for bit, and both keep the definition (each pair's count
  of earlier pairs routed to its expert): random ids, every pair to one
  expert, E 1, no pair, and the granite-4.0-h cell's E 72 / k 10.
* The op's plain path is that expression and counts nothing.
* The rule (``ops.count_takes_kernel``) sends CPU tensors, other dtypes,
  E outside 1 to ``MAX_E``, 2^31 pairs, DTensors (also through ``vmap``)
  and calls under a dispatch mode to the plain path; the op counts a
  refused card tensor in ``moe_positions.passed``. Strided ids (the
  router's top-k columns are a view) go to the kernel flattened into a
  contiguous copy, as the earlier expression flattened them. A CPU
  tensor that reports itself on the card stands in for one (the rule
  reads no more).
* The autograd op's ``vmap`` rule, the rule patched and the plain version
  in the launch's place, folds 3 clients into one call over 3 E experts
  and gives each client its own positions; a fold wider than ``MAX_E``
  stays on the plain version.
* A granite-4.0-h (hybrid) train step through the op (the rule patched)
  gives the earlier step's params and metrics bit for bit, with and
  without remat, and calls the wrapper once a MoE forward: the clients'
  layers under ``vmap`` (one call for both clients) and remat's
  recomputes too.

The kernel itself runs only on the card
(``tests/test_torch_granite_hybrid.py``, ``cuda``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import vmap  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.kernels import moe_count as M  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_granite_hybrid import _step, tiny  # noqa: E402
from _torch_dist import _no_process_group_left  # noqa: E402,F401
from _torch_threads import _one_torch_thread  # noqa: E402,F401


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


def _earlier(idx, E):
    """The layer's count as it was written before M2 (``_dispatch``)."""
    T, k = idx.shape
    flat = idx.reshape(-1)
    hits = (flat[:, None] == torch.arange(E, device=flat.device)).to(
        torch.int32)
    pos = torch.cumsum(hits, dim=0, dtype=torch.int32) - 1
    return torch.gather(pos, 1, flat[:, None]).reshape(T, k)


def _definition(idx):
    """pos[i] = #{j < i : ids[j] == ids[i]}, in a Python loop."""
    seen, out = {}, []
    for e in idx.reshape(-1).tolist():
        out.append(seen.get(e, 0))
        seen[e] = out[-1] + 1
    return torch.tensor(out, dtype=torch.int32).reshape(idx.shape)


def _ids(T, k, E, seed=0, one=None):
    """(T, k) expert ids: k distinct experts a token, as top-k routes, or
    every pair to expert ``one`` (k must then be 1)."""
    if one is not None:
        return torch.full((T, k), one, dtype=torch.int64)
    rng = np.random.RandomState(seed)
    rows = [rng.permutation(E)[:k] for _ in range(T)]
    return torch.from_numpy(np.array(rows, dtype=np.int64).reshape(T, k))


# (id, tokens, top_k, experts, every pair to this expert)
CASES = [
    ("random", 40, 3, 8, None),
    ("one-expert", 50, 1, 8, 5),
    ("E-1", 30, 1, 1, None),
    ("no-pair", 0, 4, 8, None),
    ("granite-4.0-h", 512, 10, 72, None),
]
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("T,k,E,one", [c[1:] for c in CASES], ids=IDS)
def test_plain_version_is_the_earlier_expression(T, k, E, one):
    idx = _ids(T, k, E, one=one)
    got = M.moe_positions_ref(idx, E)
    assert got.dtype == torch.int32 and got.shape == (T, k)
    assert torch.equal(got, _earlier(idx, E))
    assert torch.equal(got, _definition(idx))
    # the wrapper takes the plain version on a CPU tensor, and so does
    # the op, counting nothing
    launches, passed = M.moe_positions.launches, M.moe_positions.passed
    assert torch.equal(M.moe_positions(idx, E), got)
    assert torch.equal(ops.moe_positions(idx, E), got)
    assert (M.moe_positions.launches, M.moe_positions.passed) == (launches,
                                                                  passed)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

RULE = [  # (id, ids, E, on the card, takes the kernel)
    ("int64", lambda: torch.zeros(6, 3, dtype=torch.int64), 8, True, True),
    ("granite-server", lambda: torch.zeros(4096, 10, dtype=torch.int64), 72,
     True, True),
    ("E-max", lambda: torch.zeros(6, 3, dtype=torch.int64), M.MAX_E, True,
     True),
    ("int32", lambda: torch.zeros(6, 3, dtype=torch.int32), 8, True, False),
    ("strided", lambda: torch.zeros(3, 6, dtype=torch.int64).t(), 8, True,
     True),
    ("E-above-max", lambda: torch.zeros(6, 3, dtype=torch.int64),
     M.MAX_E + 1, True, False),
    ("E-0", lambda: torch.zeros(6, 3, dtype=torch.int64), 0, True, False),
    ("pairs-2^31", lambda: torch.empty(2 ** 31, dtype=torch.int64,
                                       device="meta"), 8, True, False),
    ("cpu", lambda: torch.zeros(6, 3, dtype=torch.int64), 8, False, False),
]


@pytest.mark.parametrize("make,E,card,want", [r[1:] for r in RULE],
                         ids=[r[0] for r in RULE])
def test_rule(make, E, card, want):
    ids = make()
    if card:
        ids = _card(ids)
    assert ops.count_takes_kernel(ids, E) is want


def test_op_counts_a_refused_card_tensor_as_passed():
    """An int32 card tensor is refused: the op takes the plain version
    and counts it in ``passed``, launching nothing."""
    idx = _ids(20, 2, 8, seed=3)
    launches, passed = M.moe_positions.launches, M.moe_positions.passed
    got = ops.moe_positions(_card(idx.to(torch.int32)), 8)
    assert torch.equal(got, _earlier(idx, 8))
    assert M.moe_positions.launches == launches
    assert M.moe_positions.passed == passed + 1


def test_rule_refuses_under_a_dispatch_mode():
    ids = _card(torch.zeros(6, 3, dtype=torch.int64))
    assert ops.count_takes_kernel(ids, 8)
    with _Mode():
        assert not ops.count_takes_kernel(ids, 8)


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
    ids = torch.zeros(6, 3, dtype=torch.int64)
    did = DTensor.from_local(ids, mesh, [Replicate()])
    assert did.is_cuda and not ops.count_takes_kernel(did, 8)
    seen = []

    def rule(t):
        seen.append(ops.count_takes_kernel(t, 8))
        return t

    vmap(rule)(DTensor.from_local(ids[None].expand(3, 6, 3).clone(), mesh,
                                  [Replicate()]))
    assert seen == [False]


# ---------------------------------------------------------------------------
# the autograd op and its vmap rule, on the plain version
# ---------------------------------------------------------------------------

def _spy(monkeypatch, calls):
    """Count the kernel wrapper's calls in ``calls``; each hands it
    contiguous ids."""
    count = ops.count_positions

    def spy(ids, E):
        assert ids.is_contiguous()
        calls.append((tuple(ids.shape), E))
        return count(ids, E)

    monkeypatch.setattr(ops, "count_positions", spy)


def _take_cpu(monkeypatch, calls=None):
    """Route CPU int64 counts through the autograd op (the rule's own
    terms, less the card's); count the wrapper's calls in ``calls``."""
    monkeypatch.setattr(ops, "count_takes_kernel", lambda ids, E: (
        ids.dtype == torch.int64 and 1 <= E <= M.MAX_E))
    if calls is not None:
        _spy(monkeypatch, calls)


@pytest.mark.parametrize("T,k,E,one", [c[1:] for c in CASES], ids=IDS)
def test_autograd_op_is_the_earlier_expression(monkeypatch, T, k, E, one):
    idx = _ids(T, k, E, one=one)
    calls = []
    _take_cpu(monkeypatch, calls)
    assert torch.equal(ops.moe_positions(idx, E), _earlier(idx, E))
    assert calls == [((T * k,), E)]


def test_autograd_op_flattens_strided_ids(monkeypatch):
    """The router's top-k ids, a column slice of its sort's order: the
    wrapper gets them flattened into contiguous ids, and the positions
    are the earlier expression's."""
    probs = torch.from_numpy(np.random.RandomState(4).rand(64, 12))
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :3]
    assert not idx.is_contiguous()
    calls = []
    _take_cpu(monkeypatch, calls)
    assert torch.equal(ops.moe_positions(idx, 12), _earlier(idx, 12))
    assert calls == [((64 * 3,), 12)]


@pytest.mark.parametrize("T,k,E", [(40, 3, 8), (64, 10, 72), (30, 1, 1)],
                         ids=["random", "granite-4.0-h", "E-1"])
def test_vmap_rule_folds_three_clients(monkeypatch, T, k, E):
    """Per-client routes stacked on a client axis, as the train step's
    client forward sees them: one call over 3 E experts, and each
    client's positions its own, as the earlier expression's under
    ``vmap`` and client by client."""
    idx = torch.stack([_ids(T, k, E, seed=b) for b in range(3)])
    want = vmap(_earlier, in_dims=(0, None))(idx, E)
    for b in range(3):
        assert torch.equal(want[b], _earlier(idx[b], E))
    calls = []
    _take_cpu(monkeypatch, calls)
    got = vmap(ops.moe_positions, in_dims=(0, None))(idx, E)
    assert torch.equal(got, want)
    assert calls == [((3 * T * k,), 3 * E)]
    # the client axis elsewhere than in front
    calls.clear()
    got = vmap(ops.moe_positions, in_dims=(1, None))(idx.movedim(0, 1), E)
    assert torch.equal(got, want)
    assert calls == [((3 * T * k,), 3 * E)]


def test_vmap_rule_wider_than_max_e_stays_plain(monkeypatch):
    """3 clients of 400 experts fold to 1,200 > ``MAX_E``: the folded
    count is refused and takes the plain version, still right."""
    E = 400
    idx = torch.stack([_ids(50, 4, E, seed=b) for b in range(3)])
    calls = []
    _take_cpu(monkeypatch, calls)
    got = vmap(ops.moe_positions, in_dims=(0, None))(idx, E)
    assert torch.equal(got, vmap(_earlier, in_dims=(0, None))(idx, E))
    assert calls == []


# ---------------------------------------------------------------------------
# a granite-4.0-h train step through the op
# ---------------------------------------------------------------------------

def _train(monkeypatch, remat, through_op):
    """Two steps of the hybrid at CPU size (10 layers, cut 2, 2 clients):
    params, optimizer state, metrics and the wrapper's calls."""
    step, params, state, batch = _step(tiny(), remat)
    calls = []
    with monkeypatch.context() as mp:
        if through_op:
            _take_cpu(mp, calls)
        else:
            _spy(mp, calls)
        metrics = []
        for i in range(2):
            params, state, out = step(params, state,
                                      dict(batch, seed=7 + 1000003 * i))
            metrics.append({key: float(v) for key, v in out.items()})
    return params, state, metrics, calls


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_granite_hybrid_step_through_the_op_bit_for_bit(monkeypatch, remat):
    today = _train(monkeypatch, remat, False)
    routed = _train(monkeypatch, remat, True)
    for a, b in zip(tree_leaves(today[:2]), tree_leaves(routed[:2])):
        assert torch.equal(a, b)
    assert today[2] == routed[2]
    assert today[3] == []
    # 2 steps x (2 client MoE layers, each one call for both clients
    # under vmap, + 8 server MoE layers), each forward again in remat's
    # recompute
    forwards = 2 * (2 + 8) * (2 if remat else 1)
    assert len(routed[3]) == forwards
    m = tiny()["moe"]
    E, k = m["num_experts"], m["top_k"]
    # the server's 64 tokens a layer; the clients' 2 x 32 over 2 E
    assert sorted(set(routed[3])) == [((64 * k,), E), ((64 * k,), 2 * E)]
    assert routed[3].count(((64 * k,), 2 * E)) == forwards // 5
