"""The port's client bank (``repro_torch.core.bank``) held to the
reference's ``tests/test_bank.py``:

* the ``device`` and ``host`` backends are bit-identical over multi-round
  runs of every scheme, with a ``set_cut`` migration and a K < N cohort,
  on the identity cohort, with the rho sampler's duplicate draws, and
  with the prefetch off;
* the host pipeline counts prefetch hits and misses, never serves a stale
  staged slice, and drops one on a broadcast or wholesale scatter;
* multi-chunk ``rho_mean`` and ``merge_anchored`` stay within 1 ulp of
  the float64 result (and equal the reference bank's host reductions),
  and ``drift_streamed`` matches the exact form;
* ``sharded`` builds at one rank in this process (its multi-rank cases
  run in ``test_torch_bank_sharded.py``); the partitions equal the
  reference's.

All on the CPU (the host bank's CUDA streams run in ``test_torch_cuda``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.bank import ClientBank as JClientBank  # noqa: E402
from repro.data import federated as jfed  # noqa: E402
from repro.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.configs.paper_cnn import LIGHT_CONFIG  # noqa: E402
from repro_torch.core.bank import (BANK_BACKENDS, ClientBank,  # noqa: E402
                                   tree_leaves, tree_nbytes)
from repro_torch.core.protocol import ProtocolEngine  # noqa: E402
from repro_torch.core.simulator import FedSimulator, SimConfig  # noqa: E402
from repro_torch.data import federated as fed  # noqa: E402
from _torch_dist import _no_process_group_left  # noqa: E402,F401
from _torch_threads import _one_torch_thread  # noqa: E402,F401

N, K, BATCH = 6, 3, 8


def _rho(n, seed=0):
    r = np.random.RandomState(seed).rand(n).astype(np.float64) + 0.5
    return (r / r.sum()).astype(np.float32)


def _data(k, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(k, 1, BATCH, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, (k, 1, BATCH)))


def _sim(scheme="sfl_ga", cut=2, cohort=K, sampler="uniform",
         bank="device", rho=None, **kw):
    # drift_metric=True: the host default streams Gamma, last ulps apart
    return FedSimulator(
        LIGHT_CONFIG,
        SimConfig(scheme=scheme, cut=cut, n_clients=N, batch=BATCH,
                  cohort=cohort, sampler=sampler, bank=bank,
                  drift_metric=True, **kw),
        rho=rho, seed=0, device="cpu")


def _run(sim, rounds=3, migrate_at=None, new_cut=1):
    out = []
    for r in range(rounds):
        if migrate_at is not None and r == migrate_at:
            sim.set_cut(new_cut)
        out.append(sim.run_round(*_data(sim.n_participants, seed=r)))
    return out


def _assert_state_equal(a, b):
    la, lb = tree_leaves(a.state), tree_leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("scheme", ["sfl_ga", "sfl", "psl", "fl"])
def test_host_bitidentical_with_migration(scheme):
    rho = _rho(N, seed=4)
    cut = 2 if scheme != "fl" else 1
    mig = 1 if scheme != "fl" else None
    ref = _sim(scheme, cut=cut, rho=rho)
    alt = _sim(scheme, cut=cut, rho=rho, bank="host")
    assert _run(ref, migrate_at=mig) == _run(alt, migrate_at=mig)
    _assert_state_equal(ref, alt)
    for a, b in zip(tree_leaves(ref.global_params()),
                    tree_leaves(alt.global_params())):
        assert torch.equal(a, b)
    alt.close()


def test_identity_cohort_parity():
    ref = _sim(cohort=None, sampler="full")
    alt = _sim(cohort=None, sampler="full", bank="host")
    assert _run(ref, migrate_at=2, new_cut=3) == \
        _run(alt, migrate_at=2, new_cut=3)
    _assert_state_equal(ref, alt)
    alt.close()


def test_rho_sampler_duplicate_scatter_parity():
    rho = _rho(N, seed=1)
    ref = _sim(sampler="rho", rho=rho)
    host = _sim(sampler="rho", rho=rho, bank="host")
    dup = any(len(set(ref.cohort_for_round(t)[0].tolist())) < K
              for t in range(4))
    assert dup, "seed produced no duplicate draws; pick another"
    assert _run(ref, rounds=4) == _run(host, rounds=4)
    _assert_state_equal(ref, host)
    host.close()


def test_duplicates_resolve_to_last_occurrence():
    """A cohort [2, 0, 2]: both backends keep the row of the LAST 2."""
    for backend in ("device", "host"):
        bank = ClientBank({"w": np.zeros((4, 2), np.float32)}, n_clients=4,
                          stacked=True, backend=backend, device="cpu")
        upd = {"w": torch.tensor([[1.0, 1.0], [5.0, 5.0], [9.0, 9.0]])}
        bank.scatter([2, 0, 2], upd)
        bank.flush()
        np.testing.assert_array_equal(bank.tree["w"].numpy(),
                                      [[5, 5], [0, 0], [9, 9], [0, 0]])
        bank.close()


def test_prefetch_off_parity():
    on = _sim(bank="host")
    off = _sim(bank="host", bank_prefetch=False)
    assert _run(on, rounds=5) == _run(off, rounds=5)
    _assert_state_equal(on, off)
    assert on.bank.stats()["prefetch_hits"] > 0
    assert off.bank.stats()["prefetch_hits"] == 0
    on.close(), off.close()


def test_pipeline_stress_matches_device():
    """The worker's prefetches and drains interleaved with the round
    thread at a tiny switch interval: 300 rounds of gathers, scatters
    (with duplicates) and prefetches staged before or after the scatter
    by the disjointness rule end where a device bank doing the same
    rounds in order ends -- a lost or reordered write would differ."""
    import sys

    rng = np.random.RandomState(0)
    n = 16
    w0 = rng.randn(n, 8).astype(np.float32)
    host = ClientBank({"w": w0.copy()}, n_clients=n, stacked=True,
                      backend="host", device="cpu")
    dev = ClientBank({"w": w0.copy()}, n_clients=n, stacked=True,
                     backend="device", device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        idx = np.sort(rng.choice(n, 4))
        for t in range(300):
            nxt = np.sort(rng.choice(n, 4))
            got, want = host.gather(idx, t=t), dev.gather(idx, t=t)
            assert torch.equal(got["w"], want["w"])
            early = np.intersect1d(idx, nxt).size == 0
            if early:
                host.prefetch(t + 1, nxt)
            host.scatter(idx, {"w": got["w"] * 0.5 + t})
            dev.scatter(idx, {"w": want["w"] * 0.5 + t})
            if not early:
                host.prefetch(t + 1, nxt)
            idx = nxt
    finally:
        sys.setswitchinterval(old)
    host.flush()
    assert torch.equal(host.tree["w"], dev.tree["w"])
    st = host.stats()  # round 0 had nothing staged
    assert (st["prefetch_hits"], st["prefetch_misses"]) == (299, 1)
    host.close()


def test_collapsed_bank_forces_device():
    sim = _sim("sfl", bank="host")
    assert sim.bank.backend == "device" and not sim.bank.stacked


def test_host_peak_within_two_slices_and_stores_host_tensors():
    sim = _sim(bank="host")
    _run(sim, rounds=5)
    st = sim.bank.stats()
    slice_bytes = st["bank_bytes"] // N * K
    assert 0 < st["device_bytes_peak"] <= 2 * slice_bytes
    assert st["bank_bytes"] == tree_nbytes(sim.state["client"])
    sim.close()


# ------------------------------------------------------- bank unit surface
def _tree(n=5, d=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(n, d).astype(np.float32),
            "b": rng.randn(n).astype(np.float32)}


def _host_bank(n=5, **kw):
    return ClientBank(_tree(n), n_clients=n, stacked=True, backend="host",
                      device="cpu", **kw)


def test_unknown_and_sharded_backends(_no_process_group_left):
    """An unknown backend is refused; ``sharded`` builds over a one-rank
    gloo group (made here, destroyed by the fixture) and its round trip
    equals the device bank's."""
    assert BANK_BACKENDS == ("device", "host", "sharded")
    with pytest.raises(ValueError, match="unknown bank backend"):
        ClientBank(_tree(), n_clients=5, stacked=True, backend="tpu_pod",
                   device="cpu")
    dev = ClientBank(_tree(), n_clients=5, stacked=True, device="cpu")
    sh = ClientBank(_tree(), n_clients=5, stacked=True, backend="sharded",
                    device="cpu")
    assert torch.distributed.get_backend() == "gloo"
    assert type(sh.tree["w"]).__name__ == "DTensor"
    idx = [0, 3, 3]
    for bank in (dev, sh):
        bank.scatter(idx, {k: v * 2.0 for k, v in bank.gather(idx).items()})
    for k in ("w", "b"):
        assert torch.equal(dev.tree[k], sh.tree[k].full_tensor())
    assert sh.stats()["device_bytes"] == dev.stats()["device_bytes"]


def test_gather_scatter_roundtrip_host():
    orig = _tree()
    bank = _host_bank()
    idx = np.asarray([1, 3])
    got = bank.gather(idx, t=0)
    np.testing.assert_array_equal(got["w"].numpy(), orig["w"][idx])
    bank.scatter(idx, {k: v + 1.0 for k, v in got.items()})
    bank.flush()
    np.testing.assert_array_equal(bank.tree["w"][idx].numpy(),
                                  orig["w"][idx] + 1)
    np.testing.assert_array_equal(bank.tree["w"][0].numpy(), orig["w"][0])


def test_prefetch_hit_miss_and_stale():
    bank = _host_bank()
    bank.prefetch(7, [0, 2])
    got = bank.gather([0, 2], t=7)  # consumes the staged slice
    st = bank.stats()
    assert (st["prefetch_hits"], st["prefetch_misses"]) == (1, 0)
    np.testing.assert_array_equal(got["b"].numpy(),
                                  bank.tree["b"][[0, 2]].numpy())
    bank.gather([1, 4], t=8)  # nothing staged: a miss
    assert bank.stats()["prefetch_misses"] == 1
    bank.prefetch(3, [0, 1])
    got = bank.gather([0, 2], t=3)  # another cohort: not served
    assert bank.stats()["prefetch_misses"] == 2
    np.testing.assert_array_equal(got["w"].numpy(),
                                  bank.tree["w"][[0, 2]].numpy())


@pytest.mark.parametrize("how", ["broadcast", "wholesale"])
def test_rewriting_scatter_invalidates_staged_prefetch(how):
    bank = _host_bank()
    bank.prefetch(1, [2, 3])  # disjoint from the scattering cohort
    if how == "broadcast":
        bank.scatter([0, 1], {"w": torch.full((2, 4), 100.0),
                              "b": torch.full((2,), 100.0)}, broadcast=True)
        want = 100
    else:
        bank.scatter(None, {"w": torch.full((5, 4), 7.0),
                            "b": torch.full((5,), 7.0)})
        want = 7
    got = bank.gather([2, 3], t=1)  # must miss, not serve stale rows
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.full((2, 4), want, np.float32))
    st = bank.stats()
    assert (st["prefetch_hits"], st["prefetch_misses"]) == (0, 1)


def test_close_releases_worker_and_stays_usable():
    with _host_bank() as bank:
        upd = {k: v + 1.0 for k, v in bank.gather([0, 2], t=0).items()}
        bank.scatter([0, 2], upd)
    assert bank._pool is None
    before = bank.tree["w"].clone()
    bank.scatter([1], {k: v[:1] * 0 for k, v in bank.gather([1]).items()})
    bank.close()
    assert bank._pool is None and bank.tree["w"][1, 0] == 0.0
    assert torch.equal(bank.tree["w"][0], before[0])


def test_broadcast_single_is_writable_per_row():
    bank = ClientBank([], n_clients=4, stacked=True, backend="host",
                      device="cpu")
    stacked = bank.broadcast_single({"w": torch.ones((3,))})
    stacked["w"][2] = 7.0
    assert stacked["w"][0, 0] == 1.0 and stacked["w"][2, 0] == 7.0


# ------------------------------------------------- multi-chunk numerics
BIG = 16


def _big_tree():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(BIG, 3).astype(np.float32),
            "b": rng.randn(BIG).astype(np.float32)}


def _assert_ulp(ref, got, bound=1.0):
    ref, got = np.asarray(ref), np.asarray(got)
    ulp = np.abs(ref - got) / np.spacing(np.abs(ref))
    assert np.max(ulp) <= bound, f"max ulp {np.max(ulp)}"


def test_multi_chunk_rho_mean_within_one_ulp():
    t = _big_tree()
    bank = ClientBank(t, n_clients=BIG, stacked=True, backend="host",
                      device="cpu", chunk_rows=5)
    assert len(list(bank._chunks())) == 4
    rho = _rho(BIG, seed=3)
    got = bank.rho_mean(rho)
    jref = JClientBank(t, n_clients=BIG, stacked=True, backend="host",
                       chunk_rows=5).rho_mean(rho)
    for k in t:
        want = np.einsum("n...,n->...", t[k].astype(np.float64),
                         rho.astype(np.float64)).astype(np.float32)
        _assert_ulp(want, got[k].numpy())
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jref[k]))


def test_multi_chunk_merge_anchored_within_one_ulp():
    t = _big_tree()
    bank = ClientBank(t, n_clients=BIG, stacked=True, backend="host",
                      device="cpu", chunk_rows=5)
    w = _rho(BIG, seed=4)
    got = bank.merge_anchored(t, w)
    jref = JClientBank(t, n_clients=BIG, stacked=True, backend="host",
                       chunk_rows=5).merge_anchored(t, w)
    for k in t:
        a64 = t[k][0].astype(np.float64)
        want = (a64 + np.einsum("n...,n->...", t[k].astype(np.float64)
                                - a64[None], w.astype(np.float64))
                ).astype(np.float32)
        _assert_ulp(want, got[k].numpy())
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jref[k]))


def test_single_chunk_host_bit_exact_with_device():
    rng = np.random.RandomState(1)
    t = {"w": rng.randn(12, 3).astype(np.float32)}
    rho = _rho(12, seed=2)
    host, dev = [ClientBank({"w": t["w"].copy()}, n_clients=12, stacked=True,
                            backend=b, device="cpu") for b in ("host",
                                                               "device")]
    assert torch.equal(host.rho_mean(rho)["w"], dev.rho_mean(rho)["w"])
    assert torch.equal(host.merge_anchored(host.tree, rho)["w"],
                       dev.merge_anchored(dev.tree, rho)["w"])


def test_drift_streamed_matches_exact_form():
    rng = np.random.RandomState(7)
    blocks = [{"w": rng.randn(9, 4).astype(np.float32),
               "b": rng.randn(9).astype(np.float32)}]
    bank = ClientBank(blocks, n_clients=9, stacked=True, backend="host",
                      device="cpu", chunk_rows=2)
    exact = bank.drift(ProtocolEngine.client_drift)
    assert exact > 0
    np.testing.assert_allclose(bank.drift_streamed(), exact, rtol=1e-5)
    jbank = JClientBank(blocks, n_clients=9, stacked=True, backend="host",
                        chunk_rows=2)
    assert bank.drift_streamed() == jbank.drift_streamed()
    collapsed = ClientBank({"w": np.zeros((3,), np.float32)}, n_clients=4,
                           stacked=False, backend="host", device="cpu")
    assert collapsed.drift_streamed() == 0.0


def test_sim_drift_modes():
    """drift_metric None on the host bank streams Gamma (finite, close to
    the exact device value); False reports NaN."""
    ref = _sim(bank="device")
    auto = FedSimulator(LIGHT_CONFIG, SimConfig(
        scheme="sfl_ga", cut=2, n_clients=N, batch=BATCH, cohort=K,
        sampler="uniform", bank="host"), seed=0, device="cpu")
    off = FedSimulator(LIGHT_CONFIG, SimConfig(
        scheme="sfl_ga", cut=2, n_clients=N, batch=BATCH, cohort=K,
        sampler="uniform", bank="host", drift_metric=False), seed=0,
        device="cpu")
    for r in range(2):
        me = ref.run_round(*_data(K, seed=r))
        ms = auto.run_round(*_data(K, seed=r))
        assert np.isfinite(ms["client_drift"])
        np.testing.assert_allclose(ms["client_drift"], me["client_drift"],
                                   rtol=1e-4)
    assert np.isnan(off.run_round(*_data(K, seed=0))["client_drift"])
    auto.close(), off.close()


def test_round_events_carry_bank_stats():
    from repro_torch import obs

    rec = obs.Recorder()
    with obs.use_recorder(rec):
        sim = _sim(bank="host")
        _run(sim, rounds=2)
    rounds = [e for e in rec.events if e.get("kind") == "round"]
    assert rounds and rounds[-1]["bank"]["backend"] == "host"
    assert rounds[-1]["bank"]["device_bytes_peak"] > 0
    names = {e.get("name") for e in rec.events
             if e.get("kind") in ("counter", "gauge")}
    assert {"bank_prefetch_hit", "bank_gather_wait_s", "bank_prefetch_s",
            "bank_scatter_s"} <= names
    sim.close()


# ------------------------------------------------------------ partitions
def test_partitions_equal_reference():
    labels = np.random.RandomState(0).randint(0, 10, 400)
    for alpha, seed in ((0.5, 0), (0.1, 3)):
        got = fed.dirichlet_partition(labels, 7, alpha, seed)
        want = jfed.dirichlet_partition(labels, 7, alpha, seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for args in ((10, 4), (10, 4, 6), (64, 16)):
        p, q = fed.CyclicPartition(*args), jfed.CyclicPartition(*args)
        assert (len(p), p.part_size) == (len(q), q.part_size)
        for a, b in zip(p, q):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fed.CyclicPartition(10, 4)[-1], [6, 7])
    with pytest.raises(IndexError):
        fed.CyclicPartition(10, 4)[4]
    with pytest.raises(ValueError):
        fed.CyclicPartition(0, 4)
    parts = [np.arange(4), np.arange(4, 40)]
    for args in ((parts, 8), (parts, 8, [1]), (fed.CyclicPartition(100, 10),
                                               16)):
        jargs = (jfed.CyclicPartition(100, 10), 16) \
            if isinstance(args[0], fed.CyclicPartition) else args
        assert fed.replacement_fraction(*args) == \
            jfed.replacement_fraction(*jargs)


def test_cyclic_partition_is_lazy_and_batches():
    p = fed.CyclicPartition(4096, 1_000_000)
    assert len(p) == 1_000_000 and p[999_999].shape == (1,)
    assert fed.replacement_fraction(p, 8) == 1.0
    ds = make_image_dataset("mnist", n=64, seed=0)
    parts = fed.CyclicPartition(64, 16)
    xs, ys = fed.round_batches(ds, parts, 4, 1, np.random.RandomState(0),
                               idx=[0, 7, 15])
    jxs, jys = jfed.round_batches(ds, jfed.CyclicPartition(64, 16), 4, 1,
                                  np.random.RandomState(0), idx=[0, 7, 15])
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
