"""The port's paged KV cache against ``repro.models.paging``.

Writes move given K/V rows, so pools must match the reference bit for
bit: a decode write drops dead slots (the reference by an out-of-range
scatter, the port by writing through the live slots' indices), a prompt
write lands in the slot's pages, and the host-side allocator fails the
same way.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import paging as rpaging  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import lm, paging  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

SLOTS, MAXP, PAGE, HKV, HD = 4, 3, 8, 2, 16


def _state(seed, lengths, live):
    rng = np.random.RandomState(seed)
    P = SLOTS * MAXP
    pk = rng.randn(HKV, P, PAGE, HD).astype(np.float32)
    pv = rng.randn(HKV, P, PAGE, HD).astype(np.float32)
    table = rng.permutation(P).reshape(SLOTS, MAXP).astype(np.int32)
    table[~np.asarray(live)] = 0  # retired rows are zeroed, as the engine does
    return pk, pv, table, np.asarray(lengths, np.int32), np.asarray(live)


def _both(pk, pv, table, lens, live):
    ref = rpaging.PagedKVCache(jnp.asarray(pk), jnp.asarray(pv),
                               jnp.asarray(table), jnp.asarray(lens),
                               jnp.asarray(live))
    port = paging.PagedKVCache(torch.from_numpy(pk.copy()),
                               torch.from_numpy(pv.copy()),
                               **paging.admission_tensors(table, lens, live,
                                                          "cpu"))
    return ref, port


def _equal(port, ref):
    for name in ("pages_k", "pages_v", "page_table", "lengths", "live"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)


@pytest.mark.parametrize("lengths,live", [
    ([3, 0, 8, 23], [True, False, True, True]),   # a dead slot, a boundary
    ([0, 0, 0, 0], [False, False, False, False]),  # all dead
    ([7, 15, 16, 1], [True, True, True, True]),
])
def test_paged_write_drops_dead_slots(lengths, live):
    pk, pv, table, lens, live = _state(0, lengths, live)
    ref, port = _both(pk, pv, table, lens, live)
    rng = np.random.RandomState(1)
    k = rng.randn(SLOTS, 1, HKV, HD).astype(np.float32)
    v = rng.randn(SLOTS, 1, HKV, HD).astype(np.float32)
    rnew = rpaging.paged_write(ref, jnp.asarray(k), jnp.asarray(v))
    new = paging.paged_write(port, torch.from_numpy(k), torch.from_numpy(v))
    _equal(new, rnew)
    # page 0, where a dead slot's zeroed table row points, is untouched
    # unless a live slot owns it
    owners = {int(table[b, lens[b] // PAGE]) for b in range(SLOTS)
              if live[b]}
    if 0 not in owners:
        np.testing.assert_array_equal(new.pages_k[:, 0].numpy(), pk[:, 0])


@pytest.mark.parametrize("S", [1, 8, 13, 24])
def test_write_prompt_round_trips(S):
    pk, pv, table, lens, live = _state(2, [0] * SLOTS, [False] * SLOTS)
    ref, port = _both(pk, pv, table, lens, live)
    ids = np.zeros((MAXP,), np.int32)
    need = paging.pages_for(S, PAGE)
    ids[:need] = [5, 2, 9][:need]
    rng = np.random.RandomState(3)
    k = rng.randn(1, S, HKV, HD).astype(np.float32)
    v = rng.randn(1, S, HKV, HD).astype(np.float32)
    rnew = rpaging.write_prompt(ref, jnp.asarray(ids), jnp.asarray(k),
                                jnp.asarray(v))
    new = paging.write_prompt(port, torch.from_numpy(ids),
                              torch.from_numpy(k), torch.from_numpy(v))
    _equal(new, rnew)
    # read back through a table row holding the slot's pages
    table2 = np.zeros((SLOTS, MAXP), np.int32)
    table2[1] = ids
    lens2 = np.asarray([0, S, 0, 0], np.int32)
    kd, vd, valid = paging.dense_view(dataclasses.replace(
        new, **paging.admission_tensors(table2, lens2, lens2 > 0, "cpu")))
    np.testing.assert_array_equal(kd[1, :S].numpy(), k[0])
    np.testing.assert_array_equal(vd[1, :S].numpy(), v[0])
    assert valid[1].sum() == S and not valid[0].any()
    rkd, rvd, rvalid = rpaging.dense_view(
        rnew._replace(page_table=jnp.asarray(table2),
                      lengths=jnp.asarray(lens2)))
    np.testing.assert_array_equal(kd.numpy(), np.asarray(rkd))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))


def test_allocator_exhaustion_and_double_free_match_reference():
    ref, port = rpaging.PageAllocator(4), paging.PageAllocator(4)
    assert port.alloc(3) == ref.alloc(3)
    for alloc in (ref, port):
        with pytest.raises(MemoryError, match=r"want 2, free 1/4"):
            alloc.alloc(2)
    assert port.alloc(1) == ref.alloc(1)
    for alloc in (ref, port):
        alloc.free([2])
        with pytest.raises(ValueError, match="double free of page 2"):
            alloc.free([2])
        with pytest.raises(ValueError, match="invalid page id 4"):
            alloc.free([4])
    assert port.free_pages == ref.free_pages == 1


def test_pages_for_matches_reference():
    for t in range(0, 40):
        for page in (8, 16):
            assert paging.pages_for(t, page) == rpaging.pages_for(t, page)


def test_group_caches_tables_and_stats_match_reference():
    rcfg = ref_reduced(ref_get_config("granite-8b"))
    cfg = reduced_config(get_config("granite-8b"))
    rplan, plan = rlm.build_plan(rcfg, 1), lm.build_plan(cfg, 1)
    rc = rpaging.init_paged_group_caches(rcfg, rlm.all_groups(rplan), 3, 20,
                                         8, None, jnp.float32)
    c = paging.init_paged_group_caches(cfg, lm.all_groups(plan), 3, 20, 8,
                                       None, torch.float32, "cpu")
    assert paging.paged_cache_stats(c) == rpaging.paged_cache_stats(rc)
    table = np.arange(9, dtype=np.int32).reshape(3, 3)
    lens = np.asarray([5, 0, 17], np.int32)
    live = lens > 0
    rc = rpaging.replace_tables(rc, table, lens, live)
    c = paging.replace_tables(c, table, lens, live)
    assert paging.paged_cache_stats(c) == rpaging.paged_cache_stats(rc)
    first = c[0][0][0]
    np.testing.assert_array_equal(first.live_idx.numpy(), [0, 2])
    assert all(x.page_table is first.page_table
               for gc in c for lc in gc for x in lc)
    with pytest.raises(ValueError, match="page_size"):
        paging.init_paged_cache(cfg, 2, 16, page_size=4)
