"""The port's ``sharded`` client bank at 1, 2 and 4 gloo ranks, held to
its own ``device`` backend -- the port's counterparts of the reference's
sharded-bank tests (``tests/test_bank.py``, ``tests/test_async.py``,
``tests/test_checkpoint_integrity.py``), whose reference side fails
under this jax (the reference's cross-shard gather raises
``ShardingTypeError``), so the oracle is the device bank built in the
same rank.

One spawn per rank count runs every case (``_torch_dist.worker_bank``:
torch is imported once a rank; the ranks meet over a ``FileStore``, no
TCP port): unit round trips (gather with duplicates and a signed zero,
scatter with duplicate indices, broadcast, replace, broadcast_single,
the identity gather, the reductions); ``FedSimulator`` for sfl_ga, psl,
sfl and fl over 3 rounds of K 3 < N 8 with two ``set_cut`` migrations;
the default drift; the async engine; save and resume, the file's bytes
equal to the device run's apart from the meta's ``bank_backend``; and
the reference's ``ValueError`` when N does not divide over the shards.

The gate is bit for bit at every rank count, the reductions included:
they gather the bank in client order and run the device expression
(``core.bank``'s docstring), so no tolerance is needed.

Here, in the test process: the reference's ``load_checkpoint`` reads
the port's sharded file to the port loader's arrays.
"""
import json

import jax
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from _torch_dist import CASES, run_worker  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank count's case results, run once, and its directory."""
    cache = {}

    def get(world):
        if world not in cache:
            tmp = tmp_path_factory.mktemp(f"ranks{world}")
            out = tmp / "result.json"
            run_worker("bank", world, tmp, out)
            cache[world] = (json.loads(out.read_text()), tmp)
        return cache[world]

    return get


@pytest.mark.parametrize("case", [*CASES, "clean"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_case(runs, world, case):
    results, _ = runs(world)
    assert results[case] == "ok"


def _like(path):
    """A numpy tree with the file's structure (the CNN simulator state:
    client and server lists of {"b", "w"} blocks)."""
    with open(path, "rb") as f:
        header = msgpack.Unpacker(f, raw=False).unpack()
    shapes = iter(header["shapes"])

    def blocks(n):
        return [{k: np.zeros(next(shapes), np.float32) for k in ("b", "w")}
                for _ in range(n)]

    n_client = header["meta"]["cut"]
    return {"client": blocks(n_client),
            "server": blocks(len(header["shapes"]) // 2 - n_client)}


@pytest.mark.parametrize("world", WORLDS)
def test_reference_reads_sharded_checkpoint(runs, world):
    _, tmp = runs(world)
    path = str(tmp / f"w{world}_sharded.ckpt")
    like = _like(path)
    ref, meta = jload(path, like)
    assert meta["bank_backend"] == "sharded"
    port, pmeta = load_checkpoint(path, like)
    assert pmeta == meta
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), port))
    assert len(ref_leaves) == len(port_leaves) == 10  # 5 blocks
    for a, b in zip(ref_leaves, port_leaves):
        assert np.asarray(a).tobytes() == b.tobytes()
