"""The port's mesh layer (``repro_torch.launch.mesh``) and the bank and
batch half of its sharding rules (``repro_torch.launch.shardings``)
held to the reference's.

The production meshes, (16, 16) and (2, 16, 16), are built over a fake
process group of 256 and 512 ranks in a process of their own
(``_torch_dist.worker_mesh``: a default group must not outlive its test
in this worker). Their axis names, shapes, client axes and shard counts,
and every rule's placements read back per tensor dimension, are compared
axis by axis with the reference's ``PartitionSpec`` on a
``jax.sharding.AbstractMesh`` of the same shape (no devices needed).
The one-rank meshes are built here, and the fixture destroys their
group.
"""
import json

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jshard  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from _torch_dist import MESHES, mesh_cases, run_worker  # noqa: E402
from _torch_dist import _no_process_group_left  # noqa: E402,F401
from _torch_threads import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "mesh.json"
    run_worker("mesh", out)
    return json.loads(out.read_text())


def _ref_mesh(tag):
    shape, axes = MESHES[tag]
    return AbstractMesh(shape, axes)


def _norm(spec, ndim):
    """A PartitionSpec as the worker's JSON: one entry per tensor dim."""
    entries = [list(s) if isinstance(s, tuple) else s for s in spec]
    return entries + [None] * (ndim - len(entries))


def _ref_case(mesh, rule, args):
    if rule == "cache_shardings":
        tree = {k: jax.ShapeDtypeStruct(tuple(v), jnp.float32)
                for k, v in args[0].items()}
        return {k: _norm(s.spec, len(args[0][k]))
                for k, s in jshard.cache_shardings(tree, mesh).items()}
    ndim = args[0]
    return _norm(getattr(jshard, rule)(mesh, *args).spec, ndim)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_production_mesh_axes(port, tag):
    mesh = _ref_mesh(tag)
    got = port[tag]
    assert got["axis_names"] == list(mesh.axis_names)
    assert got["shape"] == dict(mesh.shape)
    assert list(got["shape"]) == list(mesh.axis_names)  # mesh order
    assert got["client_axes"] == list(jmesh.client_axes(mesh))
    assert got["n_client_shards"] == jmesh.n_client_shards(mesh)
    assert got["model_axis_size"] == jmesh.model_axis_size(mesh)


@pytest.mark.parametrize("tag,name,rule,args", [
    (tag, name, rule, args) for tag in sorted(MESHES)
    for name, rule, args in mesh_cases(
        16 if tag == "single" else 32)])
def test_sharding_matches_reference(port, tag, name, rule, args):
    assert port[tag][name] == _ref_case(_ref_mesh(tag), rule, args)


def test_worker_imported_no_jax(port):
    assert port["clean"] == "ok"


def test_one_rank_meshes(_no_process_group_left):
    """No group until a mesh needs one; the bank and host meshes make a
    one-rank gloo group for the CPU, with the reference's axis names; a
    production mesh needs a group of its size."""
    dist = torch.distributed
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    bank = tmesh.make_bank_mesh("cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert dist.get_world_size() == 1
    host = tmesh.make_host_mesh("cpu")
    for mesh in (bank, host):
        assert tmesh.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert tmesh.client_axes(mesh) == ("data",)
        assert tmesh.n_client_shards(mesh) == 1
        assert tmesh.model_axis_size(mesh) == 1
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_bank_mesh()
