"""The port's parameter shardings (``repro_torch.launch.shardings``'
param half) and dry-run cases (``repro_torch.launch.specs``) held to
the reference's.

Every arch of the zoo is built at full widths with its depth cut
(``_torch_dist.spec_overrides``: the rules read widths, and every layer
grouping is kept), on both production meshes, in a process of its own
over fake 256- and 512-rank groups (``_torch_dist.worker_specs``); the
reference's trees are ``jax.eval_shape`` skeletons on a
``jax.sharding.AbstractMesh`` of the same shape. The reference stacks a
layer group's leaves along a ``repeat`` axis and the port keeps one leaf
a layer: each port layer leaf must be its stacked leaf with that axis
removed, in shape and in placement, and each stacked leaf must have
``repeat`` port leaves. ``launch.dryrun`` is never imported here: it
sets ``XLA_FLAGS`` at import.
"""
import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.launch import shardings as jshard  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from _torch_dist import (MESHES, run_worker, spec_combos,  # noqa: E402
                         spec_overrides)
from _torch_threads import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "specs.json"
    run_worker("specs", out)
    return json.loads(out.read_text())


def _mesh(tag):
    shape, axes = MESHES[tag]
    return AbstractMesh(shape, axes)


def _name(k):
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "idx"):
        return f"[{k.idx}]"
    return str(k.name)


def _norm(spec, ndim):
    entries = [list(s) if isinstance(s, tuple) else s for s in spec]
    return entries + [None] * (ndim - len(entries))


def _ref_rows(tree, shardings, prefix=""):
    """{path: (shape, dtype, spec)} of the reference's tensor leaves (a
    cache's ``length`` scalars left out: the port's is a Python int)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(shs)
    out = {}
    for (path, leaf), sh in zip(leaves, shs):
        name = prefix + "/".join(_name(k) for k in path)
        if name.endswith("length"):
            continue
        out[name] = (list(leaf.shape), str(leaf.dtype),
                     _norm(sh.spec, len(leaf.shape)))
    return out


def _check_rows(port_rows, ref):
    """Each port leaf is its reference leaf, or (a layer leaf) the
    reference's stacked leaf without the repeat axis; every stacked leaf
    has ``repeat`` port leaves and every reference leaf a port leaf."""
    seen = collections.Counter()
    for path, repeat, at, shape, dtype, spec in port_rows:
        assert path in ref, path
        rshape, rdtype, rspec = ref[path]
        assert dtype == rdtype, (path, dtype, rdtype)
        if repeat is None:
            assert (shape, spec) == (rshape, rspec), (path, shape, spec,
                                                      rshape, rspec)
        else:
            assert rshape[at] == repeat, (path, rshape, repeat)
            assert shape == rshape[:at] + rshape[at + 1:], (path, shape)
            assert spec == rspec[:at] + rspec[at + 1:], (path, spec, rspec)
        seen[path] += 1
    assert set(seen) == set(ref), sorted(set(ref) ^ set(seen))
    for path, repeat, at, *_ in port_rows:
        assert seen[path] == (1 if repeat is None else repeat), path


def _ref_trees(arch, n):
    cfg = get_config(arch).with_overrides(**spec_overrides(arch))
    cut = jspecs.default_cut(cfg)
    if cfg.arch_type == "audio":
        from repro.models import encdec as jenc

        split = jax.eval_shape(lambda: jspecs._whisper_split_stacked(
            cfg, cut, n, jnp.bfloat16))
        serve = jax.eval_shape(lambda: jenc.init_whisper(
            jax.random.key(0), cfg, jnp.bfloat16))
        return split, serve
    split = jax.eval_shape(lambda: jalg.split_lm_params(jlm.init_lm(
        jax.random.key(0), jlm.build_plan(cfg, cut), jnp.bfloat16), n))
    serve = jax.eval_shape(lambda: jlm.init_lm(
        jax.random.key(0), jlm.build_plan(cfg, 0), jnp.bfloat16))
    return split, serve


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(port, arch, tag):
    """Every client and server leaf of the split tree and every leaf of
    the serve tree, under tp and fsdp2d, fsdp on and off, and expert
    parallelism on and off for the MoE archs."""
    mesh = _mesh(tag)
    n = int(np.prod([mesh.shape[a] for a in ("pod", "data")
                     if a in mesh.axis_names]))
    split, serve = _ref_trees(arch, n)
    combos = spec_combos(get_config(arch).moe is not None)
    for policy, fsdp, ep in combos:
        got = port[tag]["params"][f"{arch}|{policy}|{fsdp}|{ep}"]
        sh = jshard.split_param_shardings(split, mesh=mesh, fsdp=fsdp,
                                          expert_parallel=ep, policy=policy)
        _check_rows(got["client"], _ref_rows(split["client"], sh["client"]))
        _check_rows(got["server"], _ref_rows(split["server"], sh["server"]))
        _check_rows(got["serve"], _ref_rows(serve, jshard.param_shardings(
            serve, mesh=mesh, client=False, fsdp=fsdp, expert_parallel=ep,
            policy=policy)))


def _rows_of(port_rows, path_end):
    return [r for r in port_rows if r[0].endswith(path_end)]


def test_column_parallel_bias_takes_the_stacked_rule(port):
    """starcoder2-3b's wq bias: the reference's stacked (repeat, 3072)
    leaf is P(None, None), so the port's per-layer (3072,) leaf stays
    replicated, where the rule on the unstacked leaf alone would give
    P('model'); client-side (16, repeat, 3072) -> ('data', None)."""
    got = port["single"]["params"]["starcoder2-3b|tp|False|False"]
    server = _rows_of(got["server"], "attn/wq/b")
    client = _rows_of(got["client"], "attn/wq/b")
    assert server and client
    assert all(r[5] == [None] for r in server), server
    assert all(r[5] == ["data", None] for r in client), client
    alone = jshard.param_spec(
        (jax.tree_util.DictKey("wq"), jax.tree_util.DictKey("b")),
        jax.ShapeDtypeStruct((3072,), jnp.bfloat16), mesh=_mesh("single"),
        client=False)
    assert _norm(alone, 1) == ["model"]


def test_fsdp2d_norm_scale_takes_the_stacked_rule(port):
    """Under fsdp2d a server norm scale: the reference's stacked
    (repeat, 4096) leaf is P(None, ('data', 'model')), so the port's
    (4096,) leaf is sharded over both axes, where the rule on it alone
    replicates it."""
    got = port["single"]["params"]["granite-8b|fsdp2d|False|False"]
    rows = _rows_of(got["server"], "norm1/scale")
    assert rows and all(r[5] == [["data", "model"]] for r in rows), rows
    alone = jshard.param_spec_fsdp2d(
        (jax.tree_util.DictKey("norm1"), jax.tree_util.DictKey("scale")),
        jax.ShapeDtypeStruct((4096,), jnp.bfloat16), mesh=_mesh("single"),
        client=False)
    assert _norm(alone, 1) == [None]


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_case_matches_reference(port, arch, shape, tag):
    """``build_case``: None where the reference skips; else the
    reference's kind and meta, and every arg leaf's shape, dtype and
    in-sharding."""
    ref = jspecs.build_case(arch, shape, _mesh(tag),
                            extra_overrides=spec_overrides(arch))
    got = port[tag]["cases"][f"{arch}|{shape}"]
    if ref is None:
        assert got is None
        return
    assert got["kind"] == ref.kind
    assert got["meta"] == json.loads(json.dumps(ref.meta))
    assert len(got["args"]) == len(ref.args)
    for i, (a, s) in enumerate(zip(ref.args, ref.in_shardings)):
        if ref.kind == "train" and i == 0:
            rows = {**_ref_rows(a["client"], s["client"], "client/"),
                    **_ref_rows(a["server"], s["server"], "server/")}
        else:
            rows = _ref_rows(a, s)
        _check_rows(got["args"][i], rows)


def test_worker_imported_no_jax(port):
    assert port["clean"] == "ok"
