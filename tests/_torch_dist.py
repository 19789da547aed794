"""Process-group helpers of the port's tests, and the worker that runs
their multi-rank and fake-group cases in processes of their own.

A default process group is process-wide state: one created in a pytest
worker would leak into every later test file that worker runs. So every
case that needs more than one rank, or a fake group of 256 or 512 ranks,
runs here, in a fresh interpreter started by ``run_worker``; the ranks
meet over a ``FileStore`` in the test's temporary directory (no TCP
port). A one-rank group made in the test process itself (``--bank
sharded`` of the launcher, ``make_bank_mesh``) is destroyed by the
``_no_process_group_left`` fixture, which a test file imports by name:

    from _torch_dist import _no_process_group_left  # noqa: F401

    python tests/_torch_dist.py mesh OUT.json
    python tests/_torch_dist.py bank WORLD DIR OUT.json
    python tests/_torch_dist.py specs|dryrun|roofline OUT.json

The worker imports torch, numpy and the port; never jax, nothing of the
reference (the ``clean`` case records it).
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

# launch.mesh / launch.shardings cases: (rule, arguments) on each mesh;
# shapes are leaves' shapes, "csize" stands for the mesh's client size
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def mesh_cases(csize: int):
    """(name, rule, args) of the sharding cases on a mesh whose client
    axes hold ``csize`` shards (16 or 32)."""
    kv = {"kv_batch": [2, 2 * csize, 256, 16, 64],
          "kv_mqa": [2, csize, 256, 1, 64],
          "kv_heads8": [2, csize, 128, 8, 64],
          "kv_seqpar": [2, 1, 4096, 16, 128],
          "kv_seqpar_short": [2, 1, 1024, 16, 128],
          "kv_seqpar_odd": [2, 1, 2056, 16, 128],
          "ssm_state": [4, csize, 24, 64, 128],
          "ssm_state_b1": [4, 1, 24, 64, 128],
          "conv_state": [4, csize, 3, 1536],
          "lengths": [4],
          "scalar": []}
    out = [(f"bank_{n}", "bank_sharding", [n]) for n in (1, 2, 3, 4)]
    for policy in ("tp", "fsdp2d"):
        out += [(f"batch_{policy}_{n}", "batch_sharding", [n, policy])
                for n in (1, 2, 3, 4)]
    out += [("serve_div", "serve_batch_sharding", [3, 4 * csize]),
            ("serve_one", "serve_batch_sharding", [3, 1]),
            ("serve_odd", "serve_batch_sharding", [2, csize + 1]),
            ("serve_none", "serve_batch_sharding", [4, None]),
            ("cache", "cache_shardings", [kv])]
    return out


def _specs(value):
    """A Sharding (or a dict of them) as JSON: per tensor dim None, an
    axis name, or a list of names."""
    if isinstance(value, dict):
        return {k: _specs(v) for k, v in value.items()}
    return [list(s) if isinstance(s, tuple) else s for s in value.spec()]


def worker_mesh(out_path: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as M
    from repro_torch.launch import shardings as S

    result = {}
    for tag, (shape, axes) in MESHES.items():
        world = int(np.prod(shape))
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = M.make_production_mesh(multi_pod=tag == "multi",
                                          device="cpu")
            csize = M.n_client_shards(mesh)
            got = {"axis_names": list(mesh.mesh_dim_names),
                   "shape": M.mesh_shape(mesh),
                   "client_axes": list(M.client_axes(mesh)),
                   "n_client_shards": csize,
                   "model_axis_size": M.model_axis_size(mesh)}
            for name, rule, args in mesh_cases(csize):
                if rule == "cache_shardings":
                    tree = {k: torch.empty(v, device="meta")
                            for k, v in args[0].items()}
                    got[name] = _specs(S.cache_shardings(tree, mesh))
                else:
                    got[name] = _specs(getattr(S, rule)(mesh, *args))
            result[tag] = got
        finally:
            dist.destroy_process_group()
    result["clean"] = _clean()
    Path(out_path).write_text(json.dumps(result))


def _clean() -> str:
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return "ok" if not bad else f"imported {bad}"


# ---------------------------------------------------------------- bank
N_CLIENTS, K = 8, 3  # N divides 1, 2 and 4 ranks


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _same_tree(a, b) -> bool:
    import torch

    from repro_torch.tree import tree_leaves

    # every DTensor made whole first: full_tensor() is a collective, and
    # a rank that stopped early would leave the others waiting
    la = [_full(x) for x in tree_leaves(a)]
    lb = [_full(y) for y in tree_leaves(b)]
    return len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


def _same_sim(a, b) -> bool:
    return _same_tree(a.state["client"], b.state["client"]) \
        and _same_tree(a.state["server"], b.state["server"])


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _sim(bank, scheme="sfl_ga", **kw):
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig

    cfg = dict(scheme=scheme, cut=2, n_clients=N_CLIENTS, batch=4,
               cohort=K, sampler="uniform", cohort_seed=3, bank=bank,
               uplink_codec="int8", downlink_codec="int8",
               drift_metric=True)
    cfg.update(kw)
    return FedSimulator(LIGHT_CONFIG, SimConfig(**cfg), seed=1,
                        device="cpu")


def _data(k, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(k, 1, 4, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, (k, 1, 4)))


def case_unit(world, tmp):
    """gather (duplicates, rows of every shard), scatter with duplicate
    indices, broadcast, wholesale replace, broadcast_single, the
    identity gather and the reductions, against the device bank."""
    import torch

    from repro_torch.core.bank import ClientBank
    from repro_torch.core.protocol import ProtocolEngine

    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(N_CLIENTS, 3, 2).astype(np.float32),
            "b": rng.randn(N_CLIENTS).astype(np.float32),
            "n": rng.randint(0, 9, (N_CLIENTS, 2)).astype(np.int64)}
    tree["w"][5, 0, 0] = -0.0  # a signed zero must survive the gather
    dev = ClientBank(tree, n_clients=N_CLIENTS, stacked=True,
                     backend="device", device="cpu")
    sh = ClientBank(tree, n_clients=N_CLIENTS, stacked=True,
                    backend="sharded", device="cpu")
    _check(type(sh.tree["w"]).__name__ == "DTensor", "tree is no DTensor")
    _check(sh.tree["w"].to_local().shape[0] == N_CLIENTS // world,
           f"local rows {sh.tree['w'].to_local().shape}")
    st = sh.stats()
    _check(set(st) == set(dev.stats()) and st["backend"] == "sharded"
           and st["device_bytes"] == dev.nbytes // world
           and st["bank_bytes"] == dev.nbytes, f"stats {st}")
    idx = np.asarray([7, 0, 5, 7, 2])
    g = sh.gather(idx)
    _check(_same_tree(dev.gather(idx), g), "gather differs")
    _check(str(g["w"][2, 0, 0].item()) == "-0.0", "-0.0 lost in gather")
    upd = {k: (v * 3 + 1 if v.dtype.is_floating_point else v + 1)
           for k, v in g.items()}
    dev.scatter(idx, upd)
    sh.scatter(idx, upd)
    _check(_same_tree(dev.tree, sh.tree), "scatter (duplicates) differs")
    _check(_same_tree(dev.gather(None), sh.gather(None)),
           "identity gather differs")
    rho = torch.from_numpy(rng.rand(N_CLIENTS).astype(np.float32))
    _check(_same_tree(dev.rho_mean(rho), sh.rho_mean(rho)), "rho_mean")
    block = {"w": dev.tree["w"], "b": dev.tree["b"]}
    sblock = {"w": sh.tree["w"], "b": sh.tree["b"]}
    _check(_same_tree(dev.merge_anchored(block, rho),
                      sh.merge_anchored(sblock, rho)), "merge_anchored")
    fl = {"w": dev.tree["w"], "b": dev.tree["b"]}
    dd = ClientBank(fl, n_clients=N_CLIENTS, stacked=True, device="cpu")
    sd = ClientBank(fl, n_clients=N_CLIENTS, stacked=True,
                    backend="sharded", device="cpu")
    a = dd.drift(ProtocolEngine.client_drift)
    b = sd.drift(ProtocolEngine.client_drift)
    _check(a == b and dd.drift_streamed() == sd.drift_streamed(),
           f"drift {a} {b}")
    _check(_same_tree(dev.full_device(), sh.full_device()), "full_device")
    dev.scatter(None, upd, broadcast=True)
    sh.scatter(None, upd, broadcast=True)
    _check(_same_tree(dev.tree, sh.tree), "broadcast scatter differs")
    whole = {k: v + 1 for k, v in dev.gather(None).items()}
    dev.scatter(None, whole)
    sh.scatter(None, whole)
    _check(_same_tree(dev.tree, sh.tree), "wholesale scatter differs")
    dev.replace(tree)
    sh.replace(tree)
    _check(_same_tree(dev.tree, sh.tree), "replace differs")
    single = {"w": torch.arange(6.).reshape(3, 2)}
    sb = sh.broadcast_single(single)
    _check(_same_tree(dev.broadcast_single(single), sb)
           and sb["w"].to_local().shape[0] == N_CLIENTS // world,
           "broadcast_single differs")
    sb["w"].to_local()[0, 0, 0] = 99.0  # each row its own copy
    _check(float(sb["w"].full_tensor()[N_CLIENTS - 1, 0, 0]) == 0.0,
           "broadcast_single rows alias")


def case_not_divisible(world, tmp):
    from repro_torch.core.bank import ClientBank

    n = N_CLIENTS + 1 if world > 1 else None
    if n is None:  # every N divides one shard
        return
    tree = {"w": np.zeros((n, 2), np.float32)}
    try:
        ClientBank(tree, n_clients=n, stacked=True, backend="sharded",
                   device="cpu")
    except ValueError as e:
        want = (f"sharded bank: N={n} not divisible by {world} client "
                f"shards (mesh {{'data': {world}, 'model': 1}})")
        _check(str(e) == want, f"message {e!s}")
        return
    raise AssertionError("no ValueError")


def _sim_case(scheme):
    def case(world, tmp):
        dev, sh = _sim("device", scheme), _sim("sharded", scheme)
        cuts = {1: 1, 2: 3} if scheme != "fl" else {}
        for t in range(3):
            if t in cuts:
                _check(dev.set_cut(cuts[t]) == sh.set_cut(cuts[t]),
                       "migration bits differ")
            x, y = _data(K, 10 + t)
            a, b = dev.run_round(x, y), sh.run_round(x, y)
            _check(a == b, f"round {t}: {a} != {b}")
            _check(_same_sim(dev, sh), f"round {t}: states differ")
        _check(_same_tree(dev.global_params(), sh.global_params()),
               "global params differ")
    return case


def case_default_drift(world, tmp):
    import math

    dev = _sim("device", drift_metric=None)
    sh = _sim("sharded", drift_metric=None)
    _check(sh._drift_mode == "exact", f"drift mode {sh._drift_mode}")
    x, y = _data(K, 20)
    a, b = dev.run_round(x, y), sh.run_round(x, y)
    _check(math.isfinite(b["client_drift"]) and b["client_drift"] > 0
           and a == b, f"drift {a} {b}")


def _async_case(scheme):
    def case(world, tmp):
        def data_fn(d, idx):
            return _data(len(idx), 100 + d)

        dev, sh = _sim("device", scheme), _sim("sharded", scheme)
        ed = dev.async_engine(data_fn, buffer=2)
        es = sh.async_engine(data_fn, buffer=2)
        for m in range(4):
            a, b = ed.step(), es.step()
            _check(a == b, f"merge {m}: {a} != {b}")
            _check(_same_sim(dev, sh), f"merge {m}: states differ")
        ed.drain()
        es.drain()
        _check(_same_sim(dev, sh), "drained states differ")
    return case


def case_checkpoint(world, tmp):
    """save after a round, restore into a fresh sharded simulator, go
    on; the file equals the device simulator's apart from the meta's
    ``bank_backend``, and rank 0 leaves it for the test to read with
    the reference's loader."""
    import msgpack
    import torch.distributed as dist

    dev, sh = _sim("device"), _sim("sharded")
    batches = [_data(K, 30 + t) for t in range(3)]
    dev.run_round(*batches[0])
    sh.run_round(*batches[0])
    sh.set_cut(1)
    dev.set_cut(1)
    dev.run_round(*batches[1])
    sh.run_round(*batches[1])
    paths = {b: os.path.join(tmp, f"w{world}_{b}.ckpt")
             for b in ("device", "sharded")}
    if dist.get_rank() == 0:
        dev.save(paths["device"])
    dist.barrier()
    sh.save(paths["sharded"])
    raw = {}
    for b, p in paths.items():
        with open(p, "rb") as f:
            up = msgpack.Unpacker(f, raw=False)
            header = up.unpack()
            f.seek(up.tell())
            raw[b] = (header, f.read())
    (hd, pd), (hs, ps) = raw["device"], raw["sharded"]
    _check(hs["meta"].pop("bank_backend") == "sharded"
           and hd["meta"].pop("bank_backend") == "device", "bank_backend")
    _check(hd == hs, "headers differ beyond bank_backend")
    _check(pd == ps, "payload bytes differ")
    again = _sim("sharded")
    meta = again.restore(paths["sharded"])
    _check(meta["t"] == 2 and again.cut == 1 and _same_sim(again, sh),
           "restore differs")
    _check(type(again.state["client"][0]["w"]).__name__ == "DTensor",
           "restore did not shard the bank")
    a, b = again.run_round(*batches[2]), sh.run_round(*batches[2])
    _check(a == b and _same_sim(again, sh), "resumed round differs")
    try:
        _sim("device").restore(paths["sharded"])
    except ValueError as e:
        _check("bank backend 'sharded'" in str(e), str(e))
    else:
        raise AssertionError("a device sim restored a sharded checkpoint")


CASES = {"unit": case_unit, "not_divisible": case_not_divisible,
         **{f"sim_{s}": _sim_case(s) for s in ("sfl_ga", "psl", "sfl",
                                               "fl")},
         "default_drift": case_default_drift,
         **{f"async_{s}": _async_case(s) for s in ("sfl_ga", "psl")},
         "checkpoint": case_checkpoint}


def _rank(rank, world, tmp, out_path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), world), rank=rank, world_size=world)
    results = {}
    try:
        for name, fn in CASES.items():
            try:
                fn(world, tmp)
                results[name] = "ok"
            except Exception as e:  # every case reports on its own
                results[name] = f"{type(e).__name__}: {e}"
        results["clean"] = _clean()
        gathered = [None] * world
        dist.all_gather_object(gathered, results)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        merged = {k: next((g[k] for g in gathered if g[k] != "ok"), "ok")
                  for k in results}
        Path(out_path).write_text(json.dumps(merged))


def worker_bank(world: int, tmp: str, out_path: str) -> None:
    store = os.path.join(tmp, "store")
    if os.path.exists(store):  # a FileStore left by an earlier run
        os.remove(store)
    if world == 1:
        _rank(0, 1, tmp, out_path)
        return
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(world, tmp, out_path), nprocs=world)


# ------------------------------------------------------- specs / dry run
# depth cuts (num_layers) shared by the port's workers and the tests'
# reference side: every layer grouping kept (Jamba's period of 8, kimi's
# dense first layer), a client and a server side at the default cut 2
SPEC_LAYERS = {"jamba-v0.1-52b": 8}
DEFAULT_SPEC_LAYERS = 3
# the dry-run rows' reduced granite-8b (full widths)
ROW_ARCH, ROW_LAYERS = "granite-8b", 3


def spec_overrides(arch: str) -> dict:
    return {"num_layers": SPEC_LAYERS.get(arch, DEFAULT_SPEC_LAYERS)}


def spec_combos(moe: bool):
    """(policy, fsdp, expert_parallel) of the param-sharding cases."""
    out = [("tp", False, False), ("tp", True, False), ("fsdp2d", False,
                                                         False)]
    if moe:
        out += [("tp", False, True), ("tp", True, True)]
    return out


def _strip_layer(path, repeat):
    """A layer leaf's path without its layer index (the second entry of
    the first run of ``[i]`` names: ``[group][layer][sublayer]``): the
    reference's path of its stacked group leaf."""
    names = list(path)
    if repeat is None:
        return "/".join(names)
    first = next(i for i, n in enumerate(names) if n.startswith("["))
    del names[first + 1]
    return "/".join(names)


def _leaf_rows(tree, shardings, at=0, prefix=""):
    """[path, repeat, stacked axis, shape, dtype, spec] a tensor leaf."""
    from repro_torch.launch.shardings import map_with_path

    rows = []

    def visit(path, leaf, repeat):
        if hasattr(leaf, "shape"):
            rows.append([prefix + _strip_layer(path, repeat), repeat, at,
                         list(leaf.shape), str(leaf.dtype).split(".")[-1]])
        return leaf

    map_with_path(visit, tree)
    specs = []
    map_with_path(lambda p, s, r: specs.append(_specs(s)) if s is not None
                  else None, shardings)
    return [r + [sp] for r, sp in zip(rows, specs)]


def _fake_trees(arch, n):
    """(split tree at the default cut, init_lm / whisper serve tree) of
    ``arch`` at full widths and ``spec_overrides`` depth, fake tensors."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.core import algorithms as alg
    from repro_torch.launch import specs
    from repro_torch.models import encdec, lm

    cfg = get_config(arch).with_overrides(**spec_overrides(arch))
    cut = specs.default_cut(cfg)
    bf = torch.bfloat16
    with FakeTensorMode():
        if cfg.arch_type == "audio":
            split = specs._whisper_split_stacked(cfg, cut, n, bf)
            serve = encdec.init_whisper(0, cfg, bf, device="cpu")
        else:
            split = alg.split_lm_params(
                lm.init_lm(0, lm.build_plan(cfg, cut), bf, device="cpu"), n)
            serve = lm.init_lm(0, lm.build_plan(cfg, 0), bf, device="cpu")
    return split, serve


def worker_specs(out_path: str) -> None:
    """The param shardings of every arch (split and serve trees, every
    policy), and every (arch x shape) case's kind, meta, args and
    in-shardings, on both production meshes."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import shardings as S
    from repro_torch.launch import specs

    result = {}
    for tag, (shape, axes) in MESHES.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(shape)))
        try:
            mesh = M.make_production_mesh(multi_pod=tag == "multi",
                                          device="cpu")
            n = M.n_client_shards(mesh)
            params, cases = {}, {}
            for arch in ARCH_IDS:
                split, serve = _fake_trees(arch, n)
                moe = get_config(arch).moe is not None
                for policy, fsdp, ep in spec_combos(moe):
                    sh = S.split_param_shardings(
                        split, mesh=mesh, fsdp=fsdp, expert_parallel=ep,
                        policy=policy)
                    key = f"{arch}|{policy}|{fsdp}|{ep}"
                    params[key] = {
                        "client": _leaf_rows(split["client"], sh["client"],
                                             1),
                        "server": _leaf_rows(split["server"], sh["server"]),
                        "serve": _leaf_rows(serve, S.param_shardings(
                            serve, mesh=mesh, client=False, fsdp=fsdp,
                            expert_parallel=ep, policy=policy))}
                for shp in INPUT_SHAPES:
                    case = specs.build_case(
                        arch, shp, mesh, extra_overrides=spec_overrides(arch))
                    if case is None:
                        cases[f"{arch}|{shp}"] = None
                        continue
                    train = case.kind == "train"
                    cases[f"{arch}|{shp}"] = {
                        "kind": case.kind, "meta": case.meta,
                        "args": [_leaf_rows(a, s) for a, s in zip(
                            case.args, case.in_shardings)]}
                    if train:  # the client side's stacked axis is 1
                        cases[f"{arch}|{shp}"]["args"][0] = (
                            _leaf_rows(case.args[0]["client"],
                                       case.in_shardings[0]["client"], 1,
                                       "client/")
                            + _leaf_rows(case.args[0]["server"],
                                         case.in_shardings[0]["server"], 0,
                                         "server/"))
            result[tag] = {"params": params, "cases": cases}
        finally:
            dist.destroy_process_group()
    result["clean"] = _clean()
    Path(out_path).write_text(json.dumps(result))


def worker_dryrun(out_path: str) -> None:
    """Dry-run rows of the reduced granite-8b (``ROW_LAYERS`` layers at
    full widths) on the single-pod mesh: train (sfl_ga and sfl with
    remat, sfl_ga without), prefill and decode, with what the tests price
    them from."""
    import math

    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.shardings import map_with_path

    ov = {"num_layers": ROW_LAYERS}
    rows = {}
    try:
        for name, shape, algo, remat in (
                ("sfl_ga", "train_4k", "sfl_ga", True),
                ("sfl", "train_4k", "sfl", True),
                ("sfl_ga_no_remat", "train_4k", "sfl_ga", False),
                ("prefill", "prefill_32k", "sfl_ga", True),
                ("decode", "decode_32k", "sfl_ga", True)):
            rows[name] = dryrun.run_case(ROW_ARCH, shape, "single",
                                         algo=algo, remat=remat,
                                         extra_overrides=ov, verbose=False)
        # the client side's per-rank elements and leaves, from its
        # placements: what sfl's model average all-reduces
        mesh = dryrun.production_mesh("single")
        case = specs.build_case(ROW_ARCH, "train_4k", mesh,
                                extra_overrides=ov)
        local = []
        map_with_path(lambda p, leaf, r: local.append(leaf), case.args[0][
            "client"])
        shds = []
        map_with_path(lambda p, s, r: shds.append(s),
                      case.in_shardings[0]["client"])
        rows["client_local"] = [
            math.prod(specs._local_shape(x.shape, s)[1:])
            for x, s in zip(local, shds)]
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    rows["moe_ep"] = _moe_expert_parallel()
    rows["clean"] = _clean()
    Path(out_path).write_text(json.dumps(rows))


def _moe_expert_parallel():
    """A reduced qwen3-moe layer's MoE under expert parallelism
    (``expert_axis="data"``, 2 routing groups) over DTensors on a fake
    (2, 2) mesh, forward and backward: the rank's expert FLOPs and its
    collectives by axis."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis.roofline import OpCounter
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import shardings as S
    from repro_torch.launch import specs
    from repro_torch.models import moe
    from repro_torch.tree import tree_leaves

    cfg = reduced_config(get_config("qwen3-moe-30b-a3b")).with_overrides(
        expert_axis="data", routing_groups=2)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        with mode:
            params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
            x = torch.empty((4, 8, cfg.d_model))
        case = specs.DryRunCase(
            arch="moe", shape="ep", kind="train",
            fn=lambda p, x: moe.moe_apply(p, cfg, x)[0].sum().backward(),
            args=(params, x),
            in_shardings=(S.param_shardings(params, mesh=mesh, client=False,
                                            expert_parallel=True),
                          S.batch_sharding(mesh, 3)), mode=mode)
        with mode:
            dargs = case.distribute()
        for t in tree_leaves(dargs[0]):
            t.requires_grad_(True)
        c = OpCounter(mesh)
        case.run(c, args=dargs)
        return {"flops": c.stats.flops,
                "coll_bytes_by_axes": c.stats.coll_bytes_by_axes}
    finally:
        dist.destroy_process_group()


def worker_roofline(out_path: str) -> None:
    """The counter on a synthetic program (the reference's SYNTH_HLO as
    eager ops on a fake 8-rank group: 5 iterations of (8,16)@(16,16)
    and an all-reduce, then an all-gather to (64,16)), and a matmul over
    DTensors, sharded and replicated, on a fake (2, 4) mesh."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis.roofline import OpCounter

    def stats(c):
        s = c.stats
        return {"flops": s.flops, "global_flops": s.global_flops,
                "dot_bytes": s.dot_bytes, "bytes": s.bytes,
                "coll_bytes_by_kind": s.coll_bytes_by_kind,
                "coll_count_by_kind": s.coll_count_by_kind,
                "coll_bytes_by_axes": s.coll_bytes_by_axes,
                "peak_bytes": s.peak_bytes}

    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        group = dist.group.WORLD
        a, w = torch.ones(8, 16), torch.ones(16, 16)
        c = OpCounter()
        with c:
            x = a
            for _ in range(5):
                x = funcol.all_reduce(x @ w, "sum", group)
            with warnings.catch_warnings():  # deprecated in newer torch
                warnings.simplefilter("ignore", FutureWarning)
                g = funcol.all_gather_tensor(x, 0, group)
            _ = g[:8] + x
        out["synth"] = stats(c)
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                               "model"))
        xs = DTensor.from_local(torch.ones(32, 64), mesh,
                                [Shard(0), Replicate()], run_check=False)
        ws = DTensor.from_local(torch.ones(64, 32), mesh,
                                [Replicate(), Shard(1)], run_check=False)
        wr = DTensor.from_local(torch.ones(64, 128), mesh,
                                [Replicate(), Replicate()], run_check=False)
        c = OpCounter(mesh)
        with c:
            xs @ ws
        out["sharded"] = stats(c)
        c = OpCounter(mesh)
        with c:
            xs @ wr
        out["replicated"] = stats(c)
        c = OpCounter(mesh)
        with c:
            xs.redistribute(mesh, [Replicate(), Replicate()])
        out["gather"] = stats(c)
    finally:
        dist.destroy_process_group()
    out["clean"] = _clean()
    Path(out_path).write_text(json.dumps(out))


# ------------------------------------------------------------- helpers
def run_worker(*args, timeout=240):
    """Run this file as a fresh interpreter with ``args``; the port's
    source first on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, __file__, *map(str, args)],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=ROOT, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"worker {args} failed:\n{out.stderr[-4000:]}")


@pytest.fixture
def _no_process_group_left():
    """Destroys the process group a test made in this process (a
    one-rank sharded bank's), so that no later test inherits it."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "mesh":
        worker_mesh(sys.argv[2])
    elif sys.argv[1] in ("specs", "dryrun", "roofline"):
        import torch

        torch.set_num_threads(1)
        {"specs": worker_specs, "dryrun": worker_dryrun,
         "roofline": worker_roofline}[sys.argv[1]](sys.argv[2])
    else:
        worker_bank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
