"""Multi-pod dry run (port of ``repro.launch.dryrun``): run every (arch x
shape) case once on the production meshes, over DTensors of fake
tensors, and write each case's roofline row.

The reference lowers and compiles each case on 512 placeholder host
devices and reads XLA's HLO. The port has neither: a case runs once,
eagerly, as rank 0 of a fake process group of the mesh's size (256 for
the (16, 16) mesh, 512 for (2, 16, 16); ``FakeStore``, no network, no
card), every tensor a fake tensor on the CPU, so nothing is allocated.
``analysis.roofline.OpCounter`` counts what rank 0 dispatches: local
FLOPs and bytes, collectives by kind, and the peak of live storage. The
three terms are priced on the card the row names (``device``: the
H100's data-sheet peaks); the run itself is a CPU tool and never ran
on that card.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single --out results/dryrun
  python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b \\
      --shape decode_32k --mesh multi --algo sfl_ga --cut 2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.split import model_flops_serve, model_flops_train_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_case

MESH_RANKS = {"single": 256, "multi": 512}
# the production mesh of the current fake group: one a group, since
# DTensor's sharding caches take an equal mesh for the same one and would
# run a new mesh's ops over an old mesh's groups
_MESH = {}


def fake_group(world: int) -> None:
    """A default process group of ``world`` fake ranks, this process rank
    0: the existing one when it has that size, else a new one (an
    existing group of another size is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    _MESH.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(mesh_tag: str):
    """The (16, 16) or (2, 16, 16) mesh over a fake group of its size."""
    fake_group(MESH_RANKS[mesh_tag])
    if mesh_tag not in _MESH:
        _MESH[mesh_tag] = make_production_mesh(
            multi_pod=(mesh_tag == "multi"), device="cpu")
    return _MESH[mesh_tag]


def run_case(arch: str, shape_name: str, mesh_tag: str, *, algo="sfl_ga",
             cut=None, fsdp=None, expert_parallel=False, remat=True,
             policy="tp", verbose=True, extra_overrides=None):
    mesh = production_mesh(mesh_tag)
    chips = mesh.size()
    t0 = time.time()
    case = build_case(arch, shape_name, mesh, algo=algo, cut=cut, fsdp=fsdp,
                      expert_parallel=expert_parallel, remat=remat,
                      policy=policy, extra_overrides=extra_overrides)
    if case is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                "status": "skipped",
                "reason": "long_500k unsupported for this family (DESIGN.md §5)"}
    counter = rl.OpCounter(mesh)
    with case.mode:
        dargs = case.distribute()
    counter.track(dargs)
    case.run(counter, args=dargs)
    del dargs
    t_run = time.time() - t0

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        mflops = model_flops_train_step(cfg, shape.global_batch * shape.seq_len,
                                        shape.seq_len)
    else:
        ntok = (shape.global_batch * shape.seq_len if shape.kind == "prefill"
                else shape.global_batch)
        mflops = model_flops_serve(cfg, ntok, shape.seq_len)

    stats = counter.stats
    roof = rl.analyze(stats, arch=arch, shape=shape_name, mesh_tag=mesh_tag,
                      chips=chips, model_flops=mflops, dtype="bfloat16")
    # whisper's encoder-decoder has no remat, in the reference too
    remat = remat and case.kind == "train" and cfg.arch_type != "audio"
    mem_text = (f"peak live storage on rank 0: {stats.peak_bytes} bytes "
                f"(fake tensors, eager, {'remat' if remat else 'no remat'})")
    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_tag} ({chips} chips) ==")
        print(f"  run: {t_run:.1f}s  meta={case.meta}")
        print(f"  memory: {mem_text}")
        print(f"  ops: flops={stats.flops:.3e} bytes={stats.bytes:.3e} "
              f"global_flops={stats.global_flops:.3e}")
        print(f"  collectives: {roof.coll_detail} "
              f"counts={stats.coll_count_by_kind}")
        print(f"  roofline on {roof.device}: compute={roof.t_compute:.4f}s "
              f"memory={roof.t_memory:.4f}s collective={roof.t_collective:.4f}s"
              f" -> bottleneck={roof.bottleneck} "
              f"useful_flops_ratio={roof.useful_flops_ratio:.3f}")
    out = roof.to_dict()
    # the counts follow torch's own decompositions and sharding rules,
    # which change between versions: the row says which one made it, and
    # whether a train step rematerialized its layers
    meta = {**case.meta, "torch": torch.__version__}
    if case.kind == "train":
        meta["remat"] = remat
    out.update({"status": "ok", "compile_s": t_run, "meta": meta,
                "memory_analysis": mem_text})
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    p.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    p.add_argument("--algo", default="sfl_ga")
    p.add_argument("--cut", type=int, default=None)
    p.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    p.add_argument("--expert-parallel", action="store_true")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--policy", default="tp", choices=["tp", "fsdp2d"])
    p.add_argument("--all", action="store_true", help="run the full matrix")
    p.add_argument("--out", default=None, help="append JSONL results here")
    args = p.parse_args(argv)

    fsdp = None if args.fsdp is None else (args.fsdp == "on")
    # --all expands unspecified dimensions; explicit --arch/--shape filter.
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    results = []
    failures = 0
    try:
        for mesh_tag in meshes:  # one fake group a mesh
            for arch in archs:
                for shape in shapes:
                    try:
                        r = run_case(arch, shape, mesh_tag, algo=args.algo,
                                     cut=args.cut, fsdp=fsdp,
                                     expert_parallel=args.expert_parallel,
                                     remat=not args.no_remat,
                                     policy=args.policy)
                    except Exception as e:
                        traceback.print_exc()
                        r = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                             "status": "error",
                             "error": f"{type(e).__name__}: {e}"}
                        failures += 1
                    results.append(r)
                    if args.out:
                        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                                    exist_ok=True)
                        with open(args.out, "a") as f:
                            f.write(json.dumps(r) + "\n")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        _MESH.clear()
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    print(f"\n== dry-run summary: {ok} ok, {sk} skipped, {failures} failed, "
          f"{len(results)} total ==")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
