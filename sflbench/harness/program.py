"""The system under test: the port's SFL split training step.

This is the only module of the benchmark that imports the program
(``repro_torch``, from the checkout's ``src/``). :class:`Trainer` holds
the one training object a run builds: the plans and the step function
of each cut (``core.algorithms.make_train_step`` with a
``core.protocol.ProtocolEngine``), the split params and the optimizer
state. :meth:`Trainer.step` is the window's call, the body of the port
launcher's LM loop (``launch/train.py`` ``train_lm``) at full
participation: batch to the device, the step, the loss copy as the sync
point; :meth:`Trainer.migrate` is that loop's resplit of the params and
the optimizer state at a cut change. :func:`counting` installs the
recorder that sums the program's ``obs`` counters over the profiled
steps.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import typing
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterator, Tuple

from harness import spec, weights

SRC = spec.ROOT / "src"


def import_program():
    """``repro_torch`` from this checkout's ``src/``; raises if it is
    missing there or another copy was already imported."""
    if not (SRC / "repro_torch" / "__init__.py").exists():
        raise RuntimeError(f"the program is not in this checkout: no "
                           f"{SRC / 'repro_torch'}")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch

    where = spec.Path(repro_torch.__file__).resolve()
    if SRC.resolve() not in where.parents:
        raise RuntimeError(f"repro_torch was imported from {where}, not "
                           f"from {SRC}")
    return repro_torch


def _build(cls, values: dict):
    """``cls(**values)``, each nested dataclass field (``moe``, ``ssm``,
    ``encoder``) built from its dict and each list made a tuple; every
    other key passes through by name."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for key, v in values.items():
        kinds = (hints[key],) + typing.get_args(hints[key]) \
            if key in hints else ()
        nested = [k for k in kinds if dataclasses.is_dataclass(k)]
        if nested and isinstance(v, dict):
            v = _build(nested[0], v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[key] = v
    return cls(**kw)


def model_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file's ``model``."""
    import_program()
    from repro_torch.configs.base import ModelConfig

    return _build(ModelConfig, dict(config["model"], name=config["name"]))


@contextmanager
def counting():
    """Install, for the ``with`` block, a recorder that sums the
    program's ``obs`` counters in memory and writes nothing; yields the
    totals (name -> sum). Its spans are the Null recorder's (the profiler
    ranges ``repro_torch.<name>``), and like the Null recorder it reports
    ``enabled`` False, so the program does no work for it that it would
    not do otherwise. The step reads the active recorder at each call
    (``obs.span``, ``obs.get_recorder()``), so installing it around the
    profiled steps is enough."""
    import_program()
    from repro_torch import obs

    totals: Dict[str, float] = {}
    lock = threading.Lock()

    class Counting(obs.NullRecorder):
        def counter(self, name, value=1, **attrs):
            with lock:
                totals[name] = totals.get(name, 0) + value

    with obs.use_recorder(Counting()):
        yield totals


def _unflatten(flat: Dict[str, object]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flatten(tree, prefix: str, out: Dict[str, object]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = tree


def _layer_lists(groups, first: int):
    """(the plan's [group][layer][sublayer] index lists, next index)."""
    out, k = [], first
    for g in groups:
        out.append([tuple(range(k + r * len(g.period),
                                k + (r + 1) * len(g.period)))
                    for r in range(g.repeat)])
        k += g.repeat * len(g.period)
    return out, k


class Trainer:
    """One split training run of the port on ``device``."""

    def __init__(self, config: dict, traffic: dict, init: Dict, device,
                 cuts, cut: int, seed: int):
        import_program()
        import torch
        from repro_torch.configs.base import TrainConfig
        from repro_torch.core import algorithms as alg
        from repro_torch.core.protocol import ProtocolEngine
        from repro_torch.models import lm
        from repro_torch.optim import make_optimizer

        self.torch, self.alg = torch, alg
        self.device = device
        t = traffic
        if t["cohort"] != t["clients"]:
            raise ValueError("the benchmark drives full participation: "
                             "cohort must equal clients")
        if t.get("tau", 1) != 1:
            raise ValueError("the benchmark drives tau 1")
        self.n, self.b, self.S = t["clients"], t["batch"], t["seq"]
        lr = float(t["lr"])
        self.cfg = model_config(config)
        tcfg = TrainConfig(model=self.cfg, algo=t["scheme"], cut_layer=cut,
                           compute_dtype="float32", param_dtype="float32",
                           lr=lr, remat=bool(t.get("remat", False)), tau=1,
                           uplink_codec=t["uplink_codec"],
                           downlink_codec=t["downlink_codec"], seed=seed,
                           optimizer=t["optimizer"])
        self.engine = ProtocolEngine(t["scheme"], t["uplink_codec"],
                                     t["downlink_codec"], base_seed=seed)
        opt = make_optimizer(t["optimizer"], lr)
        self.plans, self.steps = {}, {}
        for v in cuts:
            self.plans[v] = lm.build_plan(self.cfg, v)
            self.steps[v] = alg.make_train_step(self.plans[v], tcfg, opt,
                                                self.n, engine=self.engine)
        self.cut = cut
        self.params = alg.split_lm_params(self._tree(init, cut), self.n)
        self.opt_state = opt.init(alg.trainable_params(self.params))

    def _tree(self, flat: Dict, cut: int) -> dict:
        """``init_lm``'s tree for the plan at ``cut`` from named leaves."""
        plan = self.plans[cut]
        tree = _unflatten({k: v for k, v in flat.items()
                           if weights.layer_of(k) < 0})
        layers = {i: _unflatten({k[k.index(".") + 1:]: v
                                 for k, v in flat.items()
                                 if weights.layer_of(k) == i})
                  for i in range(self.cfg.num_layers)}
        cl, k = _layer_lists(plan.client_groups, 0)
        sl, _ = _layer_lists(plan.server_groups, k)
        tree["client"] = [[tuple(layers[i] for i in l) for l in g]
                          for g in cl]
        tree["server"] = [[tuple(layers[i] for i in l) for l in g]
                          for g in sl]
        return tree

    def named(self) -> Dict[str, object]:
        """``side.leaf`` -> the current params' tensor (client leaves
        with their leading client axis)."""
        plan, p = self.plans[self.cut], self.params
        out: Dict[str, object] = {}
        _flatten({"embed": p["client"]["embed"]}, "client.", out)
        for side, groups, first in (
                ("client", plan.client_groups, 0),
                ("server", plan.server_groups, plan.cut)):
            lists, _ = _layer_lists(groups, first)
            for g, gl in zip(p[side]["groups"], lists):
                for lp, idx in zip(g, gl):
                    for sub, i in zip(lp, idx):
                        _flatten(sub, f"{side}.layer{i}.", out)
        _flatten({k: v for k, v in p["server"].items() if k != "groups"},
                 "server.", out)
        return out

    def migrate(self, v: int):
        """Move the cut to ``v``: the params and the optimizer state."""
        old, new = self.plans[self.cut], self.plans[v]
        self.params = self.alg.resplit_lm_params(self.params, old, new)
        self.opt_state = self.alg.resplit_opt_state(self.opt_state, old, new)
        self.cut = v

    def step(self, batches: Iterator[Tuple], seed: int,
             span=lambda name: nullcontext()) -> float:
        """One training step on the stream's next batch; the loss copied
        to the host is the step's end. ``span(name)`` wraps each phase
        (the benchmark's trace spans)."""
        torch = self.torch
        with span("batch"):
            toks, labels = next(batches)
            shape = (self.n, self.b, self.S)
            batch = {"tokens": torch.from_numpy(toks.reshape(shape))
                     .to(self.device),
                     "labels": torch.from_numpy(labels.reshape(shape))
                     .to(self.device),
                     "seed": seed}
        with span("step"):
            self.params, self.opt_state, m = self.steps[self.cut](
                self.params, self.opt_state, batch)
        with span("loss_copy"):
            return float(m["loss"])
