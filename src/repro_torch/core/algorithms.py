"""SFL train and serve steps for the LLM zoo (port of
``repro.core.algorithms``).

Parameter layout under split training (the reference's keys; the port's
per-layer lists where the reference stacks a group):

* ``params["client"]`` -- ``{"embed", "groups"}``: the embedding and
  layers[:cut], every leaf with a leading client axis N (each federated
  client owns its copy);
* ``params["server"]`` -- ``{"groups", "final_norm", "head"}``:
  layers[cut:], the final norm and the head, one shared copy.

Under PEFT (``plan.peft`` set) ``client``/``server`` hold only LoRA
adapters (the client's stacked to N), and the frozen ``init_lm`` tree
rides under ``params["base"]``, one copy on both sides of the cut.

Schemes: ``sfl_ga`` aggregates the smashed-data gradients at the
boundary (eq. 5, kernel B1 on the card) and never averages the client
sides; ``sfl`` unicasts each client its cotangent and rho-averages the
client sides every round; ``psl`` unicasts and never averages. The
cut-layer transport is ``core.protocol.ProtocolEngine.boundary``: its
codecs (kernels B2/B3 for int8/int4) and tau > 1 local steps come from
``TrainConfig``.

How a step computes: the client forward runs under ``torch.func.vmap``
over the stacked client copies, one ``vmap`` a layer (the frozen base,
under PEFT, is closed over and so not batched); ``engine.boundary`` takes the (N, b, S, d)
smashed data outside the vmap (an autograd op, whose backward is the
scheme's downlink); the server forward runs on (N b, S, d); the loss is
CE + 0.01 aux. With ``TrainConfig.remat`` (the default, as in the
reference) each layer of both halves is checkpointed, the client's
``vmap`` whole. ``torch.autograd.grad`` differentiates only the
trainable leaves, so under PEFT no gradient of the base exists. The loss pins
``impl="jnp"`` as the reference's does: kernels B4/B5 have no backward.

A step opens ``obs`` spans at its phase boundaries: ``client_forward``,
``uplink`` (the boundary's forward), ``server_forward`` (with the head,
the loss and its sum), ``backward`` (holding the boundary's ``downlink``,
``core.gradagg`` and ``core.protocol``) and ``optimizer``; each resplit
opens ``resplit``. Under ``torch.profiler`` they are ranges
``repro_torch.<span>`` of the device trace; they change no arithmetic.

Batch layout: tokens/labels (N, b, S); with tau > 1 a local-epoch axis
follows the client axis, (N, tau, b, S). ``batch["seed"]`` (uint32)
drives the codecs' stochastic rounding, ``batch["rho"]`` carries cohort
weights.

``make_gen_step`` is the buffered-async loop's dispatch: the same tau
local steps without the round-end aggregation, returning the server
side's delta and the client rows. ``make_whisper_train_step`` trains the
encoder-decoder (``models.encdec``), whose smashed data is two tensors,
each through its own ``engine.boundary``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch import full_f32, obs, placed_like
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.bank import _last_occurrence
from repro_torch.core.gradagg import uniform_rho
from repro_torch.core.protocol import ProtocolEngine, aggregate_cohort
from repro_torch.models import lm as lm_mod
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

ALGOS = ("sfl_ga", "sfl", "psl")
_MOMENTS = ("m", "v", "mu")


def _stack_n(x: torch.Tensor, n: int) -> torch.Tensor:
    """n materialized copies of ``x`` along a new leading axis."""
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous()


def _rho_for(rho, n: int, device) -> torch.Tensor:
    """Aggregation weights as a float32 tensor on ``device``; uniform when
    ``rho`` is None."""
    if rho is None:
        return uniform_rho(n, device)
    return torch.as_tensor(rho, dtype=torch.float32, device=device)


def _device_of(tree):
    return tree_leaves(tree)[0].device


def split_lm_params(params: Dict, n_clients: int) -> Dict:
    """``init_lm`` output -> {client: stacked to N, server: shared}. All
    clients start from the same w^c_0 (paper §II-B)."""
    client = tree_map(lambda x: _stack_n(x, n_clients),
                      {"embed": params["embed"], "groups": params["client"]})
    server = {"groups": params["server"], "final_norm": params["final_norm"]}
    if "head" in params:
        server["head"] = params["head"]
    return {"client": client, "server": server}


def split_lm_lora_params(params: Dict, loras: Dict, n_clients: int) -> Dict:
    """PEFT layout: ``client``/``server`` hold only the trainable adapters
    (the client's stacked to N, so the bank, the cohort gather/scatter
    and the aggregation rules apply unchanged); the frozen ``init_lm``
    tree rides under ``base`` and never crosses the wire."""
    client = tree_map(lambda x: _stack_n(x, n_clients),
                      {"groups": loras["client"]})
    return {"client": client, "server": {"groups": loras["server"]},
            "base": params}


def trainable_params(split: Dict) -> Dict:
    """Everything but the frozen base: the whole tree on a full-parameter
    run, so ``opt.init(trainable_params(p))`` is layout-agnostic."""
    return {k: v for k, v in split.items() if k != "base"}


# ---------------------------------------------------------------------------
# Cut migration. The reference un- and restacks scan groups; on the port's
# per-layer lists ([group][layer][sublayer], one real layer a sublayer)
# the same moves are relayouts of lists.
# ---------------------------------------------------------------------------

def _ungroup_layers(groups_params, groups) -> list:
    """Per-layer list (one entry a real layer, in model order) of a
    side's ``[group][layer][sublayer]`` lists."""
    layers = []
    for g, gp in zip(groups, groups_params):
        if len(gp) != g.repeat:
            raise ValueError(f"group of {len(gp)} layers for a plan with "
                             f"repeat {g.repeat}")
        for r in range(g.repeat):
            for i in range(len(g.period)):
                layers.append(gp[r][i])
    return layers


def _regroup_layers(layers: list, groups) -> list:
    """Inverse of ``_ungroup_layers`` for a (possibly different)
    grouping."""
    out, k = [], 0
    for g in groups:
        p = len(g.period)
        out.append([tuple(layers[k + r * p + i] for i in range(p))
                    for r in range(g.repeat)])
        k += g.repeat * p
    if k != len(layers):
        raise ValueError(f"{len(layers)} layers for a grouping of {k}")
    return out


def _move_split_layers(client_layers: list, server_layers: list,
                       old_v: int, new_v: int, n: int, w) -> tuple:
    """Layers cross the boundary: server->client broadcasts to N copies,
    client->server collapses the N copies by the anchored-delta
    rho-average, which is exact when the copies agree (so v -> v' -> v is
    lossless from equal copies). Both compute on ``w``'s device, the
    server side's: a host-resident client bank's rows move there first,
    so the host and the device bank migrate to the same bits."""
    if new_v > old_v:
        moving = server_layers[:new_v - old_v]
        server_layers = server_layers[new_v - old_v:]
        client_layers = client_layers + [
            tree_map(lambda x: _stack_n(x, n), l) for l in moving]
    else:
        moving = client_layers[new_v:]
        client_layers = client_layers[:new_v]

        def mean(p):
            # base + sum_i w_i (p_i - base): the weighted mean, exact when
            # the client copies agree
            p32 = p.to(w.device).float()
            ww = w.reshape((n,) + (1,) * (p.ndim - 1)).float()
            return (p32[0] + torch.sum(ww * (p32 - p32[0][None]), dim=0)) \
                .to(p.dtype)

        server_layers = [tree_map(mean, l) for l in moving] + server_layers
    return client_layers, server_layers


def resplit_lm_params(split: Dict, old_plan: lm_mod.ModelPlan,
                      new_plan: lm_mod.ModelPlan, rho=None) -> Dict:
    """Move the split from ``old_plan.cut`` to ``new_plan.cut``: layers
    moving server->client are copied to every client, layers moving
    client->server collapse to one by rho-average. Works on any tree with
    the params' structure (optimizer moments migrate through it too);
    under PEFT the tree holds adapters and the frozen base, when present,
    is re-partitioned by ``resplit_base_params``."""
    with obs.span("resplit"):
        return _resplit(split, old_plan, new_plan, rho)


def _resplit(split: Dict, old_plan: lm_mod.ModelPlan,
             new_plan: lm_mod.ModelPlan, rho) -> Dict:
    old_v, new_v = old_plan.cut, new_plan.cut
    if min(old_v, new_v) < 1:
        raise ValueError("a dynamic cut needs a client side (v >= 1)")
    if old_v == new_v:
        return split
    n = int(tree_leaves(split["client"])[0].shape[0])
    w = _rho_for(rho, n, _device_of(split["server"]))
    client_layers = _ungroup_layers(split["client"]["groups"],
                                    old_plan.client_groups)
    server_layers = _ungroup_layers(split["server"]["groups"],
                                    old_plan.server_groups)
    client_layers, server_layers = _move_split_layers(
        client_layers, server_layers, old_v, new_v, n, w)
    client = {"groups": _regroup_layers(client_layers,
                                        new_plan.client_groups)}
    if "embed" in split["client"]:  # full path; adapter trees have none
        client["embed"] = split["client"]["embed"]
    server = dict(split["server"],
                  groups=_regroup_layers(server_layers,
                                         new_plan.server_groups))
    out = {"client": client, "server": server}
    if "base" in split:
        out["base"] = resplit_base_params(split["base"], old_plan, new_plan)
    return out


def resplit_base_params(base: Dict, old_plan: lm_mod.ModelPlan,
                        new_plan: lm_mod.ModelPlan) -> Dict:
    """Re-partition a frozen ``init_lm``-shaped base across a cut change:
    one shared copy on both sides, so a pure relayout -- nothing is
    averaged and nothing crosses the wire."""
    if old_plan.cut == new_plan.cut:
        return base
    layers = (_ungroup_layers(base["client"], old_plan.client_groups)
              + _ungroup_layers(base["server"], old_plan.server_groups))
    v = new_plan.cut
    return dict(base,
                client=_regroup_layers(layers[:v], new_plan.client_groups),
                server=_regroup_layers(layers[v:], new_plan.server_groups))


def resplit_opt_state(opt_state: Dict, old_plan: lm_mod.ModelPlan,
                      new_plan: lm_mod.ModelPlan, rho=None) -> Dict:
    """Params-shaped moments (adamw m/v, momentum mu) migrate as the
    params do (``resplit_lm_params``); the count passes through."""
    out = dict(opt_state)
    with obs.span("resplit"):
        for k in _MOMENTS:
            if k in out:
                out[k] = _resplit(out[k], old_plan, new_plan, rho)
    return out


# ---------------------------------------------------------------------------
# Cohorts
# ---------------------------------------------------------------------------

def gather_cohort(tree: Dict, idx) -> Dict:
    """The cohort rows of a params-shaped {client, server} tree (the
    params or one moment): client leaves trade their (N,) bank axis for a
    (K,) cohort axis; the shared server side passes through."""
    didx = torch.as_tensor(np.asarray(idx, np.int64),
                           device=_device_of(tree["client"]))
    return dict(tree, client=tree_map(lambda x: x.index_select(0, didx),
                                      tree["client"]))


def scatter_cohort(bank: Dict, cohort: Dict, idx,
                   broadcast_client: bool = False) -> Dict:
    """Fold a trained cohort back: the server side replaces wholesale,
    client rows land in their bank slots (a duplicate index keeps its
    last row, as ``core.bank`` resolves it). ``broadcast_client`` writes
    cohort row 0 to every bank row: the client-aggregating scheme (sfl),
    whose step already made every cohort row the new global model."""
    if broadcast_client:
        client = tree_map(
            lambda b, u: u[0].unsqueeze(0).expand(b.shape).to(b.dtype)
            .contiguous(), bank["client"], cohort["client"])
    else:
        uniq, pos = _last_occurrence(np.asarray(idx, np.int64))
        dev = _device_of(bank["client"])
        didx = torch.as_tensor(uniq, device=dev)
        dpos = None if pos is None else torch.as_tensor(pos, device=dev)

        def put(b, u):
            if dpos is not None:
                u = u.index_select(0, dpos)
            return b.index_copy(0, didx, u.to(b.dtype))

        client = tree_map(put, bank["client"], cohort["client"])
    return dict(bank, client=client, server=cohort["server"])


def gather_cohort_opt(opt_state: Dict, idx) -> Dict:
    out = dict(opt_state)
    for k in _MOMENTS:
        if k in out:
            out[k] = gather_cohort(out[k], idx)
    return out


def scatter_cohort_opt(bank_opt: Dict, cohort_opt: Dict, idx) -> Dict:
    """Moments scatter per row (each client keeps its own moment history,
    even under sfl's parameter aggregation); the count comes from the
    cohort run."""
    out = dict(cohort_opt)
    for k in _MOMENTS:
        if k in out:
            out[k] = scatter_cohort(bank_opt[k], cohort_opt[k], idx)
    return out


# ---------------------------------------------------------------------------
# Global model
# ---------------------------------------------------------------------------

def _rho_mean(tree, rho):
    n = int(tree_leaves(tree)[0].shape[0])
    w = _rho_for(rho, n, _device_of(tree))

    def mean(p):
        ww = w.reshape((n,) + (1,) * (p.ndim - 1)).float()
        return torch.sum(p.float() * ww, dim=0).to(p.dtype)

    return tree_map(mean, tree)


def merge_lm_params(split: Dict, rho=None) -> Dict:
    """The global eval/serve model: the rho-weighted mean of the client
    copies + the server side, as an ``init_lm`` tree."""
    client = _rho_mean(split["client"], rho)
    out = {"embed": client["embed"], "client": client["groups"],
           "server": split["server"]["groups"],
           "final_norm": split["server"]["final_norm"]}
    if "head" in split["server"]:
        out["head"] = split["server"]["head"]
    return out


def merge_lm_lora_params(split: Dict, rho=None) -> Dict:
    """PEFT counterpart of ``merge_lm_params``: rho-mean the client
    adapters, fold them into the frozen base (w' = w + s AB)."""
    cad = _rho_mean(split["client"], rho)
    return lm_mod.merge_lm_loras(split["base"],
                                 {"client": cad["groups"],
                                  "server": split["server"]["groups"]})


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _engine_for(tcfg: TrainConfig) -> ProtocolEngine:
    return ProtocolEngine(tcfg.algo, tcfg.uplink_codec, tcfg.downlink_codec,
                          base_seed=tcfg.seed,
                          adapter_sync=(tcfg.peft != "none"))


def _server_params(groups, src) -> Dict:
    full = {"client": [], "server": groups, "final_norm": src["final_norm"]}
    if "head" in src:
        full["head"] = src["head"]
    return full


def _client_forward(plan, cparams, base, tokens, impl, dtype, remat):
    """The client half over the stacked client copies: the embedding
    under ``vmap``, then each client layer as one ``vmap(layer)`` over
    that layer's per-client params and the activations. With ``remat``
    (``TrainConfig.remat``) each such ``vmap`` is checkpointed whole,
    since a checkpoint cannot sit inside ``vmap``; as in
    ``apply_groups_train`` only where autograd records. Under PEFT
    (``base`` given) ``cparams`` are the adapters, attached to the shared
    base layer inside the vmapped function; the frozen base is closed
    over, so vmap does not batch it. Returns (smashed (N, b, S, d), aux
    (N,))."""
    cfg = plan.cfg

    def embed(e, t):
        return lm_mod._inputs({"embed": e}, cfg, t, dtype=dtype)

    if tokens.is_floating_point():  # precomputed input embeddings
        x = lm_mod.scale_embedding(cfg, tokens.to(dtype))
    elif base is None:  # each client's own table
        x = vmap(embed)(cparams["embed"], tokens.long())
    else:  # the frozen base's table, shared
        x = vmap(embed, in_dims=(None, 0))(base["embed"], tokens.long())
    n, b, S = x.shape[:3]
    positions = lm_mod._positions(cfg, b, S, x.device)
    aux = torch.zeros(n, dtype=torch.float32, device=x.device)
    x0 = x
    remat = remat and torch.is_grad_enabled()
    for gi, g in enumerate(plan.client_groups):
        for j, lp in enumerate(cparams["groups"][gi]):
            def layer(lp, x, x0, aux, g=g, gi=gi, j=j):
                if base is not None:
                    lp = tf.attach_group_loras([base["client"][gi][j]],
                                               [lp])[0]
                return tf.layer_train(cfg, g.period, lp, x, x0, aux,
                                      positions, impl)

            f = vmap(layer)
            x, aux = (tf.remat_layer(f, lp, x, x0, aux) if remat
                      else f(lp, x, x0, aux))
    return x, aux


def make_loss_fn(plan: lm_mod.ModelPlan, tcfg: TrainConfig, rho,
                 engine: Optional[ProtocolEngine] = None) -> Callable:
    """``loss_fn(params, batch, seed=0, rho_w=None) -> (loss, {"ce"})``;
    ``rho_w`` replaces the full-bank rho with the cohort's weights. With
    ``tcfg.remat`` every layer of both halves is checkpointed
    (``_client_forward``; ``server_forward``'s own)."""
    dtype = getattr(torch, tcfg.compute_dtype)
    impl = "jnp"
    engine = _engine_for(tcfg) if engine is None else engine
    peft = plan.peft is not None

    def loss_fn(params, batch, seed=0, rho_w=None):
        tokens = batch["tokens"]  # (N, b, S) int, or embeds (N, b, S, d)
        labels = batch["labels"]  # (N, b, S)
        n = tokens.shape[0]
        r = _rho_for(rho if rho_w is None else rho_w, n, tokens.device)
        base = params["base"] if peft else None
        if peft:
            sparams = _server_params(
                tf.attach_group_loras(base["server"],
                                      params["server"]["groups"]), base)
        else:
            sparams = _server_params(params["server"]["groups"],
                                     params["server"])
        with obs.span("client_forward"):
            smashed, aux_c = _client_forward(plan, params["client"], base,
                                             tokens, impl, dtype,
                                             tcfg.remat)
        # the batch's layout at the boundary, where the step runs over
        # DTensors (the dry run): clients over the client axes
        smashed = placed_like(smashed, tokens)
        # the scheme's cut-layer transport: lossy uplink forward; eq. 5
        # aggregate-broadcast (sfl_ga) or per-client unicast backward
        with obs.span("uplink"):
            smashed = engine.boundary(smashed, r, seed)
        nb, b, S, d = smashed.shape
        with obs.span("server_forward"):
            logits, aux_s = lm_mod.server_forward(
                sparams, plan,
                placed_like(smashed.reshape(nb * b, S, d), tokens),
                impl=impl, remat=tcfg.remat)
            ce = lm_mod.cross_entropy(logits, labels.reshape(nb * b, S))
            loss = ce + 0.01 * (torch.sum(aux_c) + aux_s)
        return loss, {"ce": ce}

    return loss_fn


def _make_local_step(loss_fn: Callable, opt: Optimizer,
                     peft: bool) -> Callable:
    """One optimizer step. The trainable leaves (the whole split tree, or
    under PEFT everything but the base) become fresh autograd leaves;
    the frozen base is never differentiated, so gradients and optimizer
    state exist only for trainable leaves. A leaf the loss does not reach
    (the detached LoRA scale) gets a zero gradient, as the reference's
    ``stop_gradient`` gives it."""

    def local_step(params, opt_state, batch, seed, w):
        base = params.get("base") if peft else None
        tr = trainable_params(params) if peft else params
        leaves = tree_flatten(tr)[0]
        live = [l.detach().requires_grad_(True) for l in leaves]
        trg = tree_unflatten(tr, live)
        with torch.enable_grad():
            loss, metrics = loss_fn(dict(trg, base=base) if peft else trg,
                                    batch, seed, w)
            with obs.span("backward"):
                grads = torch.autograd.grad(loss, live, allow_unused=True)
        with torch.no_grad():
            grads = tree_unflatten(tr, [
                torch.zeros_like(l) if g is None else g
                for g, l in zip(grads, leaves)])
            with obs.span("optimizer"):
                updates, opt_state = opt.update(grads, opt_state, tr)
                del grads
                tr = apply_updates(tr, updates)
        del updates, live, trg
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        return (dict(tr, base=base) if peft else tr), opt_state, out

    return local_step


def _local_steps(local_step, engine, tau, params, opt_state, batch, seed,
                 w):
    """tau local steps: one on the batch at tau 1, else one a local epoch
    (the axis after the client axis) with ``engine.epoch_seeds``' codec
    seeds, the metrics averaged over the epochs."""
    if tau == 1:
        return local_step(params, opt_state, batch, seed, w)
    want = 5 if batch["tokens"].is_floating_point() else 4
    if batch["tokens"].ndim != want:
        raise ValueError(
            f"tau={tau} needs a local-epoch axis: tokens (N, tau, b, S"
            f"{', d' if want == 5 else ''}), got "
            f"{tuple(batch['tokens'].shape)}")
    seeds = engine.epoch_seeds(seed, tau)
    ms = []
    for e in range(tau):
        params, opt_state, m = local_step(
            params, opt_state, {"tokens": batch["tokens"][:, e],
                                "labels": batch["labels"][:, e]},
            seeds[e], w)
        ms.append(m)
    return params, opt_state, {k: torch.stack([m[k] for m in ms]).mean()
                               for k in ms[0]}


def make_train_step(plan: lm_mod.ModelPlan, tcfg: TrainConfig,
                    opt: Optimizer, n_clients: int, rho=None,
                    engine: Optional[ProtocolEngine] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: tau local steps of the split model, then the scheme's
    client aggregation (sfl). Launchers pass their own ``engine`` when
    they attach a traffic ledger."""
    if tcfg.algo not in ALGOS:
        raise ValueError(f"algo {tcfg.algo!r} not in {ALGOS}")
    engine = _engine_for(tcfg) if engine is None else engine
    loss_fn = make_loss_fn(plan, tcfg, rho, engine=engine)
    tau = tcfg.resolved_tau
    local_step = _make_local_step(loss_fn, opt, plan.peft is not None)

    def train_step(params, opt_state, batch):
        with full_f32():
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        seed = batch.get("seed", 0)
        dev = batch["tokens"].device
        # cohort weights over the gathered participants; absent = full
        # participation
        w = batch.get("rho")
        if w is not None:
            w = _rho_for(w, batch["tokens"].shape[0], dev)
        # the anchor of the partial-cohort aggregate: the model every
        # participant started from (the rows agree: the previous round
        # broadcast the aggregate into the bank), so row 0
        client0 = tree_map(lambda x: x[0], params["client"]) \
            if (w is not None and engine.spec.client_aggregate) else None
        params, opt_state, metrics = _local_steps(
            local_step, engine, tau, params, opt_state, batch, seed, w)
        if engine.spec.client_aggregate:
            # traditional SFL: aggregate the client sides every round --
            # the phi(v) collective SFL-GA removes
            engine.tap_model_sync(params["client"])
            if w is None:
                n = int(batch["tokens"].shape[0])
                client = engine.aggregate(params["client"],
                                          _rho_for(rho, n, dev))
            else:
                agg = aggregate_cohort(params["client"], w, anchor=client0)
                client = tree_map(
                    lambda a, like: a.unsqueeze(0).expand(like.shape)
                    .to(like.dtype).contiguous(), agg, params["client"])
            params = dict(params, client=client)
        return params, opt_state, metrics

    return train_step


def make_gen_step(plan: lm_mod.ModelPlan, tcfg: TrainConfig,
                  opt: Optimizer, k: int, rho=None,
                  engine: Optional[ProtocolEngine] = None) -> Callable:
    """Dispatch-time compute of the buffered-async LM loop
    (``launch.train``'s ``_LMAsyncExecutor``): the tau local steps of
    ``make_train_step`` without the round-end aggregation, which the
    async engine replaces by staleness-weighted merges. ``gen_step(params,
    opt_state, batch) -> ({"loss", "server_delta", "client"},
    opt_state)``: the server side's f32 delta against the dispatch-time
    server (``protocol.merge_async`` folds it into the live server at
    merge time) and the absolute client rows (sfl_ga and psl personalize
    the client sides; they scatter back into the bank as they are).

    Schemes without client aggregation (sfl_ga, psl) only; the launcher
    also keeps it to sgd, whose per-client state is nothing to discount
    by staleness."""
    if tcfg.algo not in ALGOS:
        raise ValueError(f"algo {tcfg.algo!r} not in {ALGOS}")
    engine = _engine_for(tcfg) if engine is None else engine
    if engine.spec.client_aggregate:
        raise ValueError(
            f"async LM path covers sfl_ga/psl (personalized client "
            f"sides); {tcfg.algo!r} aggregates client models every round")
    loss_fn = make_loss_fn(plan, tcfg, rho, engine=engine)
    tau = tcfg.resolved_tau
    local_step = _make_local_step(loss_fn, opt, plan.peft is not None)

    def gen_step(params, opt_state, batch):
        with full_f32():
            seed = batch.get("seed", 0)
            w = batch.get("rho")
            if w is not None:
                w = _rho_for(w, batch["tokens"].shape[0],
                             batch["tokens"].device)
            server0 = params["server"]
            params, opt_state, metrics = _local_steps(
                local_step, engine, tau, params, opt_state, batch, seed, w)
            delta = tree_map(lambda p, a: p.float() - a.float(),
                             params["server"], server0)
            return {"loss": metrics["loss"], "server_delta": delta,
                    "client": params["client"]}, opt_state

    return gen_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(plan: lm_mod.ModelPlan,
                      dtype=torch.float32) -> Callable:
    def prefill_step(params, batch):
        src = batch["tokens"] if "tokens" in batch else \
            batch["inputs_embeds"]
        return lm_mod.prefill(params, plan, tokens=batch.get("tokens"),
                              inputs_embeds=batch.get("inputs_embeds"),
                              max_len=src.shape[1], dtype=dtype)

    return prefill_step


def make_decode_step(plan: lm_mod.ModelPlan,
                     dtype=torch.float32) -> Callable:
    def decode_step(params, token, caches):
        return lm_mod.decode_step(params, plan, token, caches, dtype=dtype)

    return decode_step


# ---------------------------------------------------------------------------
# Communication accounting -- paper Fig. 4 at LLM scale
# ---------------------------------------------------------------------------

def _traffic_kw(cfg: ModelConfig, plan: lm_mod.ModelPlan, algo: str,
                n_clients: int, per_client_batch: int, seq: int, tau: int,
                bytes_per_elem: int, uplink_codec: str,
                downlink_codec: str) -> dict:
    from repro_torch.core.split import (client_adapter_numel,
                                        client_param_numel,
                                        total_param_numel)

    be8 = bytes_per_elem * 8
    peft = plan.peft is not None
    return dict(
        n_clients=n_clients, tau=tau,
        smashed_elems=per_client_batch * seq * cfg.d_model,
        label_bits=per_client_batch * seq * 32,
        client_model_bits=0 if peft else client_param_numel(plan) * be8,
        adapter_model_bits=client_adapter_numel(plan) * be8 if peft else 0,
        full_model_bits=total_param_numel(plan) * be8
        if (algo == "fl" and not peft) else 0,
        uplink_codec=uplink_codec, downlink_codec=downlink_codec,
        raw_bits_per_elem=be8)


def comm_bytes_per_round(cfg: ModelConfig, plan: lm_mod.ModelPlan, algo: str,
                         n_clients: int, per_client_batch: int, seq: int,
                         tau: int = 1, bytes_per_elem: int = 2,
                         uplink_codec: str = "fp32",
                         downlink_codec: str = "fp32") -> Dict[str, int]:
    """Edge-protocol traffic of one round, in bytes: X(v) smashed-data
    elements a client an epoch and phi(v) (or the adapters' phi-hat)
    client-model bytes, priced by ``sysmodel.traffic``. ``n_clients`` is
    the round's participant count (the cohort size K)."""
    from repro_torch.sysmodel.traffic import round_traffic_bytes

    return round_traffic_bytes(algo, **_traffic_kw(
        cfg, plan, algo, n_clients, per_client_batch, seq, tau,
        bytes_per_elem, uplink_codec, downlink_codec))


def comm_breakdown_per_round(cfg: ModelConfig, plan: lm_mod.ModelPlan,
                             algo: str, n_clients: int,
                             per_client_batch: int, seq: int, tau: int = 1,
                             bytes_per_elem: int = 2,
                             uplink_codec: str = "fp32",
                             downlink_codec: str = "fp32") -> Dict[str, int]:
    """Per ledger category, in bits: what a step's measured traffic
    ledger is reconciled against."""
    from repro_torch.sysmodel.traffic import round_traffic_breakdown

    return round_traffic_breakdown(algo, **_traffic_kw(
        cfg, plan, algo, n_clients, per_client_batch, seq, tau,
        bytes_per_elem, uplink_codec, downlink_codec))



# ---------------------------------------------------------------------------
# Whisper (encoder-decoder) split training: the smashed data is the
# decoder's residual and the encoder's states
# ---------------------------------------------------------------------------

def make_whisper_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                            opt: Optimizer, n_clients: int, rho=None,
                            engine: Optional[ProtocolEngine] = None
                            ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``models.encdec``'s split (client side stacked to N:
    ``launch.specs._whisper_split_stacked``). Batch: ``frame_embeds`` (N, b, F,
    d), ``tokens``/``labels`` (N, b, S), ``seed``. The client forward runs
    under ``torch.func.vmap``; both boundary tensors cross the scheme's
    transport outside it with the same seed (for sfl_ga each gets its
    own eq. 5 aggregate, kernel B1, and with an int codec its own B2/B3
    calls; the encoder states carry no labels); the server forward runs
    on the flattened (N b) batch with a CE loss. Aggregating schemes
    (sfl) meter the model sync and rho-average the client sides. tau 1
    only, as in the reference; ``engine`` as in ``make_train_step``."""
    from repro_torch.models import encdec

    if tcfg.algo not in ALGOS:
        raise ValueError(f"algo {tcfg.algo!r} not in {ALGOS}")
    if tcfg.resolved_tau != 1:
        raise ValueError("tau>1 not wired for enc-dec training")
    dtype = getattr(torch, tcfg.compute_dtype)
    engine = _engine_for(tcfg) if engine is None else engine

    def loss_fn(params, batch, seed=0, rho_w=None):
        fe = batch["frame_embeds"].to(dtype)  # (N, b, F, d)
        toks, labels = batch["tokens"], batch["labels"]  # (N, b, S)
        r = _rho_for(rho, toks.shape[0], toks.device)
        x, enc = vmap(lambda cp, f, t: encdec.whisper_client_forward(
            cp, cfg, f, t, dtype))(params["client"], fe, toks.long())
        # both boundary tensors cross the scheme's transport (eq. 5 for
        # sfl_ga: aggregated and broadcast; unicast for sfl/psl), in the
        # batch's layout where the step runs over DTensors (the dry run)
        x = engine.boundary(placed_like(x, toks), r, seed)
        enc = engine.boundary(placed_like(enc, toks), r, seed,
                              tap_labels=False)
        n, b = x.shape[:2]
        logits = encdec.whisper_server_forward(
            params["server"], cfg,
            placed_like(x.reshape((n * b,) + x.shape[2:]), toks),
            placed_like(enc.reshape((n * b,) + enc.shape[2:]), toks))
        ce = lm_mod.cross_entropy(logits, labels.reshape(n * b, -1))
        return ce, {"ce": ce}

    local_step = _make_local_step(loss_fn, opt, False)

    def train_step(params, opt_state, batch):
        with full_f32():
            params, opt_state, metrics = local_step(
                params, opt_state, batch, batch.get("seed", 0), None)
            if engine.spec.client_aggregate:
                engine.tap_model_sync(params["client"])
                n = int(batch["tokens"].shape[0])
                params = dict(params, client=engine.aggregate(
                    params["client"],
                    _rho_for(rho, n, batch["tokens"].device)))
            return params, opt_state, metrics

    return train_step
