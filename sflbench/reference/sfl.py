"""Plain split training with gradient aggregation (SFL-GA), step by step.

What the benchmark's checked steps compute, written out with one copy of
the client side per client and a Python loop over the clients:

1. client n embeds its tokens and runs layers [0, cut) on its own copy;
2. the server receives each client's smashed data (through the int8
   uplink when the traffic asks for it), runs layers [cut, L), the final
   norm and the head on all clients' rows, and takes the mean token
   cross-entropy; the loss adds the family's ``aux_weight`` times the sum
   of the layers' ``aux`` terms (a MoE layer's balance loss: each
   client's over its own layers, the server's over all rows), as the
   port's loss does;
3. eq. 5: the server aggregates the smashed-data gradients, s = sum_n
   rho_n s_n with rho_n = 1/N in float32 in client order, sends the one
   aggregate down (through the int8 downlink when asked) and every
   client back-propagates it through its own layers;
4. plain SGD on both sides, p - lr g;
5. at a cut change, layers moving to the server become the rho-weighted
   mean of the client copies, layers moving to the clients are copied to
   each of them.

:func:`run` returns the losses of the steps, and from the params the
norm of each leaf's first update over lr (the first gradient) and of its
change after the checked steps, as the program's are read.
``tf32=True`` computes the same in TF32 (the control); ``fault`` plants
one of the faults the check must catch.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

import reference
from reference import codec
from reference.model import cross_entropy

FAULTS = ("half_batch", "no_aggregate", "frozen")


@contextmanager
def precision(tf32: bool):
    """Matmuls and convolutions in full float32, or in TF32."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def _layer_index(name: str) -> int:
    return int(name[5:name.index(".")]) if name.startswith("layer") else -1


def _on_client(name: str, cut: int) -> bool:
    i = _layer_index(name)
    return name.startswith("embed.") or 0 <= i < cut


def update_norms(p0: Dict[str, torch.Tensor], named: Dict[str, torch.Tensor],
                 scale: float = 1.0) -> Dict[str, float]:
    """side.leaf -> ||p - p0|| * scale in float64 (client leaves over all
    their copies)."""
    out = {}
    for key, p in named.items():
        base = p0[key.split(".", 1)[1]].double()
        rows = p if key.startswith("client.") else p[None]
        ss = sum(float((r.double() - base).square().sum()) for r in rows)
        out[key] = ss ** 0.5 * scale
    return out


def _plus(total, aux):
    return aux if total is None else (total if aux is None else total + aux)


class SplitModel:
    """The reference's state: per-client copies and the server's, with
    the layers of ``family``."""

    def __init__(self, init: Dict[str, torch.Tensor], n: int, cut: int,
                 family: reference.Family):
        self.n, self.cut = n, cut
        self.family = family
        self.client: List[Dict[str, torch.Tensor]] = [
            {k: v.clone() for k, v in init.items() if _on_client(k, cut)}
            for _ in range(n)]
        self.server = {k: v.clone() for k, v in init.items()
                       if not _on_client(k, cut)}

    def named(self) -> Dict[str, torch.Tensor]:
        out = {f"client.{k}": torch.stack([c[k] for c in self.client])
               for k in self.client[0]}
        out.update({f"server.{k}": v for k, v in self.server.items()})
        return out

    def migrate(self, cut: int):
        if cut < self.cut:
            rho = 1.0 / self.n
            for k in [k for k in self.client[0] if not _on_client(k, cut)]:
                acc = torch.zeros_like(self.client[0][k])
                for c in self.client:
                    acc = acc + rho * c.pop(k)
                self.server[k] = acc
        elif cut > self.cut:
            for k in [k for k in self.server if _on_client(k, cut)]:
                v = self.server.pop(k)
                for c in self.client:
                    c[k] = v.clone()
        self.cut = cut

    def step(self, model: dict, traffic: dict, tokens, labels, seed: int,
             fault: Optional[str] = None) -> float:
        fam, n, (b, S) = self.family, self.n, tokens.shape[1:]
        L, lr = model["num_layers"], float(traffic["lr"])
        int8_up = traffic["uplink_codec"] == "int8"
        int8_down = traffic["downlink_codec"] == "int8"
        outs = []
        for i_n, c in enumerate(self.client):
            lv = {k: v.detach().requires_grad_(True) for k, v in c.items()}
            x, aux = fam.embed(lv, tokens[i_n], model), None
            for i in range(self.cut):
                x, a = fam.layer(lv, i, x, model)
                aux = _plus(aux, a)
            outs.append((x, aux, lv))
        received = [codec.roundtrip(x.detach(), codec.uplink_seed(seed, i_n))
                    if int8_up else x.detach() for i_n, (x, _, _) in
                    enumerate(outs)]
        s_in = torch.cat(received, dim=0).requires_grad_(True)
        sv = {k: v.detach().requires_grad_(True)
              for k, v in self.server.items()}
        h, aux_s = s_in, None
        for i in range(self.cut, L):
            h, a = fam.layer(sv, i, h, model)
            aux_s = _plus(aux_s, a)
        logits = fam.logits(sv, h, model)
        lab = labels.reshape(n * b, S)
        rows = n * b // 2 if fault == "half_batch" else n * b
        loss = cross_entropy(logits[:rows].reshape(rows * S, -1),
                             lab[:rows].reshape(-1))
        aux = None  # the clients' balance losses, then the server's
        for _, a, _ in outs:
            aux = _plus(aux, a)
        aux = _plus(aux, aux_s)
        w = fam.aux_weight
        total = loss if aux is None else loss + w * aux  # the port's loss
        # the server differentiates its own terms; a client's balance loss
        # reaches only that client's copy
        keys = list(sv)
        grads = torch.autograd.grad(
            loss if aux_s is None else loss + w * aux_s,
            [s_in] + [sv[k] for k in keys])
        del logits, h
        s = grads[0].view(n, b, S, -1)
        agg = torch.zeros_like(s[0])
        for i_n in range(n):
            agg = agg + (1.0 / n) * s[i_n]
        if int8_down:
            agg = codec.roundtrip(agg, codec.downlink_seed(seed))
        if fault != "frozen":
            with torch.no_grad():
                self.server = {k: sv[k] - lr * g
                               for k, g in zip(keys, grads[1:])}
        for i_n, (x, a, lv) in enumerate(outs):
            ck = list(lv)
            down = s[i_n] if fault == "no_aggregate" else agg
            ys, dys = [x], [down]
            if a is not None:
                ys.append(a)
                dys.append(torch.full_like(a, w))
            g = torch.autograd.grad(ys, [lv[k] for k in ck], grad_outputs=dys)
            if fault != "frozen":
                with torch.no_grad():
                    self.client[i_n] = {k: lv[k] - lr * gk
                                        for k, gk in zip(ck, g)}
        return float(total.detach())


def run(model: dict, traffic: dict, init: Dict[str, torch.Tensor],
        batches, seeds, cuts, family: reference.Family, *,
        tf32: bool = False, fault: Optional[str] = None) -> dict:
    """The checked steps: ``batches`` a list of (tokens, labels) tensors
    (N, b, S) on the device, ``seeds`` their codec seeds, ``cuts`` their
    cuts, with the layers of ``family``. Returns {"losses", "grad",
    "change"}."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if (traffic["scheme"], traffic["optimizer"], traffic.get("tau", 1)) \
            != ("sfl_ga", "sgd", 1) or not {traffic["uplink_codec"],
                                             traffic["downlink_codec"]} \
            <= {"fp32", "int8"}:
        raise ValueError("the reference follows sfl_ga with sgd, tau 1 and "
                         "fp32 or int8 codecs")
    n, lr = traffic["clients"], float(traffic["lr"])
    out = {"losses": [], "grad": None, "change": None}
    with precision(tf32):
        m = SplitModel(init, n, cuts[0], family)
        for k, ((tok, lab), seed, cut) in enumerate(zip(batches, seeds,
                                                          cuts)):
            if cut != m.cut:
                m.migrate(cut)
            out["losses"].append(m.step(model, traffic, tok, lab, seed,
                                        fault))
            if k == 0:
                out["grad"] = update_norms(init, m.named(), 1.0 / lr)
        out["change"] = update_norms(init, m.named())
    return out
