"""A step's expert layers on the device, less their held experts'
products: the summed time of the device operations launched under the
program's ``moe`` span and under none of its children (router, dispatch,
combine, the shared expert), a mean profiled step. Each MoE layer's
forward opens it (``models/moe.py`` ``moe_apply``), the backward's
recompute under remat too; the span is innermost, so ``client_fwd_ms``,
``server_fwd_ms`` and ``backward_ms`` leave this time out.

From ``run.trace.phases`` (``harness/phases.py``); nothing without a
trace, or where the program opens no ``moe`` span. Moves
``train_tokens_per_s``.
"""

LAYER = "expert layer, models/moe.py moe_apply"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None or "moe" not in tr.phases.device_us:
        return None
    return tr.phases.per_step_ms(tr.phases.device_us["moe"])
