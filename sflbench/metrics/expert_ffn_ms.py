"""A step's held experts' products on the device: the summed time of the
device operations launched under the program's ``moe_experts`` span (the
three batched products of the experts' SwiGLU and its gate, nested in
``moe``), a mean profiled step; forward, and the backward's recompute
under remat.

From ``run.trace.phases`` (``harness/phases.py``); nothing without a
trace, or where the program opens no ``moe_experts`` span. Moves
``train_tokens_per_s``.
"""

LAYER = "expert layer, models/moe.py moe_apply"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None or \
            "moe_experts" not in tr.phases.device_us:
        return None
    return tr.phases.per_step_ms(tr.phases.device_us["moe_experts"])
