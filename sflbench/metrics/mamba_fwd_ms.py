"""A step's Mamba-2 mixers on the device, less their SSD: the summed time
of the device operations launched under the program's ``mamba`` span and
under none of its children (the input and output projections, the
depthwise convolution, dt's softplus, the skip and the gated norm), a
mean profiled step. Each Mamba-2 forward opens it (``models/ssm.py``
``mamba2_train``), the backward's recompute under remat too; the span is
innermost, so ``client_fwd_ms``, ``server_fwd_ms`` and ``backward_ms``
leave this time out.

From ``run.trace.phases`` (``harness/phases.py``); nothing without a
trace, or where the program opens no ``mamba`` span. Moves
``train_tokens_per_s``.
"""

LAYER = "Mamba-2 mixer, models/ssm.py mamba2_train"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None or "mamba" not in tr.phases.device_us:
        return None
    return tr.phases.per_step_ms(tr.phases.device_us["mamba"])
