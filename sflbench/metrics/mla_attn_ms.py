"""A step's latent attention scores on the device: the summed time of
the device operations launched under the program's ``mla_scores`` span
(the scores over the q.k width, the causal mask, the softmax and the
values at v's width, nested in ``mla``), a mean profiled step; forward,
and the backward's recompute under remat.

From ``run.trace.phases`` (``harness/phases.py``); nothing without a
trace, or where the program opens no ``mla_scores`` span. Moves
``train_tokens_per_s``.
"""

LAYER = "latent attention, models/attention.py attend_train (MLA)"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None or \
            "mla_scores" not in tr.phases.device_us:
        return None
    return tr.phases.per_step_ms(tr.phases.device_us["mla_scores"])
