"""A step's multi-head latent attention on the device, less its scores:
the summed time of the device operations launched under the program's
``mla`` span and under none of its children (the q and kv down- and
up-projections, the latents' RMSNorms, RoPE on the rope dimensions, the
rope key's broadcast and o_proj), a mean profiled step. Each MLA
forward opens it (``models/attention.py`` ``attend_train``), the
backward's recompute under remat too; the span is innermost, so
``client_fwd_ms``, ``server_fwd_ms`` and ``backward_ms`` leave this time
out.

From ``run.trace.phases`` (``harness/phases.py``); nothing without a
trace, or where the program opens no ``mla`` span. Moves
``train_tokens_per_s``.
"""

LAYER = "latent attention, models/attention.py attend_train (MLA)"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None or "mla" not in tr.phases.device_us:
        return None
    return tr.phases.per_step_ms(tr.phases.device_us["mla"])
