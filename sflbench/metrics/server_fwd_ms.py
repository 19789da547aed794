"""A step's server forward on the device: the summed time of the device
operations launched under the program's ``server_forward`` span (the
server layers on all clients' rows, the final norm, the head and the
cross-entropy), a mean profiled step.

From ``run.trace.phases`` (``harness/phases.py`` ``Phases.readings``);
nothing without a trace or without the program's spans. Moves
``train_tokens_per_s``.
"""

LAYER = "server forward, core/algorithms.py span server_forward"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None:
        return None
    return tr.phases.readings().get("server_fwd_ms")
