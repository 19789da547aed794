"""A step's client forward on the device: the summed time of the device
operations launched under the program's ``client_forward`` span (the
embedding and the client layers, one ``vmap`` a layer over the client
copies), a mean profiled step.

From ``run.trace.phases`` (``harness/phases.py`` ``Phases.readings``);
nothing without a trace or without the program's spans. Moves
``train_tokens_per_s``.
"""

LAYER = "client forward, core/algorithms.py span client_forward"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None:
        return None
    return tr.phases.readings().get("client_fwd_ms")
