"""A step's optimizer update on the device: the summed time of the device
operations launched under the program's ``optimizer`` span (the sgd
update of every trainable leaf), a mean profiled step.

From ``run.trace.phases`` (``harness/phases.py`` ``Phases.readings``);
nothing without a trace or without the program's spans. Moves
``train_tokens_per_s``.
"""

LAYER = "optimizer, core/algorithms.py span optimizer"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None:
        return None
    return tr.phases.readings().get("optimizer_ms")
