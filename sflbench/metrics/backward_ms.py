"""A step's backward on the device, less the downlink nested in it: the
summed time of the device operations launched under the program's
``backward`` span and under none of its children, a mean profiled
step.

From ``run.trace.phases`` (``harness/phases.py`` ``Phases.readings``);
nothing without a trace or without the program's spans. Moves
``train_tokens_per_s``.
"""

LAYER = "backward, core/algorithms.py span backward"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None:
        return None
    return tr.phases.readings().get("backward_ms")
