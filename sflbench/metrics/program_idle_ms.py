"""A step's device-idle time while one of the program's spans is open:
the stretches of the profiled sub-window in which no device operation
ran, each given to the program span open on the host then, summed over
the spans; a mean profiled step. What the step's host code costs
the device; idle time under the harness alone is not counted.

From ``run.trace.phases`` (``harness/phases.py`` ``Phases.readings``);
nothing without a trace or without the program's spans. Moves
``train_tokens_per_s``.
"""

LAYER = "train step, core/algorithms.py make_train_step"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None:
        return None
    return tr.phases.readings().get("program_idle_ms")
