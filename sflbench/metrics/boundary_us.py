"""A step's cut-layer transport on the device: the summed time of the
device operations launched under the program's ``uplink`` span (the
uplink codec, B2 and B3 under int8; none under fp32) and ``downlink``
span (eq. 5's aggregation, B1, and the downlink codec), a mean
profiled step, in microseconds.

From ``run.trace.phases`` (``harness/phases.py`` ``Phases.readings``);
nothing without a trace or without the program's spans. Moves
``train_tokens_per_s``.
"""

LAYER = ("boundary, spans uplink (core/algorithms.py) and downlink "
         "(core/protocol.py, core/gradagg.py)")
UNIT = "us"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None:
        return None
    return tr.phases.readings().get("boundary_us")
