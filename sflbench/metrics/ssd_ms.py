"""A step's SSD on the device: the summed time of the device operations
launched under the program's ``ssd`` span (the chunked scan of
``models/ssm.py`` ``ssd_chunked``: the intra-chunk quadratic form, the
chunk states, their recurrence and the off-diagonal term, nested in
``mamba``), a mean profiled step; forward, and the backward's recompute
under remat.

From ``run.trace.phases`` (``harness/phases.py``); nothing without a
trace, or where the program opens no ``ssd`` span. Moves
``train_tokens_per_s``.
"""

LAYER = "Mamba-2 mixer, models/ssm.py mamba2_train"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None or "ssd" not in tr.phases.device_us:
        return None
    return tr.phases.per_step_ms(tr.phases.device_us["ssd"])
