"""How many of the program's span names the profiled steps opened, from
``run.trace.phases`` (a test's metric)."""
LAYER = "train step, core/algorithms.py make_train_step"
UNIT = "spans"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.phases is None or not tr.phases.spans:
        return None
    return float(len({name for _, _, name in tr.phases.spans}))
