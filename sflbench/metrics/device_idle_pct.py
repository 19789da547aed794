"""Share of the profiled sub-window in which no device operation ran:
1 - (union of kernel, copy and set intervals) / (the sub-window).
Moves ``train_tokens_per_s``.
"""

LAYER = "device"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
