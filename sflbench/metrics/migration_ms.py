"""Time of a cut migration: the benchmark's own span on the host clock
around each resplit of the params and the optimizer state
(``core.algorithms.resplit_lm_params`` / ``resplit_opt_state``), ending
in ``torch.cuda.synchronize()``; the mean over the traced run's window.
Moves ``step_ms_p90``.
"""

LAYER = "split, core/split.py and core/algorithms.py resplit"
UNIT = "ms"
MOVES = "step_ms_p90"


def read(run):
    ms = run.window.migrations_ms
    return sum(ms) / len(ms) if ms else None
