"""Share of the device's busy time spent in matrix-product kernels.

From the profiled sub-window: the summed time of the kernels whose names
are cuBLAS's or CUTLASS's GEMM kernels (the patterns below), over the
union of all device operations' intervals. Moves ``train_tokens_per_s``.
"""
import re

LAYER = "model, models/{transformer,attention,blocks,ssm,lm}.py"
UNIT = "%"
MOVES = "train_tokens_per_s"

GEMM = re.compile(r"gemm|xmma|nvjet|cutlass|cublas", re.IGNORECASE)


def read(run):
    tr = run.trace
    if tr is None or tr.busy_us <= 0:
        return None
    gemm = sum(d for name, _, d in tr.kernels if GEMM.search(name))
    return 100.0 * gemm / tr.busy_us
