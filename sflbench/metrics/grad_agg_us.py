"""Kernel B1's (eq. 5's aggregation) mean time a launch, in the profiled
sub-window.

B1 reads the smashed data's gradient that the server's backward has just
written, much of it still in the 50 MB L2 cache, and its output stays
there after it ends: its time in the step is below what its bytes need
from HBM, so a share of the HBM roofline reads above 100 % and is not
given. Reads nothing when the trace holds another number of B1 launches
than the steps it covers launch (``counts/grad_agg.py``). Moves
``train_tokens_per_s``.
"""
import re

LAYER = "kernel B1, kernels/grad_agg.py and csrc/grad_agg.cu"
UNIT = "us"
MOVES = "train_tokens_per_s"

B1 = re.compile(r"(?:^|[^A-Za-z_])(?:wave|stream|general)_kernel"
                r"(?![A-Za-z0-9_])")


def read(run):
    from harness import spec

    tr = run.trace
    if tr is None:
        return None
    per_step = spec.counts("grad_agg").launches_per_step(run.model,
                                                         run.traffic)
    times = [d for name, _, d in tr.kernels if B1.search(name)]
    if not per_step or not times or len(times) != len(per_step) * tr.steps:
        return None
    return sum(times) / len(times)
