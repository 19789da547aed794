"""Kernels B2 and B3's (the int8 codec's) share of their roofline.

The summed bytes of every B2 and B3 launch of the profiled steps
(``counts/quantize.py``, from the cell's shapes) over the card's HBM
bandwidth, over the summed time of those launches. Reads nothing when the
trace holds another number of B2 or B3 launches than the steps it covers
launch. Moves ``train_tokens_per_s``.
"""
import re

LAYER = "kernels B2 and B3, kernels/quantize.py"
UNIT = "%"
MOVES = "train_tokens_per_s"

B2 = re.compile(r"quantize_(?:warp|cluster|general)_kernel")
B3 = re.compile(r"dequant_(?:vector|general)_kernel")


def read(run):
    from harness import spec

    tr = run.trace
    if tr is None or run.peaks is None:
        return None
    per_step = spec.counts("quantize").launches_per_step(run.model,
                                                         run.traffic)
    t2 = [d for name, _, d in tr.kernels if B2.search(name)]
    t3 = [d for name, _, d in tr.kernels if B3.search(name)]
    n2 = sum(1 for k, _ in per_step if k == "B2") * tr.steps
    n3 = sum(1 for k, _ in per_step if k == "B3") * tr.steps
    if not per_step or len(t2) != n2 or len(t3) != n3:
        return None
    need = sum(b for _, b in per_step) * tr.steps / run.peaks["hbm_bytes"]
    return 100.0 * need / ((sum(t2) + sum(t3)) / 1e6)
