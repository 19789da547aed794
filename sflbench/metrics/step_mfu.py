"""Model FLOPs utilization of the training step.

The configuration's model FLOPs a step (``counts/<config>.py``: no
recomputation), times the steps of the traced run outside its profiled
sub-window, over their summed time (each from its start to its loss
copy), over the card's TF32 peak: the fastest published rate for float32
inputs, which no float32-accurate step can pass. Moves
``train_tokens_per_s``.
"""

LAYER = "train step, core/algorithms.py make_train_step"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(run):
    steps = run.untraced_steps
    if run.peaks is None or not steps:
        return None
    return 100.0 * run.step_flops * len(steps) / sum(steps) \
        / run.peaks["tf32_flops"]
