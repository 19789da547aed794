"""Functional optimizers and learning-rate schedules: a port of
``repro.optim``."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    masked,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_decay,
    linear_warmup_cosine,
)
