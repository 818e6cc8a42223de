"""Optimizers and schedules (``repro.optim``'s counterpart)."""

from repro_torch.optim.adamw import (OptState, adamw, apply_updates,
                                     global_norm, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup_cosine)

__all__ = [
    "OptState", "adamw", "apply_updates", "global_norm", "sgd",
    "constant", "cosine_decay", "linear_warmup_cosine",
]
