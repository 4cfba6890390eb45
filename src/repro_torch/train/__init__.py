"""Training: step factory, remat policies."""

from .remat import current_policy, maybe_remat, remat_context
from .step import TrainStepConfig, make_loss_fn, make_train_step

__all__ = ["make_train_step", "make_loss_fn", "TrainStepConfig",
           "remat_context", "maybe_remat", "current_policy"]
