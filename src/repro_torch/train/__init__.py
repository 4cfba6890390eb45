"""Training: remat policies.  The step factory comes with the training
slice."""

from .remat import current_policy, maybe_remat, remat_context

__all__ = ["remat_context", "maybe_remat", "current_policy"]
