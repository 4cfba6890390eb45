"""Optimizers: AdamW with float32 or 8-bit moments, the LR schedule."""

from .adamw import (AdamWConfig, OptState, apply_updates, clip_by_global_norm,
                    global_norm, init_opt)
from .quantized import QuantOptState, apply_updates_q8, init_opt_q8
from .schedule import warmup_cosine

__all__ = ["AdamWConfig", "OptState", "init_opt", "apply_updates",
           "global_norm", "clip_by_global_norm", "warmup_cosine",
           "QuantOptState", "init_opt_q8", "apply_updates_q8"]
