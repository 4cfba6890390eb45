"""Distribution substrate: the in-model sharding constraints (identity
on one device).  The rule tables, ``mesh_context`` and gradient
compression come with the training slice."""

from .sharding import (constrain, constrain_attn_qkv, constrain_residual,
                       residual_sharding)

__all__ = ["residual_sharding", "constrain", "constrain_residual",
           "constrain_attn_qkv"]
