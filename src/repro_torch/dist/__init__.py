"""Distribution substrate: the in-model sharding constraints (identity
on one device) and gradient compression (blockwise int8 with error
feedback).  The rule tables, ``mesh_context`` and the launch-time specs
wait for ROADMAP Queue 1 item 4, beside the dry run."""

from .compression import (dequantize_blockwise, ef_compress,
                          ef_compress_tree, quantize_blockwise)
from .sharding import (constrain, constrain_attn_qkv, constrain_residual,
                       residual_sharding)

__all__ = ["quantize_blockwise", "dequantize_blockwise", "ef_compress",
           "ef_compress_tree", "residual_sharding", "constrain",
           "constrain_residual", "constrain_attn_qkv"]
