"""Distribution substrate: sharding rules + gradient compression.

``sharding`` resolves path-pattern rules to specs and DTensor placements
(and provides the in-model ``constrain*`` helpers, which are the
identity outside a ``mesh_context``); ``compression`` implements
blockwise int8 quantization with error feedback for gradient
all-reduce.
"""

from .compression import (dequantize_blockwise, ef_compress,
                          ef_compress_tree, quantize_blockwise)
from .sharding import (PartitionSpec, ShardingRules, batch_spec, cache_spec,
                       constrain, constrain_attn_qkv, constrain_residual,
                       lm_rules, mesh_context, placements, residual_sharding,
                       tree_paths, zero1_spec)

__all__ = [
    "quantize_blockwise", "dequantize_blockwise", "ef_compress",
    "ef_compress_tree",
    "ShardingRules", "lm_rules", "tree_paths", "mesh_context",
    "residual_sharding", "constrain", "constrain_residual",
    "constrain_attn_qkv", "batch_spec", "cache_spec", "zero1_spec",
    "PartitionSpec", "placements",
]
