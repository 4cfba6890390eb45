"""StarCoder2-7B [arXiv:2402.19173; hf] — GQA (kv=4), RoPE, non-gated
GELU MLP with biases, LayerNorm."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, rope_theta=1e5, qkv_bias=True,
    mlp_kind="gelu", norm_kind="layernorm",
    source="arXiv:2402.19173; hf:bigcode/starcoder2-7b",
)
