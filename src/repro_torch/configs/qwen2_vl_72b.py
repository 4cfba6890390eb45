"""Qwen2-VL-72B [arXiv:2409.12191; hf] — VLM; the vision frontend is a
STUB (input_specs() provides M-RoPE position ids and merged embeddings).
Backbone: 80L, d_model=8192, GQA kv=8, M-RoPE."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, rope_theta=1e6, qkv_bias=True, mrope=True,
    mlp_kind="silu_gated", norm_kind="rmsnorm",
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B-Instruct",
)
