"""Zamba2-2.7B [arXiv:2411.15242; hf] — hybrid: 54 Mamba2 layers with a
SHARED full-attention block invoked every 6 layers (weights reused)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, rope_theta=1e4,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    conv_kernel=4, shared_attn_every=6,
    mlp_kind="silu_gated", norm_kind="rmsnorm", tie_embeddings=True,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
)
