"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified, paper-table] — 61L
trillion-parameter MoE: 384 experts top-8 + 1 shared expert, GQA kv=8.
The assignment pins GQA (not MLA); first layer dense as in DeepSeek-V3
lineage."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=18432, moe_d_ff=2048, vocab=163840, rope_theta=5e4,
    n_experts=384, top_k=8, n_shared_experts=1, first_dense_layers=1,
    mlp_kind="silu_gated", norm_kind="rmsnorm",
    source="arXiv:2501 Kimi K2 tech report (unverified)",
)
