"""Phi-3.5-MoE 42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct] — 16 experts
top-2, GQA kv=8."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    moe_d_ff=6400, vocab=32064, rope_theta=1e4,
    n_experts=16, top_k=2,
    mlp_kind="silu_gated", norm_kind="layernorm",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
