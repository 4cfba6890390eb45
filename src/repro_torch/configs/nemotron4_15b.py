"""Nemotron-4-15B [arXiv:2402.16819; unverified] — GQA (kv=8),
squared-ReLU non-gated MLP."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab=256000, rope_theta=1e4,
    mlp_kind="sq_relu", norm_kind="layernorm",
    source="arXiv:2402.16819 (unverified)",
)
