"""Gemma2-9B [arXiv:2408.00118; hf] — local+global alternating attention,
logit softcapping, GQA (kv=8), head_dim=256, sandwich norms."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000, rope_theta=1e4,
    attn_softcap=50.0, logit_softcap=30.0,
    sliding_window=4096, local_global_alternate=True, post_norms=True,
    mlp_kind="silu_gated", norm_kind="rmsnorm", tie_embeddings=True,
    source="arXiv:2408.00118; hf:google/gemma-2-9b",
)
