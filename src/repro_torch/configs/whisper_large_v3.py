"""Whisper-large-v3 [arXiv:2212.04356; unverified] — encoder-decoder;
the conv audio frontend is a STUB: input_specs() provides precomputed
1500-frame embeddings (assignment note).  32 encoder + 32 decoder layers,
MHA (kv=20)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_encoder_layers=32, d_model=1280, n_heads=20,
    n_kv_heads=20, d_ff=5120, vocab=51866, encoder_frames=1500,
    mlp_kind="gelu", norm_kind="layernorm",
    source="arXiv:2212.04356; hf:openai/whisper-large-v3",
)
