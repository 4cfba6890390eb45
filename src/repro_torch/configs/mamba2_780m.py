"""Mamba2-780m [arXiv:2405.21060; unverified] — attention-free SSD
(state-space duality), 48L, d_model=1536, state=128, headdim=64."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    conv_kernel=4, norm_kind="rmsnorm", tie_embeddings=True,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m",
)
