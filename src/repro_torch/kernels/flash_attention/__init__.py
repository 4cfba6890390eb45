"""Flash attention: the hand-written CUDA kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version, on the model layout (B, S, heads, d)."""
from .kernel import (H100_SMEM_OPTIN, HEAD_DIMS, FlashPlan,
                     flash_attention_cuda, flash_attention_kernel,
                     flash_plan, flash_smem_bytes, flash_wide_smem_bytes)
from .ops import flash_blocks, mha, mha_ref
from .ref import attention_ref, flash_tiled_ref

__all__ = ["mha", "mha_ref", "attention_ref", "flash_tiled_ref",
           "flash_blocks", "flash_attention_cuda", "flash_attention_kernel",
           "flash_smem_bytes", "flash_wide_smem_bytes", "flash_plan",
           "FlashPlan", "HEAD_DIMS", "H100_SMEM_OPTIN"]
